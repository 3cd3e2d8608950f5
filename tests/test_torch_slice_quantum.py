"""The slice pod's closed loop on the CPU: a StatefulSet of slices of two
hosts scaled in whole slices by the shipped slice HPA (quantum 2, pods
2..8, target 40), as bench.py's ``run_rung_multihost_quantum`` runs it.

- The scripted load through the port's trial loop twice, once over the
  port's planes (``slice_spec``) and once over the JAX package's (its TSDB,
  ``tpu_test_multihost_avg_rule``, adapter and ``HPAController(
  replica_quantum=2)``), at time scale 1 and at the virtual scale: the same
  series, replica timelines, scale-up, violations and drain, exactly.
- A planted fault, the HPA's quantum taken away: both count the same
  slice-boundary violations.
- ``run_slice_trial`` on the CPU: the collective generator over a gloo
  group of one, a 0.1 MB buffer.
- ``topology_from_env`` against JAX's for the StatefulSet's eight ordinals
  under the slice manifest's environment."""

import types
from pathlib import Path

import pytest
import torch
import yaml

from k8s_gpu_hpa_tpu.control import adapter as jax_adapter
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.loadgen.multihost import topology_from_env as jax_topology_from_env
from k8s_gpu_hpa_tpu.metrics import exposition as jax_exposition
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxVirtualClock
from k8s_gpu_hpa_tpu_torch.control.adapter import AdapterRule, CustomMetricsAdapter, ObjectReference
from k8s_gpu_hpa_tpu_torch.control.hpa import MULTIHOST_SERIES
from k8s_gpu_hpa_tpu_torch.loadgen.allreduce import AllReduceLoadGen
from k8s_gpu_hpa_tpu_torch.loadgen.multihost import topology_from_env
from k8s_gpu_hpa_tpu_torch.metrics import exposition, schema
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch import trial
from k8s_gpu_hpa_tpu_torch.trial import (
    MULTIHOST_DUTY_SERIES,
    MirrorStatefulSet,
    Pipeline,
    pod_labels_exposition,
    run_slice_trial,
    run_trial,
    slice_spec,
    wire_pipeline,
)
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores, keep_priority  # noqa: F401
from tests.test_torch_mesh import _save, run_ranks
from tests.test_torch_slice import REAL_TIME_SCALE, VIRTUAL_TIME_SCALE, ScriptedLoad

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

DEPLOY = Path(__file__).resolve().parent.parent / "deploy"
HPA_DOC = yaml.safe_load((DEPLOY / "tpu-test-multihost-hpa.yaml").read_text())
STATEFULSET_DOC = list(yaml.safe_load_all((DEPLOY / "tpu-test-multihost.yaml").read_text()))[1]
APP = "tpu-test-multihost"
#: bench.py's multihost rung: all pods within the 60 s budget of the
#: crossing (times the time scale), no scale event off a slice boundary
BUDGET_S = 60.0
MAX_VIOLATIONS = 0


def _real(mod_schema, mod_exposition, load, pod):
    """The real pod's exporter: its one device's duty cycle, in both
    activity gauges, as the mirror pods report it."""

    def fetch():
        duty = load.utilization()
        chip = mod_schema.ChipSample(0, duty, duty, 2e9, 85e9, None)
        return mod_exposition.encode_text(
            mod_schema.families_from_chips([chip], "real-0", {0: ("default", pod)})
        )

    return fetch


def _jax_pipeline(fetch_real, mirror_util, clock, time_scale: float) -> Pipeline:
    """The JAX package's layers around the port's StatefulSet of mirror
    pods: its TSDB and scraper, its slice rule, its adapter on the
    StatefulSet and its HPA with the shipped manifest's quantum, bounds and
    behavior (scaled as bench.py scales them)."""
    deployment = MirrorStatefulSet(clock, 12.0 * time_scale, APP, HPA_DOC["spec"]["minReplicas"])
    db = jax_tsdb.TimeSeriesDB(clock)
    scraper = jax_tsdb.Scraper(db)
    scraper.add_target(fetch_real, name="exporter/real", node="real-0")

    def sim():
        chips, attribution = [], {}
        for i, pod in enumerate(p for p in deployment.running() if p != deployment.real_pod):
            u = mirror_util()
            chips.append(jax_schema.ChipSample(i, u, u, 8e9, 16e9, u * 0.6))
            attribution[i] = ("default", pod)
        return jax_exposition.encode_text(jax_schema.families_from_chips(chips, "sim-0", attribution))

    def ksm():
        fam = jax_schema.MetricFamily("kube_pod_labels", "gauge")
        for pod in deployment.pods:
            fam.add(1.0, namespace="default", pod=pod, label_app=APP)
        return jax_exposition.encode_text([fam])

    scraper.add_target(sim, name="exporter/sim", node="sim-0")
    scraper.add_target(ksm, name="ksm")
    evaluator = jax_rules.RuleEvaluator(db, [jax_rules.tpu_test_multihost_avg_rule()])
    adapter = jax_adapter.CustomMetricsAdapter(db, [jax_adapter.AdapterRule(
        series=MULTIHOST_SERIES,
        resource_overrides={"namespace": "namespace", "statefulset": "StatefulSet"},
    )])
    behavior = jax_hpa.behavior_from_manifest(HPA_DOC)
    for rules in (behavior.scale_up, behavior.scale_down):
        rules.stabilization_window_seconds *= time_scale
        for policy in rules.policies:
            policy.period_seconds *= time_scale
    metric = HPA_DOC["spec"]["metrics"][0]["object"]
    hpa = jax_hpa.HPAController(
        target=deployment,
        metrics=[jax_hpa.ObjectMetricSpec(
            metric["metric"]["name"], float(metric["target"]["value"]),
            jax_adapter.ObjectReference("StatefulSet", APP, "default"),
        )],
        adapter=adapter,
        clock=clock,
        min_replicas=HPA_DOC["spec"]["minReplicas"],
        max_replicas=HPA_DOC["spec"]["maxReplicas"],
        behavior=behavior,
        replica_quantum=jax_hpa.quantum_from_manifest(HPA_DOC),
    )
    return Pipeline(deployment, db, scraper, evaluator, hpa, MULTIHOST_SERIES, slice_spec())


def _both(time_scale: float):
    """The scripted load and the slice loop around it, over the port's
    planes and over the JAX package's: two (load, pipeline, clock)."""
    spec = slice_spec()
    port_clock = VirtualClock()
    port_load = ScriptedLoad(port_clock)
    port_pipe = wire_pipeline(
        _real(schema, exposition, port_load, spec.real_pod), port_load.utilization, port_clock,
        time_scale, spec=spec,
    )
    jax_clock = JaxVirtualClock()
    jax_load = ScriptedLoad(jax_clock)
    jax_pipe = _jax_pipeline(
        _real(jax_schema, jax_exposition, jax_load, spec.real_pod), jax_load.utilization,
        jax_clock, time_scale,
    )
    return (port_load, port_pipe, port_clock), (jax_load, jax_pipe, jax_clock)


def _whole_slices(result, time_scale: float) -> None:
    """From one slice to four within the budget after the crossing, every
    scale event on a slice boundary, then the drain back to one slice in
    whole slices."""
    counts = [n for _, n, _ in result.replicas]
    assert max(counts) == 8
    assert (8, 8) in [r[1:] for r in result.replicas]
    assert result.scale_up_s <= BUDGET_S * time_scale
    assert result.slice_boundary_violations == MAX_VIOLATIONS
    assert all(n % 2 == 0 for n in counts)
    assert result.replicas[-1][1] == 2 and result.scale_down_s is not None
    assert result.scale_down_flaps == 0


@pytest.mark.parametrize("time_scale", [1.0, VIRTUAL_TIME_SCALE])
def test_the_slice_loop_gives_the_jax_components_timeline(time_scale):
    port_side, jax_side = _both(time_scale)
    port = run_trial(*port_side, time_scale)
    ref = run_trial(*jax_side, time_scale)
    assert port.series == ref.series
    assert port.replicas == ref.replicas
    assert (port.scale_up_s, port.spike_to_cross_s) == (ref.scale_up_s, ref.spike_to_cross_s)
    assert port.slice_boundary_violations == ref.slice_boundary_violations
    assert (port.scale_down_s, port.scale_down_flaps) == (ref.scale_down_s, ref.scale_down_flaps)
    _whole_slices(port, time_scale)
    if time_scale == 1.0:
        # bench.py's traffic: 3.2 devices over 6 pods read 53.3, which needs
        # all 8 (at the virtual scale the load's 3 s window, not scaled,
        # never fills between two syncs)
        assert any(abs(v - 320.0 / 6) < 1e-6 for _, v in port.series if v is not None)


def test_the_loop_counts_violations_of_an_hpa_without_the_quantum():
    """The planted fault: both HPAs lose the quantum (a vanilla HPA on the
    slice manifest), and the spike's first step, ceil(2 × 100 / 40) = 5,
    strands half a slice: both packages count it."""
    results = []
    for load, pipe, clock in _both(1.0):
        pipe.hpa.replica_quantum = 1
        results.append(run_trial(load, pipe, clock))
    port, ref = results
    assert port.replicas == ref.replicas
    assert port.slice_boundary_violations == ref.slice_boundary_violations > MAX_VIOLATIONS
    assert 5 in [n for _, n, _ in port.replicas]


def test_the_statefulset_names_its_pods_by_ordinal_and_scales_from_the_top():
    clock = VirtualClock()
    sts = MirrorStatefulSet(clock, 12.0, APP, 2)
    assert list(sts.pods) == [f"{APP}-0", f"{APP}-1"] == sts.running()
    assert sts.real_pod == f"{APP}-0"
    sts.scale_to(6)
    assert list(sts.pods) == [f"{APP}-{i}" for i in range(6)]
    assert sts.running() == [f"{APP}-0", f"{APP}-1"]
    clock.advance(12.0)
    assert len(sts.running()) == 6
    sts.scale_to(4)
    assert list(sts.pods) == [f"{APP}-{i}" for i in range(4)] and sts.replicas == 4
    fams = exposition.parse_text(pod_labels_exposition(sts))
    assert {dict(s.labels)["label_app"] for s in fams[0].samples} == {APP}


def test_the_adapter_addresses_the_statefulset():
    """``AdapterRule`` with the StatefulSet's overrides serves the recorded
    series at the StatefulSet object, and nothing at a Deployment."""
    clock = VirtualClock()
    db = TimeSeriesDB(clock)
    db.append(MULTIHOST_SERIES, (("namespace", "default"), ("statefulset", APP)), 53.5, 0.0)
    adapter = CustomMetricsAdapter(db, [AdapterRule(
        MULTIHOST_SERIES, {"namespace": "namespace", "statefulset": "StatefulSet"}
    )])
    assert adapter.get_object_metric(ObjectReference("StatefulSet", APP), MULTIHOST_SERIES) == 53.5
    assert adapter.get_object_metric(ObjectReference("Deployment", APP), MULTIHOST_SERIES) is None
    assert adapter.get_object_metric(
        ObjectReference("StatefulSet", "other"), MULTIHOST_SERIES
    ) is None


class _Host:
    """A clock for the loads' pacing: each step is 1.7 ms of work (the
    collective rung's burst on an H100), each sleep wakes 0.3 ms late, and
    0.07 ms pass between steps."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += seconds + 3e-4

    def step(self) -> None:
        self.now += 1.7e-3


@pytest.mark.parametrize("load_cls,delivers", [(trial.PacedLoad, True), (trial.TrainLoad, False)])
def test_the_paced_load_delivers_the_commanded_duty_despite_late_wakeups(
    monkeypatch, load_cls, delivers
):
    """At 3.2 devices over 6 pods, 53.3, the duty at which the slice loop
    leaves the HPA's band at 6 pods: ``PacedLoad`` delivers it within 0.5
    points; ``TrainLoad``, which sleeps after each step, falls below 50
    (the card read 43.9 under it in the slice loop)."""
    host = _Host()
    monkeypatch.setattr(trial, "time", host)
    load = load_cls(types.SimpleNamespace(step=host.step))
    load.set_intensity(3.2 / 6)
    for _ in range(3000):
        host.now += 7e-5
        load.step()
    duty = load.utilization()
    assert (abs(duty - 320.0 / 6) < 0.5) == delivers, duty
    if not delivers:
        assert duty < 50.0


def slice_trial_rank(out_dir) -> None:
    """``run_slice_trial`` on a gloo group of one, a 0.1 MB buffer."""
    torch.set_num_threads(1)
    gen = AllReduceLoadGen(buffer_mb=0.1, device="cpu")
    gen.warmup()
    result = run_slice_trial(gen, time_scale=REAL_TIME_SCALE)
    _save(out_dir, {"result": result, "rounds": gen.stats().rounds})


@pytest.mark.usefixtures("keep_priority")
def test_run_slice_trial_on_cpu_scales_two_to_eight_in_whole_slices(tmp_path):
    (got,) = run_ranks(slice_trial_rank, 1, tmp_path)
    result = got["result"]
    assert got["rounds"] > 0
    assert result.replicas[-1][1:] == (8, 8)
    assert all(n % 2 == 0 for _, n, _ in result.replicas)
    assert result.slice_boundary_violations == 0
    assert result.scale_up_s <= BUDGET_S * REAL_TIME_SCALE
    # the duty-cycle series crossed 40 after the spike
    assert max(v for t, v in result.series if t >= 0 and v is not None) > 40.0
    assert result.metrics and all(MULTIHOST_DUTY_SERIES in m for _, m in result.metrics)


def _manifest_env() -> dict[str, str]:
    """The slice container's environment as deploy/tpu-test-multihost.yaml
    sets it, in namespace ``ml``."""
    env = {}
    for var in STATEFULSET_DOC["spec"]["template"]["spec"]["containers"][0]["env"]:
        if "value" in var:
            env[var["name"]] = var["value"]
        elif var["valueFrom"]["fieldRef"]["fieldPath"] == "metadata.namespace":
            env[var["name"]] = "ml"
    return env


@pytest.mark.parametrize("ordinal", range(8))
def test_topology_from_env_matches_jax_s_for_every_ordinal(ordinal):
    env = _manifest_env()
    assert (env["HOSTS_PER_SLICE"], env["HEADLESS_SERVICE"], env["POD_NAMESPACE"]) == (
        "2", APP, "ml"
    )
    hostname = f"{APP}-{ordinal}"
    got = topology_from_env(env, hostname)
    want = jax_topology_from_env(env, hostname)
    assert (got.process_id, got.num_processes, got.coordinator_address, got.slice_index) == (
        want.process_id, want.num_processes, want.coordinator_address, want.slice_index
    )
    assert (got.slice_index, got.process_id) == (ordinal // 2, ordinal % 2)
    assert got.coordinator_address == (
        f"{APP}-{2 * (ordinal // 2)}.{APP}.ml.svc.cluster.local:8476"
    )
