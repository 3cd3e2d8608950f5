"""The serve loop on the port (k8s_gpu_hpa_tpu_torch/trial.py
``run_serve_trial``): its constants against the shipped serve manifests and
the JAX package, the reachability predicate against the JAX one, a scripted
serve trace through the port's loop over both packages' planes, and the
whole serve slice on the CPU — the decode generator behind the exporter, the
``tpu-serve`` rule and the shipped serve HPA, 1 → 4 replicas."""

import dataclasses
from pathlib import Path

import pytest
import torch
import yaml

from k8s_gpu_hpa_tpu.control import adapter as jax_adapter
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.metrics import exposition as jax_exposition
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxVirtualClock
from k8s_gpu_hpa_tpu_torch.control.hpa import shipped_behavior, signal_ceiling_clears_band
from k8s_gpu_hpa_tpu_torch.loadgen.decode import SERVE_SIZES, DecodeLoadGen
from k8s_gpu_hpa_tpu_torch.metrics import exposition, schema
from k8s_gpu_hpa_tpu_torch.metrics.rules import SERVE_BW_TARGET
from k8s_gpu_hpa_tpu_torch.trial import (
    MAX_REPLICAS,
    SERVE_POD,
    SERVE_SERIES,
    MirrorDeployment,
    Pipeline,
    run_serve_trial,
    run_trial,
    serve_spec,
    wire_pipeline,
)
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_slice import ScriptedLoad
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

DEPLOY = Path(__file__).resolve().parent.parent / "deploy"
SERVE_HPA = yaml.safe_load((DEPLOY / "tpu-serve-hpa.yaml").read_text())
#: real time, as the headline slice test runs it: pod start 2.4 s, HPA sync 3 s
REAL_TIME_SCALE = 0.2

_ENV_OF = {
    "batch": "DECODE_BATCH", "max_seq": "MAX_SEQ", "d_model": "D_MODEL",
    "n_heads": "N_HEADS", "n_layers": "N_LAYERS", "prefill_len": "PREFILL_LEN",
}


def test_serve_sizes_equal_the_deployment_manifest():
    doc = yaml.safe_load((DEPLOY / "tpu-serve-deployment.yaml").read_text())
    (container,) = doc["spec"]["template"]["spec"]["containers"]
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert env["WORKLOAD"] == "decode"
    assert {key: int(env[name]) for key, name in _ENV_OF.items()} == SERVE_SIZES


def test_serve_loop_equals_the_hpa_manifest_and_the_jax_target():
    spec = serve_spec()
    (metric,) = jax_hpa.metrics_from_manifest(SERVE_HPA)
    assert (spec.metric, spec.target) == (metric.metric_name, metric.target_value)
    assert spec.target == SERVE_BW_TARGET == jax_rules.SERVE_BW_TARGET
    assert metric.described_object.name == spec.app == "tpu-serve"
    assert (SERVE_HPA["spec"]["minReplicas"], SERVE_HPA["spec"]["maxReplicas"]) == (1, MAX_REPLICAS)
    assert dataclasses.asdict(shipped_behavior()) == dataclasses.asdict(
        jax_hpa.behavior_from_manifest(SERVE_HPA)
    )
    (rule,) = spec.rules
    want = jax_rules.tpu_test_avg_rule(
        app="tpu-serve", deployment="tpu-serve", metric=jax_schema.TPU_HBM_BW_UTIL,
        record="tpu_serve_hbm_bw_avg",
    )
    assert (rule.record, rule.labels) == (want.record, want.labels)


@pytest.mark.parametrize("ceiling", [0.0, 0.5, 1.0, 1.05, 1.1, 1.1000001, 1.2, 3.0, 13.6])
def test_signal_ceiling_clears_band_agrees_with_jax(ceiling):
    assert signal_ceiling_clears_band(ceiling, 1.0) == jax_hpa.signal_ceiling_clears_band(
        ceiling, 1.0
    )
    assert signal_ceiling_clears_band(5.5, SERVE_BW_TARGET) is False  # the band edge holds
    assert signal_ceiling_clears_band(1.1, 1.0) is False


class _ScriptedServe(ScriptedLoad):
    """A serve pod on a virtual clock: its bandwidth signal saturates at 30%
    of peak and follows the commanded intensity over a 3 s window."""

    def utilization(self, _chip_index: int = 0) -> float:
        return 0.3 * super().utilization()


def _real(mod_schema, mod_exposition, load):
    def fetch():
        chip = mod_schema.ChipSample(0, None, load.utilization() / 0.3, 2e9, 85e9, load.utilization())
        return mod_exposition.encode_text(
            mod_schema.families_from_chips([chip], "real-0", {0: ("default", SERVE_POD)})
        )

    return fetch


def _jax_serve_pipeline(fetch_real, mirror_bw, clock):
    """The JAX package's layers wired as bench.py's serve rung wires them,
    under the shipped serve HPA."""
    deployment = MirrorDeployment(clock, 12.0, SERVE_POD, "tpu-serve")
    db = jax_tsdb.TimeSeriesDB(clock)
    scraper = jax_tsdb.Scraper(db)
    scraper.add_target(fetch_real, name="exporter/real", node="real-0")

    def sim():
        chips, attribution = [], {}
        for i, pod in enumerate(p for p in deployment.running() if p != SERVE_POD):
            chips.append(jax_schema.ChipSample(i, None, None, 8e9, 16e9, mirror_bw()))
            attribution[i] = ("default", pod)
        return jax_exposition.encode_text(jax_schema.families_from_chips(chips, "sim-0", attribution))

    def ksm():
        fam = jax_schema.MetricFamily("kube_pod_labels", "gauge")
        for pod in deployment.pods:
            fam.add(1.0, namespace="default", pod=pod, label_app="tpu-serve")
        return jax_exposition.encode_text([fam])

    scraper.add_target(sim, name="exporter/sim", node="sim-0")
    scraper.add_target(ksm, name="ksm")
    evaluator = jax_rules.RuleEvaluator(db, [jax_rules.tpu_test_avg_rule(
        app="tpu-serve", deployment="tpu-serve", metric=jax_schema.TPU_HBM_BW_UTIL,
        record=SERVE_SERIES,
    )])
    hpa = jax_hpa.HPAController(
        target=deployment,
        metrics=jax_hpa.metrics_from_manifest(SERVE_HPA),
        adapter=jax_adapter.CustomMetricsAdapter(db, [jax_adapter.AdapterRule(series=SERVE_SERIES)]),
        clock=clock,
        min_replicas=SERVE_HPA["spec"]["minReplicas"],
        max_replicas=SERVE_HPA["spec"]["maxReplicas"],
        behavior=jax_hpa.behavior_from_manifest(SERVE_HPA),
    )
    return Pipeline(deployment, db, scraper, evaluator, hpa, SERVE_SERIES, serve_spec())


def test_same_serve_trace_through_both_packages_gives_identical_timelines():
    port_clock = VirtualClock()
    port_load = _ScriptedServe(port_clock)
    pipe = wire_pipeline(
        _real(schema, exposition, port_load), port_load.utilization, port_clock,
        spec=serve_spec(),
    )
    port = run_trial(port_load, pipe, port_clock)

    jax_clock = JaxVirtualClock()
    jax_load = _ScriptedServe(jax_clock)
    ref = run_trial(
        jax_load,
        _jax_serve_pipeline(_real(jax_schema, jax_exposition, jax_load), jax_load.utilization, jax_clock),
        jax_clock,
    )
    assert port.series == ref.series
    assert port.replicas == ref.replicas
    assert port.replicas[-1][1:] == (MAX_REPLICAS, MAX_REPLICAS)
    assert port.scale_up_s <= 60.0
    # pre-spike demand (0.1 of one pod) sits under the target, and the
    # crossing comes after the spike
    assert all(v < SERVE_BW_TARGET for t, v in port.series if t < 0 and v is not None)
    assert port.spike_to_cross_s >= 0


def _serve_gen(window: float) -> DecodeLoadGen:
    """A small two-phase serve generator (prefill + decode) on the CPU, f32."""
    gen = DecodeLoadGen(
        batch=2, max_seq=128, d_model=64, n_heads=1, n_layers=2, prefill_len=64,
        tokens_per_burst=4, window=window, dtype=torch.float32, device="cpu",
    )
    gen.warmup()
    return gen


def test_serve_slice_on_cpu_scales_one_to_four():
    """The CPU has no bandwidth peak, so the generator reports no signal; the
    test calibrates one, as bench.py's serve rung does off the chip, here to
    20% at saturation, so that the pre-spike demand (a tenth of one pod)
    reads about 2%, under the target: the loop, not the headroom, is what
    this run checks."""
    gen = _serve_gen(window=0.5)
    gen.step()
    gen.peak_hbm_gbps = gen.stats().achieved_gbps / 0.2
    result = run_serve_trial(gen, time_scale=REAL_TIME_SCALE)
    assert result.replicas[-1][1:] == (MAX_REPLICAS, MAX_REPLICAS)
    assert result.scale_up_s <= 60.0 * REAL_TIME_SCALE
    assert result.headroom > 1.1 and result.saturated_pct > 5.5
    assert max(v for t, v in result.series if t >= 0 and v is not None) > SERVE_BW_TARGET


def test_inert_serve_pairing_raises_without_driving_the_loop():
    """A peak so large that the saturated signal stays under 5.5%: the
    pairing is inert and the trial says so instead of timing out."""
    gen = _serve_gen(window=0.3)
    gen.step()
    gen.peak_hbm_gbps = gen.stats().achieved_gbps * 1000.0
    with pytest.raises(RuntimeError, match="inert pairing"):
        run_serve_trial(gen, time_scale=REAL_TIME_SCALE)
    # and a generator with no signal at all (no peak) is inert too
    gen.peak_hbm_gbps = None
    with pytest.raises(RuntimeError, match="inert pairing"):
        run_serve_trial(gen, time_scale=REAL_TIME_SCALE)
