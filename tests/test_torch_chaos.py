"""The chaos plane (``chaos/``), the scrape deadlines it reads
(``metrics/tsdb.py``) and the ``chaos`` and ``slo`` scenarios
(``simulate.py``) against the JAX package's.

- The registry: JAX's eighteen kinds, in JAX's order; the region and
  object-store kinds refuse a pipeline outside a region
  (tests/test_torch_evacuate.py runs them on one); ``FaultSpec``'s names
  and refusals.
- Each of the fifteen kinds, injected with its natural spec into equal
  pipelines (two nodes of 4 devices, 90% shared load, target 40; a WAL
  and an in-memory checkpoint store for the four restart kinds; the JAX
  test's small capacity economy, an autoscaler among it, for
  ``tenant_spike`` and ``provision_fail``), held,
  cleared twice and followed for 90 s: the same ``scale_history``, HPA
  conditions, replicas, ``up`` series and restart log at every second as
  JAX's, and the JAX test's hygiene (the loop healthy again, no wrapped
  fetch left, every consumer on the recovered TSDB);
  ``frozen_samples`` and ``slow_scrape`` on the text scrape path too.  A
  TSDB restart from the WAL keeps its points and a cold one loses them, an
  adapter restart inside a blackout outlives the blackout's clear, and
  ``wal_truncate`` without a WAL is refused, each as JAX's.
- Overlapping windows, after tests/test_fault_injectors.py: two scrape
  faults on one target, two same-kind node, crash-loop and adapter
  windows, a preempt inside a drain, and an adapter put in during a
  blackout, each closing first-in-first-out and last-in-first-out: the
  fault stays in force until its last window closes, as in JAX.
- The scrape deadline: timed and structured expositions within and past
  the deadline, the text path, ``up``, the backoff, the spans with their
  errors and the modeled durations in the self-metrics equal to JAX's at
  every scrape; ``remove_target``.
- ``pipeline_healthy`` and ``RecoveryReport`` as JAX's.
- The canned storm, its seeds 0-4 (and the schedules of seeds 0-9) and the
  SLO check: JAX's result dicts; the storm's whole trace span for span; the
  reports' text.
- ``trial.chaos_storm_rung()`` and ``trial.slo_burn_rung()``: bench.py's
  ``run_rung_chaos()`` and ``run_rung_slo_burn()`` dicts.
- The CLI: ``simulate --scenario chaos`` and ``--scenario slo`` exit 0
  and print what JAX's print; a broken contract exits 2 as JAX's does.

Tolerance: exact (virtual time throughout).
"""

import functools
import json

import numpy as np
import pytest
import torch

import bench
import k8s_gpu_hpa_tpu.__main__ as jax_cli
from k8s_gpu_hpa_tpu import chaos as jax_chaos
from k8s_gpu_hpa_tpu import obs as jax_obs
from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.chaos import faults as jax_faults
from k8s_gpu_hpa_tpu.chaos import schedule as jax_schedule
from k8s_gpu_hpa_tpu.chaos import storm as jax_storm
from k8s_gpu_hpa_tpu.control import capacity as jax_capacity
from k8s_gpu_hpa_tpu.control import checkpoint as jax_checkpoint
from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.control import loop as jax_loop
from k8s_gpu_hpa_tpu.metrics import exposition as jax_exposition
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.metrics import wal as jax_wal
from k8s_gpu_hpa_tpu.obs import selfmetrics as jax_selfmetrics
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
import k8s_gpu_hpa_tpu_torch.__main__ as cli
from k8s_gpu_hpa_tpu_torch import chaos, obs, simulate, trial
from k8s_gpu_hpa_tpu_torch.chaos import faults, schedule, storm
from k8s_gpu_hpa_tpu_torch.control import capacity, checkpoint, cluster, loop
from k8s_gpu_hpa_tpu_torch.metrics import exposition, tsdb, wal
from k8s_gpu_hpa_tpu_torch.obs import selfmetrics
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_trace import assert_traces_equal

torch.set_num_threads(1)

PORT = dict(chaos=chaos, faults=faults, schedule=schedule, storm=storm, cluster=cluster,
            loop=loop, clock=clock, tsdb=tsdb, obs=obs, exposition=exposition,
            selfmetrics=selfmetrics, simulate=simulate, wal=wal, checkpoint=checkpoint,
            capacity=capacity)
JAX = dict(chaos=jax_chaos, faults=jax_faults, schedule=jax_schedule, storm=jax_storm,
           cluster=jax_cluster, loop=jax_loop, clock=jax_clock, tsdb=jax_tsdb, obs=jax_obs,
           exposition=jax_exposition, selfmetrics=jax_selfmetrics, simulate=jax_simulate,
           wal=jax_wal, checkpoint=jax_checkpoint, capacity=jax_capacity)

#: the JAX kinds of the region slice, which act on a GlobalControlPlane
#: (tests/test_torch_evacuate.py) and so are not injected here
LATER_KINDS = {"region_kill", "region_partition", "objstore_outage"}
#: the kinds that break the capacity economy, run on a pipeline with one
CAPACITY_KINDS = {"tenant_spike", "provision_fail"}
#: the impulse restarts, which run on a pipeline with a WAL and a checkpoint store
RESTART_KINDS = {"tsdb_restart", "hpa_restart", "adapter_restart", "wal_truncate"}
#: tests/test_fault_injectors.py's natural spec of each ported kind
NATURAL_SPECS = {
    "exporter_outage": dict(duration=10.0),
    "frozen_samples": dict(duration=10.0),
    "slow_scrape": dict(duration=10.0),
    "scrape_blackout": dict(duration=10.0),
    "node_preempt": dict(duration=20.0),
    "node_drain": dict(duration=20.0),
    "pod_crash": dict(),
    "crashloop": dict(duration=10.0),
    "adapter_blackout": dict(duration=10.0),
    "tsdb_restart": dict(),
    "hpa_restart": dict(),
    "adapter_restart": dict(),
    "wal_truncate": dict(params={"records": 8}),
    "tenant_spike": dict(duration=10.0, params={"add": 60.0}),
    "provision_fail": dict(duration=10.0),
}


def test_the_registry_holds_the_ported_kinds_only():
    assert set(faults.FAULT_KINDS) == set(NATURAL_SPECS) | LATER_KINDS
    assert set(faults.FAULT_KINDS) == set(jax_faults.FAULT_KINDS)
    assert list(faults.FAULT_KINDS) == list(jax_faults.FAULT_KINDS)


@pytest.mark.parametrize("kwargs", [
    dict(kind="crashloop", at=660.0, duration=60.0, target="tpu-test"),
    dict(kind="scrape_blackout", at=180.5),
    dict(kind="pod_crash", at=0.0, name="mine"),
])
def test_a_fault_spec_names_itself_as_jax_s(kwargs):
    assert faults.FaultSpec(**kwargs).name == jax_faults.FaultSpec(**kwargs).name


@pytest.mark.parametrize("kwargs", [dict(at=-1.0), dict(at=1.0, duration=-2.0)])
def test_a_fault_spec_refuses_a_negative_time_as_jax_s(kwargs):
    with pytest.raises(ValueError) as got:
        faults.FaultSpec("pod_crash", **kwargs)
    with pytest.raises(ValueError) as want:
        jax_faults.FaultSpec("pod_crash", **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", sorted(LATER_KINDS) + ["no_such_kind"])
def test_a_kind_of_a_later_slice_is_refused(kind):
    """An unknown kind is refused by ``FaultSpec``; a region kind is a
    known kind, refused by its injector on a pipeline outside a region, in
    JAX's words."""
    if kind not in LATER_KINDS:
        with pytest.raises(ValueError, match=f"unknown fault kind '{kind}'"):
            faults.FaultSpec(kind, at=0.0)
        return
    pipes = [make_pipeline(mods)[1] for mods in (PORT, JAX)]
    with pytest.raises(ValueError) as got:
        faults.FAULT_KINDS[kind](pipes[0], faults.FaultSpec(kind, 0.0, 10.0))
    with pytest.raises(ValueError) as want:
        jax_faults.FAULT_KINDS[kind](pipes[1], jax_faults.FaultSpec(kind, 0.0, 10.0))
    assert str(got.value) == str(want.value)
    assert "pipeline is not part of a region" in str(got.value)


# ---- each kind on equal pipelines ------------------------------------------------


def make_pipeline(mods, structured_scrapes: bool = True, tracer=False, durable=None,
                  capacity=False):
    """tests/test_fault_injectors.py's pipeline without its region: two
    nodes of 4 devices, 90% shared load, target 40, settled for 60 s; with
    ``durable`` (a directory) its WAL there and an in-memory checkpoint
    store, as the JAX test's, else neither; with ``capacity`` the JAX test's
    capacity economy (the one tenant, an autoscaler of one 4-device node
    that provisions in 20 s and times out in 15 s), else none."""
    vclock = mods["clock"].VirtualClock()
    sim = mods["cluster"].SimCluster(
        vclock, nodes=[("tpu-node-0", 4), ("tpu-node-1", 4)], pod_start_latency=12.0)
    dep = mods["cluster"].SimDeployment(sim, "tpu-test", "tpu-test", load_fn=lambda t: 90.0,
                                        load_mode="shared")
    sim.add_deployment(dep, replicas=1)
    vclock.advance(15.0)
    kw = {"tracer": mods["obs"].Tracer(vclock)} if tracer else {}
    if durable is not None:
        kw.update(wal=mods["wal"].WriteAheadLog(durable / "wal", segment_max_records=256),
                  checkpoint_store=mods["checkpoint"].InMemoryCheckpointStore())
    if capacity:
        cap = mods["capacity"]
        kw["capacity"] = cap.CapacityConfig(
            tenants=[cap.TenantSpec("tpu-test")], autoscaler_node_chips=4,
            autoscaler_max_nodes=1, provision_delay_s=20.0, provision_timeout_s=15.0)
    pipe = mods["loop"].AutoscalingPipeline(sim, dep, target_value=40.0, max_replicas=4,
                                            structured_scrapes=structured_scrapes, **kw)
    pipe.start()
    vclock.advance(60.0)
    return vclock, pipe


def _observe(pipe) -> tuple:
    ups = sorted((dict(s.labels)["target"], s.value) for s in pipe.db.instant_vector("up"))
    return pipe.clock.now(), ups, pipe.replicas(), pipe.running(), pipe.hpa.status.last_reason


def _kind_run(mods, kind: str, structured_scrapes: bool = True, durable=None) -> dict:
    vclock, pipe = make_pipeline(mods, structured_scrapes, durable=durable,
                                 capacity=kind in CAPACITY_KINDS)
    spec = mods["faults"].FaultSpec(kind=kind, at=0.0, **NATURAL_SPECS[kind])
    clear = mods["faults"].FAULT_KINDS[kind](pipe, spec)
    seconds = []
    for _ in range(int(max(spec.duration, 5.0))):
        vclock.advance(1.0)
        seconds.append(_observe(pipe))
    clear()
    clear()  # idempotent
    for _ in range(90):
        vclock.advance(1.0)
        seconds.append(_observe(pipe))
    return {
        "seconds": seconds,
        "scale_history": pipe.scale_history,
        "conditions": pipe.hpa.condition_history,
        "healthy": mods["schedule"].pipeline_healthy(pipe),
        "up_node_1": pipe.db.latest("up", {"target": "exporter/tpu-node-1"}),
        "depths": [getattr(t, "_fault_depth", 0) for t in pipe.scraper.targets],
        "running": (pipe.running(), pipe.replicas()),
        "restarts": pipe.restart_log,
        "rewired": [c.db is pipe.db for c in (pipe.scraper, pipe.evaluator, pipe.adapter)],
        "hpa_adapter": pipe.hpa.adapter is pipe.adapter,
        "restored": pipe.hpa.restored_from_checkpoint,
    }


@pytest.mark.parametrize("kind", sorted(NATURAL_SPECS))
def test_each_kind_breaks_and_heals_the_pipeline_as_jax_s(kind, tmp_path):
    durable = {}
    if kind in RESTART_KINDS:
        durable = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    port = _kind_run(PORT, kind, durable=durable.get("port"))
    assert port == _kind_run(JAX, kind, durable=durable.get("jax"))
    # tests/test_fault_injectors.py's hygiene
    running, replicas = port["running"]
    assert running == replicas >= 1
    assert port["up_node_1"] == 1.0
    assert port["depths"] == [0] * len(port["depths"])
    assert port["healthy"]
    assert port["rewired"] == [True] * 3 and port["hpa_adapter"]
    assert bool(port["restarts"]) == (kind in RESTART_KINDS)
    if kind in RESTART_KINDS:
        assert port["restarts"][-1]["component"] == kind.split("_")[0].replace("wal", "tsdb")
    if kind in ("tsdb_restart", "wal_truncate"):
        assert port["restarts"][-1]["snapshot_restored"] is False
        assert port["restarts"][-1]["replayed_records"] > 0
    assert port["restored"] == (kind == "hpa_restart")


def _tsdb_restarts(mods, directory) -> list:
    """tests/test_fault_injectors.py's TSDB restart from the WAL, then cold."""
    _, pipe = make_pipeline(mods, durable=directory)
    before = pipe.db.total_points()
    warm = pipe.restart_tsdb()
    after = pipe.db.total_points()
    cold = pipe.restart_tsdb(from_wal=False)
    return [before, warm, after, cold, pipe.db.total_points()]


def test_a_tsdb_restart_from_the_wal_keeps_its_points_and_a_cold_one_loses_them(tmp_path):
    port = _tsdb_restarts(PORT, tmp_path / "port")
    assert port == _tsdb_restarts(JAX, tmp_path / "jax")
    before, warm, after, cold, last = port
    assert before > 0 and after == before and warm["replayed_records"] > 0
    assert cold == {"component": "tsdb", "at": cold["at"], "snapshot_restored": False,
                    "recovered_points": 0}
    assert last == 0


def _restart_in_blackout(mods, directory) -> tuple:
    _, pipe = make_pipeline(mods, durable=directory)
    f = mods["faults"]
    clear = f.FAULT_KINDS["adapter_blackout"](pipe, f.FaultSpec("adapter_blackout", 0.0, 30.0))
    f.FAULT_KINDS["adapter_restart"](pipe, f.FaultSpec("adapter_restart", 0.0))
    restarted = pipe.hpa.adapter
    clear()
    return pipe.hpa.adapter is restarted, pipe.hpa.adapter is pipe.adapter


def test_an_adapter_restart_in_a_blackout_outlives_its_clear_as_jax_s(tmp_path):
    assert _restart_in_blackout(PORT, tmp_path / "port") == (True, True)
    assert _restart_in_blackout(JAX, tmp_path / "jax") == (True, True)


def test_wal_truncate_without_a_wal_is_refused_as_jax_s():
    errors = []
    for mods in (PORT, JAX):
        _, pipe = make_pipeline(mods)
        with pytest.raises(ValueError) as err:
            mods["faults"].FAULT_KINDS["wal_truncate"](
                pipe, mods["faults"].FaultSpec("wal_truncate", 0.0))
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "wal_truncate: pipeline has no WAL attached"


def _broke(run: dict, kind: str) -> bool:
    """Whether the fault showed while it was in force: an ``up`` of 0 or a
    declared replica not running."""
    during = run["seconds"][:int(max(NATURAL_SPECS[kind].get("duration", 0.0), 5.0))]
    if kind in ("exporter_outage", "slow_scrape", "scrape_blackout", "node_preempt"):
        return any(value == 0.0 for _, ups, *_ in during for _, value in ups)
    return any(running < replicas for _, _, replicas, running, _ in during)


@pytest.mark.parametrize("kind", ["exporter_outage", "slow_scrape", "scrape_blackout",
                                  "node_preempt", "pod_crash", "crashloop", "node_drain"])
def test_each_kind_shows_while_in_force(kind):
    assert _broke(_kind_run(PORT, kind), kind)


def _adapter_blackout(mods) -> tuple:
    """A 30 s blackout, so that two syncs fall inside it (the natural 10 s
    one falls between two syncs)."""
    vclock, pipe = make_pipeline(mods)
    f = mods["faults"]
    clear = f.FAULT_KINDS["adapter_blackout"](pipe, f.FaultSpec("adapter_blackout", 0.0, 30.0))
    vclock.advance(30.0)
    clear()
    vclock.advance(30.0)
    return pipe.hpa.condition_history, pipe.scale_history, pipe.hpa.adapter is pipe.adapter


def test_an_adapter_blackout_holds_the_hpa_as_jax_s():
    port = _adapter_blackout(PORT)
    assert port == _adapter_blackout(JAX)
    conditions, _, restored = port
    assert ("ScalingActive", False, "FailedGetObjectMetric") in [c[1:] for c in conditions]
    assert restored


@pytest.mark.parametrize("kind", ["frozen_samples", "slow_scrape"])
def test_the_scrape_kinds_break_the_text_path_as_jax_s(kind):
    port = _kind_run(PORT, kind, structured_scrapes=False)
    assert port == _kind_run(JAX, kind, structured_scrapes=False)
    assert port["healthy"]


def _frozen_values(mods, structured: bool) -> list:
    """The node exporter's duty series while frozen_samples holds it, the
    load changing underneath."""
    vclock, pipe = make_pipeline(mods, structured)
    state = {"load": 90.0}
    pipe.deployment.load_fn = lambda t: state["load"]
    clear = mods["faults"].FAULT_KINDS["frozen_samples"](
        pipe, mods["faults"].FaultSpec("frozen_samples", 0.0, 30.0, target="exporter/tpu-node-0"))
    out = []
    for second in range(30):
        state["load"] = 90.0 + second
        vclock.advance(1.0)
        out.append(sorted(s.value for s in pipe.db.instant_vector("tpu_duty_cycle")))
    clear()
    vclock.advance(5.0)
    out.append(sorted(s.value for s in pipe.db.instant_vector("tpu_duty_cycle")))
    return out


@pytest.mark.parametrize("structured", [True, False])
def test_frozen_samples_freeze_families_and_text_as_jax_s(structured):
    port = _frozen_values(PORT, structured)
    assert port == _frozen_values(JAX, structured)
    assert port[0] == port[-2] != port[-1]


# ---- overlapping windows ---------------------------------------------------------


def _scrape_overlap(mods, close_order: str) -> list:
    _, pipe = make_pipeline(mods)
    f = mods["faults"]
    target = next(t for t in pipe.scraper.targets if t.name == "exporter/tpu-node-0")
    pristine = target.fetch
    clear_outage = f.FAULT_KINDS["exporter_outage"](
        pipe, f.FaultSpec("exporter_outage", 0.0, 10.0, target="exporter/tpu-node-0"))
    clear_slow = f.FAULT_KINDS["slow_scrape"](
        pipe, f.FaultSpec("slow_scrape", 0.0, 20.0, target="exporter/tpu-node-0"))
    first, second = ((clear_outage, clear_slow) if close_order == "fifo"
                     else (clear_slow, clear_outage))
    first()
    states = [target.fetch is pristine, target._fault_depth]
    second()
    return states + [target.fetch is pristine, target._fault_depth]


@pytest.mark.parametrize("close_order", ["fifo", "lifo"])
def test_overlapping_scrape_faults_restore_the_pristine_fetch_as_jax_s(close_order):
    port = _scrape_overlap(PORT, close_order)
    assert port == _scrape_overlap(JAX, close_order) == [False, 1, True, 0]


SAME_KIND = {
    "node_preempt": dict(duration=20.0, target="tpu-node-0"),
    "node_drain": dict(duration=20.0, target="tpu-node-0"),
    "crashloop": dict(duration=10.0),
    "adapter_blackout": dict(duration=10.0),
}


def _in_force(pipe, kind: str) -> bool:
    if kind in ("node_preempt", "node_drain"):
        return not pipe.cluster.nodes["tpu-node-0"].schedulable
    if kind == "crashloop":
        return "tpu-test" in pipe.cluster.crashlooping
    return type(pipe.hpa.adapter).__name__ == "_BlackoutAdapter"


def _same_kind_overlap(mods, kind: str, close_order: str) -> list:
    vclock, pipe = make_pipeline(mods)
    f = mods["faults"]
    clear_a = f.FAULT_KINDS[kind](pipe, f.FaultSpec(kind, 0.0, **SAME_KIND[kind]))
    vclock.advance(5.0)
    clear_b = f.FAULT_KINDS[kind](pipe, f.FaultSpec(kind, 0.0, **SAME_KIND[kind]))
    states = [_in_force(pipe, kind)]
    first, second = (clear_a, clear_b) if close_order == "fifo" else (clear_b, clear_a)
    first()
    first()  # idempotent: must not burn the other window's reference
    states.append(_in_force(pipe, kind))
    second()
    second()
    states.append(_in_force(pipe, kind))
    vclock.advance(120.0)
    return states + [pipe.running(), pipe.scale_history]


@pytest.mark.parametrize("close_order", ["fifo", "lifo"])
@pytest.mark.parametrize("kind", sorted(SAME_KIND))
def test_same_kind_windows_hold_until_the_last_closes_as_jax_s(kind, close_order):
    port = _same_kind_overlap(PORT, kind, close_order)
    assert port == _same_kind_overlap(JAX, kind, close_order)
    assert port[:3] == [True, True, False] and port[3] >= 1


def _preempt_inside_drain(mods) -> list:
    _, pipe = make_pipeline(mods)
    f = mods["faults"]
    clear_preempt = f.FAULT_KINDS["node_preempt"](
        pipe, f.FaultSpec("node_preempt", 0.0, 20.0, target="tpu-node-0"))
    clear_drain = f.FAULT_KINDS["node_drain"](
        pipe, f.FaultSpec("node_drain", 0.0, 40.0, target="tpu-node-0"))
    node = pipe.cluster.nodes["tpu-node-0"]
    clear_preempt()
    states = [node.schedulable, node.ready]
    clear_drain()
    return states + [node.schedulable, node.ready, node._fault_depth]


def test_a_preempt_inside_a_drain_restores_the_node_once_as_jax_s():
    port = _preempt_inside_drain(PORT)
    assert port == _preempt_inside_drain(JAX) == [False, False, True, True, 0]


def _adapter_put_in_during_blackout(mods) -> list:
    _, pipe = make_pipeline(mods)
    f = mods["faults"]
    clear = f.FAULT_KINDS["adapter_blackout"](pipe, f.FaultSpec("adapter_blackout", 0.0, 30.0))
    replacement = object()
    pipe.hpa.adapter = replacement  # another adapter takes over mid-blackout
    clear()
    return [pipe.hpa.adapter is replacement, pipe._adapter_blackout_depth]


def test_a_blackout_s_clear_keeps_an_adapter_put_in_meanwhile_as_jax_s():
    assert _adapter_put_in_during_blackout(PORT) == _adapter_put_in_during_blackout(JAX) == [
        True, 0]


# ---- the scrape deadline ------------------------------------------------------------


def _deadline_run(mods) -> list:
    """Three targets: timed text, timed families and plain text, with
    seeded durations around the 10 s deadline; 40 scrapes a second apart."""
    rng = np.random.default_rng(7)
    durations = rng.choice([0.5, 9.9, 10.0, 10.1, 25.0], size=(40, 2)).tolist()
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    tracer = mods["obs"].Tracer(vclock)
    self_metrics = mods["selfmetrics"].PipelineSelfMetrics(clock=vclock)
    scraper = mods["tsdb"].Scraper(db, tracer=tracer, selfmetrics=self_metrics)
    T = mods["tsdb"]
    step = {"i": 0}

    def text(value):
        return f"# TYPE g gauge\ng{{k=\"v\"}} {value}\n"

    scraper.add_target(lambda: T.TimedExposition(text(step["i"]), durations[step["i"]][0]),
                       name="timed", node="n0")
    scraper.add_target(
        lambda: T.StructuredExposition(mods["exposition"].parse_text(text(2 * step["i"])),
                                       durations[step["i"]][1]),
        name="structured")
    scraper.add_target(lambda: text(3 * step["i"]), name="plain")
    out = []
    for i in range(40):
        step["i"] = i
        count = scraper.scrape_once()
        out.append((count, sorted((s.labels, s.value) for s in db.instant_vector("up")),
                    sorted((s.labels, s.value) for s in db.instant_vector("g")),
                    [(t.healthy, t.consecutive_failures, t.next_attempt_at)
                     for t in scraper.targets]))
        vclock.advance(1.0)
    return out, tracer.spans, self_metrics.exposition()


def test_the_scrape_deadline_fails_a_slow_fetch_as_jax_s():
    port, port_spans, port_text = _deadline_run(PORT)
    ref, ref_spans, ref_text = _deadline_run(JAX)
    assert port == ref
    assert_traces_equal(port_spans, ref_spans)
    errors = [s.attrs["error"] for s in port_spans if s.attrs.get("ok") is False]
    assert errors and all("> deadline 10.0s" in e for e in errors)
    # the modeled durations reach the self-metrics: the timed targets' lines
    # equal JAX's (the plain target's is the wall clock's)
    def timed(text):
        return sorted(line for line in text.splitlines()
                      if 'target="timed"' in line or 'target="structured"' in line)
    assert timed(port_text) == timed(ref_text) != []


def _remove(mods, index) -> list:
    """Twelve node targets scraped, one removed, then scraped on: the
    removed target's series is written no more (and not marked stale)."""
    vclock = mods["clock"].VirtualClock()
    scraper = mods["tsdb"].Scraper(mods["tsdb"].TimeSeriesDB(vclock))
    step = {"i": 0}
    for i in range(12):
        scraper.add_target(lambda i=i: f"g{{n=\"{i}\"}} {100 * step['i'] + i}\n",
                           name=f"exporter/n{i}", node=f"n{i}")
    out = []
    for i in range(4):
        step["i"] = i
        if i == 2:
            removed = scraper.targets[index]
            scraper.remove_target(removed)
            out.append(removed in scraper.targets)
        out.append(scraper.scrape_once())
        out.append(sorted((s.labels, s.value) for s in scraper.db.instant_vector("g")))
        vclock.advance(1.0)
    return out + [t.name for t in scraper.targets]


@pytest.mark.parametrize("index", [0, 5, 11])
def test_remove_target_is_jax_s(index):
    port = _remove(PORT, index)
    assert port == _remove(JAX, index)
    assert port[4] is False and f"exporter/n{index}" not in port[-11:]
    # the removed target's value stays at the last scrape before removal
    assert (((("n", str(index)), ("node", f"n{index}")), 100.0 + index)) in port[-12]


# ---- health and reports ------------------------------------------------------------


def _health(mods) -> list:
    vclock, pipe = make_pipeline(mods)
    f, s = mods["faults"], mods["schedule"]
    out = [s.pipeline_healthy(pipe)]
    for kind, kw in (("node_drain", dict(target="tpu-node-1")), ("crashloop", {}),
                     ("exporter_outage", {})):
        clear = f.FAULT_KINDS[kind](pipe, f.FaultSpec(kind, 0.0, 5.0, **kw))
        vclock.advance(2.0)
        out.append(s.pipeline_healthy(pipe))
        clear()
        vclock.advance(120.0)
        out.append(s.pipeline_healthy(pipe))
    return out


def test_pipeline_healthy_judges_as_jax_s():
    port = _health(PORT)
    assert port == _health(JAX)
    assert port[0] and not port[1]


def _report(mods):
    r = mods["schedule"].RecoveryReport(
        fault=mods["faults"].FaultSpec("node_preempt", 10.0, 30.0, target="n0"),
        injected_at=25.04, cleared_at=55.0, detected_at=26.0, recovered_at=70.26,
        expected_replicas=3, first_good_sync_at=60.0, trace_span_id=7)
    empty = mods["schedule"].RecoveryReport(fault=mods["faults"].FaultSpec("pod_crash", 0.0))
    return [r.as_dict(), empty.as_dict(), r.recovered, empty.recovered]


def test_a_recovery_report_is_jax_s():
    assert _report(PORT) == _report(JAX)


# ---- the storm and the SLO check -------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_a_seed_s_schedule_is_jax_s(seed):
    def specs(mods):
        return [(f.kind, f.at, f.duration, f.target, f.name)
                for f in mods["storm"].storm_faults_for_seed(seed)]
    assert specs(PORT) == specs(JAX)


def _storm(mods, seed=None) -> tuple[dict, list]:
    pipes = []
    result = mods["storm"].run_fault_storm(
        pod_start_latency=12.0, seed=seed, on_pipeline=lambda pipe, _s: pipes.append(pipe))
    return result, pipes[0].tracer.spans


def test_the_canned_storm_is_jax_s_span_for_span():
    port, port_spans = _storm(PORT)
    ref, ref_spans = _storm(JAX)
    assert port == ref
    assert_traces_equal(port_spans, ref_spans)
    assert (port["settled_replicas"], port["all_recovered"],
            port["spurious_scale_events_during_blackout"],
            port["blackout_condition_observed"]) == (3, True, 0, True)
    assert [f["mttr"] for f in port["faults"]] == [8.0, 15.0, 11.0, 37.0]
    assert [f["detection_time"] for f in port["faults"]] == [0.0] * 4
    assert port["trace_spans"] == 8979
    assert port["fault_window_spans"] == [1954, 2790, 4967, 6851]
    assert all(f["replay_gap"] is None for f in port["faults"])  # no restart in the storm
    assert storm.render_chaos_report(port) == jax_storm.render_chaos_report(ref)


@pytest.mark.parametrize("seed", range(5))
def test_a_seeded_storm_is_jax_s(seed):
    port, _ = _storm(PORT, seed)
    ref, _ = _storm(JAX, seed)
    assert port == ref
    assert len(port["faults"]) == 5


@pytest.mark.parametrize("kwargs", [{}, dict(duration=300.0, fault_at=60.0, fault_duration=60.0)])
def test_the_slo_check_is_jax_s(kwargs):
    port = simulate.run_slo_check(**kwargs)
    ref = jax_simulate.run_slo_check(**kwargs)
    assert port == ref
    assert simulate.render_slo_report(port) == jax_simulate.render_slo_report(ref)
    if not kwargs:
        assert port["clean_false_positives"] == []
        assert port["fault_first_fired"] == {"SLOScrapeSuccessFastBurn": 140.0,
                                             "SLOScrapeSuccessSlowBurn": 127.0}
        assert (port["fast_detection_s"], port["slow_detection_s"], port["ok"]) == (
            20.0, 7.0, True)


def test_the_staircase_is_jax_s():
    assert simulate.SLO_STAIRCASE == jax_simulate.SLO_STAIRCASE
    assert [simulate._slo_load(t) for t in range(0, 420, 7)] == [
        jax_simulate._slo_load(t) for t in range(0, 420, 7)]


@pytest.mark.parametrize("rung,bench_rung", [("chaos_storm_rung", "run_rung_chaos"),
                                              ("slo_burn_rung", "run_rung_slo_burn")])
def test_the_rungs_give_bench_s_dicts(rung, bench_rung):
    assert getattr(trial, rung)() == getattr(bench, bench_rung)()


# ---- the CLI ---------------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["chaos", "slo"])
def test_the_scenario_exits_0_and_prints_jax_s_report(scenario, capsys):
    assert cli.main(["simulate", "--scenario", scenario]) == 0
    port = capsys.readouterr().out
    assert jax_cli.main(["simulate", "--scenario", scenario]) == 0
    assert port == capsys.readouterr().out
    assert port.rstrip().splitlines()[-1] in ("final replicas/running:   3/3", "verdict: OK")


@functools.cache
def _canned(check: str) -> str:
    """The port's storm or SLO check, run once for the contract tests."""
    return json.dumps(chaos.run_fault_storm() if check == "chaos" else simulate.run_slo_check())


def _violated(result: dict, how: str) -> dict:
    if how == "unrecovered":
        result["faults"][2].update(recovered=False, recovered_at=None, mttr=None)
        result["all_recovered"] = False
    else:
        result["spurious_scale_events_during_blackout"] = 2
    return result


@pytest.mark.parametrize("how", ["unrecovered", "spurious"])
def test_a_broken_chaos_contract_exits_2_as_jax_s(how, monkeypatch, capsys):
    canned = _violated(json.loads(_canned("chaos")), how)
    monkeypatch.setattr(chaos, "run_fault_storm", lambda **kw: canned)
    monkeypatch.setattr(jax_chaos, "run_fault_storm", lambda **kw: canned)
    assert cli.main(["simulate", "--scenario", "chaos"]) == 2
    port = capsys.readouterr().out
    assert jax_cli.main(["simulate", "--scenario", "chaos"]) == 2
    assert port == capsys.readouterr().out
    assert "CHAOS CONTRACT VIOLATED" in port


@pytest.mark.parametrize("how", ["false_positive", "never_fired"])
def test_a_broken_slo_contract_exits_2_as_jax_s(how, monkeypatch, capsys):
    canned = json.loads(_canned("slo"))
    if how == "false_positive":
        canned["clean_false_positives"] = ["SLOScrapeSuccessSlowBurn"]
    else:
        canned.update(fault_first_fired={}, fast_detection_s=None, slow_detection_s=None)
    canned["ok"] = False
    monkeypatch.setattr(simulate, "run_slo_check", lambda **kw: canned)
    monkeypatch.setattr(jax_simulate, "run_slo_check", lambda **kw: canned)
    assert cli.main(["simulate", "--scenario", "slo"]) == 2
    port = capsys.readouterr().out
    assert jax_cli.main(["simulate", "--scenario", "slo"]) == 2
    assert port == capsys.readouterr().out
    assert port.rstrip().endswith("verdict: SLO CONTRACT VIOLATED")
