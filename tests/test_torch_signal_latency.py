"""Signal-propagation latency (``obs/latency.py``), the HPA's live
propagation histogram, and bench.py's ``signal_latency`` rung
(``trial.run_signal_latency_trial``), against the JAX package's.

- The rung's dict equals ``bench.run_rung_signal_latency()`` key for key
  (3 of 3 steps scaled, sync and scale p50 = p95 = 15.0 s within the 60 s
  budget, 2162 spans, 5 replicas), and no SLO alert fires in it.
- ``propagation_report``, with and without the self-metrics' histogram
  quantiles, equals JAX's on seeded staircases through both pipelines and
  on hand-built traces (a step that scales nothing, a scale credited to
  the later of two steps).
- ``TracedLoad`` emits JAX's ``workload_change`` spans.
- A traced and an untraced pipeline take the same decisions, and the live
  loops of ``trial.py`` stay untraced.

Tolerance: exact (virtual clocks; the same float operations).
"""

import numpy as np
import pytest
import torch

import bench
from k8s_gpu_hpa_tpu import obs as jax_obs
from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.control import loop as jax_loop
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch import obs, trial
from k8s_gpu_hpa_tpu_torch.control import cluster, loop
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = (cluster, loop, clock, obs)
JAX = (jax_cluster, jax_loop, jax_clock, jax_obs)


def test_the_rung_gives_bench_s_dict():
    got = trial.run_signal_latency_trial()
    assert got == bench.run_rung_signal_latency()
    assert {k: got[k] for k in ("changes_total", "changes_scaled", "sync_latency_p50_s",
                                "sync_latency_p95_s", "scale_latency_p50_s",
                                "scale_latency_p95_s", "within_budget", "trace_spans",
                                "final_replicas")} == {
        "changes_total": 3, "changes_scaled": 3, "sync_latency_p50_s": 15.0,
        "sync_latency_p95_s": 15.0, "scale_latency_p50_s": 15.0, "scale_latency_p95_s": 15.0,
        "within_budget": True, "trace_spans": 2162, "final_replicas": 5}


def test_the_rung_s_run_fires_no_slo_alert_and_fills_the_propagation_histogram():
    run = trial.signal_latency_run()
    assert run.fired == []
    assert trial.signal_latency_rung(run.pipe) == trial.run_signal_latency_trial()
    hist = run.pipe.selfmetrics.hist_propagation
    # each of the three steps' first scale event observed once, at 15 s
    assert hist.cumulative_buckets()[2] == (15.0, 3.0)
    assert hist.cumulative_buckets()[1] == (10.0, 0.0)
    report = obs.propagation_report(run.pipe.tracer.spans, selfmetrics=run.pipe.selfmetrics)
    assert report["hist_scale_latency_p50"] == pytest.approx(12.5)
    assert report["scale_latency_p95"] == 15.0


def _staircase(seed: int):
    rng = np.random.default_rng(seed)
    steps = sorted(rng.uniform(30.0, 400.0, 4).tolist())
    levels = rng.uniform(20.0, 330.0, 5).round(0).tolist()

    def load(t):
        level = levels[0]
        for at, value in zip(steps, levels[1:]):
            if t >= at:
                level = value
        return level

    return load


def traced(mods, load_fn, seconds: float, trace: bool = True):
    cluster_mod, loop_mod, clock_mod, obs_mod = mods
    vclock = clock_mod.VirtualClock()
    tracer = obs_mod.Tracer(vclock) if trace else None
    sim = cluster_mod.SimCluster(vclock, nodes=[("obs-node-0", 4), ("obs-node-1", 4)])
    fn = obs_mod.TracedLoad(load_fn, tracer) if trace else load_fn
    dep = cluster_mod.SimDeployment(sim, "tpu-test", "tpu-test", load_fn=fn, load_mode="shared")
    sim.add_deployment(dep, replicas=1)
    pipe = loop_mod.AutoscalingPipeline(sim, dep, target_value=40.0, max_replicas=8,
                                        tracer=tracer)
    pipe.run_for(seconds)
    return pipe


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_propagation_report_is_jax_s_on_seeded_staircases(seed):
    port = traced(PORT, _staircase(seed), 480.0)
    ref = traced(JAX, _staircase(seed), 480.0)
    assert obs.propagation_report(port.tracer.spans) == jax_obs.propagation_report(
        ref.tracer.spans)
    with_hist = obs.propagation_report(port.tracer.spans, selfmetrics=port.selfmetrics)
    assert with_hist == jax_obs.propagation_report(ref.tracer.spans, selfmetrics=ref.selfmetrics)
    assert set(with_hist) >= {"hist_scale_latency_p50", "hist_scale_latency_p95",
                              "hist_scale_latency_p99"}
    assert port.selfmetrics.hist_propagation.cumulative_buckets() == (
        ref.selfmetrics.hist_propagation.cumulative_buckets())
    # the same run again gives the same report: virtual time is deterministic
    again = traced(PORT, _staircase(seed), 480.0)
    assert obs.propagation_report(again.tracer.spans) == obs.propagation_report(
        port.tracer.spans)


def test_a_traced_pipeline_decides_as_an_untraced_one():
    load = _staircase(5)
    traced_pipe = traced(PORT, load, 400.0)
    plain = traced(PORT, load, 400.0, trace=False)
    assert traced_pipe.scale_history == plain.scale_history
    assert plain.tracer is None and plain.selfmetrics is None
    assert plain.cluster.tracer is None and plain.hpa.tracer is None
    assert [t.name for t in plain.scraper.targets] == ["exporter/obs-node-0",
                                                       "exporter/obs-node-1",
                                                       "kube-state-metrics"]
    assert [t.name for t in traced_pipe.scraper.targets][-1] == "pipeline-self"
    assert plain.evaluator.alerts == [] and len(plain.evaluator.rules) == 1
    assert len(traced_pipe.evaluator.rules) == 3 and len(traced_pipe.evaluator.alerts) == 4


def test_the_live_loops_stay_untraced():
    pipe = trial.wire_pipeline(lambda: "", lambda: 0.0, clock.VirtualClock())
    assert pipe.scraper.tracer is None and pipe.scraper.selfmetrics is None
    assert pipe.evaluator.tracer is None and pipe.evaluator.alerts == []
    assert pipe.hpa.tracer is None and pipe.hpa.selfmetrics is None
    assert pipe.hpa.adapter.tracer is None


def _hand_built(mods):
    """Three steps: the first scales once (at 30 s), the second scales
    nothing before the third, and the third scales at 95 s."""
    vclock = mods[2].VirtualClock()
    tracer = mods[3].Tracer(vclock)

    def at(t, kind, attrs):
        vclock.advance(t - vclock.now())
        tracer.emit(kind, attrs)

    at(10.0, "workload_change", {"intensity": 90.0, "previous": 20.0})
    at(15.0, "hpa_sync", {"reason": "r", "current_replicas": 1, "desired_replicas": 1})
    at(30.0, "hpa_sync", {"reason": "r", "current_replicas": 1, "desired_replicas": 3})
    at(30.0, "scale_event", {"from_replicas": 1, "to_replicas": 3})
    at(50.0, "workload_change", {"intensity": 95.0, "previous": 90.0})
    at(60.0, "hpa_sync", {"reason": "r", "current_replicas": 3, "desired_replicas": 3})
    at(70.0, "workload_change", {"intensity": 200.0, "previous": 95.0})
    at(75.0, "hpa_sync", {"reason": "r", "current_replicas": 3, "desired_replicas": 3})
    at(95.0, "hpa_sync", {"reason": "r", "current_replicas": 3, "desired_replicas": 5})
    at(95.0, "scale_event", {"from_replicas": 3, "to_replicas": 5})
    return tracer.spans


def test_the_propagation_report_pairs_steps_as_jax_s_does():
    report = obs.propagation_report(_hand_built(PORT))
    assert report == jax_obs.propagation_report(_hand_built(JAX))
    assert [(r["sync_latency"], r["scale_latency"]) for r in report["changes"]] == [
        (5.0, 20.0), (10.0, None), (5.0, 25.0)]
    assert (report["changes_total"], report["changes_scaled"]) == (3, 2)
    assert (report["sync_latency_p50"], report["scale_latency_p95"]) == (5.0, 25.0)
    assert obs.propagation_report([]) == jax_obs.propagation_report([])


def _ramp(mods):
    vclock = mods[2].VirtualClock()
    tracer = mods[3].Tracer(vclock)
    load = mods[3].TracedLoad(lambda t: t * 1.3, tracer, min_delta=5.0)
    for _ in range(30):
        load(vclock.now())
        vclock.advance(1.0)
    return [s.as_dict() for s in tracer.spans]


def test_traced_load_emits_jax_s_changes():
    spans = _ramp(PORT)
    assert spans == _ramp(JAX)
    # the first call is the baseline; the baseline moves only on a change,
    # so a slow ramp emits every fourth second
    assert [s["start"] for s in spans] == [4.0, 8.0, 12.0, 16.0, 20.0, 24.0, 28.0]
    assert spans[0]["attrs"] == {"intensity": 4.0 * 1.3, "previous": 0.0}
