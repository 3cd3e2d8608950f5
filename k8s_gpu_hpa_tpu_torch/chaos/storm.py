"""The canned fault storm: one run, every layer broken once, MTTR per fault.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/storm.py``: the ``chaos`` scenario
(``python -m k8s_gpu_hpa_tpu_torch simulate --scenario chaos``) and
bench.py's ``chaos_storm`` rung (``trial.chaos_storm_rung``).  It needs no
manifest: a fixed cluster of 3 nodes of 2 devices under a steady shared
load, so its numbers compare run to run; under test is the pipeline's
recovery machinery, not a deployment.

The timeline (a steady 90% shared load at target 40 settles at 3 replicas):

=========  ==============================  =======================================
t (s)      fault                           what must happen
=========  ==============================  =======================================
30–90      exporter_outage (one node)      the signal degrades, never zeroes;
                                           up = 0 for that target; replicas hold
180–270    scrape_blackout (all targets)   the HPA holds (ScalingActive=False,
                                           FailedGetObjectMetric); no scale
                                           event while blind
420–540    node_preempt (chaos-node-0)     pods die with their devices; the
                                           rest reschedule; the exporter is
                                           unreachable; full convergence after
                                           the node comes back
660–720    crashloop (tpu-test)            replacement pods in CrashLoopBackOff
                                           with doubling restart delays; the
                                           loop converges once the image is fixed
=========  ==============================  =======================================
"""

from __future__ import annotations

import random

from k8s_gpu_hpa_tpu_torch.chaos.faults import FaultSpec
from k8s_gpu_hpa_tpu_torch.chaos.schedule import ChaosSchedule
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import HPABehavior
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch.obs import Tracer
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

STORM_FAULTS = [
    FaultSpec("exporter_outage", at=30.0, duration=60.0, target="exporter/chaos-node-1"),
    FaultSpec("scrape_blackout", at=180.0, duration=90.0),
    FaultSpec("node_preempt", at=420.0, duration=120.0, target="chaos-node-0"),
    FaultSpec("crashloop", at=660.0, duration=60.0, target="tpu-test"),
]

#: faults the canned storm never arms: a seeded storm draws its extra fault
#: from these, so that seeds explore different schedules
STORM_EXTRA_FAULT_POOL = ("frozen_samples", "slow_scrape", "pod_crash")


def storm_faults_for_seed(seed: int | None) -> list[FaultSpec]:
    """The storm's schedule.  ``seed=None`` is ``STORM_FAULTS`` as it
    stands; a seed jitters each fault's start by up to ±10 s and adds one
    fault of ``STORM_EXTRA_FAULT_POOL`` in the quiet window after the crash
    loop, the same for the same seed (and for the JAX package's)."""
    if seed is None:
        return list(STORM_FAULTS)
    rng = random.Random(seed)
    faults = [
        FaultSpec(
            f.kind,
            at=max(1.0, f.at + rng.uniform(-10.0, 10.0)),
            duration=f.duration,
            target=f.target,
        )
        for f in STORM_FAULTS
    ]
    extra = rng.choice(STORM_EXTRA_FAULT_POOL)
    # pod_crash with no target takes the first running pod of the
    # pipeline's deployment, whatever the pods are named by then
    target = {
        "frozen_samples": "exporter/chaos-node-2",
        "slow_scrape": "exporter/chaos-node-2",
        "pod_crash": None,
    }[extra]
    faults.append(FaultSpec(extra, at=rng.uniform(760.0, 820.0), duration=60.0, target=target))
    return faults


def run_fault_storm(
    pod_start_latency: float = 12.0,
    total: float = 1000.0,
    seed: int | None = None,
    on_pipeline=None,
) -> dict:
    """Run the storm; returns a JSON-able result.  ``seed`` picks a variant
    of the schedule (``storm_faults_for_seed``); None is the canned storm.
    ``on_pipeline(pipe, schedule)``, when given, is called once the
    pipeline has settled and before the schedule arms."""
    clock = VirtualClock()
    cluster = SimCluster(
        clock, nodes=[(f"chaos-node-{i}", 2) for i in range(3)], pod_start_latency=pod_start_latency
    )
    dep = SimDeployment(cluster, "tpu-test", "tpu-test", load_fn=lambda t: 90.0, load_mode="shared")
    cluster.add_deployment(dep, replicas=1)
    clock.advance(15.0)

    # the scale-down window at 60 s (Kubernetes's default is 300 s), so that
    # the convergence after each fault fits the storm and its MTTR shows
    behavior = HPABehavior()
    behavior.scale_down.stabilization_window_seconds = 60.0

    # traced: each resolved fault's report carries its fault_window span
    tracer = Tracer(clock)
    pipe = AutoscalingPipeline(
        cluster, dep, target_value=40.0, max_replicas=4, behavior=behavior, tracer=tracer
    )
    pipe.start()
    clock.advance(120.0)  # settle: 90% shared over target 40 -> 3 replicas
    settled = pipe.replicas()

    schedule = ChaosSchedule(pipe, storm_faults_for_seed(seed))
    if on_pipeline is not None:
        on_pipeline(pipe, schedule)
    schedule.arm()
    clock.advance(total)

    reports = schedule.reports
    blackout = next(r for r in reports if r.fault.kind == "scrape_blackout")
    spurious = [
        ev
        for ev in pipe.scale_history
        if blackout.injected_at is not None
        and blackout.cleared_at is not None
        and blackout.injected_at <= ev[0] < blackout.cleared_at
    ]
    blackout_condition_observed = any(
        type_ == "ScalingActive"
        and status is False
        and reason == "FailedGetObjectMetric"
        and blackout.injected_at is not None
        and blackout.cleared_at is not None
        and blackout.injected_at <= ts < blackout.cleared_at
        for ts, type_, status, reason in pipe.hpa.condition_history
    )
    return {
        "scenario": "chaos",
        "mode": "virtual",
        "settled_replicas": settled,
        "faults": [r.as_dict() for r in reports],
        "all_recovered": schedule.all_recovered(),
        "spurious_scale_events_during_blackout": len(spurious),
        "blackout_condition_observed": blackout_condition_observed,
        "final_replicas": pipe.replicas(),
        "final_running": pipe.running(),
        "scale_events": len(pipe.scale_history),
        "trace_spans": len(tracer.spans),
        "fault_window_spans": [s.span_id for s in tracer.spans_of("fault_window")],
    }


def render_chaos_report(result: dict) -> str:
    lines = [
        "chaos storm: 4 faults over "
        f"{len(result['faults'])} layers, settled at "
        f"{result['settled_replicas']} replicas",
        "",
        f"{'fault':<34} {'detect':>7} {'mttr':>7}  recovered",
    ]
    for f in result["faults"]:
        detect = "-" if f["detection_time"] is None else f"{f['detection_time']:.0f}s"
        mttr = "-" if f["mttr"] is None else f"{f['mttr']:.0f}s"
        lines.append(
            f"{f['fault']:<34} {detect:>7} {mttr:>7}  {'yes' if f['recovered'] else 'NO'}"
        )
    lines += [
        "",
        f"all recovered:            {result['all_recovered']}",
        "spurious scale events during blackout: "
        f"{result['spurious_scale_events_during_blackout']}",
        "ScalingActive=False (FailedGetObjectMetric) observed during blackout: "
        f"{result['blackout_condition_observed']}",
        f"final replicas/running:   {result['final_replicas']}/{result['final_running']}",
    ]
    return "\n".join(lines)
