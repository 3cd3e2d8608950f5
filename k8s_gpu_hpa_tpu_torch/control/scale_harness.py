"""The recovery drill: crash each durable component of the control plane
mid-run and measure its recovery.

Counterpart of ``k8s_gpu_hpa_tpu/control/scale_harness.py``, cut to its
recovery drill (``run_recovery_drill``, the ``drill`` scenario and
bench.py's ``recovery_drill`` rung, ``trial.recovery_drill_rung``).  The
JAX module's fleet, query and downsampling benches come with the
metrics-plane slice.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.chaos import ChaosSchedule, FaultSpec
from k8s_gpu_hpa_tpu_torch.control.checkpoint import FileCheckpointStore
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import HPABehavior, ScalingPolicy, ScalingRules
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch.metrics.wal import WriteAheadLog
from k8s_gpu_hpa_tpu_torch.obs import Tracer, index_spans, lineage_of
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

#: the restart fault of each component the drill can crash
DRILL_COMPONENTS = {
    "tsdb": "tsdb_restart",
    "hpa": "hpa_restart",
    "adapter": "adapter_restart",
    "wal": "wal_truncate",
}


def run_recovery_drill(
    components: tuple[str, ...] = ("tsdb", "hpa", "adapter", "wal"),
    pod_start_latency: float = 12.0,
    settle_s: float = 120.0,
    between_s: float = 180.0,
    surge_s: float = 90.0,
    stable_for: float = 10.0,
) -> dict:
    """Crash each requested component mid-run and measure its recovery.

    A durable pipeline (a WAL in a temporary directory, the HPA's
    checkpoint in a file there, traced) holds 3 replicas under a steady
    shared load; each component is crashed and rebuilt in turn, an impulse
    restart fault on a ``ChaosSchedule`` every ``between_s``; then the load
    surges, so a scale event after every restart shows that the trace
    still explains it.  ``ok``: every fault recovers, no scale event falls
    inside a fault's injected → recovered window (a restart must never
    flap), and every scale event's lineage reaches the exporter sweeps.
    """
    unknown = [c for c in components if c not in DRILL_COMPONENTS]
    if unknown:
        raise ValueError(
            f"unknown drill component(s) {unknown}; have: {', '.join(sorted(DRILL_COMPONENTS))}"
        )

    with tempfile.TemporaryDirectory(prefix="recovery-drill-") as tmp:
        clock = VirtualClock()
        cluster = SimCluster(
            clock, nodes=[(f"drill-node-{i}", 2) for i in range(3)],
            pod_start_latency=pod_start_latency,
        )
        state = {"load": 90.0}
        dep = SimDeployment(cluster, "tpu-test", "tpu-test", load_fn=lambda t: state["load"],
                            load_mode="shared")
        cluster.add_deployment(dep, replicas=1)
        clock.advance(15.0)

        tracer = Tracer(clock)
        wal = WriteAheadLog(Path(tmp) / "wal", segment_max_records=512)
        store = FileCheckpointStore(Path(tmp) / "hpa-checkpoint.json")
        behavior = HPABehavior(
            scale_down=ScalingRules(
                stabilization_window_seconds=60.0,
                policies=[ScalingPolicy("Percent", 100, 15.0)],
            )
        )
        pipe = AutoscalingPipeline(
            cluster, dep, target_value=40.0, max_replicas=4, behavior=behavior,
            tracer=tracer, wal=wal, checkpoint_store=store,
        )
        pipe.run_for(settle_s)
        settled = pipe.replicas()

        faults = [
            FaultSpec(kind=DRILL_COMPONENTS[c], at=30.0 + i * between_s)
            for i, c in enumerate(components)
        ]
        schedule = ChaosSchedule(pipe, faults, stable_for=stable_for)
        schedule.arm()
        clock.advance(30.0 + len(faults) * between_s)

        # the surge: a real scale event after every component was rebuilt
        state["load"] = 140.0
        clock.advance(surge_s)

        reports = [r.as_dict() for r in schedule.reports]
        windows = [
            (r.injected_at, r.recovered_at)
            for r in schedule.reports
            if r.injected_at is not None and r.recovered_at is not None
        ]
        spurious = sum(
            1 for ts, _a, _b in pipe.scale_history
            if any(start <= ts <= end for start, end in windows)
        )
        mttrs = [r.mttr for r in schedule.reports if r.mttr is not None]
        gaps = [r.replay_gap for r in schedule.reports if r.replay_gap is not None]
        syncs = [
            r.time_to_first_good_sync
            for r in schedule.reports
            if r.time_to_first_good_sync is not None
        ]
        by_id = index_spans(tracer.spans)
        lineages = [lineage_of(s, by_id) for s in tracer.spans_of("scale_event")]
        lineage_complete = bool(lineages) and all(w["complete"] for w in lineages)
        all_recovered = schedule.all_recovered()
        mttr_max = round(max(mttrs), 1) if mttrs else None
        return {
            "scenario": "recovery_drill",
            "mode": "virtual",
            "metric": "recovery_drill_mttr_max",
            "value": mttr_max,
            "unit": "s",
            "components": list(components),
            "settled_replicas": settled,
            "faults": reports,
            "all_recovered": all_recovered,
            "spurious_scale_events_during_replay": spurious,
            "mttr_max_s": mttr_max,
            "replay_gap_max_s": round(max(gaps), 1) if gaps else 0.0,
            "first_good_sync_max_s": round(max(syncs), 1) if syncs else None,
            "restarts": [dict(entry) for entry in pipe.restart_log],
            "final_replicas": pipe.replicas(),
            "final_running": pipe.running(),
            "scale_events": len(pipe.scale_history),
            "scale_event_lineages": len(lineages),
            "lineage_complete": lineage_complete,
            "trace_spans": len(tracer.spans),
            "ok": all_recovered and spurious == 0 and lineage_complete,
        }


def render_drill_report(result: dict) -> str:
    """The drill's summary, as the ``drill`` scenario prints it."""

    def fmt(x):
        return "-" if x is None else f"{x:g}"

    lines = [
        f"recovery drill: components={','.join(result['components'])} "
        f"settled={result['settled_replicas']} replicas",
        f"{'fault':<28} {'mttr':>6} {'replay_gap':>10} {'first_sync':>10} {'recovered':>9}",
    ]
    for f in result["faults"]:
        lines.append(
            f"{f['fault']:<28} {fmt(f['mttr']):>6} {fmt(f['replay_gap']):>10} "
            f"{fmt(f['time_to_first_good_sync']):>10} {str(f['recovered']):>9}"
        )
    lines.append(
        f"spurious scale events during replay: {result['spurious_scale_events_during_replay']}  "
        f"scale-event lineages complete: {result['lineage_complete']} "
        f"({result['scale_event_lineages']})  "
        f"final replicas: {result['final_replicas']}"
    )
    lines.append(f"verdict: {'PASS' if result['ok'] else 'FAIL'}")
    return "\n".join(lines)
