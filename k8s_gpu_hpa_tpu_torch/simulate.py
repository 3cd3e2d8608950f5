"""Scenario simulator: play a load scenario against a shipped HPA manifest.

Counterpart of ``k8s_gpu_hpa_tpu/simulate.py``, cut to the load scenarios.
``python -m k8s_gpu_hpa_tpu_torch simulate --hpa deploy/tpu-test-hpa.yaml
--scenario spike`` answers "what will this HPA do to this workload?" in
seconds of wall time, on a virtual clock, before anything touches a
cluster.  The reference learns its loop's dynamics only by deploying it
(README.md:112-123; its one documented surprise, the overshoot defect, was
found that way).

Scenarios (offered load in percent of one device; the replicas share it):

- ``spike``:  idle, then a step to 8 devices' worth at t=60;
- ``ramp``:   from idle to 8 devices' worth over 10 minutes;
- ``flap``:   an oscillation around the target, which the tolerance and
              the scale-down window keep from flapping the replicas;
- ``outage``: steady load, every exporter down from t=120 for 2 minutes:
              the HPA holds;
- ``crash``:  steady load, one pod crashes at t=120: its replacement pays
              the start latency.

An External-metric HPA (the queue rung, deploy/tpu-test-external-hpa.yaml)
is told from its manifest and plays ``spike``, ``ramp`` and ``flap`` in
queued requests: the demand is published to the external series, and the
timeline shows the desired replicas following it (queue depth is demand,
so the replicas do not feed back into it).

The manifests are read with ``manifests.load_yaml``: no YAML library.  The
JAX simulator's traced, sharded and planner runs (``trace``, ``shards``,
``explain``) and its fault, capacity, recovery, SLO, history, coverage,
race, fuzz, profile, evacuation and incident scenarios are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import (
    ExternalMetricSpec,
    HPAController,
    ObjectMetricSpec,
    behavior_from_manifest,
    metrics_from_manifest,
    quantum_from_manifest,
    signal_ceiling_clears_band,
)
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch.manifests import load_yaml
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

SCENARIOS = {
    "spike": lambda t: 800.0 if t >= 60.0 else 20.0,
    "ramp": lambda t: 20.0 + min(780.0, max(0.0, t - 60.0) * 780.0 / 600.0),
    "flap": lambda t: 80.0 + 8.0 * math.sin(2 * math.pi * t / 60.0),
    "outage": lambda t: 120.0,
    "crash": lambda t: 90.0,
}

#: queue-depth demand (requests) for External-metric HPAs; the shipped
#: target is 100 a replica (AverageValue), so these move 1 -> several
EXTERNAL_SCENARIOS = {
    "spike": lambda t: 340.0 if t >= 60.0 else 40.0,
    "ramp": lambda t: 40.0 + min(400.0, max(0.0, t - 60.0) * 400.0 / 600.0),
    "flap": lambda t: 180.0 + 30.0 * math.sin(2 * math.pi * t / 60.0),
}


@dataclass
class SimReport:
    scenario: str
    #: (t, offered, recorded, replicas, running) every ``sample_every`` s
    timeline: list[tuple[float, float, float | None, int, int]] = field(default_factory=list)
    scale_events: list[tuple[float, int, int]] = field(default_factory=list)
    #: spike: the signal's crossing -> every replica of max running
    scale_up_latency: float | None = None
    offered_units: str = "%"  # "%" of one device, or "req" for queue depth
    #: the reachability verdict when a measured signal ceiling was given
    target_note: str | None = None
    #: the query planner's counters; None, as the planner is not ported
    query_engine: dict | None = None


def _reachability(saturated_pct: float, target_value: float) -> str:
    """The verdict on a measured signal ceiling: can it ever leave the
    controller's tolerance band above the target?"""
    band = target_value * (1.0 + HPAController.TOLERANCE)
    if signal_ceiling_clears_band(saturated_pct, target_value):
        return (
            f"signal ceiling {saturated_pct:g} clears the actionable "
            f"band (> {band:g}): target reachable"
        )
    return (
        f"INERT PAIRING: signal ceiling {saturated_pct:g} cannot "
        f"clear the actionable band (> {band:g} "
        f"needed) — this HPA will never scale this workload"
    )


def run_scenario(
    hpa_doc: dict,
    scenario: str = "spike",
    duration: float = 420.0,
    pod_start_latency: float = 12.0,
    sample_every: float = 5.0,
    saturated_pct: float | None = None,
) -> SimReport:
    """Play one shipped Object-metric HPA manifest under a load scenario.

    Behavior, bounds, target and slice quantum come from the manifest.
    ``saturated_pct`` caps each pod's signal at the workload's measured
    ceiling: without it the simulated gauge can reach 100, which makes an
    inert pairing (a serve pod saturating at 6.3% against a target of 60)
    look healthy; with it the report says whether the target is
    reachable at all."""
    load_fn = SCENARIOS[scenario]
    spec = hpa_doc["spec"]
    ref = spec["scaleTargetRef"]
    metrics = metrics_from_manifest(hpa_doc)
    if len(metrics) != 1 or not isinstance(metrics[0], ObjectMetricSpec):
        raise ValueError(
            "simulate supports single Object-metric HPAs (the tensorcore "
            "rungs); got " + ", ".join(type(m).__name__ for m in metrics)
        )
    quantum = quantum_from_manifest(hpa_doc)

    clock = VirtualClock()
    max_replicas = spec["maxReplicas"]
    cluster = SimCluster(
        clock,
        nodes=[(f"tpu-node-{i}", 4) for i in range((max_replicas + 3) // 4 + 1)],
        pod_start_latency=pod_start_latency,
    )
    dep = SimDeployment(
        cluster,
        ref["name"],
        ref["name"],
        load_fn=load_fn,
        load_mode="shared",
        hosts_per_slice=quantum,
        util_cap=saturated_pct if saturated_pct is not None else 100.0,
    )
    cluster.add_deployment(dep, replicas=spec.get("minReplicas", 1))
    clock.advance(15.0)
    # scenario time starts now: the timeline's t and the load's agree (the
    # 15 s settle is not part of the scenario)
    base = clock.now()
    dep.load_fn = lambda t: load_fn(t - base)

    pipe = AutoscalingPipeline(
        cluster,
        dep,
        record=metrics[0].metric_name,
        target_value=metrics[0].target_value,
        min_replicas=spec.get("minReplicas", 1),
        max_replicas=max_replicas,
        behavior=behavior_from_manifest(hpa_doc),
        replica_quantum=quantum,
        object_kind=ref["kind"],
    )
    pipe.start()

    outage_window = (120.0, 240.0) if scenario == "outage" else None
    crash_at: float | None = 120.0 if scenario == "crash" else None
    originals: list[tuple] = []

    report = SimReport(scenario=scenario)
    t_cross = None
    target_value = metrics[0].target_value
    if saturated_pct is not None:
        report.target_note = _reachability(saturated_pct, target_value)
    elapsed = 0.0
    while elapsed < duration:
        if outage_window and originals == [] and elapsed >= outage_window[0]:
            for tgt in pipe.scraper.targets:
                if tgt.name.startswith("exporter/"):
                    originals.append((tgt, tgt.fetch))
                    tgt.fetch = _exporter_down
        if outage_window and originals and elapsed >= outage_window[1]:
            for tgt, fetch in originals:
                tgt.fetch = fetch
            outage_window = None
        if crash_at is not None and elapsed >= crash_at:
            running = cluster.running_pods(dep.name)
            if running:
                cluster.kill_pod(running[0].name)
            crash_at = None

        clock.advance(sample_every)
        elapsed += sample_every
        recorded = pipe.db.latest(metrics[0].metric_name, {})
        if t_cross is None and recorded is not None and recorded > target_value:
            t_cross = elapsed
        running_now = len(cluster.running_pods(dep.name))
        report.timeline.append((elapsed, load_fn(elapsed), recorded, dep.replicas, running_now))
        if (
            t_cross is not None
            and report.scale_up_latency is None
            and dep.replicas == max_replicas
            and running_now == max_replicas
        ):
            report.scale_up_latency = elapsed - t_cross

    report.scale_events = [(ts - base, a, b) for ts, a, b in pipe.scale_history]
    return report


def _exporter_down():
    raise ConnectionError("exporter down (scenario)")


def run_external_scenario(
    hpa_doc: dict,
    scenario: str = "spike",
    duration: float = 420.0,
    sample_every: float = 5.0,
) -> SimReport:
    """Play a shipped External-metric HPA (the queue rung) under a demand
    curve: demand -> external series -> adapter -> the HPA's desired
    replicas, over ``control/external_sim.py``.  No pod lifecycle: queue
    depth is demand, so the replicas never feed back into it."""
    from k8s_gpu_hpa_tpu_torch.control.external_sim import external_sim_from_manifest

    if scenario not in EXTERNAL_SCENARIOS:
        raise ValueError(
            f"scenario {scenario!r} not available for External-metric HPAs "
            f"(have: {', '.join(sorted(EXTERNAL_SCENARIOS))})"
        )
    demand_fn = EXTERNAL_SCENARIOS[scenario]
    sim = external_sim_from_manifest(hpa_doc)

    report = SimReport(scenario=f"{scenario} (External queue depth)", offered_units="req")
    prev = sim.target.replicas
    next_sync = 15.0
    while sim.clock.now() < duration:
        demand = demand_fn(sim.clock.now())
        sim.publish(demand)
        if sim.clock.now() >= next_sync:
            sim.hpa.sync_once()
            next_sync += 15.0
            if sim.target.replicas != prev:
                report.scale_events.append((sim.clock.now(), prev, sim.target.replicas))
                prev = sim.target.replicas
        report.timeline.append(
            (sim.clock.now(), demand, demand, sim.target.replicas, sim.target.replicas)
        )
        sim.clock.advance(sample_every)
    return report


def render_report(report: SimReport) -> str:
    offered_col = "offered%" if report.offered_units == "%" else "queued"
    lines = [
        f"scenario: {report.scenario}",
        f"{'t(s)':>6} {offered_col:>9} {'recorded':>9} {'replicas':>9} {'running':>8}",
    ]
    for t, offered, recorded, replicas, running in report.timeline:
        rec = f"{recorded:.1f}" if recorded is not None else "absent"
        lines.append(f"{t:>6.0f} {offered:>9.1f} {rec:>9} {replicas:>9} {running:>8}")
    lines.append("")
    for ts, a, b in report.scale_events:
        lines.append(f"scale event t={ts:.0f}s: {a} -> {b}")
    if report.scale_up_latency is not None:
        lines.append(
            f"scale-up latency (signal crossing -> all replicas running): "
            f"{report.scale_up_latency:.0f}s"
        )
    if report.target_note is not None:
        lines.append(report.target_note)
    return "\n".join(lines)


def main(args) -> int:
    """Run ``args.scenario`` on the manifest ``args.hpa`` and print the
    report.  Exit 2 with a one-line diagnosis for a manifest or scenario the
    simulator cannot play, and for ``--saturated-pct`` on an External HPA."""
    hpa_doc = load_yaml(Path(args.hpa).read_text())
    metrics = metrics_from_manifest(hpa_doc)
    try:
        if len(metrics) == 1 and isinstance(metrics[0], ExternalMetricSpec):
            if getattr(args, "saturated_pct", None) is not None:
                # queue depth is demand, not a gauge with a ceiling: ignoring
                # the flag would read as "pairing healthy"
                print(
                    "simulate: --saturated-pct applies to utilization-gauge "
                    "HPAs; External queue-depth metrics have no signal "
                    "ceiling (demand is unbounded)"
                )
                return 2
            report = run_external_scenario(
                hpa_doc, scenario=args.scenario, duration=args.duration
            )
        else:
            report = run_scenario(
                hpa_doc,
                scenario=args.scenario,
                duration=args.duration,
                pod_start_latency=args.pod_start,
                saturated_pct=getattr(args, "saturated_pct", None),
            )
    except ValueError as e:
        # e.g. an External manifest with an Object-only scenario: a
        # diagnosis, not a traceback
        print(f"simulate: {e}")
        return 2
    print(render_report(report))
    return 0


def add_arguments(parser) -> None:
    """The ``simulate`` command's flags (``python -m k8s_gpu_hpa_tpu_torch
    simulate``)."""
    parser.add_argument("--hpa", default="deploy/tpu-test-hpa.yaml")
    parser.add_argument("--scenario", choices=list(SCENARIOS), default="spike")
    parser.add_argument("--duration", type=float, default=420.0)
    parser.add_argument("--pod-start", type=float, default=12.0)
    parser.add_argument(
        "--saturated-pct",
        type=float,
        default=None,
        help="the workload's measured signal ceiling: caps the simulated "
        "per-pod gauge so an inert manifest/workload pairing (ceiling below "
        "target x 1.1) is diagnosed instead of simulated as healthy",
    )
