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
              the start latency;
- ``trace``:  the spike, traced (``run_scenario(trace=True)``): the
              decision timeline with each scale event's metric lineage back
              to the raw exporter sweeps, the query engine's counters, the
              signal-propagation summary and a JSONL export of the spans
              (``--trace-out``, default trace.jsonl).  Exit 2 when a scale
              event's lineage is incomplete or no scale event was traced;
- ``chaos``:  the canned fault storm (``chaos.run_fault_storm``), which
              needs no manifest: an exporter outage, a scrape blackout, a
              node preemption and a crash loop, each with its detection
              time and MTTR.  Exit 2 when a fault never recovers or a scale
              event fires during the blackout;
- ``slo``:    the SLO burn-rate alerts scored both ways (``run_slo_check``):
              a clean staircase, where any SLO alert is a false positive,
              and the same staircase with a total scrape blackout, where
              the fast scrape-success alert must fire.  Exit 2 otherwise;
- ``history``: the flight recorder (``run_history``), which needs no
              manifest: ``--days`` virtual days (default 2) of a diurnal
              load on a WAL-backed, traced, downsampling pipeline with an
              exporter outage and a TSDB restart, summarized hour by hour
              from the rollup tiers.  Exit 2 on a missing tier, an hourly
              coverage hole, an unrecovered fault or an incomplete lineage;
- ``why``:    one scale event of that run (``--event``, a span id the
              history lists) walked hop by hop back to the exporter
              sweeps, with the fault windows and restarts around it.  Exit
              2 on an unknown event or an incomplete lineage.  With
              ``--shards`` both exit 2 in one line (the TSDB restart needs
              the single-TSDB durability path), where JAX's raises;
- ``drill``:  the recovery drill (``control.scale_harness``), which needs no
              manifest: a durable pipeline (WAL, HPA checkpoint) has each
              of ``--components`` (tsdb, hpa, adapter, wal; default all)
              crashed and rebuilt mid-run, then a surge.  Exit 2 when a
              fault never recovers, a scale event falls in a recovery
              window, a lineage is incomplete, or a component is unknown;
- ``crunch``: the capacity crunch (``chaos.run_capacity_crunch``), which
              needs no manifest: three tenants of a bounded slice pool
              spike while provisioning fails and a node drains; the
              tenants' time to capacity, their worst waits and evictions,
              and the scheduler's timeline.  ``--starvation-budget``
              overrides every tenant's budget (0 shows the contract can
              fail).  Exit 2 on any violation of the capacity contract;
- ``evacuate``: the region evacuation (``chaos.run_region_evacuation``),
              which needs no manifest: three regional stacks under one
              global control plane, the home region killed mid-traffic
              through an object-store outage and a survivor's partition;
              each band's time to reconvergence against its budget, the
              cross-region decision chain and the global reads against a
              merged reference.  ``--smoke`` shortens the kill and the
              tail, ``--no-spill`` is the planted canary (must exit 2),
              ``--why TENANT`` prints one tenant's decision chain after the
              run, and ``--replay SCENARIO_JSON`` runs a committed artifact
              (tests/scenarios/evac-*.json) again instead.  Exit 2 on any
              violation of the fleet contract, on a replay that does not
              reproduce, and on an artifact that cannot be read;
- ``fuzz``:   the coverage-guided chaos fuzzer (``chaos.fuzz.run_fuzz``),
              which needs no manifest: ``--budget`` cases from ``--seed``
              (default perfgates' smoke campaign) mutate fault schedules
              and traffic against a fixed two-tenant harness; the first
              contract failure is run again, minimized and, with
              ``--fuzz-out DIR``, written as a replayable artifact.
              ``--break-grace`` is the planted canary, and ``--replay
              ARTIFACT`` runs a committed artifact (tests/scenarios/*.json
              but evac-*) again instead.  Exit 0 on a clean campaign or the
              canary found and minimized, 1 on a genuine minimized failure,
              2 on a failure that does not reproduce or cannot be
              minimized, a replay that diverges or an unreadable artifact;
- ``incident``: the paging drill (``chaos.paging``), which needs no
              manifest: the alert router armed over a canned run (``--run``
              storm, crunch or evacuate; ``--smoke`` picks the smoke
              evacuation), each page tied to its causes and the paging
              scored against the injected faults; ``--json`` writes the
              result, ``--why INC-00N`` one incident's causal chain, and
              ``--break-inhibition`` is the planted canary.  Exit 2 on any
              violation of the paging contract or an unknown run;
- ``races``:  the race harness (``control.race_harness.run_race_sweep``),
              which needs no manifest: a serial reference and
              ``--schedules`` seeded permutations (from ``--seed``) of the
              shard-rules fan-out, plus one run on a real thread pool, must
              leave bit-identical shard DBs, with the statically inferred
              lockset of the coverage map armed as runtime assertions.
              ``--break-ordering`` is the planted canary.  Exit 2 on any
              divergence or lock-discipline violation;
- ``coverage``: a canned run (``--run``: storm, crunch, drill, slo,
              races, fuzz, profile, evacuate or incident; default ``all``,
              their union) under a coverage map (``run_coverage``): the
              per-domain scorecard and the never-hit probes; ``--json``
              writes the canonical export, ``--diff BASELINE CANDIDATE``
              compares two exports (exit 2 on a lost probe) and ``--floor``
              gates the union ratio (by default the union floor for
              ``all``);
- ``profile``: a canned run (``--run``: storm, crunch, scale or all)
              under a profile map (``control.profile_harness``): the
              per-stage scorecard with its attribution; ``--json`` writes
              the timed export, ``--trace-out`` the Chrome trace and
              ``--flame-out`` the collapsed stacks, ``--plant STAGE=SECONDS``
              adds accounted (never slept) seconds to a stage, and
              ``--diff`` gates against one baseline (this run) or two
              exports (offline): exit 2 on a lost call path or a stage
              share regression.  ``--smoke`` shrinks the scale run.

An External-metric HPA (the queue rung, deploy/tpu-test-external-hpa.yaml)
is told from its manifest and plays ``spike``, ``ramp`` and ``flap`` in
queued requests: the demand is published to the external series, and the
timeline shows the desired replicas following it (queue depth is demand,
so the replicas do not feed back into it).

``--shards N`` plays an Object-metric scenario against a sharded scrape
plane of N hash-ring shards (metrics/federation.py), and ``--explain``
prints the query planner's physical plan of every rule and alert the
pipeline evaluates.

The manifests are read with ``manifests.load_yaml``: no YAML library.
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
from k8s_gpu_hpa_tpu_torch.obs import (
    TracedLoad,
    Tracer,
    format_lineage,
    index_spans,
    lineage_of,
    propagation_report,
)
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
    #: the obs.Tracer that recorded the run (``trace=True``), else None
    tracer: Tracer | None = None
    #: the clock time the scenario started: a span's start minus this is on
    #: the timeline's t axis (the 15 s settle precedes the scenario)
    trace_base: float = 0.0
    #: the query engine's counters: the run's planner and the TSDB's
    #: decode cache (metrics/planner.py), printed by the trace scenario
    query_engine: dict | None = None
    #: the physical plans of the pipeline's rules and alerts (``explain``)
    plan_explain: str | None = None


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
    trace: bool = False,
    shards: int = 0,
    explain: bool = False,
) -> SimReport:
    """Play one shipped Object-metric HPA manifest under a load scenario.

    Behavior, bounds, target and slice quantum come from the manifest.
    ``trace=True`` runs the pipeline with a tracer, the offered load's
    steps emitting ``workload_change`` spans (``SimReport.tracer``).
    ``shards`` scrapes through that many hash-ring shards, and ``explain``
    renders the planner's physical plans (``SimReport.plan_explain``).
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
    tracer = Tracer(clock) if trace else None
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
    if tracer is not None:
        dep.load_fn = TracedLoad(dep.load_fn, tracer)

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
        tracer=tracer,
        scrape_shards=shards,
    )
    pipe.start()

    outage_window = (120.0, 240.0) if scenario == "outage" else None
    crash_at: float | None = 120.0 if scenario == "crash" else None
    originals: list[tuple] = []

    report = SimReport(scenario=scenario, tracer=tracer, trace_base=base)
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
    stats = pipe.planner.stats
    report.query_engine = {
        "fastpath_chunks": stats.fastpath,
        "fallback_chunks": stats.fallback,
        "series_cache_hits": stats.series_cache_hits,
        "series_resolves": stats.series_resolves,
        "plans_built": stats.plans_built,
        "decode_cache_hits": pipe.db.decode_cache_hits,
        "decode_cache_misses": pipe.db.decode_cache_misses,
    }
    if explain:
        sections = []
        for rule in pipe.evaluator.rules:
            expr = getattr(rule, "expr", None)
            if expr is None:
                continue  # an SLO recorder folds its counters itself: no AST
            sections.append(f"{rule.record} = {expr.promql()}\n" + pipe.planner.explain(expr))
        for alert in pipe.evaluator.alerts:
            sections.append(
                f"ALERT {alert.alert} = {alert.expr.promql()}\n"
                + pipe.planner.explain(alert.expr)
            )
        report.plan_explain = "\n\n".join(sections)
    return report


def _print_plans(report: SimReport) -> None:
    if report.plan_explain:
        print()
        print("physical plans (query planner):")
        print(report.plan_explain)


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


def render_trace_timeline(report: SimReport) -> str:
    """The decision timeline of a traced run, in causal order: the offered
    load's changes, every sync's decision, and each scale event with its
    metric lineage back to the raw exporter sweeps."""
    tracer = report.tracer
    base = report.trace_base
    by_id = index_spans(tracer.spans)
    rows = sorted(
        (
            s
            for s in tracer.spans
            if s.kind in ("workload_change", "hpa_sync", "scale_event", "fault_window")
        ),
        key=lambda s: (s.start, s.span_id),
    )
    lines = ["decision timeline (t = seconds since scenario start):"]
    for s in rows:
        t = s.start - base
        if s.kind == "workload_change":
            prev = s.attrs.get("previous")
            prev_txt = f"{prev:g}" if prev is not None else "?"
            desc = f"offered load {prev_txt} -> {s.attrs['intensity']:g}"
        elif s.kind == "hpa_sync":
            desc = (
                f"{s.attrs['reason']} (replicas {s.attrs['current_replicas']}, "
                f"desired {s.attrs['desired_replicas']})"
            )
        elif s.kind == "fault_window":
            desc = f"{s.attrs['fault']} ({s.attrs['kind']})"
        else:
            desc = f"replicas {s.attrs['from_replicas']} -> {s.attrs['to_replicas']}"
        lines.append(f"t={t:>5.0f}s  {s.kind:<16} #{s.span_id:<5} {desc}")
        if s.kind == "scale_event":
            lin = lineage_of(s, by_id)
            shifted = dict(
                lin,
                hops=[
                    dict(h, first_ts=h["first_ts"] - base, last_ts=h["last_ts"] - base)
                    for h in lin["hops"]
                ],
            )
            lines.append(f"{'':9}lineage: {format_lineage(shifted)}")
            # the storage tier each read of this event's rule evaluations
            # was served from
            tiers = _tier_counts(
                by_id[sid]
                for h in lin["hops"]
                if h["kind"] == "rule_eval"
                for sid in h["span_ids"]
            )
            if tiers:
                lines.append(
                    f"{'':9}read tiers: " + ", ".join(f"{k}:{v}" for k, v in sorted(tiers.items()))
                )
    return "\n".join(lines)


def _tier_counts(spans) -> dict[str, int]:
    """The ``tiers`` attributes of rule_eval spans ("raw:3") summed into
    one {tier: reads} dict."""
    totals: dict[str, int] = {}
    for s in spans:
        for part in s.attrs.get("tiers", "").split(","):
            if part:
                label, _, n = part.rpartition(":")
                totals[label] = totals.get(label, 0) + int(n)
    return totals


def _main_trace(args) -> int:
    """The ``trace`` scenario: the spike, traced, its timeline and
    propagation summary printed and its spans written as JSONL.  Exit 2
    when a scale event has no lineage back to exporter samples, or no scale
    event was traced."""
    hpa_doc = load_yaml(Path(args.hpa).read_text())
    try:
        report = run_scenario(
            hpa_doc,
            scenario="spike",
            duration=args.duration,
            pod_start_latency=args.pod_start,
            trace=True,
            shards=getattr(args, "shards", 0),
            explain=getattr(args, "explain", False),
        )
    except ValueError as e:
        print(f"simulate: {e}")
        return 2
    print(render_trace_timeline(report))
    _print_plans(report)
    qe = report.query_engine
    print()
    print(
        "query engine: planner fastpath "
        f"{qe['fastpath_chunks']} chunk(s) / fallback "
        f"{qe['fallback_chunks']} decode(s); series cache "
        f"{qe['series_cache_hits']} hit(s) / {qe['series_resolves']} "
        f"resolve(s); decoded-window cache {qe['decode_cache_hits']} "
        f"hit(s) / {qe['decode_cache_misses']} miss(es); "
        f"{qe['plans_built']} plan(s) built"
    )
    tracer = report.tracer
    tier_totals = _tier_counts(tracer.spans_of("rule_eval"))
    if tier_totals:
        print(
            "captured reads by storage tier: "
            + ", ".join(f"{k}:{v}" for k, v in sorted(tier_totals.items()))
        )
    prop = propagation_report(tracer.spans)
    print()
    if prop["changes_total"]:
        def fmt(v):
            return "-" if v is None else f"{v:.0f}s"

        print(
            "signal propagation: "
            f"change -> first sync p50={fmt(prop['sync_latency_p50'])} "
            f"p95={fmt(prop['sync_latency_p95'])}; "
            f"change -> scale event p50={fmt(prop['scale_latency_p50'])} "
            f"p95={fmt(prop['scale_latency_p95'])} "
            f"({prop['changes_scaled']}/{prop['changes_total']} changes scaled)"
        )
    out = getattr(args, "trace_out", None) or "trace.jsonl"
    n = tracer.write_jsonl(out)
    print(f"wrote {n} spans to {out}")
    by_id = index_spans(tracer.spans)
    events = tracer.spans_of("scale_event")
    incomplete = [ev.span_id for ev in events if not lineage_of(ev, by_id)["complete"]]
    if not events or incomplete:
        print(
            "TRACE CONTRACT VIOLATED: "
            + (
                f"scale events {incomplete} have no lineage back to exporter samples"
                if incomplete
                else "no scale events traced"
            )
        )
        return 2
    return 0


#: the SLO check's rising staircase: (scenario seconds, offered % of one
#: device).  Rising only: a scale-down waits out the 300 s window, and a
#: propagation latency measured across it would read as budget burn on a
#: clean run.  Each step lands the shared signal above the band around
#: target 40 at the replicas of the step before, so each makes a scale event.
SLO_STAIRCASE: tuple[tuple[float, float], ...] = (
    (60.0, 60.0),
    (180.0, 120.0),
    (300.0, 240.0),
)


def _slo_load(t: float) -> float:
    level = 20.0
    for at, value in SLO_STAIRCASE:
        if t >= at:
            level = value
    return level


def _slo_pipeline(pod_start_latency: float) -> AutoscalingPipeline:
    """A traced pipeline under the SLO staircase, with no manifest (as the
    chaos storm), so burn numbers compare run to run."""
    clock = VirtualClock()
    tracer = Tracer(clock)
    cluster = SimCluster(
        clock, nodes=[("tpu-node-0", 4), ("tpu-node-1", 4)], pod_start_latency=pod_start_latency
    )
    dep = SimDeployment(cluster, "tpu-test", "tpu-test", load_fn=_slo_load, load_mode="shared")
    cluster.add_deployment(dep, replicas=1)
    clock.advance(15.0)
    base = clock.now()
    dep.load_fn = TracedLoad(lambda t: _slo_load(t - base), tracer)
    pipe = AutoscalingPipeline(cluster, dep, tracer=tracer)
    pipe.start()
    return pipe


def run_slo_check(
    duration: float = 420.0,
    fault_at: float = 120.0,
    fault_duration: float = 150.0,
    pod_start_latency: float = 12.0,
) -> dict:
    """Score the SLO burn-rate alerts against chaos, both ways, on two runs
    of the staircase on a traced pipeline (which evaluates the SLO
    recorders and their burn-rate pairs, control/loop.py):

    - clean: no fault; an SLO alert firing at any second is a false
      positive;
    - fault: a total scrape blackout at ``fault_at`` for
      ``fault_duration``; the fast (page) scrape-success alert not firing
      is a false negative.

    Returns each alert's first firing second and the fast and slow
    scrape-success alerts' detection latencies (injection to first firing
    sample); ``ok`` is the verdict."""
    from k8s_gpu_hpa_tpu_torch.chaos import ChaosSchedule, FaultSpec

    phases: dict[str, dict[str, float]] = {}
    for phase in ("clean", "fault"):
        pipe = _slo_pipeline(pod_start_latency)
        if phase == "fault":
            ChaosSchedule(
                pipe, [FaultSpec("scrape_blackout", at=fault_at, duration=fault_duration)]
            ).arm()
        first_fired: dict[str, float] = {}
        elapsed = 0.0
        while elapsed < duration:
            pipe.clock.advance(1.0)
            elapsed += 1.0
            for name in pipe.evaluator.firing_alerts():
                if name.startswith("SLO"):
                    first_fired.setdefault(name, elapsed)
        phases[phase] = first_fired

    def detection(alert: str) -> float | None:
        fired_at = phases["fault"].get(alert)
        return None if fired_at is None else fired_at - fault_at

    result = {
        "duration": duration,
        "fault_at": fault_at,
        "fault_duration": fault_duration,
        "clean_false_positives": sorted(phases["clean"]),
        "fault_first_fired": dict(sorted(phases["fault"].items())),
        "fast_detection_s": detection("SLOScrapeSuccessFastBurn"),
        "slow_detection_s": detection("SLOScrapeSuccessSlowBurn"),
    }
    result["ok"] = not result["clean_false_positives"] and result["fast_detection_s"] is not None
    return result


def render_slo_report(result: dict) -> str:
    lines = [
        "SLO burn-rate check (clean window + scrape blackout "
        f"t={result['fault_at']:.0f}s for {result['fault_duration']:.0f}s):",
        "",
    ]
    fps = result["clean_false_positives"]
    lines.append(
        "clean phase: no SLO alert fired"
        if not fps
        else f"clean phase: FALSE POSITIVE(S): {', '.join(fps)}"
    )
    if result["fault_first_fired"]:
        for name, at in result["fault_first_fired"].items():
            lines.append(f"fault phase: {name} first fired at t={at:.0f}s")
    else:
        lines.append("fault phase: no SLO alert fired")
    for speed, key in (("fast/page", "fast_detection_s"), ("slow/ticket", "slow_detection_s")):
        d = result[key]
        lines.append(
            f"scrape-success {speed} detection latency: "
            + ("NEVER FIRED" if d is None else f"{d:.0f}s after injection")
        )
    lines.append("")
    lines.append("verdict: " + ("OK" if result["ok"] else "SLO CONTRACT VIOLATED"))
    return "\n".join(lines)


#: the canned runs ``simulate --scenario coverage`` can collect under one
#: map, the JAX package's nine in its order (``all`` unions them)
COVERAGE_RUN_NAMES = (
    "storm",
    "crunch",
    "drill",
    "slo",
    "races",
    "fuzz",
    "profile",
    "evacuate",
    "incident",
)


def run_coverage(run: str = "all", seed: int | None = None) -> dict:
    """Run the named canned run, or all of them (``run="all"``, in
    ``COVERAGE_RUN_NAMES`` order), under one fresh CoverageMap and return
    its canonical export.  ``seed`` feeds the storm's schedule-variant
    derivation (chaos/storm.py) and the race sweep, and is part of the run
    label, so same-seed exports are bit-identical and differently labeled
    ones are not conflated."""
    from k8s_gpu_hpa_tpu_torch.chaos.crunch import run_capacity_crunch
    from k8s_gpu_hpa_tpu_torch.chaos.storm import run_fault_storm
    from k8s_gpu_hpa_tpu_torch.control.scale_harness import run_recovery_drill
    from k8s_gpu_hpa_tpu_torch.obs import coverage

    names = COVERAGE_RUN_NAMES if run == "all" else (run,)
    label = run if seed is None else f"{run}@{seed}"
    with coverage.collect(label) as cmap:
        for name in names:
            if name == "storm":
                run_fault_storm(seed=seed)
            elif name == "crunch":
                run_capacity_crunch()
            elif name == "drill":
                run_recovery_drill()
            elif name == "slo":
                run_slo_check()
            elif name == "races":
                from k8s_gpu_hpa_tpu_torch.control.race_harness import run_race_sweep

                run_race_sweep(seed=0 if seed is None else seed)
            elif name == "fuzz":
                # the fuzz session's campaign seed and budget are pinned in
                # perfgates (they make all four fuzz:* probes fire); --seed
                # varies the storm and the races, not the fuzz campaign
                from k8s_gpu_hpa_tpu_torch.chaos.fuzz import run_fuzz_coverage_session

                run_fuzz_coverage_session()
            elif name == "profile":
                # fires all four profile:* probes deterministically: a tiny
                # profiled fleet run, both exporters and synthetic diff and
                # attribution trips (control/profile_harness.py)
                from k8s_gpu_hpa_tpu_torch.control.profile_harness import (
                    run_profile_coverage_session,
                )

                run_profile_coverage_session()
            elif name == "evacuate":
                # fires the region:* probes deterministically: one smoke
                # evacuation for the lifecycle, plus the torn-seal fallback
                # and the never-published miss (chaos/evacuate.py)
                from k8s_gpu_hpa_tpu_torch.chaos.evacuate import (
                    run_evacuation_coverage_session,
                )

                run_evacuation_coverage_session()
            elif name == "incident":
                # fires all sixteen alerting:* probes deterministically: one
                # smoke evacuation paging drill (real pages, inhibition and
                # attribution) and synthetic router and correlator edges
                # (chaos/paging.py)
                from k8s_gpu_hpa_tpu_torch.chaos.paging import run_incident_coverage_session

                run_incident_coverage_session()
    return cmap.export()


def render_coverage_diff(diff: dict) -> str:
    lines = []
    for section in ("gained", "lost", "unchanged"):
        probes = diff[section]
        lines.append(f"{section} ({len(probes)}):")
        lines.extend(f"  {pid}" for pid in probes)
    lines.append(
        "verdict: COVERAGE REGRESSION — probes lost"
        if diff["regression"]
        else "verdict: OK (superset or equal)"
    )
    return "\n".join(lines)


HISTORY_TICK = 30.0
HISTORY_DAY = 86400.0


def _history_load(t: float) -> float:
    """Diurnal demand (%-of-one-chip, shared): quiet nights at 20, a midday
    peak at 240 — enough to swing the default manifest's replica count
    between 1 and ~6 once a virtual day, which is exactly the duty-cycle
    content the flight recorder exists to retain."""
    day = (t % HISTORY_DAY) / HISTORY_DAY
    # the run starts at "dawn" (load rising immediately), peaks at day 0.25,
    # and spends the back half of each day at the 20 floor
    return 20.0 + 220.0 * max(0.0, math.sin(2.0 * math.pi * day))


def _history_pipeline(wal_dir: str, pod_start_latency: float, shards: int):
    """A WAL-backed, traced, downsampling pipeline under the diurnal load:
    the long-horizon analog of ``_slo_pipeline`` (no manifest, so flight
    recorder output compares run to run).  The cluster's exporters keep
    their 1 s sweep, as JAX's do (its ``PipelineIntervals.exporter_sample``
    is read by nothing)."""
    from k8s_gpu_hpa_tpu_torch.control.loop import PipelineIntervals
    from k8s_gpu_hpa_tpu_torch.metrics.downsample import DownsamplePolicy
    from k8s_gpu_hpa_tpu_torch.metrics.wal import WriteAheadLog

    clock = VirtualClock()
    tracer = Tracer(clock)
    cluster = SimCluster(
        clock,
        nodes=[("tpu-node-0", 4), ("tpu-node-1", 4), ("tpu-node-2", 4)],
        pod_start_latency=pod_start_latency,
    )
    dep = SimDeployment(
        cluster, "tpu-test", "tpu-test", load_fn=_history_load, load_mode="shared"
    )
    cluster.add_deployment(dep, replicas=1)
    clock.advance(15.0)
    base = clock.now()
    dep.load_fn = TracedLoad(lambda t: _history_load(t - base), tracer)
    pipe = AutoscalingPipeline(
        cluster,
        dep,
        max_replicas=8,
        intervals=PipelineIntervals(
            scrape=HISTORY_TICK,
            rule_eval=HISTORY_TICK,
            hpa_sync=2 * HISTORY_TICK,
        ),
        tracer=tracer,
        wal=WriteAheadLog(wal_dir),
        scrape_shards=shards,
        downsample=DownsamplePolicy(),
    )
    pipe.start()
    return pipe, base


def run_history(
    days: float = 2.0,
    pod_start_latency: float = 30.0,
    shards: int = 0,
) -> dict:
    """The flight recorder: a multi-day diurnal run on a WAL-backed,
    downsampling, traced pipeline, summarized hour-by-hour FROM THE ROLLUP
    TIERS (metrics/downsample.py) — replica counts and duty cycle from the
    5m/1h rollups of recorder series, SLO burn from the error-budget
    counters' rollup min/last columns, fault windows and scale events from
    the trace.  A mid-run ``tsdb_restart`` (WAL replay) and an exporter
    outage are injected so the timeline proves the rollups and the lineage
    survive a crash.

    Returns the report dict; ``violations`` lists every broken contract
    (missing rollup tier, hourly coverage hole, unrecovered fault, scale
    event without complete lineage): the CLI exits 2 on any.

    ``shards`` > 0 raises ``RuntimeError`` before the run: the
    ``tsdb_restart`` fault needs the single-TSDB durability path (JAX's
    raises the same error from ``restart_tsdb`` when the fault fires)."""
    import tempfile

    from k8s_gpu_hpa_tpu_torch.chaos import ChaosSchedule, FaultSpec

    if shards:
        raise RuntimeError(
            "the history scenario's tsdb_restart fault needs the single-TSDB "
            "durability path; a sharded pipeline keeps raw series in "
            "memory-only shard DBs (run it without --shards)"
        )
    duration = days * HISTORY_DAY
    with tempfile.TemporaryDirectory(prefix="history-wal-") as wal_dir:
        pipe, base = _history_pipeline(wal_dir, pod_start_latency, shards)
        faults = [
            FaultSpec(
                "exporter_outage", at=round(duration * 0.3), duration=600.0
            ),
            FaultSpec("tsdb_restart", at=round(duration * 0.6)),
        ]
        schedule = ChaosSchedule(
            pipe, faults, monitor_interval=HISTORY_TICK, stable_for=120.0
        )
        schedule.arm()
        min_replicas = 1
        elapsed = 0.0
        while elapsed < duration:
            pipe.clock.advance(HISTORY_TICK)
            elapsed += HISTORY_TICK
            # the recorder series: replica count and an above-floor indicator,
            # appended like any scraped sample so compaction rolls them up
            # (and the WAL carries them across the tsdb_restart)
            reps = float(pipe.deployment.replicas)
            pipe.db.append("sim_replicas", (), reps)
            pipe.db.append(
                "sim_replicas_active",
                (),
                1.0 if reps > min_replicas else 0.0,
            )

        tracer = pipe.tracer
        tier_stats = pipe.db.rollup_storage_stats()

        def hour_of(end: float) -> int:
            return int(math.ceil(end / 3600.0))

        def rows_of(name: str, step: float) -> list[tuple]:
            got = pipe.db.rollup_rows(name, step=step)
            return got[0][1] if got else []

        hours: dict[int, dict] = {}

        def hour_row(h: int) -> dict:
            return hours.setdefault(
                h,
                {
                    "signal": None,
                    "replicas_avg": None,
                    "replicas_max": None,
                    "duty": None,
                    "slo_bad": 0.0,
                },
            )

        record = "tpu_test_tensorcore_avg"
        sig_rows = []
        got = pipe.db.rollup_rows(
            record, matchers={"deployment": "tpu-test"}, step=3600.0
        )
        if got:
            sig_rows = got[0][1]
        for end, count, total, _mn, _mx, _last in sig_rows:
            if count:
                hour_row(hour_of(end))["signal"] = total / count
        rep_rows = rows_of("sim_replicas", 3600.0)
        for end, count, total, _mn, mx, _last in rep_rows:
            if count:
                row = hour_row(hour_of(end))
                row["replicas_avg"] = total / count
                row["replicas_max"] = mx
        # duty cycle from the 5m tier: fraction of samples above the floor
        duty_acc: dict[int, list[float]] = {}
        for end, count, total, _mn, _mx, _last in rows_of(
            "sim_replicas_active", 300.0
        ):
            acc = duty_acc.setdefault(hour_of(end), [0.0, 0.0])
            acc[0] += total
            acc[1] += count
        for h, (good, n) in duty_acc.items():
            if n:
                hour_row(h)["duty"] = good / n
        # SLO burn from the error-budget counters: cumulative series, so a
        # 1h bucket's own (min, last) columns bound its delta — bad events
        # this hour = Δevents - Δgood, no cross-bucket subtraction needed
        for counter, sign in (("slo_events_total", 1.0), ("slo_good_total", -1.0)):
            for _labels, rows in pipe.db.rollup_rows(counter, step=3600.0):
                for end, count, _sum, mn, _mx, last in rows:
                    if count:
                        hour_row(hour_of(end))["slo_bad"] += sign * (last - mn)

        by_id = index_spans(tracer.spans)
        scale_events = [
            {
                "span_id": s.span_id,
                "t": s.start - base,
                "from": s.attrs["from_replicas"],
                "to": s.attrs["to_replicas"],
                "complete": lineage_of(s, by_id)["complete"],
            }
            for s in tracer.spans_of("scale_event")
        ]
        fault_windows = [
            {
                "t0": s.start - base,
                "t1": s.end - base,
                "fault": s.attrs["fault"],
                "kind": s.attrs["kind"],
            }
            for s in tracer.spans_of("fault_window")
        ]
        restarts = [
            {"component": e.get("component"), "t": e.get("at", 0.0) - base}
            for e in pipe.restart_log
        ]

        violations: list[str] = []
        tiers = tier_stats.get("tiers", {})
        for label in ("5m", "1h"):
            if tiers.get(label, {}).get("buckets", 0) <= 0:
                violations.append(f"rollup tier {label} missing (no buckets)")
        expected_hours = int(duration // 3600.0)
        covered = sum(
            1 for h in hours.values() if h["replicas_avg"] is not None
        )
        if covered < max(1, expected_hours - 2):
            violations.append(
                f"hourly replica coverage hole: {covered} of "
                f"{expected_hours} hours served by the 1h tier"
            )
        if not scale_events:
            violations.append("no scale events traced over the whole run")
        incomplete = [e["span_id"] for e in scale_events if not e["complete"]]
        if incomplete:
            violations.append(
                f"scale events {incomplete} have no lineage back to "
                "exporter samples"
            )
        for report in schedule.reports:
            if report.recovered_at is None:
                violations.append(f"fault {report.fault.name} never recovered")

        return {
            "days": days,
            "duration": duration,
            "hours": dict(sorted(hours.items())),
            "scale_events": scale_events,
            "fault_windows": fault_windows,
            "restarts": restarts,
            "tier_stats": tier_stats,
            "tier_reads": _tier_counts(tracer.spans_of("rule_eval")),
            "violations": violations,
            "ok": not violations,
            "tracer": tracer,
            "trace_base": base,
        }


def render_history(result: dict) -> str:
    lines = [
        f"flight recorder: {result['days']:g} virtual day(s), "
        "hourly view from the rollup tiers:",
        "",
        f"{'hour':>5} {'signal':>7} {'repl avg':>9} {'max':>4} "
        f"{'duty%':>6} {'slo bad':>8}  events",
    ]
    marks: dict[int, list[str]] = {}
    for e in result["scale_events"]:
        marks.setdefault(int(e["t"] // 3600.0) + 1, []).append(
            f"#{e['span_id']} {e['from']}->{e['to']}"
        )
    for w in result["fault_windows"]:
        marks.setdefault(int(w["t0"] // 3600.0) + 1, []).append(
            f"[fault {w['fault']}]"
        )
    for r in result["restarts"]:
        marks.setdefault(int(r["t"] // 3600.0) + 1, []).append(
            f"[restart {r['component']}]"
        )

    def fmt(v, spec: str) -> str:
        return "-" if v is None else format(v, spec)

    for h, row in result["hours"].items():
        duty = "-" if row["duty"] is None else f"{100.0 * row['duty']:.0f}"
        lines.append(
            f"{h:>5} {fmt(row['signal'], '.1f'):>7} "
            f"{fmt(row['replicas_avg'], '.2f'):>9} "
            f"{fmt(row['replicas_max'], '.0f'):>4} {duty:>6} "
            f"{row['slo_bad']:>8.1f}  " + " ".join(marks.get(h, []))
        )
    lines.append("")
    tiers = result["tier_stats"].get("tiers", {})
    lines.append(
        "rollup storage: "
        + "; ".join(
            f"{label} tier: {t['buckets']} buckets / {t['bytes']} bytes"
            for label, t in sorted(tiers.items())
        )
    )
    if result["tier_reads"]:
        lines.append(
            "rule reads by storage tier: "
            + ", ".join(
                f"{k}:{v}" for k, v in sorted(result["tier_reads"].items())
            )
        )
    n_complete = sum(1 for e in result["scale_events"] if e["complete"])
    lines.append(
        f"scale events: {len(result['scale_events'])} "
        f"({n_complete} with complete lineage) — replay one with "
        "'simulate why <id>'"
    )
    for v in result["violations"]:
        lines.append(f"HISTORY CONTRACT VIOLATED: {v}")
    return "\n".join(lines)


def run_why(
    event_id: int,
    days: float = 2.0,
    pod_start_latency: float = 30.0,
    shards: int = 0,
    history: dict | None = None,
) -> dict:
    """Replay one scale decision's full causal chain: re-run the (fully
    deterministic) history scenario, locate the scale_event span, and walk
    its lineage hop by hop — sync reason, adapter reads, rule evaluations
    (with the storage tier each captured read came from), scrapes, exporter
    sweeps, plus any fault window or restart the decision sat inside.
    ``history``, a finished ``run_history`` result, is walked instead of a
    new run (the port's addition: the same run gives the same answer)."""
    hist = history if history is not None else run_history(
        days=days, pod_start_latency=pod_start_latency, shards=shards
    )
    tracer = hist["tracer"]
    base = hist["trace_base"]
    by_id = index_spans(tracer.spans)
    span = by_id.get(event_id)
    if span is None or span.kind != "scale_event":
        known = [e["span_id"] for e in hist["scale_events"]]
        return {
            "ok": False,
            "error": f"no scale event #{event_id} in this run "
            f"(known ids: {known})",
        }
    lin = lineage_of(span, by_id)
    t = span.start - base
    context = [
        f"inside fault window {w['fault']} "
        f"(t={w['t0']:.0f}-{w['t1']:.0f}s)"
        for w in hist["fault_windows"]
        if w["t0"] <= t <= w["t1"]
    ]
    for r in hist["restarts"]:
        if 0.0 <= t - r["t"] <= 600.0:
            context.append(
                f"{t - r['t']:.0f}s after {r['component']} restart"
            )
    hops = []
    for hop in lin["hops"]:
        members = [by_id[sid] for sid in hop["span_ids"]]
        hops.append(
            {
                "kind": hop["kind"],
                "count": len(members),
                "first_t": hop["first_ts"] - base,
                "last_t": hop["last_ts"] - base,
                "details": [
                    {"span_id": s.span_id, "t": s.start - base, **s.attrs}
                    for s in members[:6]
                ],
            }
        )
    return {
        "ok": lin["complete"],
        "event": {
            "span_id": span.span_id,
            "t": t,
            "from": span.attrs["from_replicas"],
            "to": span.attrs["to_replicas"],
        },
        "context": context,
        "hops": hops,
        "complete": lin["complete"],
    }


def render_why(result: dict) -> str:
    if "error" in result:
        return f"simulate why: {result['error']}"
    ev = result["event"]
    lines = [
        f"scale event #{ev['span_id']} at t={ev['t']:.0f}s: "
        f"replicas {ev['from']} -> {ev['to']}",
    ]
    for c in result["context"]:
        lines.append(f"  context: {c}")
    for hop in result["hops"]:
        span_txt = (
            f"t={hop['first_t']:.0f}s"
            if hop["first_t"] == hop["last_t"]
            else f"t={hop['first_t']:.0f}-{hop['last_t']:.0f}s"
        )
        lines.append(f"  {hop['kind']} x{hop['count']} ({span_txt}):")
        for d in hop["details"]:
            attrs = {
                k: v for k, v in d.items() if k not in ("span_id", "t")
            }
            body = ", ".join(f"{k}={v}" for k, v in attrs.items())
            lines.append(f"    #{d['span_id']} t={d['t']:.0f}s  {body}")
        if hop["count"] > len(hop["details"]):
            lines.append(
                f"    ... and {hop['count'] - len(hop['details'])} more"
            )
    lines.append(
        "lineage: "
        + (
            "COMPLETE (reaches raw exporter samples)"
            if result["complete"]
            else "INCOMPLETE — no exporter samples reached"
        )
    )
    return "\n".join(lines)


def _main_chaos(args) -> int:
    """The ``chaos`` scenario: the storm needs no manifest (it measures the
    pipeline's recovery on a fixed cluster), so ``--hpa`` is ignored.  Exit
    2 when a fault never recovers or a scale event fires while the metrics
    are black."""
    from k8s_gpu_hpa_tpu_torch.chaos import render_chaos_report, run_fault_storm

    result = run_fault_storm(pod_start_latency=args.pod_start)
    print(render_chaos_report(result))
    unrecovered = [f["fault"] for f in result["faults"] if not f["recovered"]]
    spurious = result["spurious_scale_events_during_blackout"]
    if unrecovered or spurious:
        print(
            "CHAOS CONTRACT VIOLATED: "
            + (
                f"faults never recovered: {', '.join(unrecovered)}"
                if unrecovered
                else f"{spurious} scale event(s) during the blackout"
            )
        )
        return 2
    return 0


def _main_drill(args) -> int:
    """The ``drill`` scenario: crash each of ``--components`` mid-run and
    require the loop to converge again, with no scale event in a recovery
    window and every lineage complete.  ``--hpa`` is ignored."""
    from k8s_gpu_hpa_tpu_torch.control.scale_harness import (
        DRILL_COMPONENTS,
        render_drill_report,
        run_recovery_drill,
    )

    raw = getattr(args, "components", None) or ",".join(DRILL_COMPONENTS)
    components = tuple(c.strip() for c in raw.split(",") if c.strip())
    try:
        result = run_recovery_drill(components=components, pod_start_latency=args.pod_start)
    except ValueError as e:
        print(f"simulate: {e}")
        return 2
    print(render_drill_report(result))
    return 0 if result["ok"] else 2


def _main_history(args) -> int:
    """The flight recorder's two scenarios, which need no manifest:
    ``history`` prints the hourly view from the rollup tiers, ``why`` one
    scale event's causal chain (``--event``, a span id ``history`` lists).
    Exit 2 on a broken history contract, an unknown or missing event, and
    with ``--shards``, in one line where JAX's raises."""
    days = getattr(args, "days", 2.0)
    shards = getattr(args, "shards", 0)
    event = getattr(args, "event", None)
    if args.scenario == "why" and event is None:
        print("simulate why: pass a scale-event span id (run 'simulate history' to list them)")
        return 2
    try:
        if args.scenario == "history":
            result = run_history(days=days, shards=shards)
            print(render_history(result))
        else:
            result = run_why(int(event), days=days, shards=shards)
            print(render_why(result))
    except RuntimeError as e:
        print(f"simulate {args.scenario}: {e}")
        return 2
    return 0 if result["ok"] else 2


def _main_evacuate(args) -> int:
    """The ``evacuate`` scenario, which needs no manifest: the canned
    evacuation and its report (with ``--why``, one tenant's decision chain
    after it), or with ``--replay`` a committed artifact run again.  Exit 2
    on a contract violation, a replay that does not reproduce, or an
    artifact that cannot be read."""
    import json

    from k8s_gpu_hpa_tpu_torch.chaos.evacuate import (
        render_evacuation_report,
        render_evacuation_why,
        replay_evacuation_artifact,
        run_region_evacuation,
    )

    replay = getattr(args, "replay", None)
    if replay:
        try:
            with open(replay, encoding="utf-8") as f:
                artifact = json.load(f)
            outcome = replay_evacuation_artifact(artifact)
        except (OSError, ValueError, KeyError) as e:
            print(f"simulate evacuate --replay: {e}")
            return 2
        if outcome["ok"]:
            print(
                f"scenario {artifact['name']}: reproduced bit-identically "
                f"({outcome['actual']['fingerprint']})"
            )
            return 0
        print(f"scenario {artifact['name']}: DID NOT REPRODUCE")
        print(f"  expected: {outcome['expected']}")
        print(f"  got:      {outcome['actual']}")
        return 2
    result = run_region_evacuation(
        spill_enabled=not getattr(args, "no_spill", False), smoke=getattr(args, "smoke", False)
    )
    print(render_evacuation_report(result))
    why = getattr(args, "why", None)
    if why:
        print()
        print(render_evacuation_why(result, why))
    return 0 if result["ok"] else 2


def _main_fuzz(args) -> int:
    """The ``fuzz`` scenario, which needs no manifest: a coverage-guided
    campaign (chaos/fuzz.py) that mutates fault schedules and traffic
    against the fixed fuzz harness and minimizes any contract failure into
    a replayable ``seed + schedule`` artifact, or with ``--replay`` a
    committed artifact run again.  Exit 0 on a clean campaign, and on the
    ``--break-grace`` canary found and minimized (the fuzzer working); 1 on
    a genuine minimized failure (corpus material: commit the artifact); 2
    on a failure that does not reproduce or cannot be minimized, on a
    replay that diverges from its recorded fingerprint, and on an artifact
    that cannot be read."""
    from k8s_gpu_hpa_tpu_torch import perfgates
    from k8s_gpu_hpa_tpu_torch.chaos.fuzz import render_fuzz_report, replay_artifact, run_fuzz

    replay = getattr(args, "replay", None)
    if replay:
        try:
            result = replay_artifact(replay)
        except (OSError, ValueError, KeyError) as e:
            print(f"simulate fuzz --replay: {e}")
            return 2
        if result["ok"]:
            print(
                f"scenario {result['name']}: reproduced bit-identically "
                f"({len(result['violations'])} recorded violation(s) "
                "fired again)"
            )
            return 0
        print(f"scenario {result['name']}: DID NOT REPRODUCE")
        print(f"  expected violations: {result['expected_violations']}")
        print(f"  got violations:      {result['violations']}")
        return 2
    budget = getattr(args, "budget", None) or perfgates.FUZZ_SMOKE_BUDGET
    seed = args.seed if args.seed is not None else perfgates.FUZZ_SMOKE_SEED
    report = run_fuzz(
        budget=budget,
        seed=seed,
        break_grace=getattr(args, "break_grace", False),
        out_dir=getattr(args, "fuzz_out", None),
    )
    print(render_fuzz_report(report))
    if not report["ok"]:
        return 2
    if report["failure"] is not None and not report["break_grace"]:
        return 1
    return 0


def _main_incident(args) -> int:
    """The ``incident`` scenario, which needs no manifest: the alert router
    armed over a canned chaos run (``--run`` storm, crunch or evacuate;
    ``--smoke`` picks the smoke evacuation), every page tied to its causes
    and the paging scored against the injected faults.  ``--json`` writes
    the result as canonical JSON, ``--why INC-00N`` prints one incident's
    causal chain.  Exit 2 on any violation of the paging contract (a fault
    never paged, a page with no attributable cause, a time-to-page over
    budget, an uninhibited duplicate page: ``--break-inhibition`` plants
    the last) and on an unknown run."""
    import json

    from k8s_gpu_hpa_tpu_torch.chaos.paging import (
        run_paging_crunch,
        run_paging_evacuation,
        run_paging_storm,
    )
    from k8s_gpu_hpa_tpu_torch.obs.incident import render_incident_report, render_incident_why

    smoke = getattr(args, "smoke", False)
    run = getattr(args, "run", None) or ("evacuate" if smoke else "storm")
    break_inhibition = getattr(args, "break_inhibition", False)
    if run == "storm":
        result = run_paging_storm(
            seed=getattr(args, "seed", None), break_inhibition=break_inhibition
        )
    elif run == "crunch":
        result = run_paging_crunch(break_inhibition=break_inhibition)
    elif run == "evacuate":
        result = run_paging_evacuation(break_inhibition=break_inhibition, smoke=smoke)
    else:
        print(f"simulate incident: unknown --run {run!r} (storm, crunch, evacuate)")
        return 2
    json_out = getattr(args, "json_out", None)
    if json_out:
        Path(json_out).write_text(
            json.dumps(result, sort_keys=True, separators=(",", ":")) + "\n",
            encoding="utf-8",
        )
    print(render_incident_report(result))
    why = getattr(args, "why", None)
    if why:
        print()
        print(render_incident_why(result, why))
    if result["violations"]:
        print()
        for v in result["violations"]:
            print(f"paging contract: {v}")
    return 0 if result["ok"] else 2


def _main_coverage(args) -> int:
    """The ``coverage`` scenario: a canned run under a CoverageMap, its
    scorecard and never-hit list; ``--json`` writes the canonical export,
    ``--diff`` compares two exports (exit 2 on any lost probe) and
    ``--floor`` gates the union ratio (exit 2 below it)."""
    import json

    from k8s_gpu_hpa_tpu_torch.obs import coverage as covmod
    from k8s_gpu_hpa_tpu_torch.perfgates import COVERAGE_UNION_FLOOR

    diff_paths = getattr(args, "diff", None)
    if diff_paths:
        if len(diff_paths) != 2:
            print(
                "simulate coverage --diff wants exactly two exports: "
                "BASELINE CANDIDATE"
            )
            return 2
        try:
            a = json.loads(Path(diff_paths[0]).read_text())
            b = json.loads(Path(diff_paths[1]).read_text())
        except (OSError, ValueError) as e:
            print(f"simulate coverage --diff: {e}")
            return 2
        diff = covmod.diff_exports(a, b)
        print(render_coverage_diff(diff))
        return 2 if diff["regression"] else 0

    run = getattr(args, "run", None) or "all"
    known = COVERAGE_RUN_NAMES + ("all",)
    if run not in known:
        print(
            f"simulate coverage: unknown run {run!r} — pick one of: "
            f"{', '.join(known)}"
        )
        return 2
    export = run_coverage(run=run, seed=getattr(args, "seed", None))
    print(covmod.render_scorecard(export))
    json_path = getattr(args, "json_out", None)
    if json_path:
        Path(json_path).write_text(
            json.dumps(export, sort_keys=True, separators=(",", ":")) + "\n"
        )
        print(f"wrote {json_path}")
    # the union floor gates the full union by default (a single run covers
    # less by design); --floor overrides either way
    floor = getattr(args, "floor", None)
    if floor is None and run == "all":
        floor = COVERAGE_UNION_FLOOR
    if floor is not None:
        union = covmod.export_union_ratio(export)
        if union < floor:
            print(
                f"COVERAGE FLOOR VIOLATED: union {union:.3f} < "
                f"declared floor {floor:.3f}"
            )
            return 2
        print(f"union {union:.3f} meets declared floor {floor:.3f}")
    return 0


def _main_profile(args) -> int:
    """The ``profile`` scenario: canned run(s) under a ProfileMap and the
    per-stage scorecard with its attribution; ``--json`` writes the timed
    export, ``--trace-out``/``--flame-out`` the Chrome trace and collapsed
    stacks, and ``--diff`` gates against a baseline (two paths: offline;
    one path: this run against it).  Exit 2 on a regression, an unknown
    run or stage, or an export that cannot be read."""
    import json

    from k8s_gpu_hpa_tpu_torch.control.profile_harness import PROFILE_RUNS, run_profile
    from k8s_gpu_hpa_tpu_torch.obs import profile as profmod

    diff_paths = getattr(args, "diff", None) or []
    if len(diff_paths) > 2:
        print(
            "simulate profile --diff wants one export (run, then diff "
            "this run against it) or two (diff offline)"
        )
        return 2
    if len(diff_paths) == 2:
        try:
            a = json.loads(Path(diff_paths[0]).read_text())
            b = json.loads(Path(diff_paths[1]).read_text())
        except (OSError, ValueError) as e:
            print(f"simulate profile --diff: {e}")
            return 2
        diff = profmod.diff_exports(a, b)
        print(profmod.render_profile_diff(diff))
        return 2 if diff["regression"] else 0

    run = getattr(args, "run", None) or "storm"
    known = PROFILE_RUNS + ("all",)
    if run not in known:
        print(
            f"simulate profile: unknown run {run!r} — pick one of: "
            f"{', '.join(known)}"
        )
        return 2
    if diff_paths and run == "all":
        print(
            "simulate profile: --diff with a single baseline needs a "
            "single --run (storm, crunch, or scale)"
        )
        return 2
    plant = None
    plant_arg = getattr(args, "plant", None)
    if plant_arg:
        stage_id, _, seconds = plant_arg.partition("=")
        try:
            plant = {stage_id: float(seconds)}
        except ValueError:
            print(
                f"simulate profile: --plant wants STAGE=SECONDS, "
                f"got {plant_arg!r}"
            )
            return 2
    try:
        records = run_profile(
            run=run,
            seed=getattr(args, "seed", None),
            smoke=bool(getattr(args, "smoke", False)),
            plant=plant,
        )
    except KeyError as e:
        print(f"simulate profile: {e.args[0]}")
        return 2
    for i, rec in enumerate(records):
        if i:
            print()
        print(profmod.render_scorecard(rec["timed"]))
    last = records[-1]
    json_path = getattr(args, "json_out", None)
    if json_path:
        Path(json_path).write_text(
            json.dumps(last["timed"], sort_keys=True, separators=(",", ":")) + "\n"
        )
        print(f"wrote {json_path}")
    trace_path = getattr(args, "trace_out", None)
    if trace_path:
        Path(trace_path).write_text(profmod.render_chrome_trace(last["pmap"]))
        print(f"wrote {trace_path} (chrome://tracing / Perfetto)")
    flame_path = getattr(args, "flame_out", None)
    if flame_path:
        Path(flame_path).write_text(
            profmod.render_collapsed(last["pmap"], last["wall_s"])
        )
        print(f"wrote {flame_path} (flamegraph.pl / speedscope)")
    if diff_paths:
        try:
            baseline = json.loads(Path(diff_paths[0]).read_text())
        except (OSError, ValueError) as e:
            print(f"simulate profile --diff: {e}")
            return 2
        diff = profmod.diff_exports(baseline, last["timed"])
        print()
        print(profmod.render_profile_diff(diff))
        return 2 if diff["regression"] else 0
    return 0


def main(args) -> int:
    """Run ``args.scenario`` on the manifest ``args.hpa`` and print the
    report.  Exit 2 with a one-line diagnosis for a manifest or scenario the
    simulator cannot play, and for ``--saturated-pct`` on an External HPA."""
    if args.scenario == "trace":
        return _main_trace(args)
    if args.scenario == "chaos":
        return _main_chaos(args)
    if args.scenario == "drill":
        return _main_drill(args)
    if args.scenario == "slo":
        result = run_slo_check(pod_start_latency=args.pod_start)
        print(render_slo_report(result))
        return 0 if result["ok"] else 2
    if args.scenario in ("history", "why"):
        return _main_history(args)
    if args.scenario == "crunch":
        from k8s_gpu_hpa_tpu_torch.chaos import render_crunch_report, run_capacity_crunch

        result = run_capacity_crunch(starvation_budget=getattr(args, "starvation_budget", None))
        print(render_crunch_report(result))
        return 0 if result["ok"] else 2
    if args.scenario == "evacuate":
        return _main_evacuate(args)
    if args.scenario == "fuzz":
        return _main_fuzz(args)
    if args.scenario == "incident":
        return _main_incident(args)
    if args.scenario == "races":
        from k8s_gpu_hpa_tpu_torch.control.race_harness import render_race_report, run_race_sweep

        result = run_race_sweep(
            schedules=getattr(args, "schedules", None),
            seed=args.seed if args.seed is not None else 0,
            break_ordering=getattr(args, "break_ordering", False),
        )
        print(render_race_report(result))
        return 0 if result["ok"] else 2
    if args.scenario == "coverage":
        return _main_coverage(args)
    if args.scenario == "profile":
        return _main_profile(args)
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
                shards=getattr(args, "shards", 0),
                explain=getattr(args, "explain", False),
            )
    except ValueError as e:
        # e.g. an External manifest with an Object-only scenario: a
        # diagnosis, not a traceback
        print(f"simulate: {e}")
        return 2
    print(render_report(report))
    _print_plans(report)
    return 0


def add_arguments(parser) -> None:
    """The ``simulate`` command's flags (``python -m k8s_gpu_hpa_tpu_torch
    simulate``)."""
    parser.add_argument("--hpa", default="deploy/tpu-test-hpa.yaml")
    parser.add_argument(
        "--scenario",
        choices=[*SCENARIOS, "trace", "chaos", "slo", "drill", "history", "why", "crunch",
                 "evacuate", "coverage", "profile", "fuzz", "incident", "races"],
        default="spike",
    )
    parser.add_argument("--duration", type=float, default=420.0)
    parser.add_argument(
        "--days",
        type=float,
        default=2.0,
        help="virtual days the history/why flight-recorder run covers",
    )
    parser.add_argument(
        "--event",
        type=int,
        default=None,
        help="scale-event span id for --scenario why (listed by history)",
    )
    parser.add_argument("--pod-start", type=float, default=12.0)
    parser.add_argument(
        "--saturated-pct",
        type=float,
        default=None,
        help="the workload's measured signal ceiling: caps the simulated "
        "per-pod gauge so an inert manifest/workload pairing (ceiling below "
        "target x 1.1) is diagnosed instead of simulated as healthy",
    )
    parser.add_argument(
        "--shards",
        type=int,
        default=0,
        help="run the scenario against a sharded scrape plane with N "
        "hash-ring scraper shards (0 = single scraper)",
    )
    parser.add_argument(
        "--explain",
        action="store_true",
        help="print the query planner's physical plan for every rule and "
        "alert the pipeline evaluates",
    )
    parser.add_argument(
        "--trace-out",
        default=None,
        help="JSONL span export path for --scenario trace (default "
        "trace.jsonl); for --scenario profile, write the run's Chrome "
        "trace_event JSON here (only when given)",
    )
    parser.add_argument(
        "--components",
        default=None,
        help="comma list of components --scenario drill restarts "
        "(tsdb,hpa,adapter,wal); default all",
    )
    parser.add_argument(
        "--starvation-budget",
        type=float,
        default=None,
        help="override every tenant's starvation budget (seconds) for "
        "--scenario crunch; 0 proves the contract can fail",
    )
    parser.add_argument(
        "--smoke",
        action="store_true",
        help="profile: shrink the 'scale' run to the smoke shape "
        "(perfgates.PROFILE_SCALE_SMOKE_*); evacuate: shorten the kill and "
        "the tail; incident: run the smoke evacuation drill",
    )
    parser.add_argument(
        "--no-spill",
        action="store_true",
        help="evacuate: disable cross-region spilling (the planted canary; "
        "must exit 2)",
    )
    parser.add_argument(
        "--why",
        default=None,
        metavar="TENANT|INC-00N",
        help="evacuate: print TENANT's cross-region decision chain after the "
        "run; incident: print incident INC-00N's causal chain as a "
        "postmortem timeline",
    )
    parser.add_argument(
        "--replay",
        default=None,
        metavar="SCENARIO_JSON",
        help="evacuate: run a committed scenario artifact (tests/scenarios/"
        "evac-*.json) again instead; fuzz: run a committed fuzz artifact "
        "(tests/scenarios/*.json but evac-*) again instead; exit 2 unless "
        "it reproduces bit-identically",
    )
    parser.add_argument(
        "--budget",
        type=int,
        default=None,
        help="fuzz: exploration cases the campaign runs "
        "(default perfgates.FUZZ_SMOKE_BUDGET)",
    )
    parser.add_argument(
        "--break-grace",
        action="store_true",
        help="fuzz: arm the canary that stretches the preemption eviction "
        "grace to forever, which shows the fuzzer finds and minimizes a "
        "real failure",
    )
    parser.add_argument(
        "--fuzz-out",
        default=None,
        metavar="DIR",
        help="fuzz: write the minimized failure's replayable artifact under DIR",
    )
    parser.add_argument(
        "--break-inhibition",
        action="store_true",
        help="incident: arm the canary that computes but does not apply "
        "inhibition: the warning-severity duplicates page with "
        "would_inhibit > 0 and the paging contract must fail (exit 2)",
    )
    parser.add_argument(
        "--run",
        default=None,
        help="which canned run --scenario coverage collects (storm, crunch, "
        "drill, slo, races, fuzz, profile, evacuate or incident; default all, "
        "their union), --scenario profile "
        "measures (storm, crunch, scale or all; default storm) or --scenario "
        "incident pages over (storm, crunch or evacuate; default storm)",
    )
    parser.add_argument(
        "--seed",
        type=int,
        default=None,
        help="schedule-variant seed of the storm (chaos/storm.py) for "
        "--scenario coverage, profile and incident; default the fixed canned "
        "timeline; --scenario fuzz: the campaign's seed (default "
        "perfgates.FUZZ_SMOKE_SEED); --scenario races: the schedules' seed "
        "(default 0)",
    )
    parser.add_argument(
        "--schedules",
        type=int,
        default=None,
        help="permuted completion schedules --scenario races sweeps "
        "(default perfgates.RACE_SWEEP_SCHEDULES)",
    )
    parser.add_argument(
        "--break-ordering",
        action="store_true",
        help="races: arm the test-only ordering canary that makes the merge "
        "schedule-dependent, which proves the harness can fail (exit 2)",
    )
    parser.add_argument(
        "--json",
        dest="json_out",
        default=None,
        metavar="PATH",
        help="write --scenario coverage's canonical CoverageMap export "
        "(bit-identical across same-seed runs), --scenario profile's "
        "timed ProfileMap export or --scenario incident's result as "
        "canonical JSON to PATH",
    )
    parser.add_argument(
        "--diff",
        nargs="+",
        default=None,
        metavar="EXPORT",
        help="coverage: diff two --json exports instead of running anything "
        "(exit 2 if the candidate lost any probe); profile: with two paths "
        "diff them offline, with one path run then diff this run against "
        "the baseline (exit 2 on a lost call path or a stage share "
        "regression)",
    )
    parser.add_argument(
        "--floor",
        type=float,
        default=None,
        help="fail (exit 2) when --scenario coverage's union hit ratio lands "
        "below this; default: the perfgates union floor for --run all, no "
        "floor for single runs",
    )
    parser.add_argument(
        "--plant",
        default=None,
        metavar="STAGE=SECONDS",
        help="profile: add SECONDS to every call of STAGE in the accounting "
        "(the regression canary for --diff; nothing sleeps)",
    )
    parser.add_argument(
        "--flame-out",
        default=None,
        metavar="PATH",
        help="profile: write the run's collapsed-stack rendering "
        "(flamegraph.pl / speedscope) to PATH",
    )
