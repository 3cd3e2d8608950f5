"""Execution coverage: which decision paths a run exercised.

Counterpart of ``k8s_gpu_hpa_tpu/obs/coverage.py``, stdlib only.  A
:class:`Probe` names one decision path (an HPA sync outcome, a scheduler
branch, a planner fast or fallback path, a fault activation, an alert-state
transition, a WAL recovery path, a region joint) and a :class:`CoverageMap`
records, for one run, how often each probe fired, the clock time of its
first hit and the newest closed trace span at that moment.  The simulator
runs on a virtual clock with seeded randomness, so a map is replay-stable:
the same seed and schedule give a bit-identical export.

Rules:

- **Probe ids are stable.** ``domain:name`` strings, declared once in the
  registry below, with the JAX package's ids, descriptions and order.
  Renaming an id invalidates archived exports: append, never mutate.
- **Zero config at call sites.** Instrumented modules call
  ``coverage.hit("domain:name")`` (or ``hit_dynamic`` for registry-driven
  families such as the fault kinds); with no active map that is one global
  read and a ``None`` check, so the timed paths pay nothing when coverage
  is off.
- **Stdlib-only imports.** Every instrumented layer (metrics, control,
  chaos, obs) imports this module, so it imports none of them at the top.

The registry holds every probe of the JAX package, those whose call sites
belong to planes the port does not have yet (``concurrency:*``,
``fuzz:*``, ``alerting:*``) among them, because an export lists every
registered probe.  Surfaced by ``python -m k8s_gpu_hpa_tpu_torch simulate
--scenario coverage`` (scorecard, ``--json`` export, ``--diff`` run
comparison) and the ``tpu_sim_coverage_*`` self-metric families.
"""

from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from dataclasses import dataclass

#: every probe domain, in scorecard order
DOMAINS = (
    "hpa_condition",
    "scheduler_branch",
    "planner_path",
    "fault_kind",
    "alert_state",
    "recovery_path",
    "concurrency",
    "fuzz",
    "profile",
    "region",
    "alerting",
)

EXPORT_VERSION = 1


@dataclass(frozen=True)
class Probe:
    """One named decision path.  ``probe_id`` is ``domain:name`` — globally
    unique, stable across releases (the fuzzer's corpus keys on it)."""

    domain: str
    probe_id: str
    description: str


#: probe_id -> Probe, in declaration order
PROBES: dict[str, Probe] = {}


def probe(domain: str, name: str, description: str) -> str:
    """Declare one probe; returns its stable id (``domain:name``)."""
    if domain not in DOMAINS:
        raise ValueError(f"unknown probe domain {domain!r} (known: {DOMAINS})")
    probe_id = f"{domain}:{name}"
    if probe_id in PROBES:
        raise ValueError(f"duplicate probe id {probe_id!r}")
    PROBES[probe_id] = Probe(domain, probe_id, description)
    return probe_id


# ---- the registry ----------------------------------------------------------
#
# Declaration order groups by domain; within a domain, roughly by the order
# the code path runs.  The order is the JAX package's: exports sort by id,
# but the registry's order is part of what the tests hold equal.

# hpa_condition: every outcome one HPAController sync can reach
# (control/hpa.py), plus the capacity-economy standing conditions.
probe("hpa_condition", "sync_scale_up", "sync chose scale-up")
probe("hpa_condition", "sync_scale_down", "sync chose scale-down")
probe(
    "hpa_condition",
    "sync_within_tolerance",
    "sync held: within tolerance / stabilized",
)
probe(
    "hpa_condition",
    "sync_metrics_unavailable",
    "every metric unavailable; sync held (ScalingActive false)",
)
probe(
    "hpa_condition",
    "quantum_round",
    "slice quantum rounded the desired replica count",
)
probe(
    "hpa_condition",
    "repair_partial_slice",
    "sync repaired a stranded partial slice",
)
probe(
    "hpa_condition",
    "unschedulable",
    "Unschedulable condition went true: pods pending on pool capacity",
)
probe(
    "hpa_condition",
    "preempting",
    "Preempting condition went true: evictions running for the tenant",
)
probe(
    "hpa_condition",
    "fair_share_limited",
    "FairShareLimited condition went true: tenant over weighted share",
)
probe(
    "hpa_condition",
    "checkpoint_restored",
    "a rebuilt controller adopted sync-to-sync state from its checkpoint",
)

# scheduler_branch: the capacity economy's admission / fair-share /
# preemption / autoscaler joints (control/capacity.py).
probe("scheduler_branch", "admitted", "pending pod bound to pool capacity")
probe(
    "scheduler_branch",
    "readmitted",
    "previously evicted pod re-bound after requeue",
)
probe(
    "scheduler_branch",
    "fair_share_gate",
    "admission deferred: tenant over fair share while peers wait",
)
probe(
    "scheduler_branch",
    "preemption_eviction",
    "scheduler started evicting a lower-priority victim",
)
probe(
    "scheduler_branch",
    "eviction_requeued",
    "eviction grace expired; victim's pods requeued",
)
probe(
    "scheduler_branch",
    "provision_requested",
    "cluster-autoscaler asked for a new node",
)
probe(
    "scheduler_branch",
    "provision_backoff",
    "node provision failed; autoscaler backing off",
)
probe("scheduler_branch", "provision_done", "provisioned node joined the pool")
probe("scheduler_branch", "node_reaped", "idle autoscaled node reaped")

# planner_path: how queries are actually served (metrics/planner.py).
probe(
    "planner_path",
    "plan_built",
    "logical AST rewritten into a physical plan",
)
probe(
    "planner_path",
    "plan_cache_hit",
    "plan served from the per-rule plan cache",
)
probe(
    "planner_path",
    "series_resolve",
    "series set re-resolved through the inverted index",
)
probe(
    "planner_path",
    "series_cache_hit",
    "series set revalidated from the plan's generation cache",
)
probe(
    "planner_path",
    "rollup_tier_read",
    "range aggregate served from a downsampled rollup tier",
)
probe(
    "planner_path",
    "rollup_fallback_raw",
    "tier-eligible range aggregate fell back to the raw scan",
)
probe(
    "planner_path",
    "histogram_quantile",
    "histogram quantile evaluated through a planned bucket scan",
)
probe(
    "planner_path",
    "burn_rate",
    "SLO burn rate evaluated through planned counter scans",
)

# fault_kind: one probe per chaos injector.  Declared from this literal
# tuple (this module must not import chaos/); tests/test_torch_coverage.py
# asserts it matches chaos.faults.FAULT_KINDS.
FAULT_PROBE_KINDS = (
    "exporter_outage",
    "frozen_samples",
    "slow_scrape",
    "scrape_blackout",
    "node_preempt",
    "node_drain",
    "pod_crash",
    "crashloop",
    "adapter_blackout",
    "tsdb_restart",
    "hpa_restart",
    "adapter_restart",
    "wal_truncate",
    "tenant_spike",
    "provision_fail",
    "region_kill",
    "region_partition",
    "objstore_outage",
)
for _kind in FAULT_PROBE_KINDS:
    probe("fault_kind", _kind, f"chaos injector {_kind} armed")

# alert_state: the AlertRule state machine (metrics/rules.py) and the SLO
# recorder's evidence branches (obs/slo.py).
probe("alert_state", "pending", "alert rule entered pending")
probe("alert_state", "firing", "alert rule transitioned pending -> firing")
probe("alert_state", "resolved", "firing alert rule reset to inactive")
probe(
    "alert_state",
    "slo_seeded",
    "SLO recorder seeded its counter pair on first tick",
)
probe(
    "alert_state",
    "slo_gauge_no_evidence",
    "SLO recorder skipped a tick: gauge source absent",
)
probe(
    "alert_state",
    "slo_counter_missing",
    "SLO recorder skipped a tick: counter total missing",
)
probe(
    "alert_state",
    "slo_budget_recorded",
    "SLO recorder appended a good/total budget pair",
)

# recovery_path: durability joints — WAL replay/rotation (metrics/wal.py)
# and the controller checkpoint restore path driven by the chaos restarts.
probe(
    "recovery_path",
    "wal_replay_snapshot",
    "WAL read restored a snapshot then replayed the tail",
)
probe(
    "recovery_path",
    "wal_replay_cold",
    "WAL read replayed segments with no snapshot present",
)
probe(
    "recovery_path",
    "wal_torn_tail_dropped",
    "WAL read dropped a torn final record (crashed mid-append)",
)
probe(
    "recovery_path",
    "wal_corruption_detected",
    "WAL read raised WALCorruption on a damaged record",
)
probe("recovery_path", "wal_snapshot_written", "WAL compacted into a snapshot")
probe("recovery_path", "wal_segment_rotated", "WAL sealed a full segment")
probe(
    "recovery_path",
    "wal_tail_truncated",
    "chaos hook tore bytes off the live segment tail",
)
probe(
    "recovery_path",
    "pipeline_component_restarted",
    "a pipeline component was torn down and rebuilt mid-run",
)

# -- concurrency: thread-boundary joints + the race harness's schedule space.
# Registered for the export; their call sites come with the port's races
# plane and its shard-rules fan-out, as do the fuzz:* and alerting:* ones.
probe(
    "concurrency",
    "shard_rules_parallel",
    "shard rule evaluation fanned out on the ThreadPoolExecutor",
)
probe(
    "concurrency",
    "shard_rules_serial_fallback",
    "shard rule evaluation fell back to the serial loop (shared "
    "tracer/selfmetrics sink or parallelism disabled)",
)
probe(
    "concurrency",
    "race_schedule_serial",
    "race harness evaluated the serial reference schedule",
)
probe(
    "concurrency",
    "race_schedule_permuted",
    "race harness evaluated a seeded permuted completion schedule",
)
probe(
    "concurrency",
    "lockset_assert_armed",
    "race harness armed the instrumented lock over the inferred lockset",
)

# -- fuzz: the coverage-guided adversarial searcher's own loop joints
# (chaos/fuzz.py) — the fuzzer both CONSUMES this map (novelty steering)
# and is itself a probed decision path, so `simulate coverage --run fuzz`
# proves the search machinery end to end.
probe(
    "fuzz",
    "mutation_accepted",
    "fuzzer kept a mutated case (novel coverage or higher fitness)",
)
probe(
    "fuzz",
    "mutation_rejected",
    "fuzzer discarded a mutated case (nothing new, no fitness gain)",
)
probe(
    "fuzz",
    "minimizer_step",
    "delta-debugging minimizer re-ran a reduced candidate schedule",
)
probe(
    "fuzz",
    "corpus_replay",
    "a committed seed+schedule corpus artifact was replayed",
)

# -- profile: the continuous-profiling plane's own decision paths
# (obs/profile.py) — the profiler measures the sim, and its gates are
# themselves probed so `simulate coverage --run profile` proves the
# diff/attribution/export machinery end to end.
probe(
    "profile",
    "diff_regression",
    "profile --diff found a lost path or stage-share regression",
)
probe(
    "profile",
    "unattributed_overflow",
    "a run's unattributed time bucket exceeded the attribution floor",
)
probe(
    "profile",
    "export_trace",
    "Chrome trace_event JSON exporter rendered a profile",
)
probe(
    "profile",
    "export_flame",
    "collapsed-stack (flamegraph) exporter rendered a profile",
)

# -- region: the multi-region control plane's joints (control/region.py +
# metrics/global_query.py) — evacuation lifecycle, cross-region spill
# decisions, and the sealed-generation exchange through the object store.
probe(
    "region",
    "evacuation_started",
    "a region was killed mid-traffic; demand frozen for evacuation",
)
probe(
    "region",
    "evacuation_completed",
    "every frozen replica of a killed region is Running on mirrors",
)
probe(
    "region",
    "spill_admitted",
    "global scheduler spilled tenant replicas into a surviving region",
)
probe(
    "region",
    "spill_denied",
    "global scheduler could not place a spill (no capacity / disabled)",
)
probe(
    "region",
    "objstore_hit",
    "a sealed generation's blob fetched and validated from the store",
)
probe(
    "region",
    "objstore_miss",
    "a region had no readable sealed generation in the store",
)
probe(
    "region",
    "objstore_outage",
    "global refresh hit the store's outage window; served cached view",
)
probe(
    "region",
    "global_merge_sealed",
    "global query layer rebuilt the merged TSDB from sealed payloads",
)
probe(
    "region",
    "global_merge_fallback",
    "reader skipped a torn/unsealed generation and fell back to older",
)

# -- alerting: the incident-intelligence plane (obs/alerting.py +
# obs/incident.py) — router notification lifecycle, suppression paths, and
# the correlator's cause attribution edges.
probe(
    "alerting",
    "group_waiting",
    "a new aggregation group opened and is waiting out group_wait",
)
probe("alerting", "page_sent", "a group's first notification paged")
probe(
    "alerting",
    "update_sent",
    "an already-paged group's membership changed; one update sent",
)
probe(
    "alerting",
    "repeat_sent",
    "a still-firing group re-paged after repeat_interval of quiet",
)
probe(
    "alerting",
    "resolved_sent",
    "an empty paged group sent its resolved notification and expired",
)
probe(
    "alerting",
    "flap_coalesced",
    "a resolve→re-fire flap inside group_interval rode one update",
)
probe(
    "alerting",
    "silenced",
    "an alert instance matched an active silence and was dropped",
)
probe(
    "alerting",
    "inhibited",
    "a firing source alert suppressed a matching target instance",
)
probe(
    "alerting",
    "incident_opened",
    "the correlator opened an IncidentRecord for a page",
)
probe(
    "alerting",
    "incident_attributed",
    "an incident found at least one cause in the evidence window",
)
probe(
    "alerting",
    "incident_unattributed",
    "a page had NO attributable cause (the exit-2 contract path)",
)
probe(
    "alerting",
    "cause_fault_window",
    "an open chaos fault window attributed as an incident cause",
)
probe(
    "alerting",
    "cause_slo_burn",
    "an SLO burn-rate alert attributed as an incident cause",
)
probe(
    "alerting",
    "cause_scale_event",
    "a scale event in the window linked into the incident timeline",
)
probe(
    "alerting",
    "cause_capacity_denial",
    "a capacity-scheduler denial/preemption linked as a cause",
)
probe(
    "alerting",
    "cause_evacuation",
    "a region-evacuation decision linked as a cause",
)


def probe_ids() -> list[str]:
    """Every registered id, sorted (the canonical export order)."""
    return sorted(PROBES)


def probes_in_domain(domain: str) -> list[str]:
    return sorted(p.probe_id for p in PROBES.values() if p.domain == domain)


# ---- the per-run map -------------------------------------------------------


class CoverageMap:
    """Hit counts + first-hit provenance for one run (or one union of
    runs: ``simulate --scenario coverage`` drives several canned runs into
    one map).

    ``bind()`` attaches the clock/tracer of whatever pipeline is currently
    executing (AutoscalingPipeline binds the active map at construction),
    so first-hit timestamps are virtual seconds on that run's timeline and
    the first-hit span is the newest closed span at that instant."""

    def __init__(self, run_label: str = ""):
        self.run_label = run_label
        self.counts: dict[str, int] = {}
        self.first_hit_ts: dict[str, float | None] = {}
        self.first_hit_span: dict[str, int | None] = {}
        # record()'s check-then-set over three dicts must be atomic, or
        # first-hit provenance races when a probe fires from two threads
        self._lock = threading.Lock()
        self._clock = None
        self._tracer = None

    def bind(self, clock, tracer=None) -> None:
        self._clock = clock
        self._tracer = tracer

    def record(self, probe_id: str) -> None:
        if probe_id not in PROBES:
            raise KeyError(
                f"coverage hit on unregistered probe {probe_id!r} — declare "
                "it in obs/coverage.py"
            )
        with self._lock:
            count = self.counts.get(probe_id)
            if count is None:
                self.counts[probe_id] = 1
                self.first_hit_ts[probe_id] = (
                    None if self._clock is None else self._clock.now()
                )
                tracer = self._tracer
                spans = None if tracer is None else tracer.spans
                self.first_hit_span[probe_id] = (
                    spans[-1].span_id if spans else None
                )
            else:
                self.counts[probe_id] = count + 1

    # ---- export / summary --------------------------------------------------

    def export(self) -> dict:
        """The canonical export: every registered probe (hit or not), plus
        per-domain tallies.  Keys sort deterministically; two same-seed runs
        must produce bit-identical ``export_json()`` strings."""
        probes = {
            pid: {
                "count": self.counts.get(pid, 0),
                "first_hit_ts": self.first_hit_ts.get(pid),
                "first_hit_span": self.first_hit_span.get(pid),
            }
            for pid in probe_ids()
        }
        return {
            "version": EXPORT_VERSION,
            "run": self.run_label,
            "domains": {d: self.domain_summary(d) for d in DOMAINS},
            "probes": probes,
        }

    def export_json(self) -> str:
        return json.dumps(self.export(), sort_keys=True, separators=(",", ":"))

    def domain_summary(self, domain: str) -> dict:
        ids = probes_in_domain(domain)
        hit = sum(1 for pid in ids if self.counts.get(pid, 0) > 0)
        return {
            "registered": len(ids),
            "hit": hit,
            "ratio": (hit / len(ids)) if ids else 1.0,
        }

    def hit_count(self) -> int:
        return sum(1 for c in self.counts.values() if c > 0)

    def union_ratio(self) -> float:
        total = len(PROBES)
        return (self.hit_count() / total) if total else 1.0

    def never_hit(self) -> list[str]:
        """The gap list: registered probes this map never saw — the
        branches the future fuzzer steers toward."""
        return [pid for pid in probe_ids() if self.counts.get(pid, 0) == 0]


# ---- the active map (what instrumented call sites talk to) -----------------

_ACTIVE: CoverageMap | None = None


def activate(cmap: CoverageMap) -> CoverageMap:
    """Install ``cmap`` as the process-wide active map.  Instrumentation
    is a no-op until a map is active, so normal runs pay one global read
    per call site."""
    global _ACTIVE
    _ACTIVE = cmap
    return cmap


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> CoverageMap | None:
    return _ACTIVE


@contextmanager
def collect(run_label: str = ""):
    """``with coverage.collect("storm") as cmap: run_fault_storm()`` —
    activate a fresh map for the block, always deactivate on exit."""
    cmap = activate(CoverageMap(run_label))
    try:
        yield cmap
    finally:
        deactivate()


def bind_active(clock, tracer=None) -> None:
    """Bind the active map (if any) to a pipeline's clock/tracer —
    called by AutoscalingPipeline at construction."""
    if _ACTIVE is not None:
        _ACTIVE.bind(clock, tracer)


def hit(probe_id: str) -> None:
    """Record one hit on a statically-named probe.  Call sites pass a
    string literal."""
    if _ACTIVE is not None:
        _ACTIVE.record(probe_id)


def hit_dynamic(domain: str, name: str) -> None:
    """Record a hit on a registry-driven probe family (e.g. fault kinds,
    where the id comes from a data table, not a literal).  The ``domain``
    argument is still a literal at every call site."""
    if _ACTIVE is not None:
        _ACTIVE.record(f"{domain}:{name}")


# ---- export readers (for consumers holding a JSON export, not a map) -------


def export_union_ratio(export: dict) -> float:
    """hit probes / registered probes of an export dict."""
    probes = export.get("probes", {})
    if not probes:
        return 1.0
    return sum(1 for rec in probes.values() if rec["count"] > 0) / len(probes)


def export_never_hit(export: dict) -> list[str]:
    """Sorted never-hit probe ids of an export dict — the gap list."""
    return sorted(
        pid for pid, rec in export.get("probes", {}).items() if rec["count"] == 0
    )


# ---- run diffing -----------------------------------------------------------


def diff_exports(a: dict, b: dict) -> dict:
    """Compare two exports (``a`` = baseline, ``b`` = candidate):
    ``gained`` = probes only b hit, ``lost`` = probes only a hit,
    ``unchanged`` = hit by both or by neither.  ``regression`` is true
    when anything was lost — the CLI's exit-2 condition."""
    a_hit = {pid for pid, rec in a.get("probes", {}).items() if rec["count"] > 0}
    b_hit = {pid for pid, rec in b.get("probes", {}).items() if rec["count"] > 0}
    every = set(a.get("probes", {})) | set(b.get("probes", {}))
    gained = sorted(b_hit - a_hit)
    lost = sorted(a_hit - b_hit)
    return {
        "gained": gained,
        "lost": lost,
        "unchanged": sorted(every - set(gained) - set(lost)),
        "regression": bool(lost),
    }


# ---- scorecard rendering ---------------------------------------------------


def render_scorecard(export: dict) -> str:
    """The per-domain table ``simulate coverage`` prints."""
    lines = [
        f"coverage scorecard — run: {export.get('run') or '(unlabeled)'}",
        f"{'domain':<18} {'hit':>4} {'reg':>4} {'ratio':>7}",
    ]
    domains = export.get("domains", {})
    for domain in DOMAINS:
        d = domains.get(domain)
        if d is None:
            continue
        lines.append(
            f"{domain:<18} {d['hit']:>4} {d['registered']:>4} "
            f"{d['ratio']:>7.2f}"
        )
    probes = export.get("probes", {})
    hit_total = sum(1 for rec in probes.values() if rec["count"] > 0)
    total = len(probes)
    ratio = (hit_total / total) if total else 1.0
    lines.append(f"{'union':<18} {hit_total:>4} {total:>4} {ratio:>7.2f}")
    gaps = sorted(pid for pid, rec in probes.items() if rec["count"] == 0)
    if gaps:
        lines.append(f"never-hit probes ({len(gaps)}):")
        lines.extend(f"  {pid}" for pid in gaps)
    else:
        lines.append("never-hit probes: none")
    return "\n".join(lines)


# ---- self-metric families (tpu_sim_coverage_*) -----------------------------
#
# Name constants are single-sourced here, the JAX package's names, so a
# dashboard built for either package reads the same families.

#: probes registered per domain (gauge)
COVERAGE_PROBES_REGISTERED = "tpu_sim_coverage_probes_registered"
#: probes hit per domain in the exported run (gauge)
COVERAGE_PROBES_HIT = "tpu_sim_coverage_probes_hit"
#: per-domain hit ratio of the exported run (gauge, 0..1)
COVERAGE_HIT_RATIO = "tpu_sim_coverage_hit_ratio"

COVERAGE_METRIC_NAMES = (
    COVERAGE_PROBES_REGISTERED,
    COVERAGE_PROBES_HIT,
    COVERAGE_HIT_RATIO,
)


def coverage_families(export: dict):
    """Render an export as the ``tpu_sim_coverage_*`` MetricFamily list
    (one sample per domain, labeled ``domain=...``)."""
    from k8s_gpu_hpa_tpu_torch.metrics.schema import MetricFamily

    registered = MetricFamily(
        COVERAGE_PROBES_REGISTERED, "gauge", "coverage probes registered"
    )
    hit_fam = MetricFamily(
        COVERAGE_PROBES_HIT, "gauge", "coverage probes hit in the run"
    )
    ratio = MetricFamily(
        COVERAGE_HIT_RATIO, "gauge", "per-domain coverage hit ratio"
    )
    for domain in DOMAINS:
        d = export.get("domains", {}).get(domain)
        if d is None:
            continue
        registered.add(float(d["registered"]), domain=domain)
        hit_fam.add(float(d["hit"]), domain=domain)
        ratio.add(float(d["ratio"]), domain=domain)
    return [registered, hit_fam, ratio]


def coverage_exposition(export: dict) -> str:
    """Prometheus text rendering of :func:`coverage_families`."""
    from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text

    return encode_text(coverage_families(export))
