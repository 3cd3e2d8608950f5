"""Continuous profiling: per-stage wall-clock cost attribution.

Counterpart of ``k8s_gpu_hpa_tpu/obs/profile.py``: the cost side of the
telemetry whose path side is the coverage plane (obs/coverage.py).  A
:class:`Stage` names one instrumented joint (the scrape sweep, the TSDB
append block, rule evaluation planned or naive, the planner, the adapter
read, the HPA sync, a capacity placement, a WAL flush, a downsample
compaction, the scale harness's observation) and a :class:`ProfileMap`
accumulates, per *call path* (the stack of open stages root to leaf), call
counts plus self and cumulative wall seconds, as pprof does.

Rules (the coverage plane's):

- **Stage ids are stable.** ``domain:name`` strings declared once in the
  registry below, the JAX package's twelve.  Renaming one invalidates
  archived baselines: append, never mutate.
- **Zero config, zero cost when off.** Instrumented joints run
  ``with profile.stage("domain:name"):``; with no active map that is one
  global read and a shared null context manager.  The ``with`` form is
  also the exception-safety contract: a fault raising mid-stage (an
  ``adapter_blackout`` out of a scrape fetch) closes the span instead of
  leaking it open.
- **Structure is deterministic, timings are not.** ``export()`` is the
  canonical artifact (call paths, stages, counts, sorted keys, no
  timings) and is bit-identical for same-seed runs.  ``timed_export()``
  adds self and cumulative seconds and the attribution ratio: the
  scorecard, the ``--diff`` gate and the ``tpu_sim_profile_*`` families
  read that.
- **Wall clock only as a duration.** ``time.perf_counter`` measures the
  simulator itself and never lands on the virtual timeline.

Surfaced by ``python -m k8s_gpu_hpa_tpu_torch simulate --scenario
profile`` (scorecard, ``--json``/``--trace-out``/``--flame-out`` exports,
``--diff`` gate) and ``trial.profile_bench_rung`` (the attribution floor
against ``perfgates.PROFILE_*``).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass

from k8s_gpu_hpa_tpu_torch.obs import coverage

#: every stage domain, in scorecard order — one per instrumented layer
DOMAINS = (
    "scrape",
    "tsdb",
    "rules",
    "planner",
    "adapter",
    "hpa",
    "capacity",
    "wal",
    "downsample",
    "harness",
)

EXPORT_VERSION = 1

#: bounded raw span buffer for the Chrome trace export; past the cap the
#: aggregate (paths) keeps accumulating but raw events stop recording
TRACE_EVENT_CAP = 20000


@dataclass(frozen=True)
class Stage:
    """One named instrumented joint.  ``stage_id`` is ``domain:name`` —
    globally unique, stable across releases (profile baselines key on it)."""

    domain: str
    stage_id: str
    description: str


#: stage_id -> Stage, in declaration order
STAGES: dict[str, Stage] = {}


def stage_def(domain: str, name: str, description: str) -> str:
    """Declare one stage; returns its stable id (``domain:name``)."""
    if domain not in DOMAINS:
        raise ValueError(f"unknown stage domain {domain!r} (known: {DOMAINS})")
    stage_id = f"{domain}:{name}"
    if stage_id in STAGES:
        raise ValueError(f"duplicate stage id {stage_id!r}")
    STAGES[stage_id] = Stage(domain, stage_id, description)
    return stage_id


# ---- the registry ----------------------------------------------------------
#
# Declaration order groups by domain, roughly in pipeline order.  Every id
# below must have a ``profile.stage(...)`` bracket at a real joint; a
# bracket naming an id not below raises at record time.

stage_def("scrape", "sweep", "one Scraper.scrape_once sweep over due targets")
stage_def("tsdb", "append", "one target's families ingested into the TSDB")
stage_def("rules", "eval", "one RuleEvaluator.evaluate_once pass")
stage_def("rules", "eval_planned", "a rule evaluated through its physical plan")
stage_def("rules", "eval_fallback", "a rule evaluated by the naive walk")
stage_def("planner", "plan", "logical expression planned (cache hit or build)")
stage_def("adapter", "query", "one adapter instant read (planned or naive)")
stage_def("hpa", "sync", "one HPAController sync pass")
stage_def("capacity", "try_place", "one capacity-scheduler placement attempt")
stage_def("wal", "flush", "one WAL record written and flushed")
stage_def("downsample", "compact", "one sealed chunk folded into rollup tiers")
stage_def("harness", "observe", "scale-harness observation queries and walks")


def stage_ids() -> list[str]:
    """Every registered id, sorted (the canonical export order)."""
    return sorted(STAGES)


def stages_in_domain(domain: str) -> list[str]:
    return sorted(s.stage_id for s in STAGES.values() if s.domain == domain)


# ---- the per-run map -------------------------------------------------------


class ProfileMap:
    """Per-call-path cost accounting for one run.

    A call path is the tuple of open stage ids root→leaf at exit time;
    aggregating by path (not raw spans) bounds memory at the number of
    distinct nestings, not the number of calls.  ``plant`` maps stage_id
    to artificial extra seconds added per call at the accounting layer —
    the regression canary: a planted slowdown must trip the ``--diff``
    gate without any real sleep (sim purity forbids one)."""

    def __init__(
        self,
        run_label: str = "",
        plant: dict[str, float] | None = None,
        trace_cap: int = TRACE_EVENT_CAP,
    ):
        self.run_label = run_label
        self.plant = dict(plant or {})
        for stage_id in self.plant:
            if stage_id not in STAGES:
                raise KeyError(f"plant names unregistered stage {stage_id!r}")
        #: path tuple -> [count, self_s, cum_s]
        self._paths: dict[tuple[str, ...], list] = {}
        # stacks are per thread and the per-path accumulation is atomic,
        # so brackets may close on any thread (as in CoverageMap)
        self._lock = threading.Lock()
        self._tls = threading.local()
        #: bounded raw spans for the Chrome trace: (path, t0_s, dur_s, tid)
        self._events: list[tuple[tuple[str, ...], float, float, int]] = []
        self.events_dropped = 0
        self._trace_cap = trace_cap
        self._tids: dict[int, int] = {}
        self._epoch = time.perf_counter()

    # -- bracket entry/exit (driven by the module-level stage() spans) --------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _enter(self, stage_id: str) -> None:
        if stage_id not in STAGES:
            raise KeyError(
                f"profile bracket on unregistered stage {stage_id!r} — "
                "declare it in obs/profile.py"
            )
        # frame: [stage_id, start, child_s]
        self._stack().append([stage_id, time.perf_counter(), 0.0])

    def _exit(self, stage_id: str) -> None:
        stack = self._stack()
        if not stack or stack[-1][0] != stage_id:
            open_id = stack[-1][0] if stack else None
            raise RuntimeError(
                f"unbalanced profile bracket: exiting {stage_id!r} with "
                f"{open_id!r} open"
            )
        path = tuple(frame[0] for frame in stack)
        _, start, child_s = stack.pop()
        real = time.perf_counter() - start
        # planted canary seconds land only in THIS stage's accounting —
        # the parent's child accumulator sees real time, so a plant can't
        # push an enclosing stage's self time negative
        dur = real + self.plant.get(stage_id, 0.0)
        if stack:
            stack[-1][2] += real
        self_s = dur - child_s
        with self._lock:
            rec = self._paths.get(path)
            if rec is None:
                self._paths[path] = [1, self_s, dur]
            else:
                rec[0] += 1
                rec[1] += self_s
                rec[2] += dur
            if len(self._events) < self._trace_cap:
                tid = self._tids.setdefault(
                    threading.get_ident(), len(self._tids)
                )
                self._events.append((path, start - self._epoch, dur, tid))
            else:
                self.events_dropped += 1

    def open_spans(self) -> list[str]:
        """Stage ids still open on the CALLING thread — the balanced
        enter/exit property test reads this after a fault-storm run."""
        return [frame[0] for frame in self._stack()]

    # -- export / summary -----------------------------------------------------

    def export(self) -> dict:
        """The canonical structural export: call paths with stage, depth,
        and counts — NO timings, so two same-seed runs must produce
        bit-identical ``export_json()`` strings."""
        with self._lock:
            items = sorted(self._paths.items())
        paths = {
            ";".join(path): {
                "stage": path[-1],
                "domain": STAGES[path[-1]].domain,
                "depth": len(path),
                "count": rec[0],
            }
            for path, rec in items
        }
        return {
            "version": EXPORT_VERSION,
            "run": self.run_label,
            "stages": sorted({path[-1] for path, _ in items}),
            "paths": paths,
        }

    def export_json(self) -> str:
        return json.dumps(self.export(), sort_keys=True, separators=(",", ":"))

    def timed_export(self, wall_s: float) -> dict:
        """The structural export plus wall-clock accounting: per-path
        self/cum seconds, per-stage rollups, and the attribution ratio
        (attributed self seconds / measured wall seconds).  This is the
        scorecard/diff/baseline artifact — NOT bit-identical across runs."""
        export = self.export()
        with self._lock:
            items = sorted(self._paths.items())
        attributed = 0.0
        for path, rec in items:
            key = ";".join(path)
            export["paths"][key]["self_s"] = round(rec[1], 6)
            export["paths"][key]["cum_s"] = round(rec[2], 6)
            attributed += rec[1]
        export["wall_s"] = round(wall_s, 6)
        export["attributed_s"] = round(attributed, 6)
        export["attribution"] = (
            round(attributed / wall_s, 4) if wall_s > 0 else 0.0
        )
        export["unattributed_s"] = round(max(0.0, wall_s - attributed), 6)
        return export


# ---- the active map (what instrumented brackets talk to) -------------------

_ACTIVE: ProfileMap | None = None


class _NullSpan:
    """The shared off-switch: entering/exiting does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_pmap", "_stage_id")

    def __init__(self, pmap: ProfileMap, stage_id: str):
        self._pmap = pmap
        self._stage_id = stage_id

    def __enter__(self):
        self._pmap._enter(self._stage_id)
        return None

    def __exit__(self, exc_type, exc, tb):
        # runs on BOTH the clean and the exceptional exit — a chaos fault
        # raising mid-stage closes its span instead of leaking it
        self._pmap._exit(self._stage_id)
        return False


def stage(stage_id: str):
    """The instrumentation bracket: ``with profile.stage("scrape:sweep"):``.
    With no active map this returns one shared null context manager —
    one global read, zero allocation."""
    pmap = _ACTIVE
    if pmap is None:
        return _NULL_SPAN
    return _Span(pmap, stage_id)


def activate(pmap: ProfileMap) -> ProfileMap:
    global _ACTIVE
    _ACTIVE = pmap
    return pmap


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> ProfileMap | None:
    return _ACTIVE


class _Collect:
    """``with profile.collect("storm") as pmap:`` — activate a fresh map
    for the block, always deactivate on exit (even when the block raises)."""

    __slots__ = ("_pmap",)

    def __init__(self, run_label: str = "", plant: dict | None = None):
        self._pmap = ProfileMap(run_label, plant=plant)

    def __enter__(self) -> ProfileMap:
        return activate(self._pmap)

    def __exit__(self, exc_type, exc, tb):
        deactivate()
        return False


def collect(run_label: str = "", plant: dict | None = None) -> _Collect:
    return _Collect(run_label, plant=plant)


# ---- attribution + diff gates ----------------------------------------------


def check_attribution(timed: dict, floor: float) -> bool:
    """True iff the timed export attributes at least ``floor`` of the
    measured wall time to named stages; trips the coverage probe on the
    unattributed-bucket overflow so the gap is itself an observed path."""
    ok = timed.get("attribution", 0.0) >= floor
    if not ok:
        coverage.hit("profile:unattributed_overflow")
    return ok


def stage_rollup(timed: dict) -> dict[str, dict]:
    """Per-stage totals over every call path ending in that stage:
    ``{stage_id: {"calls", "self_s", "cum_s"}}``."""
    rollup: dict[str, dict] = {}
    for key, rec in timed.get("paths", {}).items():
        sid = rec["stage"]
        agg = rollup.setdefault(sid, {"calls": 0, "self_s": 0.0, "cum_s": 0.0})
        agg["calls"] += rec["count"]
        agg["self_s"] += rec.get("self_s", 0.0)
        agg["cum_s"] += rec.get("cum_s", 0.0)
    for agg in rollup.values():
        agg["self_s"] = round(agg["self_s"], 6)
        agg["cum_s"] = round(agg["cum_s"], 6)
    return rollup


def stage_shares(timed: dict) -> dict[str, float]:
    """Each stage's share of the export's total attributed self time."""
    rollup = stage_rollup(timed)
    total = sum(agg["self_s"] for agg in rollup.values())
    if total <= 0:
        return {sid: 0.0 for sid in rollup}
    return {sid: agg["self_s"] / total for sid, agg in rollup.items()}


def diff_exports(
    a: dict,
    b: dict,
    share_tolerance: float | None = None,
    min_self_s: float | None = None,
) -> dict:
    """Compare two timed exports (``a`` = baseline, ``b`` = candidate).

    Two regression conditions, both machine-portable by construction:

    - **lost paths**: a call path the baseline exercised is absent from
      the candidate — structure is seed-deterministic, so a lost path
      means the run genuinely stopped taking that joint;
    - **share regressions**: a stage's share of attributed self time grew
      past the baseline share by more than ``share_tolerance`` (absolute
      share points — shares, not seconds, so a uniformly slower machine
      cancels out), counted only for stages whose candidate self time
      clears ``min_self_s`` (sub-millisecond stages are all jitter).

    Defaults come from perfgates (PROFILE_DIFF_*)."""
    if share_tolerance is None or min_self_s is None:
        from k8s_gpu_hpa_tpu_torch import perfgates

        if share_tolerance is None:
            share_tolerance = perfgates.PROFILE_DIFF_SHARE_TOLERANCE
        if min_self_s is None:
            min_self_s = perfgates.PROFILE_DIFF_MIN_SELF_S
    a_paths = set(a.get("paths", {}))
    b_paths = set(b.get("paths", {}))
    lost = sorted(a_paths - b_paths)
    gained = sorted(b_paths - a_paths)
    a_share = stage_shares(a)
    b_share = stage_shares(b)
    b_rollup = stage_rollup(b)
    regressions = []
    for sid in sorted(b_share):
        delta = b_share[sid] - a_share.get(sid, 0.0)
        if delta <= share_tolerance:
            continue
        if b_rollup[sid]["self_s"] < min_self_s:
            continue
        regressions.append(
            {
                "stage": sid,
                "baseline_share": round(a_share.get(sid, 0.0), 4),
                "candidate_share": round(b_share[sid], 4),
                "delta": round(delta, 4),
            }
        )
    regression = bool(lost or regressions)
    if regression:
        coverage.hit("profile:diff_regression")
    return {
        "lost": lost,
        "gained": gained,
        "share_regressions": regressions,
        "share_tolerance": share_tolerance,
        "regression": regression,
    }


# ---- scorecard / diff rendering --------------------------------------------


def render_scorecard(timed: dict) -> str:
    """The per-stage table ``simulate profile`` prints: calls, self and
    cumulative seconds, and % of attributed self time, hottest first."""
    rollup = stage_rollup(timed)
    shares = stage_shares(timed)
    lines = [
        f"profile scorecard — run: {timed.get('run') or '(unlabeled)'}",
        f"{'stage':<22} {'calls':>8} {'self_s':>9} {'cum_s':>9} {'self%':>7}",
    ]
    for sid in sorted(rollup, key=lambda s: (-rollup[s]["self_s"], s)):
        agg = rollup[sid]
        lines.append(
            f"{sid:<22} {agg['calls']:>8} {agg['self_s']:>9.4f} "
            f"{agg['cum_s']:>9.4f} {shares.get(sid, 0.0):>6.1%}"
        )
    wall = timed.get("wall_s", 0.0)
    lines.append(
        f"attributed {timed.get('attribution', 0.0):.1%} of wall "
        f"{wall:.3f}s (unattributed {timed.get('unattributed_s', 0.0):.3f}s)"
    )
    return "\n".join(lines)


def render_profile_diff(diff: dict) -> str:
    """The diff report the ``--diff`` gate prints."""
    lines = [
        f"lost paths ({len(diff['lost'])}):",
        *(f"  {p}" for p in diff["lost"]),
        f"gained paths ({len(diff['gained'])}):",
        *(f"  {p}" for p in diff["gained"]),
        f"share regressions ({len(diff['share_regressions'])}) "
        f"[tolerance {diff['share_tolerance']:.2f}]:",
        *(
            f"  {r['stage']}: {r['baseline_share']:.1%} -> "
            f"{r['candidate_share']:.1%} (+{r['delta']:.1%})"
            for r in diff["share_regressions"]
        ),
        "verdict: "
        + ("PROFILE REGRESSION" if diff["regression"] else "OK"),
    ]
    return "\n".join(lines)


# ---- exporters -------------------------------------------------------------


def render_chrome_trace(pmap: ProfileMap) -> str:
    """Chrome ``trace_event`` JSON (load in chrome://tracing / Perfetto):
    one complete ("ph": "X") event per recorded span.  Event *structure*
    (name/cat/pid/tid order) is seed-deterministic; ts/dur are wall."""
    coverage.hit("profile:export_trace")
    with pmap._lock:
        events = list(pmap._events)
    trace = [
        {
            "name": path[-1],
            "cat": STAGES[path[-1]].domain,
            "ph": "X",
            "ts": round(t0 * 1e6, 1),
            "dur": round(dur * 1e6, 1),
            "pid": 1,
            "tid": tid,
            "args": {"path": ";".join(path)},
        }
        for path, t0, dur, tid in events
    ]
    return json.dumps(
        {
            "traceEvents": trace,
            "displayTimeUnit": "ms",
            "otherData": {
                "run": pmap.run_label,
                "events_dropped": pmap.events_dropped,
            },
        }
    )


def render_collapsed(pmap: ProfileMap, wall_s: float | None = None) -> str:
    """Collapsed-stack text (flamegraph.pl / speedscope compatible): one
    ``frame;frame;... <self_microseconds>`` line per call path, sorted —
    the line set (minus counts) is seed-deterministic."""
    coverage.hit("profile:export_flame")
    with pmap._lock:
        items = sorted(pmap._paths.items())
    lines = [
        f"{';'.join(path)} {max(0, int(rec[1] * 1e6))}" for path, rec in items
    ]
    if wall_s is not None:
        attributed = sum(rec[1] for _, rec in items)
        unattributed = max(0.0, wall_s - attributed)
        lines.append(f"(unattributed) {int(unattributed * 1e6)}")
    return "\n".join(lines) + "\n"


# ---- self-metric families (tpu_sim_profile_*) ------------------------------
#
# Name constants are single-sourced here, the JAX package's names.

#: attributed self seconds per stage in the exported run (gauge)
PROFILE_STAGE_SECONDS = "tpu_sim_profile_stage_seconds"
#: bracket entries per stage in the exported run (gauge)
PROFILE_STAGE_CALLS = "tpu_sim_profile_stage_calls"
#: attributed / measured wall seconds for the run (gauge, 0..1+)
PROFILE_ATTRIBUTION_RATIO = "tpu_sim_profile_attribution_ratio"

PROFILE_METRIC_NAMES = (
    PROFILE_STAGE_SECONDS,
    PROFILE_STAGE_CALLS,
    PROFILE_ATTRIBUTION_RATIO,
)


def profile_families(timed: dict):
    """Render a timed export as the ``tpu_sim_profile_*`` MetricFamily
    list (per-stage samples labeled ``stage=...``, the attribution ratio
    labeled ``run=...``)."""
    from k8s_gpu_hpa_tpu_torch.metrics.schema import MetricFamily

    seconds = MetricFamily(
        PROFILE_STAGE_SECONDS, "gauge", "attributed self seconds per stage"
    )
    calls = MetricFamily(
        PROFILE_STAGE_CALLS, "gauge", "profile bracket entries per stage"
    )
    ratio = MetricFamily(
        PROFILE_ATTRIBUTION_RATIO,
        "gauge",
        "attributed share of measured wall time",
    )
    rollup = stage_rollup(timed)
    for sid in sorted(rollup):
        seconds.add(float(rollup[sid]["self_s"]), stage=sid)
        calls.add(float(rollup[sid]["calls"]), stage=sid)
    ratio.add(
        float(timed.get("attribution", 0.0)),
        run=str(timed.get("run") or "(unlabeled)"),
    )
    return [seconds, calls, ratio]


def profile_exposition(timed: dict) -> str:
    """Prometheus text rendering of :func:`profile_families`."""
    from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text

    return encode_text(profile_families(timed))
