"""Query planner: physical execution plans over the columnar TSDB.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/planner.py``.  Each joint below
is a ``planner_path:*`` coverage probe and each ``plan`` call a
``planner:plan`` profile stage (obs/).

``Expr.evaluate`` is the logical definition of every rule: correct, and
slow at fleet scale, since each evaluation re-resolves the matcher's series
set through the inverted index and a range read decodes whole Gorilla
chunks it only needs an aggregate of.  :class:`QueryPlanner` rewrites a
logical AST once into a physical plan (the same node shapes, the leaf reads
replaced), and rule evaluation runs the plan thereafter:

- **label-matcher pushdown** (:class:`PlannedSelect`): the matcher's series
  set is resolved once and cached on the plan, revalidated each evaluation
  against ``TimeSeriesDB.series_generation``, a per-name counter that moves
  only when a series is created or dropped, so the steady-state evaluation
  goes straight to the per-series last-point read.
- **rollup tier selection** (:class:`_PlannedAvgOverTime`): a range query
  whose window and ``at`` are both aligned to a downsampled rollup step
  (metrics/downsample.py) reads the coarsest such tier, bit-exact for
  avg/sum/count by the shared bucket fold, and falls back to finer tiers
  and then raw wherever a tier's coverage is incomplete, counted per tier
  in ``PlannerStats.rollup_reads``/``rollup_fallbacks``.
- **chunk-summary aggregation pushdown** (:class:`_PlannedAvgOverTime`): a
  sealed chunk wholly inside the query window contributes the ``(count,
  sum, min, max, nan_count)`` summary recorded at seal time instead of a
  decode; only the boundary chunks and the head decode, through the TSDB's
  decoded-window cache (``decode_cache_hits``).
- **bit-identical results**: the planned and the naive paths share their
  accumulation shapes (``TimeSeriesDB.range_avg`` for windows, the
  ``instant_vector`` loop for instant reads), so every planned vector equals
  the naive one float for float, in the same order, with the same read
  capture.  ``planner_selfcheck`` and the doctor's ``check_query_planner``
  hold the planner to that.

Plans are ASTs too (the planned nodes subclass their logical sources), so
``promql()``, ``input_names()`` and with them the incremental skip work
unchanged.  An unknown node type passes through and evaluates naively.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from k8s_gpu_hpa_tpu_torch.metrics.downsample import tier_label as _tier_label
from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    Absent,
    Aggregate,
    AggregateBy,
    AndOn,
    Avg,
    AvgOverTime,
    BurnRate,
    Cmp,
    Expr,
    HistogramQuantile,
    MaxBy,
    MulOnGroupLeft,
    Ratio,
    RecordingRule,
    Select,
    Vector,
)
from k8s_gpu_hpa_tpu_torch.obs import coverage, profile


@dataclass
class PlannerStats:
    """Counters the self-metrics exporter and the doctor probe read.

    ``fastpath``/``fallback`` count *chunks* on planned range reads: served
    from the seal-time summary without decode vs decoded (window boundary or
    head).  ``series_cache_hits``/``series_resolves`` count per-eval series
    set validations: revalidated-from-cache vs re-resolved through the
    inverted index.

    Rollup tiers (metrics/downsample.py): ``rollup_reads`` counts range
    queries served per tier label (``{"1h": 3, ...}``),
    ``rollup_fallbacks`` counts tier-eligible queries that fell back to raw
    (a coverage hole), and ``rollup_fastpath``/``rollup_fallback`` mirror
    the chunk counters at rollup-chunk granularity (seal summary served
    against decoded)."""

    fastpath: int = 0
    fallback: int = 0
    series_cache_hits: int = 0
    series_resolves: int = 0
    plans_built: int = 0
    rollup_reads: dict = field(default_factory=dict)
    rollup_fallbacks: int = 0
    rollup_fastpath: int = 0
    rollup_fallback: int = 0


class PlannedSelect(Select):
    """Physical instant-vector scan: cached series set + the same
    per-series loop ``instant_vector`` runs (last-point scalars, historical
    ``searchsorted``, NaN staleness, lookback, capture) — bit-identical
    output in the identical order, minus the per-eval index resolution."""

    def __init__(self, src: Select, stats: PlannerStats):
        super().__init__(src.name, dict(src.matchers))
        self._stats = stats
        #: per-member [member, series_list, generation]; parallel to the
        #: db's ``members`` (a federated view) or the single db itself
        self._cache: list[list] = []

    def evaluate(self, db, at: float | None = None) -> Vector:
        at = db.clock.now() if at is None else at
        members = getattr(db, "members", None)
        if members is None:
            members = (db,)
        cache = self._cache
        if len(cache) != len(members):
            cache[:] = [[None, (), -1] for _ in members]
        name = self.name
        matchers = self.matchers or None
        stats = self._stats
        out: Vector = []
        for idx, member in enumerate(members):
            entry = cache[idx]
            gen = member.series_generation(name)
            if entry[0] is not member or entry[2] != gen:
                # series set changed (create/GC) or the member was swapped
                # (restart_tsdb): re-resolve through the inverted index
                entry[0] = member
                entry[1] = member.series_for(name, matchers)
                entry[2] = gen
                stats.series_resolves += 1
                coverage.hit("planner_path:series_resolve")
            else:
                stats.series_cache_hits += 1
                coverage.hit("planner_path:series_cache_hit")
            if entry[1]:
                out.extend(member.latest_of(name, entry[1], at))
        return out


class _PlannedAvgOverTime(AvgOverTime):
    """Physical range aggregate: the chunk-summary pushdown of
    ``TimeSeriesDB.range_avg(use_summaries=True)``, preceded by rollup
    **tier selection**: a window and ``at`` both aligned to a rollup step
    (and no finer than it) read the coarsest such tier instead of raw,
    bit-exact by the shared bucket fold, falling to finer tiers and then
    raw where a tier cannot cover the query (``stats.rollup_fallbacks``)."""

    def __init__(self, src: AvgOverTime, stats: PlannerStats):
        super().__init__(src.name, src.window, dict(src.matchers))
        self._stats = stats

    def evaluate(self, db, at: float | None = None) -> Vector:
        stats = self._stats
        steps = getattr(db, "rollup_steps", ())
        if steps:
            at_v = db.clock.now() if at is None else at
            window = self.window
            eligible = False
            for step in reversed(steps):  # the coarsest aligned tier first
                if window < step or window % step != 0.0 or at_v % step != 0.0:
                    continue
                eligible = True
                vec = db.rollup_range_avg(
                    self.name, self.matchers, window, at_v, step, stats=stats
                )
                if vec is not None:
                    coverage.hit("planner_path:rollup_tier_read")
                    return vec
            if eligible:
                stats.rollup_fallbacks += 1
                coverage.hit("planner_path:rollup_fallback_raw")
            at = at_v
        return db.range_avg(
            self.name,
            self.matchers,
            self.window,
            at,
            use_summaries=True,
            stats=self._stats,
        )


class _PlannedHistogramQuantile(HistogramQuantile):
    """Quantile over a planned bucket scan (grouping shared with the naive
    node via ``HistogramQuantile._group``)."""

    def __init__(self, src: HistogramQuantile, stats: PlannerStats):
        super().__init__(src.q, src.name, dict(src.matchers))
        self._bucket = PlannedSelect(
            Select(src.name + "_bucket", dict(src.matchers)), stats
        )

    def evaluate(self, db, at: float | None = None) -> Vector:
        coverage.hit("planner_path:histogram_quantile")
        return self._group(self._bucket.evaluate(db, at))


class _PlannedBurnRate(BurnRate):
    """Burn rate whose two counter sums read through planned scans (the
    arithmetic stays in ``BurnRate.evaluate``; only ``_sum_at`` is swapped)."""

    def __init__(self, src: BurnRate, stats: PlannerStats):
        super().__init__(
            src.good_name,
            src.total_name,
            src.objective,
            src.window,
            dict(src.good_matchers),
            dict(src.total_matchers),
        )
        self._good = PlannedSelect(
            Select(src.good_name, dict(src.good_matchers)), stats
        )
        self._total = PlannedSelect(
            Select(src.total_name, dict(src.total_matchers)), stats
        )

    def _sum_at(self, db, name, matchers, at):
        coverage.hit("planner_path:burn_rate")
        sel = (
            self._good
            if name == self.good_name and matchers == self.good_matchers
            else self._total
        )
        vec = sel.evaluate(db, at)
        if not vec:
            return None
        return sum(s.value for s in vec)


class QueryPlanner:
    """Rewrites logical ASTs into physical plans and caches them per rule.

    One planner serves one DB view (a :class:`TimeSeriesDB` or the federated
    view) — its :class:`PlannerStats` aggregate across every plan it built.
    ``invalidate()`` drops all cached plans (the restart hook: a swapped DB
    is also caught per-eval by the member-identity check, so invalidation is
    belt-and-braces, not correctness-critical)."""

    def __init__(self, db=None, stats: PlannerStats | None = None):
        self.db = db
        self.stats = stats or PlannerStats()
        #: id(logical expr) -> (logical expr, plan); the strong ref on the
        #: logical expr keeps its id from being reused
        self._plans: dict[int, tuple[Expr, Expr]] = {}

    def plan(self, expr: Expr) -> Expr:
        with profile.stage("planner:plan"):
            cached = self._plans.get(id(expr))
            if cached is not None and cached[0] is expr:
                coverage.hit("planner_path:plan_cache_hit")
                return cached[1]
            plan = self._rewrite(expr)
            self._plans[id(expr)] = (expr, plan)
            self.stats.plans_built += 1
            coverage.hit("planner_path:plan_built")
            return plan

    def invalidate(self) -> None:
        self._plans.clear()

    def _rewrite(self, e: Expr) -> Expr:
        stats = self.stats
        if type(e) is Select:
            return PlannedSelect(e, stats)
        if type(e) is AvgOverTime:
            return _PlannedAvgOverTime(e, stats)
        if type(e) is HistogramQuantile:
            return _PlannedHistogramQuantile(e, stats)
        if type(e) is BurnRate:
            return _PlannedBurnRate(e, stats)
        r = self._rewrite
        if type(e) is Avg:
            return Avg(r(e.child))
        if type(e) is Aggregate:
            return Aggregate(e.op, r(e.child))
        if type(e) is AggregateBy:
            return AggregateBy(e.op, e.keys, r(e.child))
        if type(e) is MaxBy:
            return MaxBy(e.keys, r(e.child))
        if type(e) is MulOnGroupLeft:
            return MulOnGroupLeft(r(e.left), r(e.right), e.on, e.group_left)
        if type(e) is Ratio:
            return Ratio(r(e.left), r(e.right))
        if type(e) is AndOn:
            return AndOn(r(e.left), r(e.right))
        if type(e) is Cmp:
            return Cmp(r(e.child), e.op, e.threshold)
        if type(e) is Absent:
            return Absent(r(e.child))
        # unknown node: evaluate naively — the planner never guesses
        return e

    # -- introspection --------------------------------------------------------

    def explain(self, expr: Expr) -> str:
        """Render the physical plan as an indented tree (``simulate
        --explain``).  Leaf annotations say which fast paths apply."""
        lines: list[str] = []

        def walk(node: Expr, depth: int) -> None:
            pad = "  " * depth
            if isinstance(node, PlannedSelect):
                lines.append(
                    f"{pad}IndexScan {node.promql()}"
                    "  [series-set cache (gen-validated) + last-point fast path]"
                )
            elif isinstance(node, _PlannedAvgOverTime):
                steps = getattr(self.db, "rollup_steps", ())
                tiers = (
                    "tier selection over "
                    + "/".join(_tier_label(s) for s in reversed(steps))
                    + " rollups, then "
                    if steps
                    else ""
                )
                lines.append(
                    f"{pad}RangeAgg avg_over_time[{int(node.window)}s] "
                    f"{Select(node.name, node.matchers).promql()}"
                    f"  [{tiers}chunk-summary pushdown; boundary chunks via"
                    " decode cache]"
                )
            elif isinstance(node, _PlannedHistogramQuantile):
                lines.append(f"{pad}HistogramQuantile q={node.q:g}")
                walk(node._bucket, depth + 1)
            elif isinstance(node, _PlannedBurnRate):
                lines.append(
                    f"{pad}BurnRate objective={node.objective:g} "
                    f"window={int(node.window)}s  [two planned sums x two instants]"
                )
                walk(node._good, depth + 1)
                walk(node._total, depth + 1)
            elif isinstance(node, Select):
                lines.append(f"{pad}Scan {node.promql()}  [naive]")
            else:
                label = type(node).__name__
                if isinstance(node, (Aggregate, AggregateBy)):
                    label += f" op={node.op}"
                if isinstance(node, (MaxBy, AggregateBy)):
                    label += f" by({','.join(node.keys)})"
                if isinstance(node, Cmp):
                    label += f" {node.op} {node.threshold:g}"
                if isinstance(node, MulOnGroupLeft):
                    label += (
                        f" on({','.join(node.on)})"
                        f" group_left({','.join(node.group_left)})"
                    )
                lines.append(f"{pad}{label}")
                for attr in ("child", "left", "right"):
                    sub = getattr(node, attr, None)
                    if isinstance(sub, Expr):
                        walk(sub, depth + 1)

        walk(self.plan(expr), 0)
        return "\n".join(lines)


def planner_selfcheck(
    db, rules: list[RecordingRule], planner: QueryPlanner | None = None
) -> dict:
    """Evaluate every rule both ways against the live DB and report
    agreement plus the planner's pushdown counters — the payload the doctor
    ``check_query_planner`` probe asserts on (bit-identical vectors, nonzero
    fast-path activity)."""
    planner = planner or QueryPlanner(db)
    at = db.clock.now()
    out_rules = []
    all_agree = True
    for rule in rules:
        naive = rule.expr.evaluate(db, at)
        planned = planner.plan(rule.expr).evaluate(db, at)
        agree = len(naive) == len(planned) and all(
            a.value == b.value and a.labels == b.labels
            or (a.value != a.value and b.value != b.value and a.labels == b.labels)
            for a, b in zip(naive, planned)
        )
        all_agree = all_agree and agree
        out_rules.append(
            {
                "record": rule.record,
                "agree": agree,
                "planned_samples": len(planned),
                "naive_samples": len(naive),
            }
        )
    s = planner.stats
    return {
        "rules": out_rules,
        "agree_all": all_agree,
        "fastpath": s.fastpath,
        "fallback": s.fallback,
        "series_cache_hits": s.series_cache_hits,
        "series_resolves": s.series_resolves,
        "plans_built": s.plans_built,
        "rollup_reads": dict(s.rollup_reads),
        "rollup_fallbacks": s.rollup_fallbacks,
        "rollup_fastpath": s.rollup_fastpath,
        "rollup_fallback": s.rollup_fallback,
        "decode_cache_hits": getattr(db, "decode_cache_hits", 0),
        "decode_cache_misses": getattr(db, "decode_cache_misses", 0),
    }
