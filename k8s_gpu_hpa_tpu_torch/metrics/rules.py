"""Recording-rule engine: the aggregation layer (L3) that defines the autoscale
metric.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/rules.py``, cut to the expressions
and the rules the port's loops evaluate.  The reference's single recording
rule (cuda-test-prometheusrule.yaml:12-16) is the semantic heart of its
pipeline:

    record: cuda_test_gpu_avg
    expr: avg(
        max by(node,pod,namespace)(dcgm_gpu_utilization)
        * on(pod) group_left(label_app)
        max by(pod,label_app)(kube_pod_labels{label_app="cuda-test"})
    )
    labels: {namespace: default, deployment: cuda-test}

Three load-bearing tricks, all preserved here:
1. ``max by(pod)`` collapses multi-device pods to their hottest device;
2. the ``* on(pod) group_left`` inner-join against kube-state-metrics'
   ``kube_pod_labels`` scopes device metrics to one app;
3. the hard-coded ``namespace``/``deployment`` output labels are what lets
   the custom-metrics adapter address the series as an Object metric on the
   Deployment.

Rules are expression ASTs that (a) evaluate against the in-process TSDB and
(b) render the equivalent PromQL via ``promql()``, character for character
the JAX package's, from which ``manifests.py`` renders the PrometheusRule:
one source for the tested semantics and the shipped manifest.

Evaluation is incremental, as the JAX package's: a rule whose inputs saw no
write since its last full evaluation skips (``RecordingRule._can_skip``).
With a tracer a full evaluation emits a ``rule_eval`` span linked to the
spans that wrote the points it read.  ``BurnRate``, ``AndOn``, ``Cmp`` and
``AlertRule`` carry the SLO burn-rate alerts (obs/slo.py); ``Aggregate``
and ``Absent`` the pipeline's own health alerts (``shipped_alert_rules``,
which ``manifests.py`` renders into the PrometheusRule's
``tpu-pipeline-alerts`` group).  ``AggregateBy``, ``Ratio``,
``HistogramQuantile`` and ``AvgOverTime`` carry the sharded plane's
federated aggregates, the quantile reads and the range rules; the query
planner (metrics/planner.py) rewrites any of these trees into a physical
plan that ``RuleEvaluator(planner=)`` runs in its place, with bit-identical
results.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    TPU_DUTY_CYCLE,
    TPU_HBM_USAGE,
    TPU_TENSORCORE_UTIL,
    Sample,
)
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.obs import coverage, profile

Vector = list[Sample]


class Expr:
    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        raise NotImplementedError

    def promql(self) -> str:
        raise NotImplementedError

    def input_names(self) -> frozenset[str]:
        """Series names this expression reads: the names whose TSDB write
        versions incremental evaluation compares between evaluations."""
        raise NotImplementedError


@dataclass
class Select(Expr):
    """Instant vector selector: ``name{key="value",...}``."""

    name: str
    matchers: dict[str, str] = field(default_factory=dict)

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        return db.instant_vector(self.name, self.matchers, at)

    def input_names(self) -> frozenset[str]:
        return frozenset((self.name,))

    def promql(self) -> str:
        if not self.matchers:
            return self.name
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(self.matchers.items()))
        return f"{self.name}{{{inner}}}"


def _project(sample: Sample, keys: tuple[str, ...]) -> tuple[tuple[str, str], ...]:
    labels = dict(sample.labels)
    return tuple((k, labels[k]) for k in keys if k in labels)


@dataclass
class MaxBy(Expr):
    """``max by(k1,k2,...)(child)`` — collapse to max within each label group."""

    keys: tuple[str, ...]
    child: Expr

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        groups: dict[tuple[tuple[str, str], ...], float] = {}
        for sample in self.child.evaluate(db, at):
            key = _project(sample, self.keys)
            if key not in groups or sample.value > groups[key]:
                groups[key] = sample.value
        return [Sample(v, k) for k, v in groups.items()]

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        return f"max by({','.join(self.keys)})({self.child.promql()})"


@dataclass
class MulOnGroupLeft(Expr):
    """``left * on(k) group_left(extra...) right`` — the app-scoping inner join.

    For each left sample, find the right sample sharing the ``on`` label values
    (must be unique on the right, as in PromQL); emit left.value * right.value
    with the left label set plus the ``group_left`` labels copied from the right.
    Left samples with no right match are dropped (inner-join filtering — this is
    what removes pods not labeled with the target app).
    """

    left: Expr
    right: Expr
    on: tuple[str, ...]
    group_left: tuple[str, ...] = ()

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        right_index: dict[tuple[tuple[str, str], ...], Sample] = {}
        for sample in self.right.evaluate(db, at):
            key = _project(sample, self.on)
            if key in right_index:
                raise ValueError(
                    f"many-to-many match on {self.on}: duplicate right key {key}"
                )
            right_index[key] = sample
        out: Vector = []
        for sample in self.left.evaluate(db, at):
            match = right_index.get(_project(sample, self.on))
            if match is None:
                continue
            labels = dict(sample.labels)
            right_labels = dict(match.labels)
            for extra in self.group_left:
                if extra in right_labels:
                    labels[extra] = right_labels[extra]
            out.append(Sample(sample.value * match.value, tuple(sorted(labels.items()))))
        return out

    def input_names(self) -> frozenset[str]:
        return self.left.input_names() | self.right.input_names()

    def promql(self) -> str:
        gl = ",".join(self.group_left)
        return (
            f"{self.left.promql()} * on({','.join(self.on)}) "
            f"group_left({gl}) {self.right.promql()}"
        )


@dataclass
class Avg(Expr):
    """``avg(child)`` — collapse the whole vector to one unlabeled scalar sample."""

    child: Expr

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        vec = self.child.evaluate(db, at)
        if not vec:
            return []
        return [Sample(sum(s.value for s in vec) / len(vec), ())]

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        return f"avg({self.child.promql()})"


@dataclass
class Aggregate(Expr):
    """``min(child)``, ``max(child)``, ``sum(child)`` or ``count(child)``:
    the whole vector to one sample (``avg`` keeps its own node, as the
    shipped rules render it)."""

    op: str  # "min" | "max" | "sum" | "count"
    child: Expr

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        vec = self.child.evaluate(db, at)
        if not vec:
            return []
        values = [s.value for s in vec]
        fn = {"min": min, "max": max, "sum": sum, "count": len}[self.op]
        return [Sample(float(fn(values)), ())]

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        return f"{self.op}({self.child.promql()})"


@dataclass
class AggregateBy(Expr):
    """``sum by(k1,...)(child)``, ``count by(...)``, ``min by`` or ``avg
    by``: grouped aggregation keeping the projected label set (``max by``
    keeps its own :class:`MaxBy` node, as the shipped rules render it; the
    parser reads ``max by`` as MaxBy, never as this)."""

    op: str  # "sum" | "count" | "min" | "avg"
    keys: tuple[str, ...]
    child: Expr

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        groups: dict[tuple[tuple[str, str], ...], list[float]] = {}
        for sample in self.child.evaluate(db, at):
            groups.setdefault(_project(sample, self.keys), []).append(sample.value)
        out: Vector = []
        for key, values in groups.items():
            if self.op == "sum":
                value = sum(values)
            elif self.op == "count":
                value = float(len(values))
            elif self.op == "min":
                value = min(values)
            elif self.op == "avg":
                value = sum(values) / len(values)
            else:
                raise ValueError(f"unsupported grouped aggregation {self.op!r}")
            out.append(Sample(value, key))
        return out

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        return f"{self.op} by({','.join(self.keys)})({self.child.promql()})"


@dataclass
class Ratio(Expr):
    """``left / right`` over two scalar-producing expressions: the federated
    average, ``sum(per_shard_sums) / sum(per_shard_counts)``, which never
    re-scans the raw series the shards already reduced.  An empty operand or
    a zero denominator gives an empty vector (the output goes stale rather
    than record a division artifact)."""

    left: Expr
    right: Expr

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        num = self.left.evaluate(db, at)
        den = self.right.evaluate(db, at)
        if not num or not den or den[0].value == 0.0:
            return []
        return [Sample(num[0].value / den[0].value, ())]

    def input_names(self) -> frozenset[str]:
        return self.left.input_names() | self.right.input_names()

    def promql(self) -> str:
        return f"({self.left.promql()}) / ({self.right.promql()})"


@dataclass
class AndOn(Expr):
    """``left and on() right``: PromQL's set intersection with an empty
    match group, so left's samples survive if and only if right is
    non-empty ("condition A, while condition B holds somewhere")."""

    left: Expr
    right: Expr

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        if not self.right.evaluate(db, at):
            return []
        return self.left.evaluate(db, at)

    def input_names(self) -> frozenset[str]:
        return self.left.input_names() | self.right.input_names()

    def promql(self) -> str:
        return f"{self.left.promql()} and on() {self.right.promql()}"


@dataclass
class Cmp(Expr):
    """``child > threshold`` and the like, with PromQL's filter semantics:
    the samples that pass survive, the rest drop (an alert fires on a
    non-empty result)."""

    child: Expr
    op: str  # "<" | ">" | "<=" | ">=" | "==" | "!="
    threshold: float

    _OPS = {
        "<": lambda a, b: a < b,
        ">": lambda a, b: a > b,
        "<=": lambda a, b: a <= b,
        ">=": lambda a, b: a >= b,
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
    }

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        fn = self._OPS[self.op]
        return [s for s in self.child.evaluate(db, at) if fn(s.value, self.threshold)]

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        t = self.threshold
        rendered = str(int(t)) if t == int(t) else repr(t)
        return f"{self.child.promql()} {self.op} {rendered}"


@dataclass
class Absent(Expr):
    """``absent(child)``: one sample when the child is empty.  A broken
    joint stops producing; it does not produce zeros."""

    child: Expr

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        if self.child.evaluate(db, at):
            return []
        return [Sample(1.0, ())]

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        return f"absent({self.child.promql()})"


def bucket_quantile(buckets: list[tuple[float, float]], q: float) -> float | None:
    """Prometheus's ``histogram_quantile`` interpolation over one series'
    cumulative buckets.

    ``buckets`` is [(le, cumulative_count), ...] with the +Inf bucket; ``q``
    is in [0, 1].  Linear interpolation inside the bucket the rank lands in,
    with 0 as the first bucket's lower edge; a rank in +Inf returns the
    highest finite bound (the histogram resolves nothing beyond it).  None
    when the histogram is empty or has no +Inf bucket."""
    buckets = sorted(buckets)
    if not buckets or buckets[-1][0] != math.inf:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    q = min(1.0, max(0.0, q))
    rank = q * total
    prev_bound, prev_count = 0.0, 0.0
    for bound, count in buckets:
        # count > 0: q = 0 (rank 0) lands in the first non-empty bucket, the
        # one that holds the minimum
        if count >= rank and count > 0:
            if bound == math.inf:
                return buckets[-2][0] if len(buckets) > 1 else None
            in_bucket = count - prev_count
            if in_bucket <= 0:
                return bound
            return prev_bound + (bound - prev_bound) * (rank - prev_count) / in_bucket
        prev_bound, prev_count = bound, count
    return buckets[-2][0] if len(buckets) > 1 else None


@dataclass
class HistogramQuantile(Expr):
    """``histogram_quantile(q, name_bucket{matchers})``: each series'
    quantile estimate from its cumulative buckets.  Reads the ``_bucket``
    series of a histogram family, groups them by the label set less ``le``
    and interpolates in the bucket the rank lands in
    (``bucket_quantile``), so the error is bounded by that bucket's width."""

    q: float  # quantile in [0, 1]
    name: str  # the histogram's base name (no _bucket suffix)
    matchers: dict[str, str] = field(default_factory=dict)

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        return self._group(db.instant_vector(self.name + "_bucket", self.matchers, at))

    def _group(self, bucket_samples: Vector) -> Vector:
        """The grouping and interpolation over a bucket vector, shared with
        the planned scan (planner._PlannedHistogramQuantile)."""
        groups: dict[tuple[tuple[str, str], ...], list[tuple[float, float]]] = {}
        for sample in bucket_samples:
            le = None
            rest: list[tuple[str, str]] = []
            for k, v in sample.labels:
                if k == "le":
                    le = v
                else:
                    rest.append((k, v))
            if le is None:
                continue
            try:
                bound = math.inf if le == "+Inf" else float(le)
            except ValueError:
                continue
            groups.setdefault(tuple(rest), []).append((bound, sample.value))
        out: Vector = []
        for labels, buckets in groups.items():
            value = bucket_quantile(buckets, self.q)
            if value is not None:
                out.append(Sample(value, labels))
        return out

    def input_names(self) -> frozenset[str]:
        return frozenset((self.name + "_bucket",))

    def promql(self) -> str:
        inner = Select(self.name + "_bucket", dict(self.matchers))
        q = self.q
        rendered = str(int(q)) if q == int(q) else repr(q)
        return f"histogram_quantile({rendered}, {inner.promql()})"


def _fmt_window(seconds: float) -> str:
    """PromQL's range duration: 3600 -> ``1h``, 300 -> ``5m``."""
    s = int(seconds)
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


@dataclass
class AvgOverTime(Expr):
    """``avg_over_time(name{matchers}[window])``: each series' mean over the
    trailing window, NaN staleness markers excluded (they are not samples).
    Evaluation is :meth:`TimeSeriesDB.range_avg`, the one windowed read both
    paths share: this node decodes every chunk it touches, and the planner
    calls the same method with the chunk-summary pushdown, bit for bit."""

    name: str
    window: float  # seconds
    matchers: dict[str, str] = field(default_factory=dict)

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        return db.range_avg(self.name, self.matchers, self.window, at)

    def input_names(self) -> frozenset[str]:
        return frozenset((self.name,))

    def promql(self) -> str:
        inner = Select(self.name, dict(self.matchers))
        return f"avg_over_time({inner.promql()}[{_fmt_window(self.window)}])"


@dataclass
class BurnRate(Expr):
    """An SLO's error-budget burn rate over a trailing window (SRE Workbook).

    ``burn = ((total_inc - good_inc) / total_inc) / (1 - objective)``, the
    increases being counter deltas over ``window`` seconds, read as two
    instant queries (now and now - window) summed over the matching series.
    A burn of 1.0 spends the budget exactly at the objective.  The result
    is empty, so an alert on it cannot fire, when the total counter is
    absent or did not move in the window (no traffic is no evidence of a
    burn); a counter reset is clamped to zero."""

    good_name: str
    total_name: str
    objective: float  # e.g. 0.99
    window: float  # seconds
    good_matchers: dict[str, str] = field(default_factory=dict)
    total_matchers: dict[str, str] = field(default_factory=dict)

    def _sum_at(
        self, db: TimeSeriesDB, name: str, matchers: dict[str, str], at: float
    ) -> float | None:
        vec = db.instant_vector(name, matchers, at)
        if not vec:
            return None
        return sum(s.value for s in vec)

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        at = db.clock.now() if at is None else at
        total_now = self._sum_at(db, self.total_name, self.total_matchers, at)
        if total_now is None:
            return []
        good_now = self._sum_at(db, self.good_name, self.good_matchers, at) or 0.0
        then = at - self.window
        # before the counters existed (a run younger than the window) the
        # trailing read is empty, read as 0: the increase since the start
        total_then = self._sum_at(db, self.total_name, self.total_matchers, then) or 0.0
        good_then = self._sum_at(db, self.good_name, self.good_matchers, then) or 0.0
        total_inc = max(0.0, total_now - total_then)  # reset clamp
        if total_inc <= 0:
            return []
        good_inc = min(total_inc, max(0.0, good_now - good_then))
        error_ratio = (total_inc - good_inc) / total_inc
        burn = error_ratio / (1.0 - self.objective)
        return [Sample(burn, ())]

    def input_names(self) -> frozenset[str]:
        return frozenset((self.good_name, self.total_name))

    def promql(self) -> str:
        w = _fmt_window(self.window)
        good = Select(self.good_name, dict(self.good_matchers)).promql()
        total = Select(self.total_name, dict(self.total_matchers)).promql()
        budget = 1.0 - self.objective
        return (
            f"(1 - (increase({good}[{w}]) / increase({total}[{w}])))"
            f" / {budget:g}"
        )


@dataclass
class AlertRule:
    """One ``alert:`` rule with Prometheus's ``for:`` semantics: the
    expression must stay non-empty for ``for_seconds`` before the alert
    moves from pending to firing; one empty evaluation resets it."""

    alert: str
    expr: Expr
    for_seconds: float = 0.0
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    _pending_since: float | None = field(default=None, repr=False)
    firing: bool = field(default=False, repr=False)
    #: clock time of the move to firing, None while not firing
    firing_since: float | None = field(default=None, repr=False)

    def evaluate(
        self, db: TimeSeriesDB, at: float | None = None, plan: Expr | None = None
    ) -> bool:
        """One evaluation; ``plan`` (the planner's physical plan of
        ``expr``) runs in the expression's place."""
        now = db.clock.now() if at is None else at
        if not (self.expr if plan is None else plan).evaluate(db, at):
            if self.firing:
                coverage.hit("alert_state:resolved")
            self._pending_since = None
            self.firing = False
            self.firing_since = None
            return False
        if self._pending_since is None:
            self._pending_since = now
            coverage.hit("alert_state:pending")
        was_firing = self.firing
        self.firing = now - self._pending_since >= self.for_seconds
        if self.firing and not was_firing:
            self.firing_since = now
            coverage.hit("alert_state:firing")
        return self.firing


@dataclass
class RecordingRule:
    """``record:`` output series name, expression, and static output labels.

    Evaluation is incremental: each full evaluation records the write
    versions of its input names, and a later one skips when nothing it could
    read has changed (``_can_skip`` has the conditions), so a rule whose
    inputs update more slowly than it evaluates costs a few integer
    compares a tick."""

    record: str
    expr: Expr
    labels: dict[str, str] = field(default_factory=dict)
    _last_keys: set[tuple[tuple[str, str], ...]] = field(default_factory=set, repr=False)
    #: incremental state: the input names, their versions and the time of
    #: the last full evaluation, and the age extremes of the points it read
    _input_names: tuple[str, ...] | None = field(default=None, repr=False)
    _last_sig: tuple[int, ...] | None = field(default=None, repr=False)
    _last_eval_ts: float = field(default=-math.inf, repr=False)
    _last_oldest_read: float | None = field(default=None, repr=False)
    _last_newest_read: float | None = field(default=None, repr=False)
    full_evals: int = field(default=0, repr=False)
    skipped_evals: int = field(default=0, repr=False)

    def _can_skip(self, db: TimeSeriesDB, ts: float, sig: tuple[int, ...]) -> bool:
        """A skipped evaluation must be invisible to every reader at
        ``>= ts``.  Three hazards forbid it:

        - **dirty inputs**: any write to an input name (staleness markers
          too) can change the result;
        - **refresh horizon**: a full evaluation rewrites the outputs at
          ``ts``; idling past half the lookback forces one, so outputs never
          drift toward the lookback's edge;
        - **aging inputs**: with no writes the visible inputs can only
          shrink (a point crossing the lookback changes a max); while the
          oldest point the last evaluation read is inside the window,
          nothing it used has expired.
        """
        if not self._input_names:
            return False  # inputs undeclared: always evaluate
        if sig != self._last_sig or ts < self._last_eval_ts:
            return False
        if ts - self._last_eval_ts > db.lookback * 0.5:
            return False
        if self._last_oldest_read is not None and ts - self._last_oldest_read > db.lookback:
            return False
        return True

    def evaluate_into(
        self,
        db: TimeSeriesDB,
        at: float | None = None,
        tracer=None,
        selfmetrics=None,
        plan: Expr | None = None,
    ) -> int:
        """Evaluate and write the result series back into the TSDB (``plan``,
        the planner's physical plan of ``expr``, runs in its place).  Output
        series that stop being produced get staleness markers (Prometheus rule
        semantics) so a broken input pipeline propagates to consumers instead
        of serving a frozen value for the whole lookback window.

        With a tracer a full evaluation emits a ``rule_eval`` span linked to
        the spans that wrote every point it read (the TSDB's read capture),
        and stamps its id as the origin of the points it writes.  A skipped
        evaluation emits nothing: readers keep the last full evaluation's
        points, with their values and origins."""
        count = 0
        ts = db.clock.now() if at is None else at
        if self._input_names is None:
            try:
                self._input_names = tuple(sorted(self.expr.input_names()))
            except NotImplementedError:
                self._input_names = ()
        sig = tuple(db.version(n) for n in self._input_names)
        if self._can_skip(db, ts, sig):
            self.skipped_evals += 1
            if selfmetrics is not None and self._last_newest_read is not None:
                selfmetrics.observe_rule_eval(self.record, ts - self._last_newest_read)
            return 0
        self.full_evals += 1
        span = tracer.open("rule_eval", {"rule": self.record}) if tracer else None
        origin = None if span is None else span.span_id
        wall_start = time.perf_counter()
        # a full evaluation always captures its reads: their timestamps feed
        # the aging guard above, and lineage and staleness when wired
        db.begin_capture()
        try:
            outputs = (self.expr if plan is None else plan).evaluate(db, at)
        finally:
            reads = db.end_capture()
        produced: set[tuple[tuple[str, str], ...]] = set()
        for sample in outputs:
            labels = dict(sample.labels)
            labels.update(self.labels)
            key = tuple(sorted(labels.items()))
            db.append(self.record, key, sample.value, ts, origin=origin)
            produced.add(key)
            count += 1
        for key in self._last_keys - produced:
            db.mark_stale(self.record, key, ts, origin=origin)
        self._last_keys = produced
        self._last_sig = sig
        self._last_eval_ts = ts
        if reads:
            read_ts = [r[2] for r in reads]
            self._last_oldest_read = min(read_ts)
            self._last_newest_read = max(read_ts)
        else:
            self._last_oldest_read = None
            self._last_newest_read = None
        staleness = ts - self._last_newest_read if reads else None
        if selfmetrics is not None:
            selfmetrics.observe_rule_eval(
                self.record,
                float("nan") if staleness is None else staleness,
                duration=time.perf_counter() - wall_start,
                span_id=origin,
            )
        if span is not None:
            links = tuple({r[4] for r in reads if r[4] is not None})
            attrs = {"samples_out": count}
            if staleness is not None:
                attrs["staleness_seconds"] = staleness
            if reads:
                tier_counts: dict[str, int] = {}
                for r in reads:
                    tier_counts[r[5]] = tier_counts.get(r[5], 0) + 1
                attrs["tiers"] = ",".join(f"{t}:{n}" for t, n in sorted(tier_counts.items()))
            tracer.close(span, links, **attrs)
        return count


class RuleEvaluator:
    """Evaluates a rule group once per call; the caller's schedule is the
    evaluation interval (Prometheus defaults to 30 s; the headline loop
    evaluates after every scrape to meet the 60 s scale-up budget).  Alert
    rules evaluate after the recording rules of each pass, as in
    Prometheus's group order (an alert may read a recorded series).  A rule
    may be anything with ``evaluate_into`` (obs/slo.py's ``SLORecorder``).

    With a ``planner`` (metrics.planner.QueryPlanner) every rule's and
    alert's expression runs its cached physical plan; the incremental skip
    and the read capture live outside the expression, so they hold as
    before."""

    def __init__(
        self,
        db: TimeSeriesDB,
        rules: list[RecordingRule],
        interval: float = 1.0,
        alerts: list[AlertRule] | None = None,
        tracer=None,
        selfmetrics=None,
        planner=None,
    ):
        self.db = db
        self.rules = rules
        #: the period its owner evaluates it at (the pipeline's ``rule_eval``)
        self.interval = interval
        self.alerts = alerts or []
        #: obs.Tracer / obs.PipelineSelfMetrics, passed to every evaluation
        self.tracer = tracer
        self.selfmetrics = selfmetrics
        self.planner = planner

    def _plan_for(self, rule) -> Expr | None:
        # a rule with no expression (obs.slo.SLORecorder folds its counters
        # itself) has nothing to plan
        expr = getattr(rule, "expr", None)
        if self.planner is None or expr is None:
            return None
        return self.planner.plan(expr)

    def evaluate_once(self) -> int:
        with profile.stage("rules:eval"):
            return self._evaluate_once()

    def _evaluate_once(self) -> int:
        count = 0
        for rule in self.rules:
            # planned outside the rule's own stage, as the JAX package
            # brackets it: ``planner:plan`` sits directly under ``rules:eval``
            plan = self._plan_for(rule)
            if plan is None:
                with profile.stage("rules:eval_fallback"):
                    count += rule.evaluate_into(
                        self.db, tracer=self.tracer, selfmetrics=self.selfmetrics
                    )
            else:
                with profile.stage("rules:eval_planned"):
                    count += rule.evaluate_into(
                        self.db,
                        tracer=self.tracer,
                        selfmetrics=self.selfmetrics,
                        plan=plan,
                    )
        for alert in self.alerts:
            alert.evaluate(self.db, plan=self._plan_for(alert))
        return count

    def firing_alert_instances(self) -> list[dict]:
        """The firing alerts as plain dicts (name, labels, annotations and
        the clock time they began firing), sorted by name and labels."""
        instances = [
            {
                "name": a.alert,
                "labels": dict(a.labels),
                "annotations": dict(a.annotations),
                "active_since": a.firing_since,
            }
            for a in self.alerts
            if a.firing
        ]
        instances.sort(key=lambda i: (i["name"], sorted(i["labels"].items())))
        return instances

    def firing_alerts(self) -> list[str]:
        return [i["name"] for i in self.firing_alert_instances()]


def _app_scoped(
    metric: str, app: str, keys: tuple[str, ...] = ("node", "pod", "namespace")
) -> Expr:
    """The per-pod maxima of ``metric`` joined to the pods labelled ``app``:
    ``max by(node,pod,namespace)(metric) * on(pod) group_left(label_app)
    max by(pod,label_app)(kube_pod_labels{label_app="app"})``, the maxima
    grouped by ``keys``."""
    return MulOnGroupLeft(
        left=MaxBy(keys, Select(metric)),
        right=MaxBy(
            ("pod", "label_app"),
            Select("kube_pod_labels", {"label_app": app}),
        ),
        on=("pod",),
        group_left=("label_app",),
    )


def tpu_test_avg_rule(
    app: str = "tpu-test",
    deployment: str = "tpu-test",
    namespace: str = "default",
    metric: str = TPU_TENSORCORE_UTIL,
    record: str = "tpu_test_tensorcore_avg",
) -> RecordingRule:
    """The reference's rule, same three-trick shape
    (cuda-test-prometheusrule.yaml:13), with a per-device max: the device
    metric is per device, so ``max by(node,pod,namespace)`` also collapses
    the devices of a multi-device pod."""
    return RecordingRule(
        record=record,
        expr=Avg(_app_scoped(metric, app)),
        labels={"namespace": namespace, "deployment": deployment},
    )


def tpu_test_multihost_avg_rule(
    app: str = "tpu-test-multihost",
    statefulset: str = "tpu-test-multihost",
    namespace: str = "default",
    metric: str = TPU_TENSORCORE_UTIL,
    record: str = "tpu_test_multihost_tensorcore_avg",
) -> RecordingRule:
    """The slice pod's rule (deploy/tpu-test-multihost-hpa.yaml's series):
    the same three-trick shape over a StatefulSet of slices, each pod one
    host of a multi-host slice.  The average over the per-pod maxima is the
    average over every host of every slice, which equals the per-slice
    average when the slices are of one size.  The output labels address the
    series at the StatefulSet object."""
    return RecordingRule(
        record=record,
        expr=Avg(_app_scoped(metric, app)),
        labels={"namespace": namespace, "statefulset": statefulset},
    )


def tpu_test_pod_max_rule(
    app: str = "tpu-test",
    metric: str = TPU_HBM_USAGE,
    record: str = "tpu_test_hbm_used_bytes",
) -> RecordingRule:
    """The per-pod rule of a Pods-type HPA metric (deploy/tpu-test-hbm-hpa.yaml):
    each pod's devices collapse to the hottest (``max by(namespace,pod)``,
    no node: one value a pod) and the same ``kube_pod_labels`` join scopes
    them to the app, but the per-pod label set stays, with no output labels:
    the adapter addresses the result per pod (``/namespaces/{ns}/pods/*/...``)
    and the HPA averages it (AverageValue)."""
    return RecordingRule(record=record, expr=_app_scoped(metric, app, ("namespace", "pod")))


#: The serve HPA's target, percent of the device's memory-bandwidth peak
#: (deploy/tpu-serve-hpa.yaml; ``SERVE_BW_TARGET`` of the JAX package's
#: rules).  The serve trial checks that the workload's saturated signal
#: clears the band above it before it drives the loop, and the
#: unreachable-target alert pages below the band under it.
SERVE_BW_TARGET = 5.0


# ---- the shipped alerts: the pipeline's silent failures made loud ----------


def pipeline_alert_rules(
    record: str = "tpu_test_tensorcore_avg", app: str = "tpu-test"
) -> list[AlertRule]:
    """The pipeline's own health alerts, one for each way the loop dies
    without an error anywhere: an exporter's source goes stale (up 0), an
    exporter's newest reading ages, the recorded series vanishes (any joint
    upstream broken), or it is present but pinned at zero while the
    workload runs (``flat_zero_alert``)."""
    return [
        flat_zero_alert(record, app),
        AlertRule(
            alert="TpuExporterDown",
            expr=Cmp(Aggregate("min", Select("tpu_metrics_exporter_up")), "<", 1),
            for_seconds=30.0,
            labels={"severity": "critical"},
            annotations={
                "summary": "a tpu-metrics-exporter is serving but its metric "
                "source went stale (up=0); per-chip gauges are withheld"
            },
        ),
        AlertRule(
            alert="TpuExporterStale",
            expr=Cmp(
                Aggregate("max", Select("tpu_metrics_exporter_sample_age_seconds")), ">", 10
            ),
            for_seconds=30.0,
            labels={"severity": "warning"},
            annotations={
                "summary": "an exporter's newest chip reading is older than "
                "10s (collect loop wedged or libtpu unresponsive)"
            },
        ),
        AlertRule(
            alert="TpuAutoscaleSignalAbsent",
            expr=Absent(Select(record)),
            for_seconds=60.0,
            labels={"severity": "critical"},
            annotations={
                "summary": f"recorded series {record} is absent: scrape job, "
                "recording rule, kube_pod_labels join, or the workload itself "
                "is broken - the HPA is flying blind (holding)"
            },
        ),
    ]


def _app_duty_max(app: str) -> Expr:
    """The largest per-device duty cycle over ``app``'s pods: the "the
    workload is demonstrably busy" conjunct of the flat-zero and
    unreachable-target alerts."""
    return Aggregate(
        "max",
        MulOnGroupLeft(
            left=MaxBy(("pod",), Select(TPU_DUTY_CYCLE)),
            right=MaxBy(("pod",), Select("kube_pod_labels", {"label_app": app})),
            on=("pod",),
        ),
    )


def serve_target_unreachable_alert(
    target: float = SERVE_BW_TARGET, for_seconds: float = 600.0
) -> AlertRule:
    """The serve fleet is saturated (duty above 90%) while the bandwidth
    signal its HPA reads sits below the tolerance band's floor, where the
    HPA would scale down: the signal cannot follow the load (a workload too
    small to push bandwidth, a broken fallback, or a mistuned target).  The
    band keeps a correctly paired hot fleet, which may settle anywhere in
    [0.9, 1.1] x target, from paging."""
    # the controller's own tolerance (imported here: the metrics layer needs
    # the constant, not the control plane)
    from k8s_gpu_hpa_tpu_torch.control.hpa import HPAController

    band = target * (1.0 - HPAController.TOLERANCE)
    return AlertRule(
        alert="TpuServeTargetUnreachable",
        expr=AndOn(
            Cmp(Select("tpu_serve_hbm_bw_avg"), "<", band),
            Cmp(_app_duty_max("tpu-serve"), ">", 90.0),
        ),
        for_seconds=for_seconds,
        labels={"severity": "warning"},
        annotations={
            "summary": "tpu-serve pods have been saturated (duty > 90%) for "
            "10m while tpu_serve_hbm_bw_avg sits below every HPA "
            f"equilibrium (< {band:g}, the tolerance band floor): the "
            "autoscale signal cannot follow the load — resize the workload, "
            "fix the bandwidth fallback chain, or retune the target"
        },
    )


def flat_zero_alert(record: str, app: str) -> AlertRule:
    """The autoscale series is present but zero while the workload is
    demonstrably active: a source feeding zeros or a broken self-report,
    which ``Absent`` cannot see.  Its three conjuncts: the series is 0;
    some pod of ``app`` is Running (kube_pod_labels alone also lists
    Pending pods); the app's pods have a nonzero duty cycle (an idle
    workload may sit at 0 for hours)."""
    running_pods = Aggregate(
        "count",
        MulOnGroupLeft(
            left=MaxBy(("pod",), Select("kube_pod_labels", {"label_app": app})),
            right=MaxBy(
                ("pod",), Cmp(Select("kube_pod_status_phase", {"phase": "Running"}), "==", 1)
            ),
            on=("pod",),
        ),
    )
    return AlertRule(
        alert="TpuAutoscaleSignalFlatZero",
        expr=AndOn(
            AndOn(Cmp(Select(record), "==", 0), Cmp(running_pods, ">", 0)),
            Cmp(_app_duty_max(app), ">", 0),
        ),
        for_seconds=120.0,
        labels={"severity": "warning", "record": record},
        annotations={
            "summary": f"autoscale series {record} is present but flat zero "
            f"while {app} pods are Running with nonzero duty cycle: the "
            "device counter or workload self-report feeding it is broken, "
            "and the HPA will never scale this rung"
        },
    )


def device_counters_dead_alert() -> AlertRule:
    """Every device claims zero total memory, which no real device reports
    even idle: the source serves zeros, not measurements (duty included, so
    the flat-zero alert's gate cannot see it)."""
    return AlertRule(
        alert="TpuDeviceCountersDead",
        expr=Cmp(Aggregate("max", Select("tpu_hbm_memory_total_bytes")), "==", 0),
        for_seconds=120.0,
        labels={"severity": "critical"},
        annotations={
            "summary": "every chip reports 0 total HBM bytes: the metric "
            "source is serving zeros, not measurements — all utilization "
            "gauges (and the HPA signals built on them) are fake"
        },
    )


def chip_hot_alert(threshold_c: float = 90.0) -> AlertRule:
    """A device over ``threshold_c`` for a minute.  The temperature family
    is exported only where the source measures it, so elsewhere the
    expression is empty and the alert silent."""
    return AlertRule(
        alert="TpuChipHot",
        expr=Cmp(Aggregate("max", Select("tpu_chip_temperature_celsius")), ">", threshold_c),
        for_seconds=60.0,
        labels={"severity": "warning"},
        annotations={
            "summary": f"a TPU chip reports over {threshold_c:g}C for 60s: "
            "sustained thermal pressure degrades clocks before it trips "
            "hardware protection — check node cooling / duty cycles"
        },
    )


def slice_held_partial_alert(for_seconds: float = 300.0) -> AlertRule:
    """The slice-quantum operator holds a target off a slice boundary (its
    ``quantum_operator_partial_slice_held`` gauge) for ``for_seconds``:
    stranded hosts running and serving nothing."""
    return AlertRule(
        alert="TpuSliceHeldPartial",
        expr=Cmp(Aggregate("max", Select("quantum_operator_partial_slice_held")), ">", 0),
        for_seconds=for_seconds,
        labels={"severity": "warning"},
        annotations={
            "summary": "the slice-quantum operator has been holding a target "
            "on a partial slice for 5m: stranded hosts are running but "
            "serving nothing — make the HPA's minReplicas/maxReplicas slice "
            "multiples so the vanilla HPA stops landing off-boundary"
        },
    )


def shipped_alert_rules() -> list[AlertRule]:
    """The shipped alert list, the PrometheusRule's ``tpu-pipeline-alerts``
    group: the pipeline's alerts, a flat-zero guard of its own for the
    serve rung's bandwidth series, and the unreachable-target, dead-counter,
    hot-device and held-partial-slice alerts."""
    return pipeline_alert_rules() + [
        flat_zero_alert("tpu_serve_hbm_bw_avg", "tpu-serve"),
        serve_target_unreachable_alert(),
        device_counters_dead_alert(),
        chip_hot_alert(),
        slice_held_partial_alert(),
    ]
