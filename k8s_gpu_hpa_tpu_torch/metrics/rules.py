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
one source for the tested semantics and the shipped manifest.  Every
evaluation is a full one: the JAX package's incremental short-circuit,
planner, tracing and alert rules are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from k8s_gpu_hpa_tpu_torch.metrics.schema import Sample, TPU_HBM_USAGE, TPU_TENSORCORE_UTIL
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB

Vector = list[Sample]


class Expr:
    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        raise NotImplementedError

    def promql(self) -> str:
        raise NotImplementedError


@dataclass
class Select(Expr):
    """Instant vector selector: ``name{key="value",...}``."""

    name: str
    matchers: dict[str, str] = field(default_factory=dict)

    def evaluate(self, db: TimeSeriesDB, at: float | None = None) -> Vector:
        return db.instant_vector(self.name, self.matchers, at)

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

    def promql(self) -> str:
        return f"avg({self.child.promql()})"


@dataclass
class RecordingRule:
    """``record:`` output series name, expression, and static output labels."""

    record: str
    expr: Expr
    labels: dict[str, str] = field(default_factory=dict)
    _last_keys: set[tuple[tuple[str, str], ...]] = field(default_factory=set, repr=False)

    def evaluate_into(self, db: TimeSeriesDB, at: float | None = None) -> int:
        """Evaluate and write the result series back into the TSDB.  Output
        series that stop being produced get staleness markers (Prometheus rule
        semantics) so a broken input pipeline propagates to consumers instead
        of serving a frozen value for the whole lookback window."""
        ts = db.clock.now() if at is None else at
        produced: set[tuple[tuple[str, str], ...]] = set()
        for sample in self.expr.evaluate(db, at):
            labels = dict(sample.labels)
            labels.update(self.labels)
            key = tuple(sorted(labels.items()))
            db.append(self.record, key, sample.value, ts)
            produced.add(key)
        for key in self._last_keys - produced:
            db.mark_stale(self.record, key, ts)
        self._last_keys = produced
        return len(produced)


class RuleEvaluator:
    """Evaluates a rule group once per call; the caller's schedule is the
    evaluation interval (Prometheus defaults to 30 s; the headline loop
    evaluates after every scrape to meet the 60 s scale-up budget)."""

    def __init__(self, db: TimeSeriesDB, rules: list[RecordingRule]):
        self.db = db
        self.rules = rules

    def evaluate_once(self) -> int:
        return sum(rule.evaluate_into(self.db) for rule in self.rules)


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
#: clears the band above it before it drives the loop.
SERVE_BW_TARGET = 5.0
