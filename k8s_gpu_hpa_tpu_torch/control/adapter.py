"""Custom-metrics API adapter semantics (L4), the Object-metric subset.

Counterpart of ``k8s_gpu_hpa_tpu/control/adapter.py``.  In production this
layer is prometheus-adapter driven by explicit rules
(deploy/prometheus-adapter-values.yaml).  This module implements what the
headline loop needs of it: find the series an explicit ``seriesQuery``-style
rule names, associate it with a Kubernetes object via its resource labels
(the recorded series carries ``namespace``/``deployment`` labels precisely
for this, cuda-test-prometheusrule.yaml:14-16), and serve its instant value
on the ``custom.metrics.k8s.io/v1beta1`` contract the HPA polls.  Pods and
External metrics, tracing and the query planner are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB


@dataclass(frozen=True)
class ObjectReference:
    """A namespaced object a metric can be addressed against (HPA Object metric
    ``target``, cuda-test-hpa.yaml:14-19)."""

    kind: str
    name: str
    namespace: str = "default"


@dataclass
class AdapterRule:
    """One explicit discovery rule: which series to expose and which label names
    map to which Kubernetes resources (the ``seriesQuery``/``resources`` stanza
    of prometheus-adapter's config)."""

    series: str
    resource_overrides: dict[str, str] = field(
        default_factory=lambda: {"namespace": "namespace", "deployment": "Deployment"}
    )
    #: exposed metric name; defaults to the series name unrenamed
    as_name: str = ""

    @property
    def metric_name(self) -> str:
        return self.as_name or self.series


class CustomMetricsAdapter:
    """Serves instant metric values addressed by (object, metric-name)."""

    def __init__(self, db: TimeSeriesDB, rules: list[AdapterRule]):
        self.db = db
        self.rules = {r.metric_name: r for r in rules}

    def get_object_metric(self, ref: ObjectReference, metric_name: str) -> float | None:
        """Value of ``metric_name`` for the given object, or None if absent/stale.

        Staleness falls out of the TSDB lookback window — a dead pipeline stops
        answering, which makes the HPA hold its last decision (K8s semantics for
        failed metric queries)."""
        rule = self.rules.get(metric_name)
        if rule is None:
            return None
        matchers = {"namespace": ref.namespace}
        # Find the label that encodes this object kind (e.g. deployment=<name>).
        for label, kind in rule.resource_overrides.items():
            if kind.lower() == ref.kind.lower():
                matchers[label] = ref.name
                break
        else:
            return None
        vec = self.db.instant_vector(rule.series, matchers)
        if not vec:
            return None
        if len(vec) > 1:
            raise ValueError(
                f"adapter rule for {metric_name} matched {len(vec)} series for {ref}"
            )
        return vec[0].value
