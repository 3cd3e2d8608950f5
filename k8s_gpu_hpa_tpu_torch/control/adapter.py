"""Custom-metrics API adapter semantics (L4).

Counterpart of ``k8s_gpu_hpa_tpu/control/adapter.py``.  In production this
layer is prometheus-adapter driven by explicit rules
(deploy/prometheus-adapter-values.yaml).  This module implements what the
port's loops need of it: find the series an explicit ``seriesQuery``-style
rule names, associate it with a Kubernetes object via its resource labels
(the recorded series carries ``namespace``/``deployment`` labels precisely
for this, cuda-test-prometheusrule.yaml:14-16), and serve instant values on
the two aggregated APIs the HPA polls: ``custom.metrics.k8s.io/v1beta1``
(Object and Pods metrics) and ``external.metrics.k8s.io/v1beta1`` (External
metrics, addressed by name and label selector within a namespace).  Every
read is a plain ``instant_vector`` of the TSDB: tracing and the query
planner are not ported.
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


@dataclass
class ExternalRule:
    """One ``externalRules`` entry: a series served on
    ``external.metrics.k8s.io``, associated with no Kubernetes object and
    addressed by name and label selector within a namespace (the
    ``namespace`` label is the tenancy boundary)."""

    series: str
    as_name: str = ""

    @property
    def metric_name(self) -> str:
        return self.as_name or self.series


class CustomMetricsAdapter:
    """Serves instant metric values addressed by (object, metric-name), by
    (namespace, metric-name, pods) and by (namespace, metric-name,
    selector): one instance models both aggregated APIs prometheus-adapter
    registers, ``rules:`` for custom metrics and ``externalRules:`` for
    external ones."""

    def __init__(
        self,
        db: TimeSeriesDB,
        rules: list[AdapterRule],
        external_rules: list[ExternalRule] | None = None,
    ):
        self.db = db
        self.rules = {r.metric_name: r for r in rules}
        self.external_rules = {r.metric_name: r for r in (external_rules or [])}

    def list_metrics(self) -> list[str]:
        """Discovery on ``custom.metrics.k8s.io``: the names whose series
        exist now (what ``kubectl get --raw`` on the API lists)."""
        return sorted(
            name for name, rule in self.rules.items() if self.db.instant_vector(rule.series)
        )

    def list_external_metrics(self) -> list[str]:
        """Discovery on ``external.metrics.k8s.io``."""
        return sorted(
            name
            for name, rule in self.external_rules.items()
            if self.db.instant_vector(rule.series)
        )

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

    def get_pods_metric(
        self, namespace: str, metric_name: str, pod_names: list[str]
    ) -> dict[str, float]:
        """Per-pod values of a Pods-type HPA metric.

        The API path is ``/namespaces/{ns}/pods/*/{metric}``: the HPA
        resolves its target's pods and the adapter answers for each.  The
        rule must map a label to ``Pod`` (the series' ``pod`` label).  Pods
        with no fresh series are absent from the result: the HPA's
        missing-pod rule decides what that means."""
        rule = self.rules.get(metric_name)
        if rule is None:
            return {}
        pod_label = next(
            (label for label, kind in rule.resource_overrides.items() if kind.lower() == "pod"),
            None,
        )
        if pod_label is None:
            return {}
        out: dict[str, float] = {}
        for name in pod_names:
            vec = self.db.instant_vector(rule.series, {"namespace": namespace, pod_label: name})
            if not vec:
                continue
            if len(vec) > 1:
                raise ValueError(
                    f"pods rule for {metric_name} matched {len(vec)} series "
                    f"for pod {namespace}/{name}"
                )
            out[name] = vec[0].value
        return out

    def get_external_metric(
        self, namespace: str, metric_name: str, selector: dict[str, str] | None = None
    ) -> list[float]:
        """Every value of an External metric in ``namespace`` that matches
        the label selector: ``external.metrics.k8s.io`` returns a list, and
        the HPA sums it."""
        rule = self.external_rules.get(metric_name)
        if rule is None:
            return []
        matchers = {"namespace": namespace, **(selector or {})}
        return [s.value for s in self.db.instant_vector(rule.series, matchers)]
