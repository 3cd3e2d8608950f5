"""The whole autoscaling pipeline assembled over the simulated cluster.

Counterpart of ``k8s_gpu_hpa_tpu/control/loop.py``, cut to its core.  It
wires the five layers on one clock:

    SimCluster (L1 workload on L0 devices)
      -> Scraper targets: one exporter a node + kube-state-metrics   (L2 -> L3)
      -> RuleEvaluator: tpu_test_avg_rule (or the StatefulSet's)      (L3)
      -> CustomMetricsAdapter                                         (L4)
      -> HPAController -> deployment.scale_to                         (L5)

Every period is explicit and defaults to the shipped values: a 1 s scrape
(kube-prometheus-stack-values.yaml:5), a 1 s rule evaluation and a 15 s
HPA sync; the cluster's exporters collect every 1 s by default (the
reference's every 10 s, dcgm-exporter.yaml:37).  Runs are on a
``VirtualClock``.

The JAX pipeline's tracer, self-metrics and SLO recorders, its write-ahead
log, checkpoints and component restarts, sharded scraping and downsampled
tiers, the capacity economy with ``add_tenant_hpa``, and the query planner
are not ported; the constructor takes none of their parameters.  The
planner gives the naive evaluation's values bit for bit by its own
contract, so the naive ``RuleEvaluator`` here records the same series.
"""

from __future__ import annotations

from dataclasses import dataclass

from k8s_gpu_hpa_tpu_torch.control.adapter import (
    AdapterRule,
    CustomMetricsAdapter,
    ObjectReference,
)
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import (
    HPABehavior,
    HPAController,
    MetricSpec,
    ObjectMetricSpec,
)
from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    RecordingRule,
    RuleEvaluator,
    tpu_test_avg_rule,
    tpu_test_multihost_avg_rule,
)
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import Scraper, TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock


@dataclass
class PipelineIntervals:
    """The loop's periods, seconds; the exporters' collection interval is
    the cluster's (``SimCluster(exporter_sample_interval=)``)."""

    scrape: float = 1.0  # kube-prometheus-stack-values.yaml:5
    rule_eval: float = 1.0
    hpa_sync: float = 15.0  # kube-controller-manager's default


def _overrides_for(rule: RecordingRule) -> dict[str, str]:
    """The adapter's resource mapping of a rule's series: the object kind
    its own output labels name, so rules addressed at a Deployment and at a
    StatefulSet resolve side by side; a rule with no output labels is per
    pod (``tpu_test_pod_max_rule``) and is addressed at pods."""
    if "statefulset" in rule.labels:
        kind = "StatefulSet"
    elif rule.labels:
        kind = "Deployment"
    else:
        kind = "Pod"
    return {"namespace": "namespace", kind.lower(): kind}


class AutoscalingPipeline:
    """The closed loop over a simulated cluster."""

    def __init__(
        self,
        cluster: SimCluster,
        deployment: SimDeployment,
        record: str = "tpu_test_tensorcore_avg",
        target_value: float = 40.0,
        min_replicas: int = 1,
        max_replicas: int = 4,
        behavior: HPABehavior | None = None,
        intervals: PipelineIntervals | None = None,
        extra_rules: list[RecordingRule] | None = None,
        replica_quantum: int = 1,
        object_kind: str = "Deployment",  # "Deployment" | "StatefulSet"
        metric_specs: list[MetricSpec] | None = None,
        extra_adapter_rules: list[AdapterRule] | None = None,
        structured_scrapes: bool = True,
    ):
        self.cluster = cluster
        self.deployment = deployment
        self.intervals = intervals or PipelineIntervals()
        clock: VirtualClock = cluster.clock
        self.db = TimeSeriesDB(clock)
        self.scraper = Scraper(self.db)
        # Structured scrapes (the default) hand the scraper the exporters'
        # families, the same samples without a text round trip;
        # structured_scrapes=False runs the text path end to end.
        if structured_scrapes:
            self._exporter_fetch = cluster.exporter_fetch_families
            ksm_fetch = cluster.kube_state_metrics_families
        else:
            self._exporter_fetch = cluster.exporter_fetch
            ksm_fetch = cluster.kube_state_metrics_text
        for node_name in cluster.nodes:
            self._add_node_target(node_name)
        # a node that joins later is scraped from its first sweep; a removed
        # node's target goes with it
        cluster.on_node_added.append(lambda node: self._add_node_target(node.name))
        cluster.on_node_removed.append(self._drop_node_target)
        self.scraper.add_target(ksm_fetch, name="kube-state-metrics")

        if object_kind == "StatefulSet":
            primary = tpu_test_multihost_avg_rule(
                app=deployment.app_label,
                statefulset=deployment.name,
                namespace=deployment.namespace,
                record=record,
            )
        else:
            primary = tpu_test_avg_rule(
                app=deployment.app_label,
                deployment=deployment.name,
                namespace=deployment.namespace,
                record=record,
            )
        rules = [primary] + (extra_rules or [])
        self.evaluator = RuleEvaluator(self.db, rules)
        self.adapter = CustomMetricsAdapter(
            self.db,
            [AdapterRule(series=r.record, resource_overrides=_overrides_for(r)) for r in rules]
            + (extra_adapter_rules or []),
        )

        ref = ObjectReference(object_kind, deployment.name, deployment.namespace)
        # An Object or External spec parsed for another namespace would match
        # nothing and hold the HPA for ever: refuse it here.
        for spec in metric_specs or []:
            ns = getattr(getattr(spec, "described_object", None), "namespace", None) or getattr(
                spec, "namespace", None
            )
            if ns is not None and ns != deployment.namespace:
                raise ValueError(
                    f"metric spec {spec} addresses namespace {ns!r} but the "
                    f"deployment is in {deployment.namespace!r}"
                )
        self.hpa = HPAController(
            target=deployment,
            metrics=metric_specs or [ObjectMetricSpec(record, target_value, ref)],
            adapter=self.adapter,
            clock=clock,
            min_replicas=min_replicas,
            max_replicas=max_replicas,
            behavior=behavior,
            replica_quantum=replica_quantum,
            pod_lister=deployment,
            namespace=deployment.namespace,
        )
        self.scale_history: list[tuple[float, int, int]] = []  # (ts, from, to)
        self.hpa.on_scale = lambda a, b: self.scale_history.append((clock.now(), a, b))
        self._clock = clock
        self._started = False

    def _add_node_target(self, node_name: str) -> None:
        self.scraper.add_target(
            lambda: self._exporter_fetch(node_name), name=f"exporter/{node_name}", node=node_name
        )

    def _drop_node_target(self, node_name: str) -> None:
        self.scraper.targets[:] = [
            t for t in self.scraper.targets if t.name != f"exporter/{node_name}"
        ]

    @property
    def clock(self) -> VirtualClock:
        """The virtual clock everything runs on, the cluster's."""
        return self._clock

    def start(self) -> None:
        """Register the periodic ticks on the clock: scrape, rule evaluation,
        HPA sync, in that order, which orders the ticks that fall at one
        instant.  Each tick finds its component through ``self`` when it
        fires, so a component replaced between ticks takes over at the next."""
        if self._started:
            return
        self._started = True
        self._periodic(self.intervals.scrape, lambda: self.scraper.scrape_once())
        self._periodic(self.intervals.rule_eval, lambda: self.evaluator.evaluate_once())
        self._periodic(self.intervals.hpa_sync, lambda: self.hpa.sync_once())

    def _periodic(self, interval: float, fn) -> None:
        def tick():
            fn()
            self._clock.call_later(interval, tick)

        self._clock.call_later(interval, tick)

    def run_for(self, seconds: float) -> None:
        self.start()
        self._clock.advance(seconds)

    def replicas(self) -> int:
        return self.deployment.replicas

    def running(self) -> int:
        return len(self.cluster.running_pods(self.deployment.name))
