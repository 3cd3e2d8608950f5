"""The External-metric control plane wired from an HPA manifest, for runs on
a virtual clock.

Counterpart of ``k8s_gpu_hpa_tpu/control/external_sim.py``.  It builds the
queue-depth HPA's plane (deploy/tpu-test-external-hpa.yaml): a TSDB that
takes the demand series under the manifest's own label selector, the
``external.metrics.k8s.io`` adapter, and the v2 controller with the
manifest's bounds and behavior.  The manifest comes as a dict, as the
port's generator renders it (``manifests.external_hpa_doc()``), so the sim
runs what an operator would apply.
"""

from __future__ import annotations

from dataclasses import dataclass

from k8s_gpu_hpa_tpu_torch.control.adapter import CustomMetricsAdapter, ExternalRule
from k8s_gpu_hpa_tpu_torch.control.hpa import (
    ExternalMetricSpec,
    HPAController,
    behavior_from_manifest,
    metrics_from_manifest,
)
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock


class ScaleTarget:
    """The scale subresource alone: a replica count the HPA sets."""

    def __init__(self, replicas: int = 1):
        self.replicas = replicas

    def scale_to(self, n: int) -> None:
        self.replicas = n


@dataclass
class ExternalSim:
    clock: VirtualClock
    db: TimeSeriesDB
    adapter: CustomMetricsAdapter
    hpa: HPAController
    target: ScaleTarget
    metric: ExternalMetricSpec
    labels: tuple

    def publish(self, value: float) -> None:
        """One sample of the demand series under the manifest's selector
        labels and the namespace label the adapter scopes by."""
        self.db.append(self.metric.metric_name, self.labels, value, self.clock.now())


def external_sim_from_manifest(
    hpa_doc: dict, clock: VirtualClock | None = None, namespace: str = "default"
) -> ExternalSim:
    """The External-metric plane of an HPA manifest.  Raises ValueError
    unless the manifest holds exactly one metric, an External one."""
    metrics = metrics_from_manifest(hpa_doc)
    if len(metrics) != 1 or not isinstance(metrics[0], ExternalMetricSpec):
        raise ValueError(
            "external sim supports single External-metric HPAs (the queue "
            "rung); got " + ", ".join(type(m).__name__ for m in metrics)
        )
    metric = metrics[0]
    labels = tuple(sorted({"namespace": namespace, **metric.selector}.items()))
    spec = hpa_doc["spec"]
    clock = clock or VirtualClock()
    db = TimeSeriesDB(clock)
    adapter = CustomMetricsAdapter(db, [], external_rules=[ExternalRule(metric.metric_name)])
    target = ScaleTarget(replicas=spec.get("minReplicas", 1))
    hpa = HPAController(
        target=target,
        metrics=metrics,
        adapter=adapter,
        clock=clock,
        min_replicas=spec.get("minReplicas", 1),
        max_replicas=spec["maxReplicas"],
        behavior=behavior_from_manifest(hpa_doc),
    )
    return ExternalSim(clock, db, adapter, hpa, target, metric, labels)
