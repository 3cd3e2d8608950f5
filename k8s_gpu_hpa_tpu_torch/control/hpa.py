"""HorizontalPodAutoscaler controller (L5): ``autoscaling/v2`` semantics.

Counterpart of ``k8s_gpu_hpa_tpu/control/hpa.py``.  The reference closes its
loop with an ``autoscaling/v2beta1`` HPA (cuda-test-hpa.yaml:1) and documents
its failure mode: replica overshoot straight to maxReplicas because of metric
lag, fixable by the ``behavior`` field of newer API versions
(README.md:123).  This controller implements the v2 algorithm including
``behavior``:

    desired = ceil(current * metricValue / targetValue)        # core formula
    within tolerance (|ratio-1| <= 0.1) -> no change
    multiple metrics -> max of per-metric proposals
    stabilization window -> scale-down uses the max recommendation in the
        window, scale-up the min
    scaling policies (Pods / Percent per periodSeconds) bound the step size

for four metric types: Object (``target.type: Value``, or ``AverageValue``
divided by current replicas), Resource (the pods' mean utilization percent
of their request, read from a metrics.k8s.io stand-in), Pods (the average
over the target's ready pods, with Kubernetes' conservative rule for pods
that report nothing) and External (the sum of the series a selector
matches, or that sum per current replica).  Each sync sets the
``AbleToScale`` and ``ScalingActive`` status conditions a real HPA object
carries, and ``on_scale`` hears of each change of replicas.  Replica quanta: on a StatefulSet of
multi-host slices replicas move in whole slices (``replica_quantum``, read
from the HPA's ``k8s-tpu-hpa/replica-quantum`` annotation by
``quantum_from_manifest``).

With a tracer, each sync emits an ``hpa_sync`` span linked to the
``adapter_query`` spans it issued and, when replicas change, a
``scale_event`` span; with self-metrics it reports its duration, its
decision and each change's signal-propagation latency.  With a
``checkpoint_store`` (control/checkpoint.py) it saves its state after every
sync and restores it when built, so a restarted controller keeps its
stabilization windows.  With a ``capacity_probe`` (a tenant's standing in
control/capacity.py) every sync sets the Unschedulable, Preempting and
FairShareLimited conditions.
``behavior_from_manifest`` and ``metrics_from_manifest`` parse an HPA
manifest given as a dict; the shipped manifests' values are also written in
code here (``shipped_behavior()``, ``train_metrics()``, ``hbm_metrics()``,
the ``MULTIHOST_*``, ``HBM_*`` and ``QUEUE_*`` constants), so the port
reads no YAML.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Protocol

from k8s_gpu_hpa_tpu_torch.control.adapter import CustomMetricsAdapter, ObjectReference
from k8s_gpu_hpa_tpu_torch.control.checkpoint import CHECKPOINT_VERSION
from k8s_gpu_hpa_tpu_torch.obs import coverage, profile
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock
from k8s_gpu_hpa_tpu_torch.utils.quantity import parse_quantity


@dataclass
class ObjectMetricSpec:
    """One Object-type metric (cuda-test-hpa.yaml:13-21): ``target_value``
    compares the object's metric directly; ``average`` is a ``target.type:
    AverageValue`` target, which divides the object's value by current
    replicas before comparing."""

    metric_name: str
    target_value: float
    described_object: ObjectReference
    average: bool = False


@dataclass
class ResourceMetricSpec:
    """One Resource-type metric: ``resource`` (e.g. "cpu") with a target
    average utilization, percent of the pods' requests: the metrics.k8s.io
    path a plain HPA uses (deploy/cpu-busyloop-hpa.yaml, the rung without
    an accelerator)."""

    resource: str
    target_average_utilization: float


@dataclass
class PodsMetricSpec:
    """One Pods-type metric: a per-pod custom metric with an AverageValue
    target.  The HPA averages the metric over the target's ready pods and
    scales by value/target: the shape of the per-device HBM HPA
    (deploy/tpu-test-hbm-hpa.yaml), whose signal is per pod."""

    metric_name: str
    target_average_value: float


@dataclass
class ExternalMetricSpec:
    """One External-type metric: a series on ``external.metrics.k8s.io``
    addressed by name and label selector, associated with no Kubernetes
    object.  ``target_value`` compares the sum of the matched series;
    ``target_average_value`` divides that sum by current replicas (the
    queue-depth-per-worker idiom)."""

    metric_name: str
    selector: dict[str, str] = field(default_factory=dict)
    target_value: float | None = None
    target_average_value: float | None = None
    #: None: the controller's namespace (the HPA object's own)
    namespace: str | None = None

    def __post_init__(self) -> None:
        if (self.target_value is None) == (self.target_average_value is None):
            raise ValueError("exactly one of target_value / target_average_value required")


MetricSpec = ObjectMetricSpec | ResourceMetricSpec | PodsMetricSpec | ExternalMetricSpec


class PodLister(Protocol):
    """What Pods-type metrics need: the HPA lists the scale target's ready
    pods, then asks the adapter for each pod's value."""

    def ready_pod_names(self) -> list[str]: ...


class ResourceMetricsReader(Protocol):
    """The metrics.k8s.io stand-in: each of the scale target's pods'
    utilization, percent of its request."""

    def pod_utilizations(self, resource: str) -> list[float]: ...


@dataclass
class ScalingPolicy:
    """``type: Pods|Percent, value, periodSeconds`` — max change per period."""

    type: str  # "Pods" | "Percent"
    value: int
    period_seconds: float


@dataclass
class ScalingRules:
    """Per-direction ``behavior`` stanza."""

    stabilization_window_seconds: float = 0.0
    select_policy: str = "Max"  # "Max" | "Min" | "Disabled"
    policies: list[ScalingPolicy] = field(default_factory=list)


@dataclass
class HPABehavior:
    """K8s defaults: scale-up fast (100%/15s or 4 pods/15s, window 0),
    scale-down conservative (100%/15s, window 300 s)."""

    scale_up: ScalingRules = field(
        default_factory=lambda: ScalingRules(
            stabilization_window_seconds=0.0,
            select_policy="Max",
            policies=[
                ScalingPolicy("Percent", 100, 15.0),
                ScalingPolicy("Pods", 4, 15.0),
            ],
        )
    )
    scale_down: ScalingRules = field(
        default_factory=lambda: ScalingRules(
            stabilization_window_seconds=300.0,
            select_policy="Max",
            policies=[ScalingPolicy("Percent", 100, 15.0)],
        )
    )


def shipped_behavior() -> HPABehavior:
    """The ``behavior:`` stanza of deploy/tpu-test-hpa.yaml: scale up by
    max(2 pods, 100%) per 15 s with no window; scale down by 50% per 60 s
    after a 120 s stabilization window."""
    return HPABehavior(
        scale_up=ScalingRules(
            stabilization_window_seconds=0.0,
            select_policy="Max",
            policies=[ScalingPolicy("Pods", 2, 15.0), ScalingPolicy("Percent", 100, 15.0)],
        ),
        scale_down=ScalingRules(
            stabilization_window_seconds=120.0,
            select_policy="Max",
            policies=[ScalingPolicy("Percent", 50, 60.0)],
        ),
    )


def shipped_multihost_behavior(quantum: int = 2) -> HPABehavior:
    """The ``behavior:`` stanza of deploy/tpu-test-multihost-hpa.yaml, in
    pods, which are hosts, for slices of ``quantum`` hosts (the shipped 2):
    scale up by two slices per 15 s with no window; scale down by one slice
    per 60 s after a 120 s stabilization window."""
    return HPABehavior(
        scale_up=ScalingRules(
            stabilization_window_seconds=0.0,
            select_policy="Max",
            policies=[ScalingPolicy("Pods", 2 * quantum, 15.0)],
        ),
        scale_down=ScalingRules(
            stabilization_window_seconds=120.0,
            select_policy="Max",
            policies=[ScalingPolicy("Pods", quantum, 60.0)],
        ),
    )


#: The slice HPA's annotation: pods per slice, the quantum replicas move in
QUANTUM_ANNOTATION = "k8s-tpu-hpa/replica-quantum"
#: deploy/tpu-test-multihost-hpa.yaml: its Object metric on the
#: ``tpu-test-multihost`` StatefulSet with ``target.type: Value``, its pods
#: 2..8 (one to four slices of 2 hosts) and its quantum
MULTIHOST_SERIES = "tpu_test_multihost_tensorcore_avg"
MULTIHOST_TARGET = 40.0
MULTIHOST_MIN_REPLICAS = 2
MULTIHOST_MAX_REPLICAS = 8
MULTIHOST_QUANTUM = 2


#: deploy/tpu-test-hbm-hpa.yaml: a Pods metric, the per-pod hottest
#: device's bytes in use, with an AverageValue target, on the
#: ``tpu-test-v5e8`` Deployment, pods 1..4 and the shipped behavior.  13Gi
#: is the JAX manifest's target (of a 16 GiB v5e chip); an operator sets the
#: target for the card's memory.
HBM_APP = "tpu-test-v5e8"
HBM_SERIES = "tpu_test_hbm_used_bytes"
HBM_TARGET = "13Gi"
HBM_MIN_REPLICAS = 1
HBM_MAX_REPLICAS = 4
#: deploy/tpu-test-external-hpa.yaml (HPA ``tpu-serve-queue``): an External
#: metric, the serving fleet's summed queue depth under the selector, with
#: an AverageValue target (100 queued requests a replica), on the
#: ``tpu-serve`` Deployment, pods 1..4 and the shipped behavior
QUEUE_HPA = "tpu-serve-queue"
QUEUE_APP = "tpu-serve"
QUEUE_SERIES = "tpu_test_queue_depth"
QUEUE_SELECTOR = {"queue": "tpu-serve"}
QUEUE_TARGET = "100"
QUEUE_MIN_REPLICAS = 1
QUEUE_MAX_REPLICAS = 4


def hbm_metrics() -> list[PodsMetricSpec]:
    """The ``metrics:`` of deploy/tpu-test-hbm-hpa.yaml written in code."""
    return [PodsMetricSpec(HBM_SERIES, parse_quantity(HBM_TARGET))]


def behavior_from_manifest(hpa_doc: dict) -> HPABehavior:
    """The controller's behavior from the ``behavior:`` stanza of an
    autoscaling/v2 HPA manifest given as a dict; a direction the stanza
    leaves out keeps Kubernetes' default."""

    def parse_rules(d: dict) -> ScalingRules:
        return ScalingRules(
            stabilization_window_seconds=float(d.get("stabilizationWindowSeconds", 0)),
            select_policy=d.get("selectPolicy", "Max"),
            policies=[
                ScalingPolicy(p["type"], p["value"], float(p["periodSeconds"]))
                for p in d.get("policies", [])
            ],
        )

    b = hpa_doc["spec"].get("behavior", {})
    behavior = HPABehavior()
    if "scaleUp" in b:
        behavior.scale_up = parse_rules(b["scaleUp"])
    if "scaleDown" in b:
        behavior.scale_down = parse_rules(b["scaleDown"])
    return behavior


def metrics_from_manifest(hpa_doc: dict, namespace: str = "default") -> list[MetricSpec]:
    """The controller's specs from the ``spec.metrics`` list of an
    autoscaling/v2 HPA manifest given as a dict: Object, Resource, Pods and
    External metrics, their targets parsed as Kubernetes quantities
    (``"40"``, ``"13Gi"``, ``"500m"``).  A Resource metric must have a
    Utilization target: the reader serves percent of request, not usage."""
    specs: list[MetricSpec] = []
    for m in hpa_doc["spec"].get("metrics", []):
        kind = m["type"]
        if kind == "Object":
            o = m["object"]
            target = o["target"]
            average = "averageValue" in target
            specs.append(ObjectMetricSpec(
                metric_name=o["metric"]["name"],
                target_value=parse_quantity(target["averageValue"] if average else target["value"]),
                described_object=ObjectReference(
                    o["describedObject"]["kind"],
                    o["describedObject"]["name"],
                    o["describedObject"].get("namespace", namespace),
                ),
                average=average,
            ))
        elif kind == "Pods":
            p = m["pods"]
            specs.append(PodsMetricSpec(
                metric_name=p["metric"]["name"],
                target_average_value=parse_quantity(p["target"]["averageValue"]),
            ))
        elif kind == "External":
            e = m["external"]
            target = e["target"]
            specs.append(ExternalMetricSpec(
                metric_name=e["metric"]["name"],
                selector=e["metric"].get("selector", {}).get("matchLabels", {}),
                target_value=parse_quantity(target["value"]) if "value" in target else None,
                target_average_value=(
                    parse_quantity(target["averageValue"]) if "averageValue" in target else None
                ),
                namespace=namespace,
            ))
        elif kind == "Resource":
            r = m["resource"]
            if "averageUtilization" not in r["target"]:
                raise ValueError(
                    f"Resource metric {r['name']}: only target.type Utilization is "
                    f"supported (got {r['target'].get('type', '?')})"
                )
            specs.append(ResourceMetricSpec(
                resource=r["name"],
                target_average_utilization=float(r["target"]["averageUtilization"]),
            ))
        else:
            raise ValueError(f"unsupported HPA metric type {kind}")
    return specs


def quantum_from_manifest(hpa_doc: dict) -> int:
    """Slice-atomicity quantum from the ``k8s-tpu-hpa/replica-quantum``
    annotation (deploy/tpu-test-multihost-hpa.yaml); 1 when absent."""
    annotations = hpa_doc.get("metadata", {}).get("annotations", {})
    return int(annotations.get(QUANTUM_ANNOTATION, 1))


#: The tpu-train HPA's two Object metrics (deploy/tpu-train-hpa.yaml): the
#: deployment's mean duty cycle, percent, and its mean memory-bandwidth use,
#: percent of the device's peak.  autoscaling/v2 takes the largest proposal
#: of the metrics it has, so the deployment scales out when either binds.
TRAIN_DUTY_SERIES = "tpu_train_duty_cycle_avg"
TRAIN_DUTY_TARGET = 50.0
TRAIN_BW_SERIES = "tpu_train_hbm_bw_avg"
TRAIN_BW_TARGET = 30.0


def train_metrics() -> list[ObjectMetricSpec]:
    """The ``metrics:`` of deploy/tpu-train-hpa.yaml written in code: both
    Object metrics on the ``tpu-train`` Deployment with ``target.type:
    Value``.  Its replicas run 1..4 and its behavior is ``shipped_behavior()``."""
    ref = ObjectReference("Deployment", "tpu-train", "default")
    return [
        ObjectMetricSpec(TRAIN_DUTY_SERIES, TRAIN_DUTY_TARGET, ref),
        ObjectMetricSpec(TRAIN_BW_SERIES, TRAIN_BW_TARGET, ref),
    ]


def signal_ceiling_clears_band(ceiling: float, target: float) -> bool:
    """Can a workload whose gauge saturates at ``ceiling`` ever trigger
    scale-up against ``target``?  Only strictly above
    ``target * (1 + TOLERANCE)``: at exactly the band edge the controller
    holds (``|ratio - 1| <= tolerance`` skips scaling)."""
    return ceiling > target * (1.0 + HPAController.TOLERANCE)


class ScalableTarget(Protocol):
    """The scale-subresource contract: read and mutate ``replicas``."""

    replicas: int

    def scale_to(self, replicas: int) -> None: ...


@dataclass
class HPACondition:
    """One status condition (``status.conditions[]`` of an autoscaling/v2
    object): why the HPA acts or holds, in the shape the doctor's L5 probe
    reads off a live cluster (``doctor.check_hpa_status``)."""

    type: str  # "AbleToScale" | "ScalingActive"
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float | None = None

    def as_k8s(self) -> dict:
        """The shape ``kubectl get --raw .../horizontalpodautoscalers`` serves."""
        return {
            "type": self.type,
            "status": "True" if self.status else "False",
            "reason": self.reason,
            "message": self.message,
        }


@dataclass
class HPAStatus:
    current_replicas: int = 1
    desired_replicas: int = 1
    last_metric_values: dict[str, float] = field(default_factory=dict)
    last_scale_time: float | None = None
    #: why the last sync made its decision, for observability/tests
    last_reason: str = ""
    #: condition type -> current condition (AbleToScale / ScalingActive)
    conditions: dict[str, HPACondition] = field(default_factory=dict)

    def condition(self, type_: str) -> HPACondition | None:
        return self.conditions.get(type_)

    def conditions_as_k8s(self) -> list[dict]:
        return [c.as_k8s() for c in self.conditions.values()]


class HPAController:
    """One HPA object + its sync loop (kube-controller-manager syncs every 15 s
    by default)."""

    TOLERANCE = 0.1  # kube-controller-manager --horizontal-pod-autoscaler-tolerance

    def __init__(
        self,
        target: ScalableTarget,
        metrics: list[MetricSpec],
        adapter: CustomMetricsAdapter | None,
        clock: Clock,
        min_replicas: int = 1,
        max_replicas: int = 4,
        behavior: HPABehavior | None = None,
        sync_interval: float = 15.0,
        on_scale: Callable[[int, int], None] | None = None,
        replica_quantum: int = 1,
        resource_metrics: ResourceMetricsReader | None = None,
        pod_lister: PodLister | None = None,
        namespace: str = "default",
        tracer=None,
        selfmetrics=None,
        checkpoint_store=None,
        capacity_probe=None,
    ):
        self.target = target
        self.metrics = metrics
        self.adapter = adapter
        self.clock = clock
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.behavior = behavior or HPABehavior()
        #: the period its owner syncs it at (the pipeline's ``hpa_sync``),
        #: kept so that a rebuilt controller keeps it
        self.sync_interval = sync_interval
        #: called with (from, to) after each change of the target's replicas
        self.on_scale = on_scale
        # Slice atomicity: on multi-host slices one logical replica is
        # ``hosts_per_slice`` pods, and a partial slice contributes zero
        # capacity (its hosts block at the process group's rendezvous), so
        # replicas move in whole-slice quanta.
        if replica_quantum < 1:
            raise ValueError("replica_quantum must be >= 1")
        if replica_quantum > 1 and max_replicas < replica_quantum:
            raise ValueError(
                f"max_replicas={max_replicas} cannot fit one slice of "
                f"replica_quantum={replica_quantum} pods"
            )
        self.replica_quantum = replica_quantum
        self.resource_metrics = resource_metrics
        self.pod_lister = pod_lister
        self.namespace = namespace
        #: obs.Tracer: each sync emits an ``hpa_sync`` span, each change of
        #: replicas a ``scale_event`` span
        self.tracer = tracer
        #: obs.PipelineSelfMetrics: sync durations, decisions, propagation
        self.selfmetrics = selfmetrics
        self.status = HPAStatus(current_replicas=target.replicas)
        #: (ts, type, status, reason) at every change of a condition's
        #: status or reason (a real HPA keeps only the latest condition)
        self.condition_history: list[tuple[float, str, bool, str]] = []
        #: (ts, recommendation) ring for stabilization windows
        self._recommendations: list[tuple[float, int]] = []
        #: (ts, replicas_after) scale-event log for policy period lookback
        self._scale_events: list[tuple[float, int]] = [(clock.now(), target.replicas)]
        #: the current sync's notes from the missing-pod rule, appended to
        #: ``last_reason``
        self._proposal_notes: list[str] = []
        #: clock time of the last sync that computed a replica count
        #: (ScalingActive true)
        self.last_good_sync_at: float | None = None
        #: the workload_change span whose propagation was last observed
        self._propagation_seen: int | None = None
        #: returns the tenant's standing in the capacity economy (the dict of
        #: control/capacity.CapacityScheduler.tenant_status); with it every
        #: sync shows a starved tenant on its own HPA, where one looks first
        self.capacity_probe = capacity_probe
        #: control.checkpoint.CheckpointStore: the state kept across syncs,
        #: restored here, before the first sync, so that a restarted
        #: controller keeps the stabilization windows in force
        self.checkpoint_store = checkpoint_store
        self.restored_from_checkpoint = False
        if checkpoint_store is not None:
            self.restored_from_checkpoint = self._restore_checkpoint()

    # ---- durable state (control/checkpoint.py) -----------------------------

    def _checkpoint_state(self) -> dict:
        return {
            "version": CHECKPOINT_VERSION,
            "saved_at": self.clock.now(),
            "recommendations": [list(r) for r in self._recommendations],
            "scale_events": [list(e) for e in self._scale_events],
            "last_good_sync_at": self.last_good_sync_at,
            "status": {
                "desired_replicas": self.status.desired_replicas,
                "last_metric_values": dict(self.status.last_metric_values),
                "last_scale_time": self.status.last_scale_time,
                "last_reason": self.status.last_reason,
                "conditions": [
                    [c.type, c.status, c.reason, c.message, c.last_transition_time]
                    for c in self.status.conditions.values()
                ],
            },
            "condition_history": [list(h) for h in self.condition_history],
        }

    def _save_checkpoint(self) -> None:
        if self.checkpoint_store is not None:
            self.checkpoint_store.save(self._checkpoint_state())

    def _restore_checkpoint(self) -> bool:
        """Take the store's state if there is one of this schema.  The
        scale target stays the truth for ``current_replicas``: a checkpoint
        restores history, never the world."""
        state = self.checkpoint_store.load()
        if not state or state.get("version") != CHECKPOINT_VERSION:
            return False
        self._recommendations = [
            (float(ts), int(rec)) for ts, rec in state.get("recommendations", [])
        ]
        events = [(float(ts), int(n)) for ts, n in state.get("scale_events", [])]
        if events:
            self._scale_events = events
        self.last_good_sync_at = state.get("last_good_sync_at")
        status = state.get("status", {})
        self.status.desired_replicas = int(status.get("desired_replicas", self.target.replicas))
        self.status.last_metric_values = dict(status.get("last_metric_values", {}))
        self.status.last_scale_time = status.get("last_scale_time")
        self.status.last_reason = status.get("last_reason", "")
        for type_, st, reason, message, transition in status.get("conditions", []):
            self.status.conditions[type_] = HPACondition(
                type_, bool(st), reason, message, transition
            )
        self.condition_history = [
            (float(ts), type_, bool(st), reason)
            for ts, type_, st, reason in state.get("condition_history", [])
        ]
        coverage.hit("hpa_condition:checkpoint_restored")
        return True

    def _set_condition(self, type_: str, status: bool, reason: str, message: str = "") -> None:
        now = self.clock.now()
        prev = self.status.conditions.get(type_)
        transition = (
            now if prev is None or prev.status != status else prev.last_transition_time
        )
        if prev is None or prev.status != status or prev.reason != reason:
            self.condition_history.append((now, type_, status, reason))
        self.status.conditions[type_] = HPACondition(type_, status, reason, message, transition)

    def _unavailable_reason(self) -> str:
        """Kubernetes' reason for "could not fetch the metric", by the type
        of the first metric spec (FailedGet{Object,Pods,Resource,External}Metric,
        as kube-controller-manager sets it on ScalingActive)."""
        spec = self.metrics[0] if self.metrics else None
        if isinstance(spec, PodsMetricSpec):
            return "FailedGetPodsMetric"
        if isinstance(spec, ResourceMetricSpec):
            return "FailedGetResourceMetric"
        if isinstance(spec, ExternalMetricSpec):
            return "FailedGetExternalMetric"
        return "FailedGetObjectMetric"

    def _metric_proposal(self, spec: MetricSpec, current: int) -> int | None:
        if isinstance(spec, ResourceMetricSpec):
            # the metrics.k8s.io path: no adapter, the reader's per-pod percent
            if self.resource_metrics is None:
                return None
            utils = self.resource_metrics.pod_utilizations(spec.resource)
            if not utils:
                return None
            value = sum(utils) / len(utils)
            self.status.last_metric_values[f"resource/{spec.resource}"] = value
            target = spec.target_average_utilization
        elif self.adapter is None:
            return None
        elif isinstance(spec, PodsMetricSpec):
            if self.pod_lister is None:
                return None
            pods = self.pod_lister.ready_pod_names()
            values = self.adapter.get_pods_metric(self.namespace, spec.metric_name, pods)
            if not values:
                return None
            target = spec.target_average_value
            value = sum(values.values()) / len(values)
            missing = len(pods) - len(values)
            if missing > 0 and abs(value / target - 1.0) > self.TOLERANCE:
                # Kubernetes' conservative missing-pod rule: pods without a
                # sample never amplify the move.  Toward scale-up they count
                # 0, toward scale-down at the target; if that erases or
                # flips the signal, hold.
                if value > target:
                    adjusted = sum(values.values()) / len(pods)
                    assumed = "0"
                else:
                    adjusted = (sum(values.values()) + target * missing) / len(pods)
                    assumed = "target"
                note = f"{missing}/{len(pods)} pods missing {spec.metric_name}; assumed {assumed}"
                flipped = (adjusted > target) != (value > target)
                if flipped or abs(adjusted / target - 1.0) <= self.TOLERANCE:
                    self._proposal_notes.append(note + "; held")
                    self.status.last_metric_values[f"pods/{spec.metric_name}"] = adjusted
                    return current
                self._proposal_notes.append(note)
                value = adjusted
            self.status.last_metric_values[f"pods/{spec.metric_name}"] = value
        elif isinstance(spec, ExternalMetricSpec):
            series = self.adapter.get_external_metric(
                spec.namespace or self.namespace, spec.metric_name, spec.selector
            )
            if not series:
                return None
            total = sum(series)
            self.status.last_metric_values[f"external/{spec.metric_name}"] = total
            if spec.target_average_value is not None:
                # per replica of the target's current count, not per running pod
                value = total / max(1, current)
                target = spec.target_average_value
            else:
                value = total
                target = spec.target_value
        else:
            value = self.adapter.get_object_metric(spec.described_object, spec.metric_name)
            if value is None:
                return None
            self.status.last_metric_values[spec.metric_name] = value
            if spec.average:  # target.type: AverageValue, per current replica
                value = value / max(1, current)
            target = spec.target_value
        ratio = value / target
        if abs(ratio - 1.0) <= self.TOLERANCE:
            return current
        return max(1, math.ceil(current * ratio))

    def _replicas_at(self, ts: float) -> int:
        """Replica count in effect at time ``ts`` (for policy period lookback)."""
        replicas = self._scale_events[0][1]
        for when, count in self._scale_events:
            if when <= ts:
                replicas = count
            else:
                break
        return replicas

    def _policy_limit(self, rules: ScalingRules, current: int, up: bool) -> int:
        """Largest (Max) / smallest (Min) replica count the policies allow now."""
        if rules.select_policy == "Disabled":
            return current
        if not rules.policies:
            return self.max_replicas if up else self.min_replicas
        now = self.clock.now()
        limits = []
        for policy in rules.policies:
            base = self._replicas_at(now - policy.period_seconds)
            if policy.type == "Pods":
                delta = policy.value
            elif policy.type == "Percent":
                delta = math.ceil(base * policy.value / 100.0)
            else:
                raise ValueError(f"unknown policy type {policy.type}")
            limits.append(base + delta if up else base - delta)
        if up:
            return max(limits) if rules.select_policy == "Max" else min(limits)
        # scale-down: "Max" selects the policy permitting the most change,
        # i.e. the lowest allowed replica count.
        return min(limits) if rules.select_policy == "Max" else max(limits)

    def _stabilized(self, recommendation: int) -> int:
        """Apply stabilization windows over the recommendation history."""
        now = self.clock.now()
        self._recommendations.append((now, recommendation))
        down_window = self.behavior.scale_down.stabilization_window_seconds
        up_window = self.behavior.scale_up.stabilization_window_seconds
        keep = max(down_window, up_window)
        self._recommendations = [
            (ts, rec) for ts, rec in self._recommendations if now - ts <= keep
        ]
        stabilized = recommendation
        current = self.target.replicas
        if recommendation < current and down_window > 0:
            stabilized = max(
                rec for ts, rec in self._recommendations if now - ts <= down_window
            )
        elif recommendation > current and up_window > 0:
            stabilized = min(
                rec for ts, rec in self._recommendations if now - ts <= up_window
            )
        return stabilized

    def sync_once(self) -> HPAStatus:
        """One sync pass.  Untraced, this is the v2 algorithm
        (``_sync_inner``) alone; traced, the pass runs inside an ``hpa_sync``
        span that links the adapter_query spans it issued (a tracer scope)
        and, when replicas change, is followed by a ``scale_event`` span, the
        start of every lineage walk."""
        with profile.stage("hpa:sync"):
            return self._sync_once_impl()

    def _sync_once_impl(self) -> HPAStatus:
        if self.tracer is None and self.selfmetrics is None:
            status = self._sync_inner()
            self._save_checkpoint()
            return status
        before = self.target.replicas
        wall_start = time.perf_counter()
        span = None
        if self.tracer is not None:
            span = self.tracer.open("hpa_sync")
            self.tracer.push_scope()
        try:
            status = self._sync_inner()
        finally:
            children = self.tracer.pop_scope() if self.tracer is not None else ()
        duration = time.perf_counter() - wall_start
        if self.selfmetrics is not None:
            self.selfmetrics.observe_sync(
                duration, status.last_reason, None if span is None else span.span_id
            )
        if span is not None:
            self.tracer.close(
                span,
                children,
                reason=status.last_reason,
                current_replicas=before,
                desired_replicas=status.desired_replicas,
                duration_seconds=duration,
            )
            after = self.target.replicas
            if after != before:
                event = self.tracer.emit(
                    "scale_event",
                    {"from_replicas": before, "to_replicas": after},
                    links=(span.span_id,),
                )
                self._observe_propagation(event)
        self._save_checkpoint()
        return status

    def _observe_propagation(self, event) -> None:
        """The first scale event after each workload_change observes the
        signal-propagation latency (clock seconds) into the self-metrics
        histogram, exemplared with the scale_event span: the live
        counterpart of ``obs/latency.propagation_report``."""
        if self.selfmetrics is None:
            return
        changes = self.tracer.spans_of("workload_change")
        if not changes:
            return
        change = changes[-1]
        if change.span_id == self._propagation_seen:
            return
        self._propagation_seen = change.span_id
        latency = max(0.0, event.start - change.start)
        self.selfmetrics.observe_propagation(latency, event.span_id)

    def _capacity_conditions(self) -> None:
        """The tenant's standing in the capacity economy as conditions
        (control/capacity.py), at every sync whatever its metrics say: a
        tenant starved of devices usually still has metrics."""
        if self.capacity_probe is None:
            return
        probe = self.capacity_probe()
        pending = int(probe.get("pending_pods", 0))
        if pending > 0:
            coverage.hit("hpa_condition:unschedulable")
        self._set_condition(
            "Unschedulable",
            pending > 0,
            "PodsPending" if pending > 0 else "AllPodsScheduled",
            f"{pending} pod(s) awaiting pool capacity"
            if pending > 0 else "every pod of the target is scheduled",
        )
        evicting = int(probe.get("evictions_in_flight", 0))
        if evicting > 0:
            coverage.hit("hpa_condition:preempting")
        self._set_condition(
            "Preempting",
            evicting > 0,
            "EvictionInProgress" if evicting > 0 else "NoVictims",
            f"{evicting} lower-priority victim(s) in eviction grace"
            if evicting > 0 else "no evictions running on the target's behalf",
        )
        limited = bool(probe.get("fair_share_limited", False))
        if limited:
            coverage.hit("hpa_condition:fair_share_limited")
        self._set_condition(
            "FairShareLimited",
            limited,
            "OverFairShare" if limited else "WithinFairShare",
            "over weighted fair share while peers wait under theirs"
            if limited else "within the tenant's weighted fair share",
        )

    def _sync_inner(self) -> HPAStatus:
        current = self.target.replicas
        self.status.current_replicas = current
        self._proposal_notes = []
        self._set_condition(
            "AbleToScale", True, "SucceededGetScale",
            "the HPA controller was able to get the target's current scale",
        )
        self._capacity_conditions()
        proposals = [self._metric_proposal(spec, current) for spec in self.metrics]
        valid = [p for p in proposals if p is not None]
        if not valid:
            # All metrics unavailable: hold (K8s skips scaling on total failure).
            coverage.hit("hpa_condition:sync_metrics_unavailable")
            self.status.last_reason = "metrics unavailable; holding"
            self.status.desired_replicas = current
            self._set_condition(
                "ScalingActive", False, self._unavailable_reason(),
                "the HPA was unable to compute the replica count: no metric values available",
            )
            return self.status
        self._set_condition(
            "ScalingActive", True, "ValidMetricFound",
            "the HPA was able to successfully calculate a replica count",
        )
        self.last_good_sync_at = self.clock.now()

        recommendation = max(valid)  # multiple metrics -> largest proposal
        recommendation = min(max(recommendation, self.min_replicas), self.max_replicas)
        desired = self._stabilized(recommendation)

        if desired > current:
            coverage.hit("hpa_condition:sync_scale_up")
            limit = self._policy_limit(self.behavior.scale_up, current, up=True)
            desired = min(desired, max(limit, current))
            reason = f"scale up {current}->{desired} (policy limit {limit})"
        elif desired < current:
            coverage.hit("hpa_condition:sync_scale_down")
            limit = self._policy_limit(self.behavior.scale_down, current, up=False)
            desired = max(desired, min(limit, current))
            reason = f"scale down {current}->{desired} (policy limit {limit})"
        else:
            coverage.hit("hpa_condition:sync_within_tolerance")
            reason = "within tolerance / stabilized"

        desired = min(max(desired, self.min_replicas), self.max_replicas)
        q = self.replica_quantum
        if q > 1:
            # Round up when growing (a partial slice serves nothing, so the
            # policy step may be exceeded by < one quantum; rounding down
            # instead could deadlock against a tight policy forever).  When
            # shrinking, round up TOWARD current: behavior policies are hard
            # caps in the down direction, so hold the extra slice until the
            # policy window permits removing a whole one.  Bounds that aren't
            # slice multiples would themselves strand a partial slice; snap
            # them inward (the constructor guarantees max_replicas >= q).
            max_q = self.max_replicas // q * q
            min_q = min(math.ceil(self.min_replicas / q) * q, max_q)
            coverage.hit("hpa_condition:quantum_round")
            if desired > current:
                desired = min(math.ceil(desired / q) * q, max_q)
            elif desired < current:
                desired = max(min(math.ceil(desired / q) * q, current), min_q)
            elif desired % q:
                # the current count is itself a partial slice (scaled by
                # hand, or a misaligned target adopted): release the
                # stranded hosts, which serve nothing anyway
                desired = max(desired // q * q, min_q)
                coverage.hit("hpa_condition:repair_partial_slice")
                reason = f"repair partial slice {current}->{desired}"
        if self._proposal_notes:
            reason += " [" + "; ".join(self._proposal_notes) + "]"
        self.status.desired_replicas = desired
        self.status.last_reason = reason

        if desired != current:
            self.target.scale_to(desired)
            now = self.clock.now()
            self._scale_events.append((now, desired))
            self._prune_scale_events(now)
            self.status.last_scale_time = now
            self._set_condition(
                "AbleToScale", True, "SucceededRescale",
                f"the HPA controller was able to update the target scale to {desired}",
            )
            if self.on_scale:
                self.on_scale(current, desired)
        return self.status

    def _prune_scale_events(self, now: float) -> None:
        """Keep only events needed for policy lookback: everything within the
        longest policy period, plus the last event at-or-before that cutoff."""
        periods = [
            p.period_seconds
            for rules in (self.behavior.scale_up, self.behavior.scale_down)
            for p in rules.policies
        ]
        cutoff = now - (max(periods) if periods else 0.0)
        keep_from = 0
        for i, (ts, _) in enumerate(self._scale_events):
            if ts <= cutoff:
                keep_from = i
        self._scale_events = self._scale_events[keep_from:]
