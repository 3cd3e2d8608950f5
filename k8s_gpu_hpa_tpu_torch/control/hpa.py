"""HorizontalPodAutoscaler controller (L5): ``autoscaling/v2`` semantics, the
Object-metric subset.

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

and replica quanta: on a StatefulSet of multi-host slices replicas move in
whole slices (``replica_quantum``, read from the HPA's
``k8s-tpu-hpa/replica-quantum`` annotation by ``quantum_from_manifest``).

Status conditions, Pods/Resource/External metrics, tracing and checkpoints
are not ported.  ``shipped_behavior()`` is the behavior stanza of
deploy/tpu-test-hpa.yaml written in code, ``shipped_multihost_behavior()``
that of deploy/tpu-test-multihost-hpa.yaml, and ``train_metrics()`` the
metrics of deploy/tpu-train-hpa.yaml, so the port reads no YAML.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Protocol

from k8s_gpu_hpa_tpu_torch.control.adapter import CustomMetricsAdapter, ObjectReference
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock


@dataclass
class ObjectMetricSpec:
    """One Object-type metric with a ``target.type: Value`` target: the
    object's metric compares directly with ``target_value``
    (cuda-test-hpa.yaml:13-21)."""

    metric_name: str
    target_value: float
    described_object: ObjectReference


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
class HPAStatus:
    current_replicas: int = 1
    desired_replicas: int = 1
    last_metric_values: dict[str, float] = field(default_factory=dict)
    last_scale_time: float | None = None
    #: why the last sync made its decision, for observability/tests
    last_reason: str = ""


class HPAController:
    """One HPA object + its sync loop (kube-controller-manager syncs every 15 s
    by default)."""

    TOLERANCE = 0.1  # kube-controller-manager --horizontal-pod-autoscaler-tolerance

    def __init__(
        self,
        target: ScalableTarget,
        metrics: list[ObjectMetricSpec],
        adapter: CustomMetricsAdapter,
        clock: Clock,
        min_replicas: int = 1,
        max_replicas: int = 4,
        behavior: HPABehavior | None = None,
        replica_quantum: int = 1,
    ):
        self.target = target
        self.metrics = metrics
        self.adapter = adapter
        self.clock = clock
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.behavior = behavior or HPABehavior()
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
        self.status = HPAStatus(current_replicas=target.replicas)
        #: (ts, recommendation) ring for stabilization windows
        self._recommendations: list[tuple[float, int]] = []
        #: (ts, replicas_after) scale-event log for policy period lookback
        self._scale_events: list[tuple[float, int]] = [(clock.now(), target.replicas)]

    def _metric_proposal(self, spec: ObjectMetricSpec, current: int) -> int | None:
        value = self.adapter.get_object_metric(spec.described_object, spec.metric_name)
        if value is None:
            return None
        self.status.last_metric_values[spec.metric_name] = value
        ratio = value / spec.target_value
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
        """One sync pass of the v2 algorithm."""
        current = self.target.replicas
        self.status.current_replicas = current
        proposals = [self._metric_proposal(spec, current) for spec in self.metrics]
        valid = [p for p in proposals if p is not None]
        if not valid:
            # All metrics unavailable: hold (K8s skips scaling on total failure).
            self.status.last_reason = "metrics unavailable; holding"
            self.status.desired_replicas = current
            return self.status

        recommendation = max(valid)  # multiple metrics -> largest proposal
        recommendation = min(max(recommendation, self.min_replicas), self.max_replicas)
        desired = self._stabilized(recommendation)

        if desired > current:
            limit = self._policy_limit(self.behavior.scale_up, current, up=True)
            desired = min(desired, max(limit, current))
            reason = f"scale up {current}->{desired} (policy limit {limit})"
        elif desired < current:
            limit = self._policy_limit(self.behavior.scale_down, current, up=False)
            desired = max(desired, min(limit, current))
            reason = f"scale down {current}->{desired} (policy limit {limit})"
        else:
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
            if desired > current:
                desired = min(math.ceil(desired / q) * q, max_q)
            elif desired < current:
                desired = max(min(math.ceil(desired / q) * q, current), min_q)
            elif desired % q:
                # the current count is itself a partial slice (scaled by
                # hand, or a misaligned target adopted): release the
                # stranded hosts, which serve nothing anyway
                desired = max(desired // q * q, min_q)
                reason = f"repair partial slice {current}->{desired}"
        self.status.desired_replicas = desired
        self.status.last_reason = reason

        if desired != current:
            self.target.scale_to(desired)
            now = self.clock.now()
            self._scale_events.append((now, desired))
            self._prune_scale_events(now)
            self.status.last_scale_time = now
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
