"""The capacity economy: a bounded pool of device slices shared by tenants.

Counterpart of ``k8s_gpu_hpa_tpu/control/capacity.py``.  Without it every
pipeline scales one deployment against devices without end; with it demand
can exceed supply, and this module arbitrates, after Borg's economy of
priority and quota and the Kubernetes scheduler's preemption:

- **SlicePool**: the bounded inventory, every ready node's devices, counted
  in slice quanta (``slice_quantum`` devices a slice, the whole-slice rule
  ``control/operator.py`` keeps for replicas).  The node is the slice
  boundary: a pod's devices all come from one node, and a provisioned node
  holds whole quanta.  ``audit()`` checks conservation (used + free ==
  capacity) and the boundary at any tick.
- **TenantSpec**: one deployment's standing: its PriorityClass value, its
  weight in the weighted fair share, a preemption budget (the evictions it
  tolerates) and a starvation budget (its longest acceptable Pending stint).
- **CapacityScheduler**: once installed (``SimCluster.scheduler``) it
  replaces first-fit.  Pending pods are admitted by priority; at saturation
  a weighted max-min fair share arbitrates within a priority (a tenant over
  its share yields to tenants of its priority or higher under theirs:
  ``FairShareLimited``); a higher priority preempts strictly lower ones by
  eviction with grace: a victim turns ``Terminating``, keeps its devices
  through the grace period, then queues again as ``Pending``.  No victim is
  deleted, so each preemption shows in the timeline as pending, admitted,
  preempted and readmitted.
- **ClusterAutoscaler**: node provisioning in whole quanta, with a
  provisioning delay, a timeout when the cloud hangs (the ``provision_fail``
  fault) and exponential backoff over consecutive failures.
- **PoolMetricsExporter**: the pool's own ``tpu_pool_*`` families as one
  more scrape target, so saturation shows through exposition, TSDB and
  dashboard like every other signal.

Nothing here advances the clock: the scheduler reacts to callbacks
(``SimCluster._try_start``'s retries) and schedules later work with
``clock.call_later``.  Each branch is a ``scheduler_branch:*`` coverage
probe and each placement a ``capacity:try_place`` profile stage (obs/).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimNode, SimPod
from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text
from k8s_gpu_hpa_tpu_torch.metrics.schema import MetricFamily
from k8s_gpu_hpa_tpu_torch.obs import coverage, profile

# ---- the pool's own metric names (the dashboard's and manifests' contract) --

POOL_CAPACITY_CHIPS = "tpu_pool_capacity_chips"
POOL_USED_CHIPS = "tpu_pool_used_chips"
POOL_PENDING_PODS = "tpu_pool_pending_pods"
POOL_PENDING_SECONDS = "tpu_pool_tenant_pending_seconds"
POOL_PREEMPTIONS = "tpu_pool_preemptions_total"
POOL_FAIR_SHARE_LIMITED = "tpu_pool_fair_share_limited"
POOL_PROVISIONED_NODES = "tpu_pool_provisioned_nodes"
POOL_PROVISIONS = "tpu_pool_provisions_total"
POOL_PROVISION_FAILURES = "tpu_pool_provision_failures_total"

#: every family the pool's exporter serves
POOL_METRIC_NAMES = (
    POOL_CAPACITY_CHIPS,
    POOL_USED_CHIPS,
    POOL_PENDING_PODS,
    POOL_PENDING_SECONDS,
    POOL_PREEMPTIONS,
    POOL_FAIR_SHARE_LIMITED,
    POOL_PROVISIONED_NODES,
    POOL_PROVISIONS,
    POOL_PROVISION_FAILURES,
)

#: the scrape target's name (one for the cluster, as the pipeline's own is)
POOL_TARGET_NAME = "capacity-pool"


@dataclass
class TenantSpec:
    """One tenant's standing in the economy, keyed by deployment name.

    ``priority`` is a PriorityClass value: the order of admission, and only
    a strictly higher one preempts.  ``weight`` is the tenant's weight in
    the fair share among tenants of one priority.  ``preemption_budget``
    caps the evictions the tenant's pods suffer over a run (at its budget a
    tenant is no longer a victim).  ``starvation_budget_s`` is the longest
    Pending stint the tenant accepts; the crunch's contract fails past it."""

    name: str
    priority: int = 0
    weight: float = 1.0
    preemption_budget: int = 8
    starvation_budget_s: float = 600.0

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")
        if self.preemption_budget < 0:
            raise ValueError(f"tenant {self.name}: preemption_budget must be >= 0")


class SlicePool:
    """The bounded inventory over a ``SimCluster``'s ready nodes.

    Every count is recomputed from the cluster's allocation maps: the pool
    keeps no state of its own that could drift, so ``audit()`` checks
    something real."""

    def __init__(self, cluster: SimCluster, slice_quantum: int = 1):
        if slice_quantum < 1:
            raise ValueError("slice_quantum must be >= 1")
        self.cluster = cluster
        self.slice_quantum = slice_quantum

    def _ready_nodes(self) -> list[SimNode]:
        return [n for n in self.cluster.nodes.values() if n.ready]

    def capacity(self) -> int:
        return sum(n.num_chips for n in self._ready_nodes())

    def used(self) -> int:
        return sum(len(n.allocations) for n in self._ready_nodes())

    def free(self) -> int:
        return sum(len(n.free_chips()) for n in self._ready_nodes())

    def audit(self) -> dict:
        """Conservation and the slice boundary, checkable at any tick.

        Each violation is a sentence:
        - a node whose used + free is not its capacity;
        - a device allocated to a pod that is gone, or that does not claim
          it (``pod.node``, ``pod.chip_ids``);
        - a pod holding devices of a missing node, or not the count it
          asked for, or devices its node does not give it (a pod never
          straddles the node boundary);
        - a node whose device count is not whole slice quanta.
        """
        violations: list[str] = []
        cluster = self.cluster
        q = self.slice_quantum
        for node in cluster.nodes.values():
            if node.num_chips % q:
                violations.append(
                    f"node {node.name}: {node.num_chips} chips is not a "
                    f"whole number of slice quanta ({q})"
                )
            used = len(node.allocations)
            free = len(node.free_chips())
            if used + free != node.num_chips:
                violations.append(
                    f"node {node.name}: used {used} + free {free} != "
                    f"capacity {node.num_chips}"
                )
            for idx, pod_name in node.allocations.items():
                pod = cluster.pods.get(pod_name)
                if pod is None:
                    violations.append(
                        f"node {node.name} chip {idx}: allocated to missing "
                        f"pod {pod_name}"
                    )
                elif pod.node != node.name or idx not in pod.chip_ids:
                    violations.append(
                        f"node {node.name} chip {idx}: pod {pod_name} does "
                        f"not claim it (pod.node={pod.node})"
                    )
        for pod in cluster.pods.values():
            if pod.node is None:
                continue
            node = cluster.nodes.get(pod.node)
            if node is None:
                violations.append(f"pod {pod.name}: bound to missing node {pod.node}")
                continue
            if len(pod.chip_ids) != pod.chips_requested:
                violations.append(
                    f"pod {pod.name}: holds {len(pod.chip_ids)} chips, "
                    f"requested {pod.chips_requested}"
                )
            for idx in pod.chip_ids:
                if node.allocations.get(idx) != pod.name:
                    violations.append(
                        f"pod {pod.name}: claims chip {idx} on {node.name} "
                        f"but the node disagrees"
                    )
        capacity, used, free = self.capacity(), self.used(), self.free()
        return {
            "capacity": capacity,
            "used": used,
            "free": free,
            "conserved": used + free == capacity and not violations,
            "violations": violations,
        }


class ClusterAutoscaler:
    """The simulated cluster autoscaler: it provisions nodes of whole quanta.

    ``request()`` is cheap and limits itself: the scheduler calls it at every
    failed placement, and it does nothing while an attempt is in flight,
    while it backs off after failures, or at ``max_nodes``.  A failed
    attempt (the ``provision_fail`` fault) is a hung cloud API: it fails only
    after ``provision_timeout_s``, and consecutive failures back off
    exponentially (doubling from the base, capped), so the pressure to retry
    comes from the pods' requeues, not from a loop here."""

    def __init__(
        self,
        cluster: SimCluster,
        node_chips: int,
        provision_delay_s: float = 90.0,
        provision_timeout_s: float = 120.0,
        max_nodes: int = 2,
        backoff_base_s: float = 30.0,
        backoff_cap_s: float = 480.0,
    ):
        self.cluster = cluster
        self.node_chips = node_chips
        self.provision_delay_s = provision_delay_s
        self.provision_timeout_s = provision_timeout_s
        self.max_nodes = max_nodes
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        #: the ``provision_fail`` fault: an attempt started while it is set
        #: fails after the timeout, even if the fault clears meanwhile (a
        #: request already lost to a dead API)
        self.failing = False
        #: how many ``provision_fail`` windows overlap now
        self._fail_depth = 0
        self.in_flight = False
        self.backoff_until = -float("inf")
        self.consecutive_failures = 0
        self.provisions_total = 0
        self.provision_failures_total = 0
        #: autoscaled nodes in the cluster now, in the order provisioned
        self.provisioned: list[str] = []
        self._counter = 0
        #: set by build_capacity, so provisioning lands in the timeline
        self.scheduler: CapacityScheduler | None = None
        self._empty_since: dict[str, float] = {}

    def _event(self, event: str, detail: str = "") -> None:
        if self.scheduler is not None:
            self.scheduler.record_event("", "", event, detail)

    def request(self) -> None:
        clock = self.cluster.clock
        now = clock.now()
        if (
            self.in_flight
            or now < self.backoff_until
            or len(self.provisioned) >= self.max_nodes
        ):
            return
        self.in_flight = True
        will_fail = self.failing
        coverage.hit("scheduler_branch:provision_requested")
        self._event(
            "provision_requested",
            f"{self.node_chips}-chip node, "
            + (
                f"will time out after {self.provision_timeout_s:.0f}s"
                if will_fail
                else f"ready in {self.provision_delay_s:.0f}s"
            ),
        )
        if will_fail:
            clock.call_later(self.provision_timeout_s, self._provision_failed)
        else:
            clock.call_later(self.provision_delay_s, self._provision_done)

    def _provision_failed(self) -> None:
        self.in_flight = False
        self.provision_failures_total += 1
        self.consecutive_failures += 1
        delay = min(
            self.backoff_cap_s,
            self.backoff_base_s * 2.0 ** (self.consecutive_failures - 1),
        )
        self.backoff_until = self.cluster.clock.now() + delay
        coverage.hit("scheduler_branch:provision_backoff")
        self._event(
            "provision_failed",
            f"failure #{self.consecutive_failures}, backing off {delay:.0f}s",
        )

    def _provision_done(self) -> None:
        self.in_flight = False
        self.consecutive_failures = 0
        name = f"tpu-auto-{self._counter}"
        self._counter += 1
        self.cluster.add_node(name, self.node_chips)
        self.provisioned.append(name)
        self.provisions_total += 1
        coverage.hit("scheduler_branch:provision_done")
        self._event("provisioned", f"node {name} ({self.node_chips} chips)")

    def reap_idle(self, idle_s: float = 120.0) -> list[str]:
        """Remove the autoscaled nodes that have been empty for ``idle_s``:
        the autoscaler's scale-down, called by a harness's monitor (the
        crunch's tick).  A node that holds devices is never removed."""
        now = self.cluster.clock.now()
        reaped: list[str] = []
        for name in list(self.provisioned):
            node = self.cluster.nodes.get(name)
            if node is None:
                self.provisioned.remove(name)
                self._empty_since.pop(name, None)
                continue
            if node.allocations:
                self._empty_since.pop(name, None)
                continue
            since = self._empty_since.setdefault(name, now)
            if now - since >= idle_s:
                self.cluster.remove_node(name)
                self.provisioned.remove(name)
                self._empty_since.pop(name, None)
                reaped.append(name)
                coverage.hit("scheduler_branch:node_reaped")
                self._event("node_reaped", f"node {name} idle {idle_s:.0f}s")
        return reaped


class CapacityScheduler:
    """Admission by priority and fair share, with preemption by eviction
    with grace.

    Installed as ``cluster.scheduler``, it takes every placement attempt of
    ``SimCluster._try_start`` through ``try_place``, a pod at a time:

    1. **The yield walk**: the Pending pods in order of priority (highest
       first), used devices over weight (least first) and wait (longest
       first); the pod binds only with what is left after every pod ahead of
       it that fits somewhere has its claim reserved.  A pod ahead that fits
       nowhere reserves nothing (backfill: a big pod's wait must not idle
       devices a small pod can use; its remedies are the two steps below).
    2. **The fair-share gate**: at saturation, a tenant at or over its
       weighted share yields to a tenant of its priority or higher under
       theirs: no preemption and no provisioning for it
       (``FairShareLimited``).  Demand of a lower priority never limits a
       higher one.
    3. **Preemption**: where strictly lower-priority victims on some node can
       make room (within their budgets), evict the cheapest set with grace:
       they turn ``Terminating`` holding their devices, release them when the
       grace ends and queue again as ``Pending``.  Devices that evictions in
       flight will free count as available, so retries never evict more.
    4. **Provisioning**: ask the autoscaler for another node.

    Each transition lands in ``events``, the timeline ``simulate --scenario
    crunch`` prints and its contract scores."""

    def __init__(
        self,
        cluster: SimCluster,
        pool: SlicePool,
        tenants: list[TenantSpec] | None = None,
        grace_s: float = 5.0,
    ):
        self.cluster = cluster
        self.pool = pool
        self.grace_s = grace_s
        self.tenants: dict[str, TenantSpec] = {t.name: t for t in (tenants or [])}
        self.autoscaler: ClusterAutoscaler | None = None
        #: the (t, tenant, pod, event, detail) timeline: transitions only
        #: (pending, admitted, preempted, evicted, readmitted,
        #: fair_share_limited, provision_*), never a retry, so it stays small
        self.events: list[dict] = []
        #: pod name -> the clock time its current Pending stint began
        self.pending_since: dict[str, float] = {}
        #: tenant -> pending seconds of closed stints (open ones are added
        #: when read)
        self.pending_seconds_total: dict[str, float] = {}
        #: tenant -> its longest closed Pending stint
        self.max_pending_stint: dict[str, float] = {}
        #: tenant -> each admission's wait, the time-to-capacity samples the
        #: crunch's p95 gates score
        self.admission_waits: dict[str, list[float]] = {}
        #: tenant -> evictions suffered (against its preemption budget)
        self.preemptions_suffered: dict[str, int] = {}
        self.preemptions_total = 0
        #: tenant -> evictions in flight on its behalf (its HPA's
        #: ``Preempting`` condition)
        self.evictions_for: dict[str, int] = {}
        #: pods evicted at least once: their next admission is a readmission
        self._preempted_pods: set[str] = set()
        #: tenant -> held back by the fair-share gate now
        self.fair_share_limited: dict[str, bool] = {}
        cluster.scheduler = self

    # ---- tenants -----------------------------------------------------------

    def tenant(self, name: str) -> TenantSpec:
        """The deployment's tenant spec; a deployment with none takes part
        at priority 0 and weight 1."""
        spec = self.tenants.get(name)
        if spec is None:
            spec = TenantSpec(name=name)
            self.tenants[name] = spec
        return spec

    def used_chips(self, tenant: str) -> int:
        return sum(
            len(p.chip_ids)
            for p in self.cluster.deployment_pods(tenant)
            if p.node is not None
        )

    def pending_pods(self, tenant: str) -> list[SimPod]:
        return [p for p in self.cluster.deployment_pods(tenant) if p.phase == "Pending"]

    def fair_share_chips(self, tenant: str) -> float:
        """The tenant's weighted share of the capacity, among tenants with
        pods."""
        active = [
            name for name in self.cluster.deployments if self.cluster.deployment_pods(name)
        ]
        if tenant not in active:
            active.append(tenant)
        total_weight = sum(self.tenant(name).weight for name in active)
        if total_weight <= 0:
            return 0.0
        return self.pool.capacity() * self.tenant(tenant).weight / total_weight

    # ---- the timeline --------------------------------------------------------

    def record_event(self, tenant: str, pod: str, event: str, detail: str = "") -> None:
        self.events.append({
            "t": self.cluster.clock.now(),
            "tenant": tenant,
            "pod": pod,
            "event": event,
            "detail": detail,
        })

    # ---- placement -----------------------------------------------------------

    def _schedulable_nodes(self) -> list[SimNode]:
        return [n for n in self.cluster.nodes.values() if n.ready and n.schedulable]

    def _pending_order(self) -> list[SimPod]:
        now = self.cluster.clock.now()
        share: dict[str, float] = {}

        def key(p: SimPod):
            spec = self.tenant(p.deployment)
            if p.deployment not in share:
                share[p.deployment] = self.used_chips(p.deployment) / spec.weight
            return (
                -spec.priority,
                share[p.deployment],
                self.pending_since.get(p.name, now),
                p.name,
            )

        pending = [p for p in self.cluster.pods.values() if p.phase == "Pending"]
        return sorted(pending, key=key)

    def try_place(self, pod: SimPod) -> bool:
        """One placement attempt (``_try_start``'s hook): True if the pod
        bound to a node; on False it stays Pending for the cluster's retry."""
        with profile.stage("capacity:try_place"):
            nodes = self._schedulable_nodes()
            budget = {n.name: len(n.free_chips()) for n in nodes}
            for other in self._pending_order():
                if other.name == pod.name:
                    for node in nodes:
                        if budget[node.name] >= pod.chips_requested and (
                            self.cluster.bind_pod(pod, node)
                        ):
                            self._record_admission(pod)
                            return True
                    break
                for name in budget:
                    if budget[name] >= other.chips_requested:
                        budget[name] -= other.chips_requested
                        break
            self._note_pending(pod)
            if self._fair_share_gate(pod):
                return False
            self._maybe_preempt(pod)
            if self.autoscaler is not None:
                self.autoscaler.request()
            return False

    def _note_pending(self, pod: SimPod) -> None:
        if pod.name in self.pending_since:
            return
        self.pending_since[pod.name] = self.cluster.clock.now()
        self.record_event(
            pod.deployment,
            pod.name,
            "pending",
            f"{pod.chips_requested} chips wanted, pool "
            f"{self.pool.used()}/{self.pool.capacity()} used",
        )

    def _record_admission(self, pod: SimPod) -> None:
        now = self.cluster.clock.now()
        since = self.pending_since.pop(pod.name, None)
        wait = 0.0 if since is None else now - since
        tenant = pod.deployment
        self.pending_seconds_total[tenant] = self.pending_seconds_total.get(tenant, 0.0) + wait
        self.max_pending_stint[tenant] = max(self.max_pending_stint.get(tenant, 0.0), wait)
        self.admission_waits.setdefault(tenant, []).append(wait)
        if self.fair_share_limited.get(tenant):
            self.fair_share_limited[tenant] = False
        if pod.name in self._preempted_pods:
            event = "readmitted"
            coverage.hit("scheduler_branch:readmitted")
        else:
            event = "admitted"
            coverage.hit("scheduler_branch:admitted")
        self.record_event(tenant, pod.name, event, f"node {pod.node}, waited {wait:.1f}s")

    def _fair_share_gate(self, pod: SimPod) -> bool:
        """True if the pod's tenant must yield: over its share while a
        tenant of its priority or higher, under its own share, has pods
        Pending."""
        tenant = pod.deployment
        spec = self.tenant(tenant)
        over = self.used_chips(tenant) + pod.chips_requested > self.fair_share_chips(tenant)
        limited = False
        if over:
            for other in self.cluster.deployments:
                if other == tenant:
                    continue
                if self.tenant(other).priority < spec.priority:
                    continue
                if self.pending_pods(other) and (
                    self.used_chips(other) < self.fair_share_chips(other)
                ):
                    limited = True
                    break
        if limited:
            coverage.hit("scheduler_branch:fair_share_gate")
        if limited and not self.fair_share_limited.get(tenant):
            self.record_event(
                tenant,
                pod.name,
                "fair_share_limited",
                f"using {self.used_chips(tenant)} of "
                f"{self.fair_share_chips(tenant):.1f}-chip share",
            )
        self.fair_share_limited[tenant] = limited
        return limited

    def _incoming_chips(self, node: SimNode) -> int:
        """The node's devices already being freed: its eviction victims'."""
        return sum(
            len(p.chip_ids)
            for p in self.cluster.pods.values()
            if p.node == node.name and p.phase == "Terminating"
        )

    def _maybe_preempt(self, pod: SimPod) -> None:
        spec = self.tenant(pod.deployment)
        nodes = self._schedulable_nodes()
        # evictions in flight that will make room on some node: this retry
        # waits for them and evicts no more
        for node in nodes:
            if len(node.free_chips()) + self._incoming_chips(node) >= pod.chips_requested:
                return
        for node in nodes:
            victims = self._victims_on(node, spec, pod.chips_requested)
            if victims is None:
                continue
            for victim in victims:
                self._evict(victim, pod.deployment)
            return

    def _victims_on(self, node: SimNode, spec: TenantSpec, need: int) -> list[SimPod] | None:
        """The cheapest set of victims on one node that frees ``need``
        devices for a pod of ``spec``'s priority, or None.  Victims are
        Running pods of strictly lower-priority tenants within their
        budgets, lowest priority first and, within one, newest first (as a
        ReplicaSet scales down)."""
        have = len(node.free_chips()) + self._incoming_chips(node)
        candidates = [
            p
            for p in self.cluster.pods.values()
            if p.node == node.name
            and p.phase == "Running"
            and self.tenant(p.deployment).priority < spec.priority
            and self.preemptions_suffered.get(p.deployment, 0)
            < self.tenant(p.deployment).preemption_budget
        ]
        candidates.sort(key=lambda p: (self.tenant(p.deployment).priority, -p.created_at))
        chosen: list[SimPod] = []
        budget_left = {
            t: self.tenant(t).preemption_budget - self.preemptions_suffered.get(t, 0)
            for t in {p.deployment for p in candidates}
        }
        for p in candidates:
            if have >= need:
                break
            if budget_left[p.deployment] <= 0:
                continue
            budget_left[p.deployment] -= 1
            chosen.append(p)
            have += len(p.chip_ids)
        return chosen if chosen and have >= need else None

    def _evict(self, victim: SimPod, beneficiary: str) -> None:
        victim.phase = "Terminating"
        tenant = victim.deployment
        self.preemptions_suffered[tenant] = self.preemptions_suffered.get(tenant, 0) + 1
        self.preemptions_total += 1
        self.evictions_for[beneficiary] = self.evictions_for.get(beneficiary, 0) + 1
        self._preempted_pods.add(victim.name)
        coverage.hit("scheduler_branch:preemption_eviction")
        self.record_event(
            tenant,
            victim.name,
            "preempted",
            f"victim of {beneficiary}, grace {self.grace_s:.0f}s",
        )
        self.cluster.clock.call_later(
            self.grace_s, lambda: self._finish_eviction(victim, beneficiary)
        )

    def _finish_eviction(self, victim: SimPod, beneficiary: str) -> None:
        self.evictions_for[beneficiary] = max(0, self.evictions_for.get(beneficiary, 0) - 1)
        if self.cluster.pods.get(victim.name) is not victim or victim.phase != "Terminating":
            return  # deleted during the grace (a scale-down, a lost node)
        if victim.node is not None:
            node = self.cluster.nodes.get(victim.node)
            if node is not None:
                for idx in victim.chip_ids:
                    node.allocations.pop(idx, None)
        victim.node = None
        victim.chip_ids = []
        victim.phase = "Pending"
        coverage.hit("scheduler_branch:eviction_requeued")
        self.record_event(victim.deployment, victim.name, "evicted", "grace elapsed, re-queued")
        self._note_pending(victim)
        self.cluster._try_start(victim)

    # ---- lifecycle hooks -----------------------------------------------------

    def on_pod_deleted(self, pod: SimPod) -> None:
        """The cluster's hook: close a deleted pod's Pending stint, so its
        tenant's accounting keeps no stint of a pod that is gone."""
        since = self.pending_since.pop(pod.name, None)
        if since is not None:
            tenant = pod.deployment
            stint = self.cluster.clock.now() - since
            self.pending_seconds_total[tenant] = self.pending_seconds_total.get(tenant, 0.0) + stint
            self.max_pending_stint[tenant] = max(self.max_pending_stint.get(tenant, 0.0), stint)
        self._preempted_pods.discard(pod.name)

    # ---- per-tenant status (the HPA's capacity probe) ------------------------

    def _open_stints(self, tenant: str) -> list[float]:
        now = self.cluster.clock.now()
        return [
            now - since
            for name, since in self.pending_since.items()
            if (p := self.cluster.pods.get(name)) is not None and p.deployment == tenant
        ]

    def open_stint_seconds(self, tenant: str) -> float:
        """How long the tenant's longest open Pending stint has run."""
        return max(self._open_stints(tenant), default=0.0)

    def tenant_pending_seconds(self, tenant: str) -> float:
        """Pending seconds so far, open stints included (monotonic: the
        counter the pool's exporter serves)."""
        return self.pending_seconds_total.get(tenant, 0.0) + sum(self._open_stints(tenant))

    def tenant_status(self, tenant: str) -> dict:
        """The capacity probe an ``HPAController`` shows as conditions."""
        return {
            "pending_pods": len(self.pending_pods(tenant)),
            "evictions_in_flight": self.evictions_for.get(tenant, 0),
            "fair_share_limited": bool(self.fair_share_limited.get(tenant)),
            "preemptions_suffered": self.preemptions_suffered.get(tenant, 0),
            "pending_seconds": self.tenant_pending_seconds(tenant),
        }


class PoolMetricsExporter:
    """The pool's own families as one more scrape target (``capacity-pool``),
    on the path of every other signal, so a saturated pool shows on the
    shipped dashboard."""

    def __init__(self, scheduler: CapacityScheduler):
        self.scheduler = scheduler

    def families(self) -> list[MetricFamily]:
        sched = self.scheduler
        pool = sched.pool
        cap = MetricFamily(POOL_CAPACITY_CHIPS, "gauge", "Chips on ready nodes")
        cap.add(float(pool.capacity()))
        used = MetricFamily(POOL_USED_CHIPS, "gauge", "Chips allocated to pods")
        used.add(float(pool.used()))
        pending = MetricFamily(POOL_PENDING_PODS, "gauge", "Pods awaiting capacity per tenant")
        waiting = MetricFamily(
            POOL_PENDING_SECONDS,
            "counter",
            "Cumulative seconds tenant pods have waited for capacity",
        )
        preempt = MetricFamily(POOL_PREEMPTIONS, "counter", "Evictions suffered per tenant")
        limited = MetricFamily(
            POOL_FAIR_SHARE_LIMITED,
            "gauge",
            "1 while the tenant is held back by the fair-share gate",
        )
        for t in sorted(set(sched.tenants) | set(sched.cluster.deployments)):
            pending.add(float(len(sched.pending_pods(t))), tenant=t)
            waiting.add(sched.tenant_pending_seconds(t), tenant=t)
            preempt.add(float(sched.preemptions_suffered.get(t, 0)), tenant=t)
            limited.add(1.0 if sched.fair_share_limited.get(t) else 0.0, tenant=t)
        auto = sched.autoscaler
        nodes = MetricFamily(POOL_PROVISIONED_NODES, "gauge", "Autoscaled nodes in the cluster")
        provs = MetricFamily(POOL_PROVISIONS, "counter", "Successful node provisions")
        fails = MetricFamily(POOL_PROVISION_FAILURES, "counter", "Failed node provisions")
        nodes.add(float(len(auto.provisioned)) if auto else 0.0)
        provs.add(float(auto.provisions_total) if auto else 0.0)
        fails.add(float(auto.provision_failures_total) if auto else 0.0)
        return [cap, used, pending, waiting, preempt, limited, nodes, provs, fails]

    def exposition(self) -> str:
        return encode_text(self.families())


@dataclass
class CapacityConfig:
    """What ``AutoscalingPipeline(capacity=...)`` needs to stand the economy
    up: the tenants, the slice quantum, the eviction grace and, when
    ``autoscaler_node_chips`` is set, the simulated cluster autoscaler."""

    tenants: list[TenantSpec] = field(default_factory=list)
    slice_quantum: int = 1
    grace_s: float = 5.0
    #: devices an autoscaled node holds (whole quanta); None: no autoscaler
    autoscaler_node_chips: int | None = None
    autoscaler_max_nodes: int = 2
    provision_delay_s: float = 90.0
    provision_timeout_s: float = 120.0
    backoff_base_s: float = 30.0
    backoff_cap_s: float = 480.0


def build_capacity(cluster: SimCluster, config: CapacityConfig) -> CapacityScheduler:
    """Stand the pool, the scheduler and (if configured) the autoscaler up
    over a cluster, the scheduler installed as ``cluster.scheduler``."""
    pool = SlicePool(cluster, slice_quantum=config.slice_quantum)
    scheduler = CapacityScheduler(cluster, pool, tenants=config.tenants, grace_s=config.grace_s)
    if config.autoscaler_node_chips is not None:
        if config.autoscaler_node_chips % config.slice_quantum:
            raise ValueError(
                f"autoscaler_node_chips={config.autoscaler_node_chips} is not "
                f"a whole number of slice quanta ({config.slice_quantum})"
            )
        autoscaler = ClusterAutoscaler(
            cluster,
            node_chips=config.autoscaler_node_chips,
            provision_delay_s=config.provision_delay_s,
            provision_timeout_s=config.provision_timeout_s,
            max_nodes=config.autoscaler_max_nodes,
            backoff_base_s=config.backoff_base_s,
            backoff_cap_s=config.backoff_cap_s,
        )
        autoscaler.scheduler = scheduler
        scheduler.autoscaler = autoscaler
    return scheduler


def capacity_selfcheck() -> dict:
    """The doctor's small crunch (``check_capacity_pool``): one 4-device
    node, a low-priority tenant filling it, a high-priority tenant whose
    arrival forces a preemption, and an autoscaler whose new node lets the
    victim run again: the whole round trip of pending, admitted, preempted
    and readmitted, with the pool audited every virtual second."""
    from k8s_gpu_hpa_tpu_torch.control.cluster import SimDeployment
    from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

    clock = VirtualClock()
    cluster = SimCluster(clock, nodes=[("tpu-node-0", 4)], pod_start_latency=2.0)
    scheduler = build_capacity(
        cluster,
        CapacityConfig(
            tenants=[
                TenantSpec("hi", priority=100, weight=1.0, preemption_budget=0),
                TenantSpec("lo", priority=0, weight=1.0, preemption_budget=4),
            ],
            slice_quantum=4,
            grace_s=2.0,
            autoscaler_node_chips=4,
            autoscaler_max_nodes=1,
            provision_delay_s=20.0,
        ),
    )
    lo = SimDeployment(cluster, "lo", "lo", chips_per_pod=4)
    hi = SimDeployment(cluster, "hi", "hi", chips_per_pod=4)
    audits: list[dict] = []

    def tick():
        audits.append(scheduler.pool.audit())
        clock.call_later(1.0, tick)

    clock.call_later(1.0, tick)
    cluster.add_deployment(lo, replicas=1)
    clock.advance(10.0)  # lo runs on the only node
    cluster.add_deployment(hi, replicas=1)  # which forces lo's preemption
    clock.advance(60.0)  # the eviction, a provision, lo's readmission
    lo_events = [e["event"] for e in scheduler.events if e["tenant"] == "lo"]
    return {
        "ticks": len(audits),
        "conserved_all": all(a["conserved"] for a in audits),
        "violations": [v for a in audits for v in a["violations"]],
        "preemption_roundtrip": all(
            e in lo_events for e in ("admitted", "preempted", "readmitted")
        ),
        "lo_running": len(cluster.running_pods("lo")),
        "hi_running": len(cluster.running_pods("hi")),
        "preemptions_total": scheduler.preemptions_total,
        "events": [
            {k: e[k] for k in ("t", "tenant", "pod", "event")} for e in scheduler.events
        ],
    }
