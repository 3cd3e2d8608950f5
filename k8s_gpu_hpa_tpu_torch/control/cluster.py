"""Simulated Kubernetes cluster for closed-loop runs on a virtual clock.

Counterpart of ``k8s_gpu_hpa_tpu/control/cluster.py``.  It models the
cluster behaviors the autoscaling loop depends on:

- **nodes with accelerator devices** (an extended resource such as
  ``nvidia.com/gpu``, cuda-test-deployment.yaml:22);
- **pod lifecycle with start latency**: schedule, image pull and container
  start, the dominant term in the reference's overshoot defect
  (README.md:123), with first-fit binding and a 5 s requeue while no node
  fits;
- **deployments as scalable targets** (the HPA sets ``spec.replicas``
  through the scale subresource), scaled down newest pod first;
- **per-node exporter endpoints** serving exposition from simulated device
  activity, with the exporter's own collection interval (the reference
  collects every 10 s, dcgm-exporter.yaml:37);
- **kube-state-metrics**: ``kube_pod_labels`` (the join input of
  cuda-test-prometheusrule.yaml:13) and the one-hot ``kube_pod_status_phase``;
- **faults**: a pod killed, a node preempted or drained and restored, a
  node added or removed, and a deployment whose containers crash on start
  (CrashLoopBackOff with the kubelet's 10 s to 300 s backoff).

Load model: a deployment's offered load is a function of time.  In
``shared`` mode the running replicas divide it (a service that scales with
its replicas); in ``per_pod`` mode each replica runs at the offered
intensity (the reference's vectorAdd busy-loop, cuda-test-deployment.yaml:19).
The device model of ``_NodeExporter._collect`` is the JAX package's, number
for number, so both packages serve the same series: it models the shipped
HPA contract, not a measured card.

With a tracer (``obs/trace.py``), each fresh collection sweep of a node
exporter emits an ``exporter_sample`` span, the root of every metric
lineage.  With a capacity scheduler installed (``control/capacity.py``),
every placement goes through its ladder of priority, fair share and
preemption instead of first-fit.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable

from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text
from k8s_gpu_hpa_tpu_torch.metrics.schema import ChipSample, MetricFamily, families_from_chips
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock


@dataclass
class SimPod:
    name: str
    namespace: str
    labels: dict[str, str]
    deployment: str
    chips_requested: int
    #: Pending -> Running -> (deleted); CrashLoopBackOff while its container
    #: crashes on start; Terminating while a preemption's grace period runs
    #: (its devices still held, until control/capacity.py releases them and
    #: queues the pod again as Pending)
    phase: str = "Pending"
    node: str | None = None
    chip_ids: list[int] = field(default_factory=list)
    created_at: float = 0.0
    started_at: float | None = None
    #: container restarts while crashlooping (drives the restart backoff)
    restart_count: int = 0


@dataclass
class SimNode:
    name: str
    num_chips: int
    #: device index -> pod name
    allocations: dict[int, str] = field(default_factory=dict)
    #: False after preemption: the node is gone, its exporter unreachable
    ready: bool = True
    #: False while cordoned (drain) or preempted: the scheduler skips it
    schedulable: bool = True

    def free_chips(self) -> list[int]:
        return [i for i in range(self.num_chips) if i not in self.allocations]


class SimDeployment:
    """A scalable target with an offered-load model."""

    def __init__(
        self,
        cluster: "SimCluster",
        name: str,
        app_label: str,
        chips_per_pod: int = 1,
        namespace: str = "default",
        load_fn: Callable[[float], float] | None = None,
        load_mode: str = "shared",  # "shared" | "per_pod"
        hosts_per_slice: int = 1,
        barrier_idle_util: float = 2.0,
        util_cap: float = 100.0,
    ):
        if load_mode not in ("shared", "per_pod"):
            raise ValueError(f"load_mode must be 'shared' or 'per_pod', not {load_mode!r}")
        self.cluster = cluster
        self.name = name
        self.namespace = namespace
        self.app_label = app_label
        self.chips_per_pod = chips_per_pod
        self.load_fn = load_fn or (lambda t: 0.0)
        self.load_mode = load_mode
        # Multi-host slices: ``replicas`` counts pods (hosts), one workload
        # replica is ``hosts_per_slice`` pods, and the hosts of an incomplete
        # slice wait at the rendezvous, near idle, serving nothing: hence
        # the HPA's replica quantum.
        self.hosts_per_slice = hosts_per_slice
        self.barrier_idle_util = barrier_idle_util
        #: the workload's measured signal ceiling: a real generator's gauge
        #: saturates at what its kernels reach, not at 100, and a simulator
        #: with an ideal ceiling shows an inert pairing as healthy
        self.util_cap = util_cap
        self.replicas = 0

    def scale_to(self, replicas: int) -> None:
        self.replicas = replicas
        self.cluster.reconcile(self)

    def ready_pod_names(self) -> list[str]:
        """The PodLister contract (control/hpa.py): the ready pods a
        Pods-type metric averages over."""
        return [p.name for p in self.cluster.running_pods(self.name)]

    def pod_utilization(self, pod: SimPod) -> float:
        """The running pod's tensor-core utilization now, percent."""
        offered = self.load_fn(self.cluster.clock.now())
        running = self.cluster.running_pods(self.name)
        if self.hosts_per_slice > 1:
            ordered = sorted(running, key=lambda p: (p.created_at, p.name))
            n_slices = len(ordered) // self.hosts_per_slice
            active = ordered[: n_slices * self.hosts_per_slice]
            if pod not in active:
                # a host waiting at the rendezvous never reads hotter than
                # the workload's ceiling
                return min(self.util_cap, self.barrier_idle_util)
            if self.load_mode == "per_pod":
                return min(self.util_cap, offered)
            return min(self.util_cap, offered / n_slices)
        if self.load_mode == "per_pod":
            return min(self.util_cap, offered)
        if not running:
            return 0.0
        return min(self.util_cap, offered / len(running))


@dataclass
class SimResourceMetrics:
    """The metrics.k8s.io stand-in (the metrics-server path of a plain HPA):
    the utilization percent of each of one deployment's running pods, from
    the same load model as the device metrics."""

    cluster: "SimCluster"
    deployment: str

    def pod_utilizations(self, resource: str) -> list[float]:
        dep = self.cluster.deployments[self.deployment]
        return [dep.pod_utilization(p) for p in self.cluster.running_pods(self.deployment)]


class _NodeExporter:
    """One node's metrics endpoint, with a collection-interval cache: its
    readings refresh at most every ``sample_interval`` seconds, as
    dcgm-exporter's ``-c`` flag sets (dcgm-exporter.yaml:37).  Serving is
    instant; the cache is the staleness."""

    def __init__(self, cluster: "SimCluster", node: SimNode, sample_interval: float):
        self.cluster = cluster
        self.node = node
        self.sample_interval = sample_interval
        #: the collected families are the cache; the text is rendered at
        #: most once a sweep, so structured scrapes never encode it
        self._families: list[MetricFamily] | None = None
        self._text: str | None = None
        self._last_sample = -float("inf")
        #: span id of the sweep behind the current cache: the lineage root a
        #: scrape of this exporter links to (a cache hit keeps the old id,
        #: since the data is that old)
        self.last_span_id: int | None = None

    def _refresh(self) -> None:
        now = self.cluster.clock.now()
        if self._families is None or now - self._last_sample >= self.sample_interval:
            self._families = self._collect()
            self._text = None
            self._last_sample = now
            if self.cluster.tracer is not None:
                self.last_span_id = self.cluster.tracer.emit(
                    "exporter_sample",
                    {"node": self.node.name, "chips": self.node.num_chips},
                ).span_id

    def fetch(self) -> str:
        self._refresh()
        if self._text is None:
            self._text = encode_text(self._families)
        return self._text

    def fetch_families(self) -> list[MetricFamily]:
        """The same cached sweep as ``fetch``, without the text."""
        self._refresh()
        return self._families

    def _collect(self) -> list[MetricFamily]:
        chips: list[ChipSample] = []
        attribution: dict[int, tuple[str, str]] = {}
        for idx in range(self.node.num_chips):
            pod_name = self.node.allocations.get(idx)
            util = 0.0
            hbm_used = 0.5e9
            if pod_name is not None:
                pod = self.cluster.pods[pod_name]
                util = self.cluster.deployments[pod.deployment].pod_utilization(pod)
                hbm_used = 0.5e9 + 15.5e9 * util / 100.0
                attribution[idx] = (pod.namespace, pod.name)
            chips.append(ChipSample(
                accel_index=idx,
                tensorcore_util=util,
                duty_cycle=min(100.0, util * 1.1),
                hbm_usage_bytes=hbm_used,
                hbm_total_bytes=16e9,
                hbm_bw_util=util * 0.6,
            ))
        return families_from_chips(chips, node=self.node.name, attribution=attribution)


class SimCluster:
    """Nodes, pods and deployments, with the two simulated metric endpoints."""

    #: the one-hot phases kube-state-metrics exports a pod; the simulation's
    #: CrashLoopBackOff reports Pending, as the kubelet does upstream
    KSM_PHASES = ("Pending", "Running", "Succeeded", "Failed", "Unknown")
    _KSM_PHASE_MAP = {"CrashLoopBackOff": "Pending", "Terminating": "Running"}

    def __init__(
        self,
        clock: VirtualClock,
        nodes: list[tuple[str, int]] | None = None,
        pod_start_latency: float = 12.0,
        exporter_sample_interval: float = 1.0,
        tracer=None,
    ):
        self.clock = clock
        #: obs.Tracer, or None; settable after construction (control/loop.py
        #: wires it in)
        self.tracer = tracer
        self.nodes = {
            name: SimNode(name, chips) for name, chips in (nodes or [("tpu-node-0", 8)])
        }
        self.pods: dict[str, SimPod] = {}
        self.deployments: dict[str, SimDeployment] = {}
        self.pod_start_latency = pod_start_latency
        self.exporter_sample_interval = exporter_sample_interval
        #: deployments whose containers crash on start
        self.crashlooping: set[str] = set()
        #: control/capacity.CapacityScheduler once the capacity economy is
        #: installed: every placement then goes through it, not first-fit
        self.scheduler = None
        #: called when a node joins or leaves; control/loop.py keeps its
        #: scrape targets in step through these
        self.on_node_added: list[Callable[[SimNode], None]] = []
        self.on_node_removed: list[Callable[[str], None]] = []
        self._name_counter = itertools.count()
        self.exporters = {
            name: _NodeExporter(self, node, exporter_sample_interval)
            for name, node in self.nodes.items()
        }

    # ---- deployment and pod lifecycle ---------------------------------------

    def add_deployment(self, deployment: SimDeployment, replicas: int = 1) -> None:
        self.deployments[deployment.name] = deployment
        deployment.scale_to(replicas)

    def deployment_pods(self, name: str) -> list[SimPod]:
        return [p for p in self.pods.values() if p.deployment == name]

    def running_pods(self, name: str) -> list[SimPod]:
        return [p for p in self.deployment_pods(name) if p.phase == "Running"]

    def reconcile(self, deployment: SimDeployment) -> None:
        pods = sorted(self.deployment_pods(deployment.name), key=lambda p: p.created_at)
        while len(pods) > deployment.replicas:
            self._delete_pod(pods.pop())  # newest first, as a ReplicaSet scales down
        while len(pods) < deployment.replicas:
            pods.append(self._create_pod(deployment))

    def _create_pod(self, deployment: SimDeployment) -> SimPod:
        pod = SimPod(
            name=f"{deployment.name}-{next(self._name_counter):04x}",
            namespace=deployment.namespace,
            labels={"app": deployment.app_label},
            deployment=deployment.name,
            chips_requested=deployment.chips_per_pod,
            created_at=self.clock.now(),
        )
        self.pods[pod.name] = pod
        self.clock.call_later(self.pod_start_latency, lambda: self._try_start(pod))
        return pod

    def _try_start(self, pod: SimPod) -> None:
        if pod.name not in self.pods or pod.phase in ("Running", "Terminating"):
            return
        if pod.deployment in self.crashlooping:
            # the container starts and crashes at once: CrashLoopBackOff with
            # the kubelet's restart delay (10 s, doubling, at most 5 min),
            # holding no device meanwhile
            pod.restart_count += 1
            pod.phase = "CrashLoopBackOff"
            delay = min(300.0, 10.0 * 2.0 ** (pod.restart_count - 1))
            self.clock.call_later(delay, lambda: self._try_start(pod))
            return
        if self.scheduler is not None:
            placed = self.scheduler.try_place(pod)
        else:
            placed = self._first_fit(pod)
        if placed:
            return
        # no node fits: stay Pending and retry (kube-scheduler's requeue)
        pod.phase = "Pending"
        self.clock.call_later(5.0, lambda: self._try_start(pod))

    def _first_fit(self, pod: SimPod) -> bool:
        """The first node that fits."""
        return any(self.bind_pod(pod, node) for node in self.nodes.values())

    def bind_pod(self, pod: SimPod, node: SimNode) -> bool:
        """Bind a pod to a node if it fits: the one place devices are
        assigned, where first-fit and the capacity scheduler both end, so the
        pool's audit has one allocation path to trust."""
        if not (node.ready and node.schedulable):
            return False
        free = node.free_chips()
        if len(free) < pod.chips_requested:
            return False
        pod.node = node.name
        pod.chip_ids = free[: pod.chips_requested]
        for idx in pod.chip_ids:
            node.allocations[idx] = pod.name
        pod.phase = "Running"
        pod.started_at = self.clock.now()
        return True

    def _delete_pod(self, pod: SimPod) -> None:
        if pod.node is not None:
            node = self.nodes.get(pod.node)
            if node is not None:
                for idx in pod.chip_ids:
                    node.allocations.pop(idx, None)
        self.pods.pop(pod.name, None)
        if self.scheduler is not None:
            self.scheduler.on_pod_deleted(pod)

    def kill_pod(self, name: str) -> None:
        """Crash one pod (OOM, eviction, a node's blip): its devices free at
        once and the ReplicaSet creates a replacement, which pays the start
        latency."""
        pod = self.pods.get(name)
        if pod is None:
            raise KeyError(f"no pod {name}")
        self._delete_pod(pod)
        self.reconcile(self.deployments[pod.deployment])

    # ---- node lifecycle ------------------------------------------------------

    def add_node(self, name: str, num_chips: int) -> SimNode:
        """A node joins (the cluster autoscaler's provision completes):
        schedulable at once, with its own exporter endpoint."""
        if name in self.nodes:
            raise ValueError(f"node {name} already exists")
        node = SimNode(name, num_chips)
        self.nodes[name] = node
        self.exporters[name] = _NodeExporter(self, node, self.exporter_sample_interval)
        for callback in list(self.on_node_added):
            callback(node)
        return node

    def remove_node(self, name: str) -> None:
        """A node leaves for good (the autoscaler's scale-down).  A node that
        still holds devices is refused: deprovisioning kills no pod, which
        is what ``drain_node`` and ``preempt_node`` model."""
        node = self.nodes.get(name)
        if node is None:
            raise KeyError(f"no node {name}")
        if node.allocations:
            raise ValueError(f"node {name} still has {len(node.allocations)} chips allocated")
        self.nodes.pop(name)
        self.exporters.pop(name, None)
        for callback in list(self.on_node_removed):
            callback(name)

    def _evict(self, name: str, reclaim: bool) -> None:
        """Delete every pod on the node (with ``reclaim``, the node's devices
        go with it), then let each affected deployment create its
        replacements."""
        victims = [p for p in self.pods.values() if p.node == name]
        affected: dict[str, SimDeployment] = {}
        for pod in victims:
            affected[pod.deployment] = self.deployments[pod.deployment]
            self._delete_pod(pod)
        if reclaim:
            self.nodes[name].allocations.clear()
        for deployment in affected.values():
            self.reconcile(deployment)

    def preempt_node(self, name: str) -> None:
        """Spot reclamation: the node vanishes now.  Its pods die with their
        devices, its exporter becomes unreachable (scrapes fail rather than
        freeze), and the replacements must fit on the other nodes or wait
        Pending (``restore_node``)."""
        node = self.nodes[name]
        node.ready = False
        node.schedulable = False
        self._evict(name, reclaim=True)

    def drain_node(self, name: str) -> None:
        """``kubectl drain``: cordon, then evict the node's pods, which
        reschedule elsewhere.  The node stays up and its exporter serves
        idle devices."""
        self.nodes[name].schedulable = False
        self._evict(name, reclaim=False)

    def restore_node(self, name: str) -> None:
        """A preempted or drained node comes back, schedulable with every
        device free; Pending pods take it at their next retry."""
        node = self.nodes[name]
        node.ready = True
        node.schedulable = True
        node.allocations.clear()

    # ---- crash on start ----------------------------------------------------

    def start_crashloop(self, deployment_name: str) -> None:
        """The deployment's containers crash on start: every pod that would
        start enters CrashLoopBackOff instead.  Running pods keep running;
        ``kill_pod`` puts their replacements in the loop."""
        if deployment_name not in self.deployments:
            raise KeyError(f"no deployment {deployment_name}")
        self.crashlooping.add(deployment_name)

    def stop_crashloop(self, deployment_name: str) -> None:
        """Clear the fault; backing-off pods start at their next retry."""
        self.crashlooping.discard(deployment_name)

    # ---- metric endpoints --------------------------------------------------

    def exporter_fetch(self, node_name: str) -> str:
        if not self.nodes[node_name].ready:
            raise ConnectionError(f"node {node_name} is down (preempted)")
        return self.exporters[node_name].fetch()

    def exporter_fetch_families(self, node_name: str) -> list[MetricFamily]:
        """``exporter_fetch`` without the text: the same data, the same
        failure of a node that is down."""
        if not self.nodes[node_name].ready:
            raise ConnectionError(f"node {node_name} is down (preempted)")
        return self.exporters[node_name].fetch_families()

    def exporter_sample_span(self, node_name: str) -> int | None:
        """Span id of the sweep behind the node exporter's current cache
        (the provider of ``ScrapeTarget.trace_origin``)."""
        return self.exporters[node_name].last_span_id

    def kube_state_metrics_families(self) -> list[MetricFamily]:
        """``kube_pod_labels`` and the one-hot ``kube_pod_status_phase`` of
        every pod, Pending ones too (kube-state-metrics exports them; the
        rule's inner join with the device metric they lack keeps them out of
        the average)."""
        fam = MetricFamily("kube_pod_labels", "gauge", "Kubernetes pod labels")
        phase_fam = MetricFamily(
            "kube_pod_status_phase", "gauge", "Kubernetes pod status phase (one-hot)"
        )
        for pod in self.pods.values():
            fam.add(1.0, namespace=pod.namespace, pod=pod.name,
                    label_app=pod.labels.get("app", ""))
            reported = self._KSM_PHASE_MAP.get(pod.phase, pod.phase)
            for phase in self.KSM_PHASES:
                phase_fam.add(1.0 if phase == reported else 0.0,
                              namespace=pod.namespace, pod=pod.name, phase=phase)
        return [fam, phase_fam]

    def kube_state_metrics_text(self) -> str:
        """``kube_state_metrics_families`` as text exposition."""
        return encode_text(self.kube_state_metrics_families())
