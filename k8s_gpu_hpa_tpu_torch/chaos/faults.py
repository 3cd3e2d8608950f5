"""Declarative fault specs and the injectors that break a running pipeline.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/faults.py``, cut to the kinds whose
layers the port has.  A :class:`FaultSpec` names what breaks, when and for
how long; ``FAULT_KINDS`` knows how to break it against an
``AutoscalingPipeline``:

========================  =====================================================
kind                      layer it breaks
========================  =====================================================
``exporter_outage``       L2→L3: one (or every) exporter target refuses
``frozen_samples``        L2: the exporter answers, but its payload never changes
``slow_scrape``           L2→L3: the fetch runs past the target's deadline
``scrape_blackout``       L3: every scrape target down (a Prometheus outage)
``node_preempt``          L0/L1: the node is reclaimed: its pods die with their
                          devices and its exporter is unreachable
``node_drain``            L1: cordon and evict; node and exporter stay up
``pod_crash``             L1: one pod dies once; its replacement pays the start
``crashloop``             L1: containers crash on start (CrashLoopBackOff)
``adapter_blackout``      L4: the custom-metrics API answers nothing
``tsdb_restart``          L3: the TSDB crashes and is rebuilt from its WAL
``hpa_restart``           L5: controller failover, restored from its checkpoint
``adapter_restart``       L4: the adapter is replaced (it keeps no state)
``wal_truncate``          L3: the WAL's tail is destroyed, then the TSDB restarts
``tenant_spike``          L1: one tenant's offered load jumps (a capacity crunch)
``provision_fail``        L0: the cluster autoscaler's cloud API hangs
``region_kill``           fleet: a whole region dies; its demand spills to the
                          surviving regions (control/region.py)
``region_partition``      fleet: a region is cut off from the exchange; it
                          serves its own tenants and takes no spill
``objstore_outage``       fleet: the object store under the exchange is down
========================  =====================================================

An injector returns a ``clear()`` that undoes its fault; a duration-0 fault
(``pod_crash`` and the four restarts) is an impulse and clears at once.  ``clear()`` is
idempotent and safe under overlapping windows: a scrape target gets its
pristine fetch back only when the last fault over it clears, whatever order
the windows close in, and the same per-resource depth counter holds a node
(``node_preempt``, ``node_drain``), a deployment's crash loop and the
adapter slot (``adapter_blackout``) down until their last window closes.

The three fleet kinds act through the pipeline's region and its
``GlobalControlPlane`` (``pipeline.region.plane``), and raise ValueError,
in the JAX package's words, on a pipeline that is not part of one.
``inject_fault`` records the kind's ``fault_kind:*`` coverage probe
(obs/coverage.py) before it dispatches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

from k8s_gpu_hpa_tpu_torch.metrics.tsdb import (
    ScrapeTarget,
    StructuredExposition,
    TimedExposition,
)
from k8s_gpu_hpa_tpu_torch.obs import coverage

if TYPE_CHECKING:  # pragma: no cover - typing only
    from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline


@dataclass
class FaultSpec:
    """One declared fault: ``kind`` at ``at`` seconds (schedule-relative),
    lasting ``duration`` seconds (0 = impulse).  ``target`` names the victim
    where the kind needs one (a scrape target, node, pod or deployment);
    None picks the kind's default (every exporter, the first node, the
    pipeline's deployment...)."""

    kind: str
    at: float
    duration: float = 0.0
    target: str | None = None
    params: dict = field(default_factory=dict)
    name: str = ""

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} "
                f"(have: {', '.join(sorted(FAULT_KINDS))})"
            )
        if self.at < 0 or self.duration < 0:
            raise ValueError("fault at/duration must be >= 0")
        if not self.name:
            suffix = f"/{self.target}" if self.target else ""
            self.name = f"{self.kind}{suffix}@{self.at:g}s"


ClearFn = Callable[[], None]


def _scrape_targets(pipe: "AutoscalingPipeline", selector: str | None) -> list[ScrapeTarget]:
    if selector is None:
        return [t for t in pipe.scraper.targets if t.name.startswith("exporter/")]
    matches = [t for t in pipe.scraper.targets if t.name == selector]
    if not matches:
        raise ValueError(f"no scrape target named {selector!r}")
    return matches


def _wrap_fetch(targets: list[ScrapeTarget], make_fetch) -> ClearFn:
    """Wrap each target's fetch; returns an idempotent, overlap-safe
    ``clear``.  Overlapping faults stack (each wraps the fetch in force),
    and a per-target depth counter restores the pristine fetch only when
    the last of them clears: restoring the fetch captured at injection
    would bring back a cleared fault when windows close out of order."""
    wrapped: list[ScrapeTarget] = []
    for target in targets:
        depth = getattr(target, "_fault_depth", 0)
        if depth == 0:
            target._pristine_fetch = target.fetch
        target._fault_depth = depth + 1
        target.fetch = make_fetch(target, target.fetch)
        wrapped.append(target)
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        for target in wrapped:
            target._fault_depth -= 1
            if target._fault_depth == 0:
                target.fetch = target._pristine_fetch

    return clear


def _inject_exporter_outage(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    def make_fetch(target, _original):
        def refused():
            raise ConnectionError(f"{target.name}: connection refused (chaos)")

        return refused

    return _wrap_fetch(_scrape_targets(pipe, spec.target), make_fetch)


def _inject_frozen_samples(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """The endpoint keeps answering with the exposition it served at
    injection: scrapes succeed, ``up`` stays 1 and the values never move.
    Text, families and timed wrappers all freeze; the exporter replaces,
    never mutates, its cached families, so a captured list stays still."""

    def make_fetch(_target, original):
        frozen = original()
        if isinstance(frozen, TimedExposition):
            frozen = frozen.text
        elif isinstance(frozen, StructuredExposition):
            frozen = frozen.families
        return lambda: frozen

    return _wrap_fetch(_scrape_targets(pipe, spec.target), make_fetch)


def _inject_slow_scrape(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """Every fetch reports ``params["latency"]`` seconds (default twice the
    target's deadline), so the scraper gives it up as a timeout."""

    def make_fetch(target, original):
        latency = float(spec.params.get("latency", target.deadline * 2.0))

        def slow():
            fetched = original()
            if isinstance(fetched, TimedExposition):
                return TimedExposition(fetched.text, duration=latency)
            if isinstance(fetched, StructuredExposition):
                return StructuredExposition(fetched.families, duration=latency)
            if isinstance(fetched, str):
                return TimedExposition(fetched, duration=latency)
            return StructuredExposition(fetched, duration=latency)

        return slow

    return _wrap_fetch(_scrape_targets(pipe, spec.target), make_fetch)


def _inject_scrape_blackout(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    def make_fetch(target, _original):
        def refused():
            raise ConnectionError(f"{target.name}: scrape blackout (chaos)")

        return refused

    return _wrap_fetch(list(pipe.scraper.targets), make_fetch)


def _default_node(pipe: "AutoscalingPipeline", spec: FaultSpec) -> str:
    if spec.target is not None:
        if spec.target not in pipe.cluster.nodes:
            raise ValueError(f"no node named {spec.target!r}")
        return spec.target
    return next(iter(pipe.cluster.nodes))


def _node_fault_window(pipe: "AutoscalingPipeline", node_name: str) -> ClearFn:
    """Overlap-safe node restoration, the shape of ``_wrap_fetch``: stacked
    preempt and drain windows over one node each raise its depth, and
    ``restore_node`` runs only when the last of them closes."""
    node = pipe.cluster.nodes[node_name]
    node._fault_depth = getattr(node, "_fault_depth", 0) + 1
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        node._fault_depth -= 1
        if node._fault_depth == 0:
            pipe.cluster.restore_node(node_name)

    return clear


def _inject_node_preempt(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    node = _default_node(pipe, spec)
    clear = _node_fault_window(pipe, node)
    pipe.cluster.preempt_node(node)
    return clear


def _inject_node_drain(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    node = _default_node(pipe, spec)
    clear = _node_fault_window(pipe, node)
    pipe.cluster.drain_node(node)
    return clear


def _inject_pod_crash(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    cluster = pipe.cluster
    if spec.target is not None:
        victim = spec.target
    else:
        running = cluster.running_pods(pipe.deployment.name)
        if not running:
            raise ValueError("pod_crash: no running pod to crash")
        victim = running[0].name
    cluster.kill_pod(victim)
    return lambda: None


def _inject_crashloop(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    cluster = pipe.cluster
    deployment = spec.target or pipe.deployment.name
    # a depth per deployment: the first of two overlapping windows must not
    # stop the loop while the second is open
    depths = getattr(cluster, "_crashloop_fault_depth", None)
    if depths is None:
        depths = cluster._crashloop_fault_depth = {}
    depths[deployment] = depths.get(deployment, 0) + 1
    cluster.start_crashloop(deployment)
    # crash one running pod, so that the loop shows at once (its replacement
    # enters CrashLoopBackOff) and not only at the next scale-up
    running = cluster.running_pods(deployment)
    if running:
        cluster.kill_pod(running[0].name)
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        depths[deployment] -= 1
        if depths[deployment] == 0:
            cluster.stop_crashloop(deployment)

    return clear


class _BlackoutAdapter:
    """A custom-metrics API that discovers and serves nothing (L4 down)."""

    def get_object_metric(self, *args, **kwargs):
        return None

    def get_pods_metric(self, *args, **kwargs):
        return {}

    def get_external_metric(self, *args, **kwargs):
        return []

    def list_metrics(self):
        return []


def _inject_adapter_blackout(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    # a depth on the pipeline: a second overlapping blackout must not take
    # the first one's stand-in for the real adapter
    depth = getattr(pipe, "_adapter_blackout_depth", 0)
    if depth == 0:
        pipe._adapter_blackout_pristine = pipe.hpa.adapter
    pipe._adapter_blackout_depth = depth + 1
    pipe.hpa.adapter = _BlackoutAdapter()
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        pipe._adapter_blackout_depth -= 1
        # swap the real adapter back only when the last window closes, and
        # only over the stand-in (never over an adapter put in meanwhile)
        if pipe._adapter_blackout_depth == 0 and isinstance(pipe.hpa.adapter, _BlackoutAdapter):
            pipe.hpa.adapter = pipe._adapter_blackout_pristine

    return clear


def _inject_tsdb_restart(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """Impulse: crash the TSDB and rebuild it from its WAL
    (``params["from_wal"] = False``: the empty rebuild of a DB without
    one)."""
    pipe.restart_tsdb(from_wal=bool(spec.params.get("from_wal", True)))
    return lambda: None


def _inject_hpa_restart(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """Impulse: controller failover, a new HPAController restored from the
    pipeline's checkpoint store (cold without one)."""
    pipe.restart_hpa()
    return lambda: None


def _inject_adapter_restart(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """Impulse: replace the custom-metrics adapter (rewiring alone)."""
    pipe.restart_adapter()
    return lambda: None


def _inject_wal_truncate(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """Impulse: destroy the WAL's tail, ``params["records"]`` whole
    records (64) and a torn partial one (``tear=False`` leaves it out), then
    crash and recover the TSDB, so the recovery starts from the damaged
    log."""
    if pipe.wal is None:
        raise ValueError("wal_truncate: pipeline has no WAL attached")
    pipe.wal.truncate_tail(
        records=int(spec.params.get("records", 64)),
        tear=bool(spec.params.get("tear", True)),
    )
    pipe.restart_tsdb()
    return lambda: None


def _inject_tenant_spike(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """One tenant's offered load rises by ``params["add"]`` (60.0) for the
    window: the demand side of a capacity crunch.  The pipeline's primary
    deployment by default, or the tenant deployment ``target`` names.
    Overlapping spikes stack as ``_wrap_fetch``'s faults do: each wraps the
    load function in force, and a depth counter a deployment gives the
    pristine function back only when the last one clears."""
    name = spec.target or pipe.deployment.name
    deployment = pipe.cluster.deployments.get(name)
    if deployment is None:
        raise ValueError(f"tenant_spike: no deployment named {name!r}")
    add = float(spec.params.get("add", 60.0))
    depth = getattr(deployment, "_spike_depth", 0)
    if depth == 0:
        deployment._pristine_load_fn = deployment.load_fn
    deployment._spike_depth = depth + 1
    inner = deployment.load_fn
    deployment.load_fn = lambda t: inner(t) + add
    if pipe.tracer is not None:
        pipe.tracer.emit("workload_change", {"deployment": name, "load_add": add})
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        deployment._spike_depth -= 1
        if deployment._spike_depth == 0:
            deployment.load_fn = deployment._pristine_load_fn

    return clear


def _inject_provision_fail(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """The cluster autoscaler's cloud API hangs: each provision started in
    the window fails after ``provision_timeout_s`` and drives the
    autoscaler's backoff.  An attempt in flight when the window closes still
    fails (its request is lost already).  Overlapping windows stack on a
    depth counter; the flag drops when the last one clears."""
    scheduler = getattr(pipe, "capacity_scheduler", None)
    autoscaler = getattr(scheduler, "autoscaler", None)
    if autoscaler is None:
        raise ValueError(
            "provision_fail: pipeline has no cluster autoscaler attached "
            "(pass capacity=CapacityConfig(autoscaler_node_chips=...))"
        )
    autoscaler._fail_depth += 1
    autoscaler.failing = True
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        autoscaler._fail_depth -= 1
        if autoscaler._fail_depth == 0:
            autoscaler.failing = False

    return clear


def _region_plane(pipe: "AutoscalingPipeline", kind: str):
    """The pipeline's region and its global plane, or a ValueError that says
    why a fleet kind cannot bite (as ``provision_fail`` does)."""
    region = getattr(pipe, "region", None)
    plane = getattr(region, "plane", None) if region is not None else None
    if plane is None:
        raise ValueError(
            f"{kind}: pipeline is not part of a region under a "
            "GlobalControlPlane (wrap it in control/region.Region and "
            "register it on a plane)"
        )
    return region, plane


def _resolve_region_target(region, plane, spec: FaultSpec, kind: str) -> str:
    target = spec.target or region.name
    if target not in plane.regions:
        raise ValueError(f"{kind}: no region named {target!r}")
    return target


def _inject_region_kill(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """A whole region dies mid-traffic: the plane freezes its demand and
    preempts every node, and the spill must serve the frozen replicas from
    the surviving regions.  Kills nest on the plane's depth counter a
    region."""
    region, plane = _region_plane(pipe, "region_kill")
    target = _resolve_region_target(region, plane, spec, "region_kill")
    plane.kill_region(target)
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        plane.recover_region(target)

    return clear


def _inject_region_partition(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """Cut a region off from the exchange: it stops publishing sealed
    generations (global reads serve its last one) and takes no spill, while
    its own loops go on serving."""
    region, plane = _region_plane(pipe, "region_partition")
    target = _resolve_region_target(region, plane, spec, "region_partition")
    plane.partition_region(target)
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        plane.heal_partition(target)

    return clear


def _inject_objstore_outage(pipe: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """The object store goes dark for the whole fleet: publishes fail (no
    generation number is used up) and the global query layer serves its
    cached payloads.  Outage windows nest in the store."""
    _, plane = _region_plane(pipe, "objstore_outage")
    plane.objstore.begin_outage()
    cleared = False

    def clear() -> None:
        nonlocal cleared
        if cleared:
            return
        cleared = True
        plane.objstore.end_outage()

    return clear


FAULT_KINDS: dict[str, Callable[["AutoscalingPipeline", FaultSpec], ClearFn]] = {
    "exporter_outage": _inject_exporter_outage,
    "frozen_samples": _inject_frozen_samples,
    "slow_scrape": _inject_slow_scrape,
    "scrape_blackout": _inject_scrape_blackout,
    "node_preempt": _inject_node_preempt,
    "node_drain": _inject_node_drain,
    "pod_crash": _inject_pod_crash,
    "crashloop": _inject_crashloop,
    "adapter_blackout": _inject_adapter_blackout,
    "tsdb_restart": _inject_tsdb_restart,
    "hpa_restart": _inject_hpa_restart,
    "adapter_restart": _inject_adapter_restart,
    "wal_truncate": _inject_wal_truncate,
    "tenant_spike": _inject_tenant_spike,
    "provision_fail": _inject_provision_fail,
    "region_kill": _inject_region_kill,
    "region_partition": _inject_region_partition,
    "objstore_outage": _inject_objstore_outage,
}


def inject_fault(pipeline: "AutoscalingPipeline", spec: FaultSpec) -> ClearFn:
    """The injection entry point (``ChaosSchedule`` calls this, not the
    table): records the kind's coverage probe, then dispatches.  The
    ``fault_kind`` probes are one per key of FAULT_KINDS, which
    ``obs.coverage.FAULT_PROBE_KINDS`` mirrors."""
    coverage.hit_dynamic("fault_kind", spec.kind)
    return FAULT_KINDS[spec.kind](pipeline, spec)
