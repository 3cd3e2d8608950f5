"""Regions and the global control plane above them.

Counterpart of ``k8s_gpu_hpa_tpu/control/region.py``.  Every slice before
this one lives in one cluster: one SimCluster, one scrape plane, one
SlicePool.  This module composes N of those stacks into a fleet:

- :class:`Region` wraps one assembled :class:`AutoscalingPipeline`
  (federated scrape plane, SlicePool and CapacityScheduler, an HPA a
  tenant) and gives it a name, a liveness bit and a locality table;
- :class:`GlobalControlPlane` runs two loops over the regions, both on the
  shared virtual clock:

  1. the **exchange loop**: every ``publish_interval`` each live region
     that is not partitioned seals its TSDB state into a format-3 snapshot
     payload and uploads it under the sealed-generation protocol of
     :mod:`..metrics.global_query`, whose
     :class:`~k8s_gpu_hpa_tpu_torch.metrics.global_query.GlobalQueryLayer`
     merges the sealed payloads for reads across regions;
  2. the **global scheduler**: every ``sync_interval`` it walks the tenants
     in priority order and spills demand its home cannot serve to other
     regions: a killed home (``region_kill``) spills its frozen desired
     replicas, a saturated one its overflow (pods Pending past
     ``spill_after_s``).  Candidate regions rank by ``(pool load ratio,
     data-locality cost, name)``; in the target region the spilled pods
     belong to a registered :class:`TenantSpec` mirror, so priority and the
     fair share still arbitrate pod by pod.  Every decision (admitted,
     denied, drained) is one row of ``decision_log``, the chain ``simulate
     --scenario evacuate --why`` prints.

The mirrors are made when the plane is built: every tenant gets a
``<tenant>-evac`` deployment at 0 replicas in every region but its home,
with a TenantSpec of its priority, weight and budgets.  A spill is then a
``scale_to``: nothing is created across regions during an incident, when
it would be least likely to work.

An evacuation (one a ``region_kill``):

    ALIVE --kill--> DEAD (demand frozen, nodes preempted, autoscaler capped)
      DEAD --schedule ticks--> SPILLING (mirrors scale out, the TTC runs)
      SPILLING --all frozen demand Running on mirrors--> EVACUATED
        (each tenant's TTC recorded)
    DEAD --recover--> ALIVE (nodes restored)
      ALIVE + home converged again --schedule tick--> mirrors drained to 0

The lifecycle's joints are ``region:*`` coverage probes
(``evacuation_started``, ``spill_admitted``, ``spill_denied`` and
``evacuation_completed``; obs/coverage.py).
"""

from __future__ import annotations

from k8s_gpu_hpa_tpu_torch.control.capacity import CapacityConfig, TenantSpec
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import HPABehavior
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch.metrics.global_query import (
    GlobalQueryLayer,
    combined_payload_of,
    publish_snapshot,
)
from k8s_gpu_hpa_tpu_torch.metrics.objstore import ObjectStoreUnavailable, SimObjectStore
from k8s_gpu_hpa_tpu_torch.obs import coverage

#: mirror deployments are ``<tenant>-evac`` in every region but the home
MIRROR_SUFFIX = "-evac"


def mirror_name(tenant: str) -> str:
    return tenant + MIRROR_SUFFIX


class Region:
    """One named regional stack: a pipeline and its place in the fleet.

    ``tenants`` maps each home tenant's deployment to its row (the dict
    shape of :func:`build_region`'s ``tenants``); ``locality`` maps the other
    regions to a relative data-locality cost (1.0 when missing) that ranks
    spill targets."""

    def __init__(
        self,
        name: str,
        pipeline: AutoscalingPipeline,
        tenants: dict[str, dict] | None = None,
        locality: dict[str, float] | None = None,
    ):
        self.name = name
        self.pipeline = pipeline
        # the region-level fault kinds find the region, and through it the
        # plane, from the pipeline they are given
        pipeline.region = self
        self.tenants = dict(tenants or {})
        self.locality = dict(locality or {})
        self.alive = True
        self.partitioned = False
        self.plane: GlobalControlPlane | None = None
        self._kill_depth = 0
        self._partition_depth = 0
        self._saved_max_nodes: int | None = None
        self._dead_node_hook = None

    @property
    def cluster(self) -> SimCluster:
        return self.pipeline.cluster

    @property
    def scheduler(self):
        return self.pipeline.capacity_scheduler

    def pool_ratio(self) -> float:
        """used / capacity of the regional pool; a dead pool counts as full."""
        pool = self.scheduler.pool
        capacity = pool.capacity()
        if capacity <= 0:
            return 1.0
        return pool.used() / capacity

    def locality_cost(self, other: str) -> float:
        return float(self.locality.get(other, 1.0))

    def headroom_chips(self) -> int:
        """Free devices less those already promised to pods not yet bound
        (Pending or starting): the spill's admission signal.  ``pool.free()``
        alone would count twice: a tenant of higher priority spilled on the
        same tick has desired replicas whose pods have not bound yet."""
        committed = 0
        for dep_name, dep in self.cluster.deployments.items():
            bound = sum(1 for p in self.cluster.deployment_pods(dep_name) if p.node is not None)
            committed += max(0, dep.replicas - bound) * dep.chips_per_pod
        return self.scheduler.pool.free() - committed


def build_region(
    clock,
    name: str,
    tenants: list[dict],
    node_chips: int,
    base_nodes: int,
    slice_quantum: int = 1,
    autoscaler_max_nodes: int = 0,
    provision_delay_s: float = 60.0,
    grace_s: float = 5.0,
    locality: dict[str, float] | None = None,
    scrape_shards: int = 2,
    pod_start_latency: float = 5.0,
    target_value: float = 40.0,
    stabilization_s: float = 60.0,
) -> Region:
    """One regional stack on the shared clock.

    ``tenants`` rows are dicts of ``name``, ``priority``, ``weight``,
    ``preemption_budget``, ``starvation_budget_s``, ``chips_per_pod``,
    ``max_replicas``, ``base_load`` and ``band`` (the TTC budget's band,
    ``"prod"`` or ``"batch"``); the first row is the pipeline's own tenant.
    It never advances the clock: the regions share it, and settling is the
    scenario's work."""
    cluster = SimCluster(
        clock,
        nodes=[(f"{name}-node-{i}", node_chips) for i in range(base_nodes)],
        pod_start_latency=pod_start_latency,
    )
    specs = [
        TenantSpec(
            t["name"],
            priority=t["priority"],
            weight=t["weight"],
            preemption_budget=t["preemption_budget"],
            starvation_budget_s=t["starvation_budget_s"],
        )
        for t in tenants
    ]
    config = CapacityConfig(
        tenants=specs,
        slice_quantum=slice_quantum,
        grace_s=grace_s,
        autoscaler_node_chips=node_chips if autoscaler_max_nodes else None,
        autoscaler_max_nodes=autoscaler_max_nodes,
        provision_delay_s=provision_delay_s,
    )
    deployments = {
        t["name"]: SimDeployment(
            cluster,
            t["name"],
            t["name"],
            chips_per_pod=t["chips_per_pod"],
            load_fn=lambda now, base=t["base_load"]: base,
            load_mode="shared",
        )
        for t in tenants
    }
    primary = tenants[0]
    cluster.add_deployment(deployments[primary["name"]], replicas=1)
    behavior = HPABehavior()
    behavior.scale_down.stabilization_window_seconds = stabilization_s
    pipeline = AutoscalingPipeline(
        cluster,
        deployments[primary["name"]],
        record=f"{primary['name'].replace('-', '_')}_tensorcore_avg",
        target_value=target_value,
        max_replicas=primary["max_replicas"],
        behavior=behavior,
        capacity=config,
        scrape_shards=scrape_shards,
    )
    for t in tenants[1:]:
        cluster.add_deployment(deployments[t["name"]], replicas=1)
        tenant_behavior = HPABehavior()
        tenant_behavior.scale_down.stabilization_window_seconds = stabilization_s
        pipeline.add_tenant_hpa(
            deployments[t["name"]],
            target_value=target_value,
            max_replicas=t["max_replicas"],
            behavior=tenant_behavior,
        )
    return Region(name, pipeline, tenants={t["name"]: t for t in tenants}, locality=locality)


class GlobalControlPlane:
    """The fleet's brain: the exchange loop and the spill scheduler.

    ``spill_enabled=False`` is the ``region_evacuation`` rung's planted
    canary: the plane records every decision but denies every spill, an
    evacuation that must fail its reconvergence budgets."""

    def __init__(
        self,
        clock,
        regions: list[Region],
        objstore: SimObjectStore,
        spill_enabled: bool = True,
        sync_interval: float = 15.0,
        publish_interval: float = 30.0,
        spill_after_s: float = 45.0,
    ):
        self.clock = clock
        self.regions: dict[str, Region] = {r.name: r for r in regions}
        self.objstore = objstore
        self.spill_enabled = spill_enabled
        self.sync_interval = sync_interval
        self.publish_interval = publish_interval
        self.spill_after_s = spill_after_s
        self.query = GlobalQueryLayer(clock, objstore)
        #: tenant -> home region (tenant names are unique in the fleet)
        self._home: dict[str, str] = {}
        for region in regions:
            region.plane = self
            self.query.register_region(region.name)
            for tenant in region.tenants:
                if tenant in self._home:
                    raise ValueError(f"tenant {tenant} homed in two regions")
                self._home[tenant] = region.name
        self._generation: dict[str, int] = {r.name: 0 for r in regions}
        #: (tenant, region) -> the mirror deployment made there
        self._mirrors: dict[tuple[str, str], SimDeployment] = {}
        self._make_mirrors()
        #: one row a global scheduling decision (the ``--why`` chain)
        self.decision_log: list[dict] = []
        #: the regions' lifecycle (kill, recover, partition, failed publish)
        self.events: list[dict] = []
        #: one record a region_kill: frozen demand, each tenant's TTC
        self.evacuations: list[dict] = []
        self.publishes_total = 0
        self.publish_failures_total = 0
        self.spills_admitted = 0
        self.spills_denied = 0
        self._started = False

    # ---- construction ------------------------------------------------------

    def _spec(self, tenant: str) -> dict:
        return self.regions[self._home[tenant]].tenants[tenant]

    def _make_mirrors(self) -> None:
        """Every tenant's mirror in every region but its home, with a
        TenantSpec of its own, so the target's CapacityScheduler arbitrates
        spilled pods at the tenant's priority, weight and budgets."""
        for tenant, home in self._home.items():
            spec = self._spec(tenant)
            for region in self.regions.values():
                if region.name == home:
                    continue
                mirror = mirror_name(tenant)
                dep = SimDeployment(
                    region.cluster,
                    mirror,
                    mirror,
                    chips_per_pod=spec["chips_per_pod"],
                    load_fn=lambda now, base=spec["base_load"]: base,
                    load_mode="shared",
                )
                region.cluster.add_deployment(dep, replicas=0)
                region.scheduler.tenants[mirror] = TenantSpec(
                    mirror,
                    priority=spec["priority"],
                    weight=spec["weight"],
                    preemption_budget=spec["preemption_budget"],
                    starvation_budget_s=spec["starvation_budget_s"],
                )
                self._mirrors[(tenant, region.name)] = dep

    # ---- the two loops -----------------------------------------------------

    def start(self) -> None:
        """Start every regional pipeline and the plane's publish and schedule
        ticks on the shared clock.  Idempotent."""
        if self._started:
            return
        self._started = True
        for region in self.regions.values():
            region.pipeline.start()
        self._periodic(self.publish_interval, self._publish_tick)
        self._periodic(self.sync_interval, self._schedule_tick)

    def _periodic(self, interval: float, fn) -> None:
        def tick():
            fn()
            self.clock.call_later(interval, tick)

        self.clock.call_later(interval, tick)

    def _event(self, event: str, region: str, detail: str = "") -> None:
        self.events.append({"t": self.clock.now(), "event": event, "region": region, "detail": detail})

    # ---- exchange loop -----------------------------------------------------

    def publish_region(self, name: str, fail_blob_after: int | None = None) -> None:
        """Seal and upload one region's TSDB state as its next generation.
        An outage fails this publish alone (the generation number is not
        used up); a torn upload propagates to the fault that tore it."""
        region = self.regions[name]
        payload = combined_payload_of(region.pipeline.db)
        generation = self._generation[name] + 1
        try:
            publish_snapshot(self.objstore, name, generation, payload, fail_blob_after=fail_blob_after)
        except ObjectStoreUnavailable:
            self.publish_failures_total += 1
            self._event("publish_failed", name, "object store unavailable")
            return
        self._generation[name] = generation
        self.publishes_total += 1

    def _publish_tick(self) -> None:
        for region in self.regions.values():
            if region.alive and not region.partitioned:
                self.publish_region(region.name)

    # ---- region lifecycle (the fault kinds' targets) -----------------------

    def kill_region(self, name: str) -> None:
        """A whole region vanishes: its demand freezes at the desired
        replicas, every node is preempted (and every node added while it is
        dead, on arrival), and its autoscaler is capped so the dead region
        cannot come back on its own.  Kills nest on a depth counter."""
        region = self.regions[name]
        region._kill_depth += 1
        if region._kill_depth > 1:
            return
        now = self.clock.now()
        region.alive = False
        frozen = {tenant: region.cluster.deployments[tenant].replicas for tenant in region.tenants}
        self.evacuations.append({
            "region": name,
            "killed_at": now,
            "frozen": frozen,
            "tenant_ttc_s": {},
            "completed_at": None,
            "drained_at": None,
        })
        scheduler = region.scheduler
        autoscaler = scheduler.autoscaler if scheduler is not None else None
        if autoscaler is not None:
            region._saved_max_nodes = autoscaler.max_nodes
            autoscaler.max_nodes = len(autoscaler.provisioned)

        def dead_node_hook(node, cluster=region.cluster):
            cluster.preempt_node(node.name)

        # the hook goes on before the nodes are preempted
        region._dead_node_hook = dead_node_hook
        region.cluster.on_node_added.append(dead_node_hook)
        for node in list(region.cluster.nodes):
            region.cluster.preempt_node(node)
        coverage.hit("region:evacuation_started")
        self._event("region_kill", name, f"frozen demand {frozen}")

    def recover_region(self, name: str) -> None:
        region = self.regions[name]
        if region._kill_depth == 0:
            return
        region._kill_depth -= 1
        if region._kill_depth:
            return
        if region._dead_node_hook is not None:
            try:
                region.cluster.on_node_added.remove(region._dead_node_hook)
            except ValueError:
                pass
            region._dead_node_hook = None
        for node_name, node in list(region.cluster.nodes.items()):
            if not (node.ready and node.schedulable):
                region.cluster.restore_node(node_name)
        scheduler = region.scheduler
        autoscaler = scheduler.autoscaler if scheduler is not None else None
        if autoscaler is not None and region._saved_max_nodes is not None:
            autoscaler.max_nodes = region._saved_max_nodes
            region._saved_max_nodes = None
        region.alive = True
        self._event("region_recover", name)

    def partition_region(self, name: str) -> None:
        """A partition severs the exchange alone: the region goes on serving
        its own tenants, but stops publishing (global reads serve its last
        sealed generation) and is passed over as a spill target."""
        region = self.regions[name]
        region._partition_depth += 1
        if region._partition_depth == 1:
            region.partitioned = True
            self._event("region_partition", name)

    def heal_partition(self, name: str) -> None:
        region = self.regions[name]
        if region._partition_depth == 0:
            return
        region._partition_depth -= 1
        if region._partition_depth == 0:
            region.partitioned = False
            self._event("partition_heal", name)

    # ---- the global scheduler ----------------------------------------------

    def _mirror_assigned(self, tenant: str) -> int:
        return sum(dep.replicas for (t, _), dep in self._mirrors.items() if t == tenant)

    def _mirror_running(self, tenant: str) -> int:
        return sum(
            len(self.regions[region_name].cluster.running_pods(dep.name))
            for (t, region_name), dep in self._mirrors.items()
            if t == tenant
        )

    def _spill_demand(self, tenant: str, home: Region) -> tuple[int | None, str]:
        """The mirror replicas this tenant needs across the fleet now: a dead
        home spills its frozen desired count, a saturated one its overflow
        (pods Pending past ``spill_after_s``), a healthy one nothing (None:
        the mirrors drain once home has converged again)."""
        if not home.alive:
            for evac in reversed(self.evacuations):
                if evac["region"] == home.name:
                    return evac["frozen"].get(tenant, 0), "region_dead"
            return home.cluster.deployments[tenant].replicas, "region_dead"
        scheduler = home.scheduler
        pending = len(scheduler.pending_pods(tenant))
        if pending and scheduler.open_stint_seconds(tenant) >= self.spill_after_s:
            return pending, "pool_saturated"
        return None, ""

    def _schedule_tick(self) -> None:
        now = self.clock.now()
        # priority order: prod's spill lands before batch competes for the
        # same surviving capacity
        for tenant in sorted(self._home, key=lambda t: (-self._spec(t)["priority"], t)):
            home = self.regions[self._home[tenant]]
            demand, cause = self._spill_demand(tenant, home)
            if demand is None:
                self._maybe_drain(tenant, home, now)
                continue
            deficit = demand - self._mirror_assigned(tenant)
            if deficit > 0:
                self._place_spill(tenant, home, deficit, cause, now)
        self._account_evacuations(now)

    def _place_spill(self, tenant: str, home: Region, deficit: int, cause: str, now: float) -> None:
        if not self.spill_enabled:
            self.spills_denied += 1
            coverage.hit("region:spill_denied")
            self.decision_log.append({
                "t": now, "tenant": tenant, "from": home.name, "to": None,
                "replicas": deficit, "cause": cause, "denied": "spill_disabled",
            })
            return
        chips = self._spec(tenant)["chips_per_pod"]
        candidates = sorted(
            (r for r in self.regions.values()
             if r.name != home.name and r.alive and not r.partitioned),
            key=lambda r: (r.pool_ratio(), home.locality_cost(r.name), r.name),
        )
        for region in candidates:
            if deficit <= 0:
                break
            admit = min(deficit, max(0, region.headroom_chips()) // chips)
            if admit <= 0:
                continue
            dep = self._mirrors[(tenant, region.name)]
            dep.scale_to(dep.replicas + admit)
            deficit -= admit
            self.spills_admitted += 1
            coverage.hit("region:spill_admitted")
            self.decision_log.append({
                "t": now, "tenant": tenant, "from": home.name, "to": region.name,
                "replicas": admit, "cause": cause,
                "score": [round(region.pool_ratio(), 3), home.locality_cost(region.name)],
            })
        if deficit > 0:
            self.spills_denied += 1
            coverage.hit("region:spill_denied")
            self.decision_log.append({
                "t": now, "tenant": tenant, "from": home.name, "to": None,
                "replicas": deficit, "cause": cause, "denied": "no_capacity",
            })

    def _maybe_drain(self, tenant: str, home: Region, now: float) -> None:
        """Home serves again: once the tenant's own pods all run at its
        desired count with nothing Pending, the mirrors scale to 0."""
        if self._mirror_assigned(tenant) == 0:
            return
        desired = home.cluster.deployments[tenant].replicas
        running = len(home.cluster.running_pods(tenant))
        if running != desired or home.scheduler.pending_pods(tenant):
            return
        for (t, region_name), dep in self._mirrors.items():
            if t == tenant and dep.replicas:
                dep.scale_to(0)
                self.decision_log.append({
                    "t": now, "tenant": tenant, "from": region_name, "to": home.name,
                    "replicas": 0, "cause": "drain_home_recovered",
                })
        for evac in self.evacuations:
            if evac["region"] == home.name and evac["drained_at"] is None:
                evac["drained_at"] = now

    def _account_evacuations(self, now: float) -> None:
        for evac in self.evacuations:
            if evac["completed_at"] is not None:
                continue
            for tenant, want in evac["frozen"].items():
                if tenant in evac["tenant_ttc_s"]:
                    continue
                if want == 0 or self._mirror_running(tenant) >= want:
                    evac["tenant_ttc_s"][tenant] = round(now - evac["killed_at"], 1)
            if len(evac["tenant_ttc_s"]) == len(evac["frozen"]):
                evac["completed_at"] = now
                coverage.hit("region:evacuation_completed")
                self._event("evacuation_complete", evac["region"], f"ttc {evac['tenant_ttc_s']}")

    # ---- health + introspection --------------------------------------------

    def healthy(self) -> bool:
        """Every live region's pipeline converged and observable; a killed
        region is expected to be unhealthy and is passed over."""
        from k8s_gpu_hpa_tpu_torch.chaos.schedule import pipeline_healthy

        return all(pipeline_healthy(region.pipeline) for region in self.regions.values() if region.alive)

    def explain(self, tenant: str) -> list[dict]:
        """The tenant's decision chain across regions, oldest first."""
        return [d for d in self.decision_log if d["tenant"] == tenant]

    def status(self) -> dict:
        return {
            "regions": {
                name: {
                    "alive": r.alive,
                    "partitioned": r.partitioned,
                    "pool_ratio": round(r.pool_ratio(), 3),
                    "generation": self._generation[name],
                }
                for name, r in sorted(self.regions.items())
            },
            "publishes": self.publishes_total,
            "publish_failures": self.publish_failures_total,
            "spills_admitted": self.spills_admitted,
            "spills_denied": self.spills_denied,
            "evacuations": self.evacuations,
        }
