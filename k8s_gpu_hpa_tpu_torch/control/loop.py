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

With ``tracer=`` (an ``obs.Tracer``) every stage emits spans and each
scale event's lineage walks back to the exporter sweeps (obs/): the cluster
gets the tracer, a ``PipelineSelfMetrics`` is scraped as the
``pipeline-self`` target after kube-state-metrics, the shipped SLO
recorders evaluate after the rules and their burn-rate alerts after them.
Without it every stage takes its untraced path.

Durability: with ``wal=`` (a ``metrics.wal.WriteAheadLog``) the TSDB logs
every append and can be rebuilt from the log, and with
``checkpoint_store=`` (control/checkpoint.py) the HPA keeps its state
across a rebuild.  ``restart_tsdb``, ``restart_hpa`` and
``restart_adapter`` crash a component and rebuild it from that state (the
chaos plane's restart faults drive them); each restart lands in
``restart_log`` and, traced, as a ``component_restart`` span.

With ``scrape_shards=N`` scraping splits over N hash-ring shards, each
with its own TSDB (metrics/federation.py), and every consumer reads a
``FederatedTSDB`` over the global DB (which keeps the WAL and takes every
write) and the shards.  One query planner over that view
(metrics/planner.py) compiles every rule, alert and adapter query into a
physical plan once; the evaluator and the adapter run the plans, and the
traced pipeline serves the planner's and the decode cache's counters among
its self-metrics.

With ``downsample=`` (a ``metrics.downsample.DownsamplePolicy``) every
TSDB of the pipeline compacts its aged raw chunks into rollup tiers, which
the planner reads for tier-aligned range queries; a restarted TSDB keeps
the policy.

With ``capacity=`` (a ``control.capacity.CapacityConfig``) the capacity
economy is installed over the cluster before any pod schedules: a bounded
slice pool, the scheduler of priority, fair share and preemption, and
optionally the simulated cluster autoscaler.  The pool's own families are
scraped as the ``capacity-pool`` target after kube-state-metrics, every HPA
of the pipeline reports its tenant's standing as conditions, and
``add_tenant_hpa`` wires more tenants through the same plane, each with its
rule, its adapter entry and its HPA on the shared clock.
"""

from __future__ import annotations

from dataclasses import dataclass

from k8s_gpu_hpa_tpu_torch.control.adapter import (
    AdapterRule,
    CustomMetricsAdapter,
    ObjectReference,
)
from k8s_gpu_hpa_tpu_torch.control.capacity import (
    POOL_TARGET_NAME,
    PoolMetricsExporter,
    build_capacity,
)
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import (
    HPABehavior,
    HPAController,
    MetricSpec,
    ObjectMetricSpec,
)
from k8s_gpu_hpa_tpu_torch.metrics.federation import FederatedTSDB, ShardedScrapePlane
from k8s_gpu_hpa_tpu_torch.metrics.planner import QueryPlanner
from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    RecordingRule,
    RuleEvaluator,
    tpu_test_avg_rule,
    tpu_test_multihost_avg_rule,
)
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import Scraper, TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.metrics.wal import WriteAheadLog
from k8s_gpu_hpa_tpu_torch.obs import coverage
from k8s_gpu_hpa_tpu_torch.obs.selfmetrics import SELF_TARGET_NAME, PipelineSelfMetrics
from k8s_gpu_hpa_tpu_torch.obs.slo import shipped_slo_alerts, shipped_slo_recorders
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
        tracer=None,
        structured_scrapes: bool = True,
        wal=None,
        checkpoint_store=None,
        scrape_shards: int = 0,
        downsample=None,
        capacity=None,
    ):
        self.cluster = cluster
        self.deployment = deployment
        self.intervals = intervals or PipelineIntervals()
        clock: VirtualClock = cluster.clock
        # a run collecting coverage (obs/coverage.py) takes its first-hit
        # times and spans from this pipeline's clock and tracer; with no
        # active map this does nothing
        coverage.bind_active(clock, tracer)
        #: the CapacityScheduler and its PoolMetricsExporter with
        #: ``capacity``, else None; installed before any pod schedules, so
        #: even the first reconcile is arbitrated
        self.capacity_scheduler = None
        self.pool_metrics = None
        if capacity is not None:
            self.capacity_scheduler = build_capacity(cluster, capacity)
            self.pool_metrics = PoolMetricsExporter(self.capacity_scheduler)
        #: the TSDB's WriteAheadLog and the HPA's CheckpointStore, kept for
        #: the restarts, which rebuild from them
        self.wal = wal
        self.checkpoint_store = checkpoint_store
        #: one entry a component restart: component, at, recovery stats
        self.restart_log: list[dict] = []
        self.tracer = tracer
        self.selfmetrics = None
        if tracer is not None:
            cluster.tracer = tracer
            self.selfmetrics = PipelineSelfMetrics(clock=clock)
        #: the ShardedScrapePlane with ``scrape_shards``, else None; raw
        #: scraped series then live in its shard DBs, and everything the
        #: control plane writes in the global DB
        self.shard_plane = None
        if scrape_shards:
            self.shard_plane = ShardedScrapePlane(
                clock,
                scrape_shards,
                interval=self.intervals.scrape,
                tracer=tracer,
                selfmetrics=self.selfmetrics,
                downsample=downsample,
            )
            self.db = FederatedTSDB(
                TimeSeriesDB(clock, wal=wal, downsample=downsample), self.shard_plane.shard_dbs
            )
            self.scraper = self.shard_plane
        else:
            self.db = TimeSeriesDB(clock, wal=wal, downsample=downsample)
            self.scraper = Scraper(
                self.db,
                interval=self.intervals.scrape,
                tracer=tracer,
                selfmetrics=self.selfmetrics,
            )
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
        if self.pool_metrics is not None:
            self.scraper.add_target(
                self.pool_metrics.families if structured_scrapes else self.pool_metrics.exposition,
                name=POOL_TARGET_NAME,
            )
        if self.selfmetrics is not None:
            # the pipeline scrapes its own self-metrics like any target, so
            # they land in the same TSDB
            self.scraper.add_target(self.selfmetrics.exposition, name=SELF_TARGET_NAME)

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
        # the SLOs come with the tracer: the propagation SLO reads the
        # self-metrics, and the untraced loops skip the recorders' reads
        slo_recorders: list = []
        alerts = None
        if self.selfmetrics is not None:
            slo_recorders = shipped_slo_recorders()
            alerts = shipped_slo_alerts()
        self.planner = QueryPlanner(self.db)
        if self.selfmetrics is not None:
            self.selfmetrics.attach_query_engine(self.planner.stats, self.db)
        self.evaluator = RuleEvaluator(
            self.db,
            rules + slo_recorders,
            alerts=alerts,
            tracer=tracer,
            selfmetrics=self.selfmetrics,
            planner=self.planner,
        )
        #: obs.alerting.AlertRouter or None, hung here by the paging harness
        #: (chaos/paging.py); polled once a rule tick with the labelled
        #: firing alerts, so routing keeps the evaluator's cadence and owns
        #: no timers (a VirtualClock callback must never advance the clock)
        self.page_router = None
        self.adapter = CustomMetricsAdapter(
            self.db,
            [AdapterRule(series=r.record, resource_overrides=_overrides_for(r)) for r in rules]
            + (extra_adapter_rules or []),
            tracer=tracer,
            selfmetrics=self.selfmetrics,
            planner=self.planner,
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
            tracer=tracer,
            selfmetrics=self.selfmetrics,
            checkpoint_store=checkpoint_store,
            capacity_probe=self._capacity_probe_for(deployment.name),
        )
        self.scale_history: list[tuple[float, int, int]] = []  # (ts, from, to)
        self.hpa.on_scale = lambda a, b: self.scale_history.append((clock.now(), a, b))
        #: tenant deployment name -> its HPAController (``add_tenant_hpa``);
        #: the primary deployment's stays ``self.hpa``
        self.tenant_hpas: dict[str, HPAController] = {}
        #: tenant name -> its (ts, from, to) scale log, as ``scale_history``
        self.tenant_scale_history: dict[str, list[tuple[float, int, int]]] = {}
        self._clock = clock
        self._started = False

    def _capacity_probe_for(self, tenant: str):
        """The tenant's capacity probe for its HPA's conditions, or None
        without a capacity economy."""
        if self.capacity_scheduler is None:
            return None
        return lambda: self.capacity_scheduler.tenant_status(tenant)

    def add_tenant_hpa(
        self,
        deployment: SimDeployment,
        record: str | None = None,
        target_value: float = 40.0,
        min_replicas: int = 1,
        max_replicas: int = 4,
        behavior: HPABehavior | None = None,
        replica_quantum: int = 1,
    ) -> HPAController:
        """Wire one more tenant deployment through the same plane: its own
        recorded rule (its pods picked by the app-label join), its adapter
        entry and its HPAController on the shared clock, N controllers
        arbitrated by one CapacityScheduler.  The deployment must already be
        in the cluster (``cluster.add_deployment``)."""
        name = deployment.name
        if name in self.tenant_hpas or name == self.deployment.name:
            raise ValueError(f"deployment {name} already has an HPA")
        record = record or f"{name.replace('-', '_')}_tensorcore_avg"
        rule = tpu_test_avg_rule(
            app=deployment.app_label,
            deployment=name,
            namespace=deployment.namespace,
            record=record,
        )
        self.evaluator.rules.append(rule)
        self.adapter.rules[record] = AdapterRule(series=record)
        ref = ObjectReference("Deployment", name, deployment.namespace)
        hpa = HPAController(
            target=deployment,
            metrics=[ObjectMetricSpec(record, target_value, ref)],
            adapter=self.adapter,
            clock=self._clock,
            min_replicas=min_replicas,
            max_replicas=max_replicas,
            behavior=behavior,
            replica_quantum=replica_quantum,
            pod_lister=deployment,
            namespace=deployment.namespace,
            tracer=self.tracer,
            selfmetrics=self.selfmetrics,
            capacity_probe=self._capacity_probe_for(name),
        )
        history: list[tuple[float, int, int]] = []
        hpa.on_scale = lambda a, b: history.append((self._clock.now(), a, b))
        self.tenant_scale_history[name] = history
        self.tenant_hpas[name] = hpa
        if self._started:
            self._periodic_tenant_sync(name)
        return hpa

    def _periodic_tenant_sync(self, name: str) -> None:
        self._periodic(self.intervals.hpa_sync, lambda: self.tenant_hpas[name].sync_once())

    def tenant_replicas(self, name: str) -> int:
        return self.cluster.deployments[name].replicas

    def tenant_running(self, name: str) -> int:
        return len(self.cluster.running_pods(name))

    def _add_node_target(self, node_name: str) -> None:
        target = self.scraper.add_target(
            lambda: self._exporter_fetch(node_name), name=f"exporter/{node_name}", node=node_name
        )
        if self.tracer is not None:
            target.trace_origin = lambda: self.cluster.exporter_sample_span(node_name)

    def _drop_node_target(self, node_name: str) -> None:
        for target in list(self.scraper.targets):
            if target.name == f"exporter/{node_name}":
                self.scraper.remove_target(target)

    @property
    def clock(self) -> VirtualClock:
        """The virtual clock everything runs on, the cluster's."""
        return self._clock

    def start(self) -> None:
        """Register the periodic ticks on the clock: scrape, rule evaluation,
        HPA sync (then each tenant's, in the order added), which orders the
        ticks that fall at one instant.  Each tick finds its component through ``self`` when it
        fires, so a component replaced between ticks takes over at the next."""
        if self._started:
            return
        self._started = True
        self._periodic(self.intervals.scrape, lambda: self.scraper.scrape_once())
        self._periodic(self.intervals.rule_eval, self._rule_tick)
        self._periodic(self.intervals.hpa_sync, lambda: self.hpa.sync_once())
        for name in self.tenant_hpas:
            self._periodic_tenant_sync(name)

    def _rule_tick(self) -> None:
        """One rule tick: the shards' local rules first (the federation's
        pre-reductions), then the global evaluator that reads them, then the
        alert router observing whatever that evaluation left firing."""
        if self.shard_plane is not None:
            self.shard_plane.evaluate_rules_once()
        self.evaluator.evaluate_once()
        if self.page_router is not None:
            self.page_router.observe(self.evaluator.firing_alert_instances())

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

    # ---- crash and restart (the chaos plane's restart faults) --------------

    def restart_tsdb(self, from_wal: bool = True) -> dict:
        """Kill the TSDB and rebuild it: from its WAL when one is attached
        (``TimeSeriesDB.recover``), else empty (the failure durability
        exists to prevent, kept so a drill can show the difference).  The
        scraper, the evaluator and the adapter are pointed at the new DB,
        and the scraper spreads its next sweep so the recovered DB does not
        take every target on one tick.  The planner's cached plans (series
        sets resolved against the dead DB) are dropped, and the self-metrics
        read the new DB's decode cache.  The new DB keeps the old one's
        downsample policy.  A sharded pipeline raises: its raw
        series live in memory-only shard DBs (a restarted agent re-scrapes)."""
        if self.shard_plane is not None:
            raise RuntimeError(
                "restart_tsdb drives the single-TSDB durability path; "
                "sharded pipelines keep raw series in memory-only shard DBs "
                "(Prometheus-agent semantics: a restarted agent re-scrapes)"
            )
        old = self.db
        if from_wal and self.wal is not None:
            # a crashed process cannot reuse its file handles: a new WAL over
            # the same directory opens a segment past any torn tail, as a
            # real restart would
            self.wal.close()
            self.wal = WriteAheadLog(self.wal.directory, self.wal.segment_max_records)
            db = TimeSeriesDB.recover(
                self.wal,
                self._clock,
                lookback=old.lookback,
                retention=old.retention,
                snapshot_every=old.snapshot_every,
                chunk_size=old.chunk_size,
                downsample=old.downsample_policy,
            )
            info = dict(db.last_recovery or {})
        else:
            db = TimeSeriesDB(
                self._clock,
                lookback=old.lookback,
                retention=old.retention,
                chunk_size=old.chunk_size,
                downsample=old.downsample_policy,
            )
            info = {"snapshot_restored": False, "recovered_points": 0}
        self.db = db
        self.scraper.db = db
        self.evaluator.db = db
        self.adapter.db = db
        self.planner.invalidate()
        self.adapter.invalidate_plans()
        if self.selfmetrics is not None:
            self.selfmetrics.attach_query_engine(self.planner.stats, db)
        self.scraper.stagger_after_recovery()
        return self._log_restart("tsdb", info)

    def restart_hpa(self) -> dict:
        """Kill the HPAController and build a replacement with the same
        wiring, restored from the checkpoint store when one is attached (it
        takes the stabilization window and the scale-event history before
        its first sync), and keeping its capacity probe."""
        old = self.hpa
        self.hpa = HPAController(
            target=old.target,
            metrics=old.metrics,
            adapter=self.adapter,
            clock=self._clock,
            min_replicas=old.min_replicas,
            max_replicas=old.max_replicas,
            behavior=old.behavior,
            on_scale=old.on_scale,
            replica_quantum=old.replica_quantum,
            resource_metrics=old.resource_metrics,
            pod_lister=old.pod_lister,
            namespace=old.namespace,
            tracer=old.tracer,
            selfmetrics=old.selfmetrics,
            checkpoint_store=self.checkpoint_store,
            capacity_probe=old.capacity_probe,
        )
        return self._log_restart("hpa", {"checkpoint_restored": self.hpa.restored_from_checkpoint})

    def restart_adapter(self) -> dict:
        """Kill the CustomMetricsAdapter and rebuild it over the live DB.
        The adapter keeps no state between queries, so its restart is
        rewiring alone; a drill shows that it is.  The tenants' HPAs move to
        the new adapter too (the JAX pipeline leaves them on the old one)."""
        old = self.adapter
        self.adapter = CustomMetricsAdapter(
            self.db,
            list(old.rules.values()),
            external_rules=list(old.external_rules.values()),
            tracer=old.tracer,
            selfmetrics=old.selfmetrics,
            planner=old.planner,
        )
        for hpa in (self.hpa, *self.tenant_hpas.values()):
            hpa.adapter = self.adapter
        return self._log_restart("adapter", {})

    def _log_restart(self, component: str, info: dict) -> dict:
        entry = {"component": component, "at": self._clock.now(), **info}
        self.restart_log.append(entry)
        coverage.hit("recovery_path:pipeline_component_restarted")
        if self.tracer is not None:
            attrs = {"component": component}
            for key in (
                "snapshot_restored",
                "recovered_series",
                "recovered_points",
                "replayed_records",
                "dropped_records",
                "replay_gap_seconds",
                "checkpoint_restored",
            ):
                if info.get(key) is not None:
                    attrs[key] = info[key]
            self.tracer.emit("component_restart", attrs)
        return entry
