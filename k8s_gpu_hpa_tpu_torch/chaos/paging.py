"""The paging harness: the alert router armed over the canned chaos runs.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/paging.py``, the orchestration layer
of the incident plane.  It hangs an
:class:`~k8s_gpu_hpa_tpu_torch.obs.alerting.AlertRouter` on a scenario's
pipeline through the ``on_pipeline`` and ``on_plane`` hooks, adds the alert
rules the scenario needs, runs the scenario, correlates every page into an
incident record (obs/incident.py) and scores the paging against the
injected faults (the ChaosSchedule's RecoveryReports).  Three drills, three
alert sources:

- **storm** (``run_paging_storm``): the wired SLO burn alerts, the shipped
  pipeline health alerts (metrics/rules.pipeline_alert_rules) and two
  state-probe rules over ``pipeline_healthy``, the critical and warning
  pair whose inhibition is the deterministic mis-inhibition canary;
- **crunch** (``run_paging_crunch``): the state-probe pair alone (the
  crunch's pipeline is untraced, so no SLO alert is wired);
- **evacuate** (``run_paging_evacuation``): fleet probe rules on a
  surviving region's evaluator: RegionDead, RegionPartitioned,
  ObjstoreUnavailable and a TenantUnschedulable for each tenant, the last
  inhibited by RegionDead over the shared ``region`` label.

A state-probe alert rule is an ordinary :class:`AlertRule` whose
expression is a :class:`StateProbe`, a duck-typed Expr that reads live
pipeline or plane state instead of the TSDB.  The planner passes an
unknown expression through as it is, and ``for_seconds`` still applies,
so pending and firing (and their coverage probes) behave as for a metric
alert.

``break_inhibition=True`` arms the planted canary: the router computes
inhibition but does not apply it, so the warning-severity duplicates page
with ``would_inhibit > 0`` and :func:`evaluate_paging_contract` fails the
run, the exit 2 that ``simulate --scenario incident --break-inhibition``
and ``trial.paging_bench_rung`` both require.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from k8s_gpu_hpa_tpu_torch import perfgates
from k8s_gpu_hpa_tpu_torch.chaos.schedule import pipeline_healthy
from k8s_gpu_hpa_tpu_torch.metrics.rules import AlertRule, pipeline_alert_rules
from k8s_gpu_hpa_tpu_torch.obs import coverage
from k8s_gpu_hpa_tpu_torch.obs.alerting import (
    AlertRouter,
    Matcher,
    Silence,
    shipped_inhibit_rules,
)
from k8s_gpu_hpa_tpu_torch.obs.incident import correlate, score_paging

#: grouping labels for every paging drill: one group per alert family and
#: severity, split by region so a fleet incident pages per-region
PAGING_GROUP_BY = ("alertname", "severity", "region")


@dataclass
class StateProbe:
    """Duck-typed Expr evaluating a boolean state probe: a non-empty
    vector while the probed condition holds, empty otherwise.  Lets an
    AlertRule watch live pipeline/plane state (health, region liveness)
    that has no TSDB series, with unchanged pending→firing semantics."""

    probe: Callable[[], bool]

    def evaluate(self, db, at=None):
        return [1.0] if self.probe() else []

    def input_names(self) -> frozenset:
        return frozenset()

    def promql(self) -> str:
        return "state_probe()"


def health_alert_rules(pipe) -> list[AlertRule]:
    """The critical/warning pair over ``pipeline_healthy``.  The warning
    twin exists for the ticket queue — and, because it fires in lockstep
    with the critical, it is ALWAYS inhibited by it (severity inhibition,
    equal slo+component): the deterministic target the mis-inhibition
    canary un-suppresses."""

    def unhealthy() -> bool:
        return not pipeline_healthy(pipe)

    shared = dict(component="pipeline")
    return [
        AlertRule(
            alert="PipelineUnhealthy",
            expr=StateProbe(unhealthy),
            for_seconds=perfgates.PAGING_ALERT_FOR_S,
            labels={"severity": "critical", **shared},
            annotations={
                "summary": "pipeline not converged/observable "
                "(pods pending or crashlooping, node or scrape target down)"
            },
        ),
        AlertRule(
            alert="PipelineDegraded",
            expr=StateProbe(unhealthy),
            for_seconds=perfgates.PAGING_ALERT_FOR_S,
            labels={"severity": "warning", **shared},
            annotations={
                "summary": "ticket-severity twin of PipelineUnhealthy; "
                "inhibited while the critical fires"
            },
        ),
    ]


def region_alert_rules(plane) -> list[AlertRule]:
    """Fleet alert rules over GlobalControlPlane state, hosted on one
    surviving region's evaluator: region death/partition, object-store
    outage, and per-tenant unschedulability during an open evacuation."""
    for_s = perfgates.PAGING_ALERT_FOR_S
    rules: list[AlertRule] = []
    for name in plane.regions:
        rules.append(
            AlertRule(
                alert="RegionDead",
                expr=StateProbe(lambda n=name: not plane.regions[n].alive),
                for_seconds=for_s,
                labels={"severity": "critical", "region": name},
                annotations={"summary": f"region {name} vanished; demand frozen"},
            )
        )
        rules.append(
            AlertRule(
                alert="RegionPartitioned",
                expr=StateProbe(lambda n=name: plane.regions[n].partitioned),
                for_seconds=for_s,
                labels={
                    "severity": "critical",
                    "region": name,
                    "component": "exchange",
                },
                annotations={
                    "summary": f"region {name} cut off the exchange plane"
                },
            )
        )
    rules.append(
        AlertRule(
            alert="ObjstoreUnavailable",
            expr=StateProbe(lambda: not plane.objstore.available),
            for_seconds=for_s,
            labels={"severity": "critical", "component": "objstore"},
            annotations={
                "summary": "object store refusing puts/gets; "
                "global reads serving cached sealed views"
            },
        )
    )

    def tenant_unschedulable(region_name: str, tenant: str) -> Callable[[], bool]:
        def probe() -> bool:
            if plane.regions[region_name].alive:
                return False
            for evac in reversed(plane.evacuations):
                if evac["region"] == region_name:
                    return (
                        tenant in evac["frozen"]
                        and evac["tenant_ttc_s"].get(tenant) is None
                    )
            return False

        return probe

    for region_name, region in plane.regions.items():
        for tenant in region.tenants:
            rules.append(
                AlertRule(
                    alert="TenantUnschedulable",
                    expr=StateProbe(tenant_unschedulable(region_name, tenant)),
                    for_seconds=for_s,
                    labels={
                        "severity": "warning",
                        "region": region_name,
                        "tenant": tenant,
                    },
                    annotations={
                        "summary": f"tenant {tenant} frozen in dead region "
                        f"{region_name}, not yet re-served by mirrors"
                    },
                )
            )
    return rules


def build_router(
    clock,
    break_inhibition: bool = False,
    silences: tuple[Silence, ...] = (),
) -> AlertRouter:
    """The canonical drill router: perfgates timing, shipped inhibition."""
    return AlertRouter(
        clock,
        group_by=PAGING_GROUP_BY,
        group_wait=perfgates.PAGING_GROUP_WAIT_S,
        group_interval=perfgates.PAGING_GROUP_INTERVAL_S,
        repeat_interval=perfgates.PAGING_REPEAT_INTERVAL_S,
        inhibit_rules=shipped_inhibit_rules(),
        silences=silences,
        break_inhibition=break_inhibition,
    )


def attach_pager(
    pipe,
    rules: list[AlertRule],
    break_inhibition: bool = False,
    silences: tuple[Silence, ...] = (),
) -> AlertRouter:
    """Append ``rules`` to the pipeline's evaluator and hang the router on
    ``pipe.page_router`` — the rule-eval tick polls it from then on."""
    router = build_router(
        pipe.clock, break_inhibition=break_inhibition, silences=silences
    )
    pipe.evaluator.alerts = list(pipe.evaluator.alerts) + list(rules)
    pipe.page_router = router
    return router


# ---------------------------------------------------------------------------
# contract


def evaluate_paging_contract(result: dict, scenario: str) -> tuple[bool, list[str]]:
    """The paging contract over one drill result — pure over the dict.

    Fails on: recall below the (exact) floor, precision below floor, p95
    time-to-page over the scenario budget, any unattributable page, or any
    notification-log violation (uninhibited duplicate pages included — the
    armed canary fails HERE, by design)."""
    violations: list[str] = []
    score = result["score"]
    if score["recall"] < perfgates.PAGING_RECALL_FLOOR:
        violations.append(
            f"recall {score['recall']} < {perfgates.PAGING_RECALL_FLOOR}: "
            f"unpaged faults {score['uncovered_faults']}"
        )
    if score["precision"] < perfgates.PAGING_PRECISION_FLOOR:
        violations.append(
            f"precision {score['precision']} < "
            f"{perfgates.PAGING_PRECISION_FLOOR}"
        )
    budget = perfgates.PAGING_TTP_P95_MAX_S[scenario]
    p95 = score["time_to_page_s"]["p95"]
    if p95 is not None and p95 > budget:
        violations.append(f"time-to-page p95 {p95:.1f}s > budget {budget:.0f}s")
    for v in score["violations"]:
        violations.append(
            f"{v['kind']} at {v['t']:.0f}s (group {v['group']})"
        )
    for incident_id in score["unattributed_incidents"]:
        violations.append(f"{incident_id}: page with no attributable cause")
    return (not violations, violations)


def _paging_result(
    scenario: str,
    base: dict,
    router: AlertRouter,
    evidence: dict,
) -> dict:
    incidents = correlate(router.pages(), evidence)
    score = score_paging(
        evidence.get("faults") or [],
        incidents,
        router.log,
        router.repeat_interval,
    )
    result = {
        "scenario": f"paging_{scenario}",
        "base_ok": bool(base.get("ok", base.get("all_recovered"))),
        "faults": evidence.get("faults") or [],
        "notifications": router.export(),
        "incidents": incidents,
        "score": score,
        "break_inhibition": router.break_inhibition,
    }
    ok, violations = evaluate_paging_contract(result, scenario)
    result["ok"] = ok and result["base_ok"]
    result["violations"] = violations
    return result


# ---------------------------------------------------------------------------
# the three drills


def run_paging_storm(
    seed: int | None = None, break_inhibition: bool = False
) -> dict:
    from k8s_gpu_hpa_tpu_torch.chaos.storm import run_fault_storm

    holder: dict = {}

    def hook(pipe, schedule) -> None:
        holder["pipe"] = pipe
        holder["router"] = attach_pager(
            pipe,
            health_alert_rules(pipe) + pipeline_alert_rules(),
            break_inhibition=break_inhibition,
        )

    base = run_fault_storm(seed=seed, on_pipeline=hook)
    return _paging_result(
        "storm",
        base,
        holder["router"],
        {
            "faults": base["faults"],
            "scale_events": holder["pipe"].scale_history,
        },
    )


def run_paging_crunch(break_inhibition: bool = False) -> dict:
    from k8s_gpu_hpa_tpu_torch.chaos.crunch import run_capacity_crunch

    holder: dict = {}

    def hook(pipe, schedule) -> None:
        holder["pipe"] = pipe
        holder["router"] = attach_pager(
            pipe, health_alert_rules(pipe), break_inhibition=break_inhibition
        )

    base = run_capacity_crunch(on_pipeline=hook)
    return _paging_result(
        "crunch",
        base,
        holder["router"],
        {
            "faults": base["faults"],
            "scale_events": holder["pipe"].scale_history,
            "capacity_events": base["events"],
        },
    )


def run_paging_evacuation(
    break_inhibition: bool = False, smoke: bool = True
) -> dict:
    from k8s_gpu_hpa_tpu_torch.chaos.evacuate import run_region_evacuation

    holder: dict = {}

    def hook(plane, regions, schedule) -> None:
        # host the fleet rules on a surviving region's evaluator: the home
        # region's own ticks die with it mid-drill
        host = next(n for n in plane.regions if n != "us")
        pipe = plane.regions[host].pipeline
        holder["pipe"] = pipe
        holder["router"] = attach_pager(
            pipe, region_alert_rules(plane), break_inhibition=break_inhibition
        )

    base = run_region_evacuation(smoke=smoke, on_plane=hook)
    return _paging_result(
        "evacuate",
        base,
        holder["router"],
        {
            "faults": base["faults"],
            "scale_events": holder["pipe"].scale_history,
            "evacuation_decisions": base["decisions"],
        },
    )


# ---------------------------------------------------------------------------
# coverage session


def _exercise_alerting_edges() -> None:
    """Deterministically drive the router joints the canned drills don't
    reach every run: an active silence, a resolve→re-fire flap coalescing
    into one update, a repeat_interval re-page, and a clean resolve —
    the same synthetic-edge idiom as run_evacuation_coverage_session."""
    from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

    clock = VirtualClock()
    router = AlertRouter(
        clock,
        group_by=("alertname",),
        group_wait=5.0,
        group_interval=30.0,
        repeat_interval=60.0,
        inhibit_rules=shipped_inhibit_rules(),
        silences=(
            Silence(
                "sil-coverage",
                (Matcher("alertname", "NoisyNeighbor"),),
                starts_at=0.0,
                ends_at=10_000.0,
                created_by="coverage-session",
                comment="planted: the silenced path must stay exercised",
            ),
        ),
    )

    def inst(name: str, since: float, **labels: str) -> dict:
        return {
            "name": name,
            "labels": labels,
            "annotations": {},
            "active_since": since,
        }

    flappy = inst("FlappyAlert", 1.0, severity="critical")
    noisy = inst("NoisyNeighbor", 1.0, severity="warning")
    # warning twin on the same slo: inhibited by the critical source
    twin = inst("SloTwin", 1.0, severity="warning", slo="edge")
    src = inst("SloSource", 1.0, severity="critical", slo="edge")
    clock.advance(1.0)
    router.observe([flappy, noisy, src, twin])  # silence + inhibit + open
    clock.advance(6.0)
    router.observe([flappy, src])  # both groups page after group_wait
    clock.advance(2.0)
    router.observe([src])  # flappy resolves (inside group_interval)
    clock.advance(2.0)
    refired = inst("FlappyAlert", 11.0, severity="critical")
    router.observe([refired, src])  # ...and re-fires: a flap
    clock.advance(30.0)
    router.observe([refired, src])  # group_interval due: ONE update
    clock.advance(65.0)
    router.observe([refired, src])  # repeat_interval due: re-page
    clock.advance(35.0)
    router.observe([src])  # flappy group empty + interval due: resolved


def _exercise_incident_edges() -> None:
    """Drive every correlator cause kind plus the unattributed exit-2 path
    over fabricated pages — the cheap deterministic complement to the real
    evacuation drill the session also runs."""
    page = {
        "seq": 0,
        "t": 100.0,
        "kind": "page",
        "group": {"alertname": "PipelineUnhealthy"},
        "fingerprint": "0",
        "alerts": [
            {
                "name": "SLOSignalPropagationFastBurn",
                "labels": {"severity": "critical", "slo": "edge", "burn": "fast"},
                "active_since": 90.0,
            }
        ],
        "would_inhibit": 0,
    }
    correlate(
        [page],
        {
            "faults": [
                {
                    "fault": "edge_fault",
                    "kind": "exporter_outage",
                    "injected_at": 80.0,
                    "cleared_at": 140.0,
                    "recovered_at": 150.0,
                    "trace_span_id": 1,
                }
            ],
            "scale_events": [(95.0, 2, 3)],
            "capacity_events": [
                {"t": 92.0, "tenant": "tpu-prod", "event": "preempted"}
            ],
            "evacuation_decisions": [
                {
                    "t": 94.0,
                    "tenant": "tpu-prod",
                    "from": "us",
                    "to": "eu",
                    "replicas": 2,
                    "denied": False,
                }
            ],
        },
    )
    orphan = dict(page, seq=1, t=5000.0, alerts=[
        {"name": "Mystery", "labels": {}, "active_since": 4990.0}
    ])
    correlate([orphan], {})  # no evidence: the unattributed contract path


def run_incident_coverage_session() -> dict:
    """The ``coverage --run incident`` session: one real evacuation paging
    drill (region alerts, inhibition, incident attribution over real
    decisions) plus the deterministic router/correlator edge exercises."""
    result = run_paging_evacuation(smoke=True)
    _exercise_alerting_edges()
    _exercise_incident_edges()
    return {"ok": result["ok"], "pages": result["score"]["pages_total"]}
