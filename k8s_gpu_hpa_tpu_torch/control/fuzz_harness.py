"""The fuzzer's system under test: one deterministic multi-tenant case.

Counterpart of ``k8s_gpu_hpa_tpu/control/fuzz_harness.py``.  The
coverage-guided fuzzer (:mod:`..chaos.fuzz`) needs a fixed, fast and fully
deterministic harness to run many mutated fault schedules and traffic
shapes against.  This is it: a capacity economy of two tenants on a small
pool, big enough that every fault kind of the registry has something real
to break (nodes to preempt, an autoscaler to starve, a WAL to truncate,
tenants to spike into preemption), small enough that a case runs in a few
seconds of wall time.

The contract is the crunch's (:func:`..chaos.crunch.evaluate_crunch_contract`),
not a second one: the fuzzer hunts violations of the clauses the canned
crunch gates, less its three ``vacuous run:`` clauses (a fuzzed schedule
owes nobody a preemption: one that never squeezes is dull, not broken,
and the fitness starves it out) and its surplus-node clause.

Beside the contract a case scores *fitness*, signals that are no
violation but make a case interesting: SLO burn (the traced pipeline wires
the SLO recorders and alert pairs), pool-audit violations, preemption
pressure and scale events whose lineage breaks.

``break_grace`` is the planted canary (``simulate --scenario fuzz
--break-grace``): it stretches the eviction grace of a preemption to
forever, so any case that preempts strands a Terminating pod and breaks
the convergence clause, a real failure the fuzzer must find and minimize
within the pinned budget (perfgates.FUZZ_CANARY_BUDGET).

A run is pure over ``(faults, traffic, break_grace)``: the virtual clock
only, no ambient randomness, the WAL in a temporary directory whose path
never reaches the outcome.  Two identical calls give the same
:func:`outcome_fingerprint`, which is what makes corpus artifacts
replayable as regression tests.
"""

from __future__ import annotations

import json

from k8s_gpu_hpa_tpu_torch.chaos.crunch import evaluate_crunch_contract
from k8s_gpu_hpa_tpu_torch.chaos.faults import FaultSpec
from k8s_gpu_hpa_tpu_torch.chaos.schedule import ChaosSchedule, _Armed
from k8s_gpu_hpa_tpu_torch.control.capacity import CapacityConfig, TenantSpec
from k8s_gpu_hpa_tpu_torch.control.checkpoint import InMemoryCheckpointStore
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import HPABehavior
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch.metrics.wal import WriteAheadLog
from k8s_gpu_hpa_tpu_torch.obs.latency import percentile

#: (name, priority, weight, preemption_budget, devices_per_pod, max_replicas,
#:  base_load, starvation_budget_s, ttc_gate_s): two tenants, one pool.  The
#: budgets are generous on purpose: a case without faults passes the
#: contract clean, so every violation the fuzzer finds is the schedule's
FUZZ_TENANTS = [
    ("tpu-prod", 100, 2.0, 0, 2, 4, 30.0, 300.0, 240.0),
    ("tpu-batch", 10, 1.0, 8, 1, 6, 35.0, 700.0, 600.0),
]

FUZZ_NODES = [("fuzz-node-0", 4), ("fuzz-node-1", 4)]

#: the bounds of a schedule's shape, which the generator and the replayer
#: both keep
FUZZ_MAX_FAULTS = 10
FUZZ_MAX_AT_S = 600.0
FUZZ_MAX_DURATION_S = 240.0
FUZZ_SETTLE_S = 90.0
FUZZ_TAIL_S = 300.0
FUZZ_MIN_TOTAL_S = 240.0
FUZZ_MAX_TOTAL_S = 1200.0

#: the traffic bases the mutator may set, per tenant
FUZZ_TRAFFIC_MIN = 10.0
FUZZ_TRAFFIC_MAX = 60.0

DEFAULT_TRAFFIC = {name: base for name, _, _, _, _, _, base, _, _ in FUZZ_TENANTS}


class _FuzzSchedule(ChaosSchedule):
    """A ChaosSchedule that survives an injector's refusal.

    Fuzzed schedules legally hold specs an injector refuses at run time
    (``pod_crash`` with nothing running, a target a shrunk schedule no
    longer fits, a region kind outside a region).  The stock schedule lets
    that ValueError out of ``clock.advance`` and kills the case; here it is
    recorded as an inject error and the fault marked resolved (cleared and
    "recovered" at the refusal), so ``all_recovered()`` scores the faults
    that landed, not the one that never existed."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.inject_errors: list[str] = []

    def _inject(self, armed: _Armed) -> None:
        try:
            super()._inject(armed)
        except ValueError as exc:
            now = self.pipeline.clock.now()
            armed.report.cleared_at = now
            armed.report.recovered_at = now
            armed.clear_fn = None
            armed.resolved = True
            self.inject_errors.append(f"{armed.spec.name}: {exc}")


def _ttc_gate(name: str) -> float:
    for row in FUZZ_TENANTS:
        if row[0] == name:
            return row[8]
    raise KeyError(name)


def run_fuzz_case(
    faults: list[FaultSpec],
    traffic: dict[str, float] | None = None,
    break_grace: bool = False,
) -> dict:
    """Run one fuzz case: the fixed two-tenant harness under ``faults`` and
    the tenants' base loads ``traffic``.  Returns a JSON-able outcome with
    the contract evaluated (``violations``), the fitness ``score`` (higher
    is more interesting) and the deterministic ``fingerprint``."""
    import tempfile

    from k8s_gpu_hpa_tpu_torch.obs import Tracer, index_spans, lineage_of
    from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

    traffic = dict(DEFAULT_TRAFFIC, **(traffic or {}))
    unknown = sorted(set(traffic) - set(DEFAULT_TRAFFIC))
    if unknown:
        raise ValueError(f"traffic names unknown tenants: {unknown}")

    clock = VirtualClock()
    tracer = Tracer(clock)
    cluster = SimCluster(clock, nodes=list(FUZZ_NODES), pod_start_latency=5.0)
    config = CapacityConfig(
        tenants=[
            TenantSpec(
                name,
                priority=priority,
                weight=weight,
                preemption_budget=budget,
                starvation_budget_s=starve,
            )
            for name, priority, weight, budget, _, _, _, starve, _ in FUZZ_TENANTS
        ],
        slice_quantum=1,
        # the canary: a grace longer than any run means a preempted pod
        # never finishes Terminating, so convergence can never hold
        grace_s=1e7 if break_grace else 5.0,
        autoscaler_node_chips=4,
        autoscaler_max_nodes=1,
        provision_delay_s=30.0,
        provision_timeout_s=20.0,
        backoff_base_s=30.0,
        backoff_cap_s=240.0,
    )

    deployments: dict[str, SimDeployment] = {}
    for name, _, _, _, chips, _, _, _, _ in FUZZ_TENANTS:
        deployments[name] = SimDeployment(
            cluster,
            name,
            name,
            chips_per_pod=chips,
            load_fn=lambda t, b=traffic[name]: b,
            load_mode="shared",
        )

    prod = deployments["tpu-prod"]
    cluster.add_deployment(prod, replicas=1)
    clock.advance(10.0)
    behavior = HPABehavior()
    behavior.scale_down.stabilization_window_seconds = 60.0

    with tempfile.TemporaryDirectory(prefix="fuzz-wal-") as wal_dir:
        pipe = AutoscalingPipeline(
            cluster,
            prod,
            record="tpu_prod_tensorcore_avg",
            target_value=40.0,
            max_replicas=FUZZ_TENANTS[0][5],
            behavior=behavior,
            tracer=tracer,
            wal=WriteAheadLog(wal_dir, segment_max_records=256),
            checkpoint_store=InMemoryCheckpointStore(),
            capacity=config,
        )
        for name, _, _, _, _, max_replicas, _, _, _ in FUZZ_TENANTS[1:]:
            cluster.add_deployment(deployments[name], replicas=1)
            tenant_behavior = HPABehavior()
            tenant_behavior.scale_down.stabilization_window_seconds = 60.0
            pipe.add_tenant_hpa(
                deployments[name],
                target_value=40.0,
                max_replicas=max_replicas,
                behavior=tenant_behavior,
            )
        scheduler = pipe.capacity_scheduler
        autoscaler = scheduler.autoscaler

        audits: list[dict] = []
        reaped: list[str] = []
        slo_state = {"violation_s": 0.0}

        def monitor() -> None:
            audits.append(scheduler.pool.audit())
            reaped.extend(autoscaler.reap_idle(idle_s=120.0))
            if any(name.startswith("SLO") for name in pipe.evaluator.firing_alerts()):
                slo_state["violation_s"] += 5.0
            clock.call_later(5.0, monitor)

        clock.call_later(5.0, monitor)

        pipe.start()
        clock.advance(FUZZ_SETTLE_S)

        schedule = _FuzzSchedule(pipe, list(faults))
        schedule.arm()
        end = max([s.at + max(s.duration, 0.0) for s in faults], default=0.0)
        total = min(FUZZ_MAX_TOTAL_S, max(FUZZ_MIN_TOTAL_S, end + FUZZ_TAIL_S))
        clock.advance(total)

        tenant_results: dict[str, dict] = {}
        for name, priority, weight, budget, chips, _, _, _, _ in FUZZ_TENANTS:
            spec = scheduler.tenants[name]
            waits = scheduler.admission_waits.get(name, [])
            pods = cluster.deployment_pods(name)
            ttc_p95 = percentile(list(waits), 95.0)
            tenant_results[name] = {
                "priority": priority,
                "weight": weight,
                "chips_per_pod": chips,
                "preemption_budget": budget,
                "starvation_budget_s": spec.starvation_budget_s,
                "ttc_gate_s": _ttc_gate(name),
                "admissions": len(waits),
                "ttc_p95_s": None if ttc_p95 is None else round(ttc_p95, 1),
                "max_pending_stint_s": round(
                    max(
                        scheduler.max_pending_stint.get(name, 0.0),
                        scheduler.open_stint_seconds(name),
                    ),
                    1,
                ),
                "preemptions_suffered": scheduler.preemptions_suffered.get(name, 0),
                "final_replicas": cluster.deployments[name].replicas,
                "final_running": len(cluster.running_pods(name)),
                "final_pending": sum(1 for p in pods if p.phase == "Pending"),
                "final_terminating": sum(1 for p in pods if p.phase == "Terminating"),
            }

        by_id = index_spans(tracer.spans)
        scale_events = tracer.spans_of("scale_event")
        lineage_breaks = sum(1 for s in scale_events if not lineage_of(s, by_id)["complete"])

        final_audit = scheduler.pool.audit()
        result = {
            "scenario": "fuzz_case",
            "mode": "virtual",
            "total_s": total,
            "traffic": {k: traffic[k] for k in sorted(traffic)},
            "break_grace": break_grace,
            "tenants": tenant_results,
            "pool": {
                "capacity_final": final_audit["capacity"],
                "used_final": final_audit["used"],
                "audit_ticks": len(audits),
                "conserved_all": all(a["conserved"] for a in audits) and final_audit["conserved"],
                "audit_violations": [v for a in audits + [final_audit] for v in a["violations"]],
            },
            "autoscaler": {
                "provisions": autoscaler.provisions_total,
                "provision_failures": autoscaler.provision_failures_total,
                "nodes_final": len(autoscaler.provisioned),
            },
            "preemptions_total": scheduler.preemptions_total,
            "faults": [r.as_dict() for r in schedule.reports],
            "all_recovered": schedule.all_recovered(),
            "inject_errors": list(schedule.inject_errors),
            "slo_violation_s": slo_state["violation_s"],
            "scale_events": len(scale_events),
            "lineage_breaks": lineage_breaks,
        }

    # Two crunch clauses do not carry over to arbitrary schedules: the three
    # "vacuous run:" checks (a fuzzed case owes nobody a preemption) and the
    # surplus-node reap clause (the crunch's wind-down empties the
    # autoscaled node, so the reap is certain there, but a fuzzed schedule
    # may legitimately park a tenant's pod on it for good).  Both feed the
    # fitness (``_score``) instead.
    contract = [
        v
        for v in evaluate_crunch_contract(result)
        if not v.startswith("vacuous run:") and "surplus autoscaled node" not in v
    ]
    if lineage_breaks:
        contract.append(f"{lineage_breaks} scale event(s) without complete metric lineage")
    result["violations"] = contract
    result["ok"] = not contract
    result["score"] = _score(result)
    result["fingerprint"] = outcome_fingerprint(result)
    return result


def _score(outcome: dict) -> float:
    """Fitness: how interesting a case is.  Violations dominate; the rest
    rewards pressure (burn, audit noise, preemption churn, injection
    friction), so the search climbs toward the contract's edges before
    anything breaks.  Rounded, so equal behaviour cannot differ in the last
    bit."""
    return round(
        len(outcome["violations"]) * 100.0
        + outcome["slo_violation_s"] / 6.0
        + len(outcome["pool"]["audit_violations"]) * 5.0
        + outcome["preemptions_total"] * 2.0
        + outcome["lineage_breaks"] * 20.0
        + outcome["autoscaler"]["nodes_final"] * 10.0
        + len(outcome["inject_errors"]),
        3,
    )


#: the outcome keys a replay must reproduce exactly: everything
#: deterministic that carries behaviour, nothing of the environment
_FINGERPRINT_KEYS = (
    "scenario",
    "total_s",
    "traffic",
    "break_grace",
    "tenants",
    "pool",
    "autoscaler",
    "preemptions_total",
    "faults",
    "all_recovered",
    "inject_errors",
    "slo_violation_s",
    "scale_events",
    "lineage_breaks",
    "violations",
)


def outcome_fingerprint(outcome: dict) -> str:
    """Canonical JSON of the chosen outcome keys.  Two runs of one case (in
    the campaign, in the minimizer, in a corpus replay long after) must give
    the same string, or the scenario does not reproduce."""
    return json.dumps(
        {k: outcome[k] for k in _FINGERPRINT_KEYS if k in outcome},
        sort_keys=True,
        separators=(",", ":"),
    )
