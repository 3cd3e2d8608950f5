"""The capacity crunch: three tenants spike into a pool that cannot hold them.

Counterpart of ``k8s_gpu_hpa_tpu/chaos/crunch.py``: the ``capacity_crunch``
rung behind ``python -m k8s_gpu_hpa_tpu_torch simulate --scenario crunch``.
Where the storm (:mod:`.storm`) breaks the observability plane a layer at a
time, the crunch breaks supply: demand spikes at once across three tenants
of different PriorityClasses, a cloud API that refuses to provision just when
the autoscaler needs it, and a node drained in the middle of the squeeze.
Under test is the capacity economy (``control/capacity.py``): admission by
priority, the weighted fair share at saturation, preemption by eviction with
grace and the provisioning backoff, scored by :func:`evaluate_crunch_contract`
against the ceilings of :mod:`..perfgates`.

The cast (a pool of 2 nodes of 8 devices, a slice quantum of 4, and an
autoscaler that may add 2 more 8-device nodes):

=========  ========  ======  =======  =========  =====  ====================
tenant     priority  weight  devices  preempt    max    peak demand
                             a pod    budget     repl.
=========  ========  ======  =======  =========  =====  ====================
tpu-prod   100       2.0     4        0 (never)  4      16 devices (latency)
tpu-batch  10        1.0     2        6          6      12 devices (training)
tpu-best   10        0.5     1        10         8      3 devices (best effort)
=========  ========  ======  =======  =========  =====  ====================

A peak demand of 31 devices against 16 base and 16 autoscaled, and the middle
of the crunch takes one base node away.  The faults (seconds after arming):

=========  =============================  ====================================
t (s)      fault                          what must happen
=========  =============================  ====================================
140-240    provision_fail                 the autoscaler's attempts time out
                                          and back off; no loop hammers the API
150-510    tenant_spike tpu-prod (+130)   prod preempts the low priority within
                                          its TTC gate; the victims queue again
155-510    tenant_spike tpu-batch (+170)  batch over its share yields to best
                                          (FairShareLimited), waits for nodes
160-510    tenant_spike tpu-best (+90)    best effort rides the fair share and
                                          is never starved past its budget
300-420    node_drain crunch-node-1       displaced prod pods are admitted
                                          again on the node just provisioned
=========  =============================  ====================================

After 510 s the spikes clear: the HPAs scale down, the autoscaled nodes
empty and are reaped, and the contract asks for full convergence with the
pool conserved at every 5 s audit of the run.
"""

from __future__ import annotations

from k8s_gpu_hpa_tpu_torch import perfgates
from k8s_gpu_hpa_tpu_torch.chaos.faults import FaultSpec
from k8s_gpu_hpa_tpu_torch.chaos.schedule import ChaosSchedule
from k8s_gpu_hpa_tpu_torch.control.capacity import CapacityConfig, TenantSpec
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import HPABehavior
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
from k8s_gpu_hpa_tpu_torch.obs.latency import percentile
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

#: (name, priority, weight, preemption_budget, chips_per_pod, max_replicas,
#:  base_load, spike_add); the starvation budgets are perfgates', so the
#: contract and the gates cannot drift apart
CRUNCH_TENANTS = [
    ("tpu-prod", 100, 2.0, 0, 4, 4, 30.0, 130.0),
    ("tpu-batch", 10, 1.0, 6, 2, 6, 35.0, 170.0),
    ("tpu-best", 10, 0.5, 10, 1, 8, 30.0, 90.0),
]

CRUNCH_FAULTS = [
    FaultSpec("provision_fail", at=140.0, duration=100.0),
    FaultSpec("tenant_spike", at=150.0, duration=360.0, target="tpu-prod",
              params={"add": 130.0}),
    FaultSpec("tenant_spike", at=155.0, duration=355.0, target="tpu-batch",
              params={"add": 170.0}),
    FaultSpec("tenant_spike", at=160.0, duration=350.0, target="tpu-best",
              params={"add": 90.0}),
    FaultSpec("node_drain", at=300.0, duration=120.0, target="crunch-node-1"),
]


def _ttc_gate_s(priority: int) -> float:
    """The time-to-capacity p95 ceiling of a tenant's priority: the top one
    is served by preemption, the others by provisioning."""
    if priority >= 100:
        return perfgates.CRUNCH_HIGH_TTC_P95_MAX_S
    return perfgates.CRUNCH_LOW_TTC_P95_MAX_S


def _stabilized_down(window_s: float = 60.0) -> HPABehavior:
    """The shipped behavior with a 60 s scale-down stabilization (as the
    storm's), so the convergence the contract checks fits the run."""
    behavior = HPABehavior()
    behavior.scale_down.stabilization_window_seconds = window_s
    return behavior


def run_capacity_crunch(
    starvation_budget: float | None = None,
    total: float = perfgates.CRUNCH_TOTAL_S,
    on_pipeline=None,
) -> dict:
    """Run the canned crunch and return a JSON-able result, the contract
    evaluated (``result["ok"]``, ``result["violations"]``).

    ``starvation_budget`` overrides every tenant's declared budget: the
    ``--starvation-budget`` knob that shows the contract can fail (0 fails
    any run that ever queued a pod).  ``on_pipeline(pipe, schedule)`` runs
    before the faults are armed."""
    clock = VirtualClock()
    cluster = SimCluster(
        clock,
        nodes=[
            (f"crunch-node-{i}", perfgates.CRUNCH_NODE_CHIPS)
            for i in range(perfgates.CRUNCH_BASE_NODES)
        ],
        pod_start_latency=5.0,
    )
    tenants = [
        TenantSpec(
            name,
            priority=priority,
            weight=weight,
            preemption_budget=budget,
            starvation_budget_s=(
                perfgates.CRUNCH_STARVATION_BUDGETS_S[name]
                if starvation_budget is None else starvation_budget
            ),
        )
        for name, priority, weight, budget, _, _, _, _ in CRUNCH_TENANTS
    ]
    config = CapacityConfig(
        tenants=tenants,
        slice_quantum=perfgates.CRUNCH_SLICE_QUANTUM,
        grace_s=perfgates.CRUNCH_EVICTION_GRACE_S,
        autoscaler_node_chips=perfgates.CRUNCH_NODE_CHIPS,
        autoscaler_max_nodes=perfgates.CRUNCH_AUTOSCALER_MAX_NODES,
        provision_delay_s=perfgates.CRUNCH_PROVISION_DELAY_S,
        provision_timeout_s=perfgates.CRUNCH_PROVISION_TIMEOUT_S,
        backoff_base_s=30.0,
        backoff_cap_s=240.0,
    )

    # each tenant's load is a closure over its own base (tenant_spike wraps
    # load_fn for its window)
    deployments = {
        name: SimDeployment(
            cluster, name, name, chips_per_pod=chips, load_fn=lambda t, b=base: b,
            load_mode="shared",
        )
        for name, _, _, _, chips, _, base, _ in CRUNCH_TENANTS
    }

    # the capacity config comes in on the primary pipeline; the other two
    # tenants join its plane through add_tenant_hpa, so one CapacityScheduler
    # arbitrates all three controllers
    prod = deployments["tpu-prod"]
    cluster.add_deployment(prod, replicas=1)
    clock.advance(10.0)
    pipe = AutoscalingPipeline(
        cluster,
        prod,
        record="tpu_prod_tensorcore_avg",
        target_value=40.0,
        max_replicas=CRUNCH_TENANTS[0][5],
        behavior=_stabilized_down(),
        capacity=config,
    )
    for name, _, _, _, _, max_replicas, _, _ in CRUNCH_TENANTS[1:]:
        cluster.add_deployment(deployments[name], replicas=1)
        pipe.add_tenant_hpa(
            deployments[name],
            target_value=40.0,
            max_replicas=max_replicas,
            behavior=_stabilized_down(),
        )
    scheduler = pipe.capacity_scheduler
    autoscaler = scheduler.autoscaler

    # the 5 s monitor audits the pool at every tick, crunch or not, and runs
    # the autoscaler's scale-down, so convergence includes giving nodes back
    audits: list[dict] = []
    reaped: list[str] = []

    def monitor() -> None:
        audits.append(scheduler.pool.audit())
        reaped.extend(autoscaler.reap_idle(idle_s=120.0))
        clock.call_later(5.0, monitor)

    clock.call_later(5.0, monitor)

    pipe.start()
    clock.advance(120.0)  # settle: every tenant at its base load
    settled = {name: cluster.deployments[name].replicas for name in deployments}

    schedule = ChaosSchedule(pipe, CRUNCH_FAULTS)
    if on_pipeline is not None:
        on_pipeline(pipe, schedule)
    schedule.arm()
    clock.advance(total)

    tenant_results: dict[str, dict] = {}
    for name, priority, weight, budget, chips, _, _, _ in CRUNCH_TENANTS:
        waits = scheduler.admission_waits.get(name, [])
        pods = cluster.deployment_pods(name)
        ttc_p95 = percentile(list(waits), 95.0)
        tenant_results[name] = {
            "priority": priority,
            "weight": weight,
            "chips_per_pod": chips,
            "preemption_budget": budget,
            "starvation_budget_s": scheduler.tenants[name].starvation_budget_s,
            "ttc_gate_s": _ttc_gate_s(priority),
            "admissions": len(waits),
            "ttc_p95_s": None if ttc_p95 is None else round(ttc_p95, 1),
            "max_pending_stint_s": round(
                max(
                    scheduler.max_pending_stint.get(name, 0.0),
                    scheduler.open_stint_seconds(name),
                ),
                1,
            ),
            "pending_seconds": round(scheduler.tenant_pending_seconds(name), 1),
            "preemptions_suffered": scheduler.preemptions_suffered.get(name, 0),
            "final_replicas": cluster.deployments[name].replicas,
            "final_running": len(cluster.running_pods(name)),
            "final_pending": sum(1 for p in pods if p.phase == "Pending"),
            "final_terminating": sum(1 for p in pods if p.phase == "Terminating"),
            "scale_events": len(
                pipe.scale_history if name == prod.name else pipe.tenant_scale_history[name]
            ),
        }

    final_audit = scheduler.pool.audit()
    result = {
        "scenario": "capacity_crunch",
        "mode": "virtual",
        "settled": settled,
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
            "reaped": reaped,
        },
        "preemptions_total": scheduler.preemptions_total,
        "faults": [r.as_dict() for r in schedule.reports],
        "all_recovered": schedule.all_recovered(),
        "events": scheduler.events,
    }
    result["violations"] = evaluate_crunch_contract(result)
    result["ok"] = not result["violations"]
    return result


def evaluate_crunch_contract(result: dict) -> list[str]:
    """Score a crunch result against the capacity contract, purely over the
    result dict (tests feed it doctored results to fire each clause):

    - **conservation and the slice boundary**: every 5 s audit conserved,
      no boundary violation;
    - **time to capacity**: each tenant's admission-wait p95 within its
      priority's perfgates ceiling;
    - **starvation**: no tenant's worst Pending stint (open stints at the
      end included) past its declared budget;
    - **preemption budget**: no tenant evicted more times than it declared
      it tolerates;
    - **convergence**: once the crunch clears, every tenant's pods all
      Running at the desired count, every fault recovered, the surplus
      autoscaled nodes reaped;
    - **not vacuous**: the run preempted, provisioned, and had a provision
      fail; a crunch that never squeezed shows nothing.
    """
    violations: list[str] = []
    pool = result["pool"]
    if not pool["conserved_all"]:
        violations.append(
            "pool conservation broken: "
            + ("; ".join(pool["audit_violations"][:3]) or "used + free != capacity on some tick")
        )
    for name, t in result["tenants"].items():
        if t["ttc_p95_s"] is not None and t["ttc_p95_s"] > t["ttc_gate_s"]:
            violations.append(
                f"{name}: time-to-capacity p95 {t['ttc_p95_s']:.1f}s "
                f"exceeds the {t['ttc_gate_s']:.0f}s gate"
            )
        if t["max_pending_stint_s"] > t["starvation_budget_s"]:
            violations.append(
                f"{name}: starved {t['max_pending_stint_s']:.1f}s, over its "
                f"{t['starvation_budget_s']:.0f}s budget"
            )
        if t["preemptions_suffered"] > t["preemption_budget"]:
            violations.append(
                f"{name}: evicted {t['preemptions_suffered']} times, over its "
                f"budget of {t['preemption_budget']}"
            )
        if t["final_running"] != t["final_replicas"] or t["final_pending"] or t["final_terminating"]:
            violations.append(
                f"{name}: did not converge ({t['final_running']}/"
                f"{t['final_replicas']} running, {t['final_pending']} pending, "
                f"{t['final_terminating']} terminating)"
            )
    if not result["all_recovered"]:
        violations.append("not every fault recovered")
    auto = result["autoscaler"]
    if auto["nodes_final"] != 0:
        violations.append(f"{auto['nodes_final']} surplus autoscaled node(s) never reaped")
    if result["preemptions_total"] < 1:
        violations.append("vacuous run: no preemption ever happened")
    if auto["provisions"] < 1:
        violations.append("vacuous run: the autoscaler never provisioned")
    if auto["provision_failures"] < 1:
        violations.append("vacuous run: provision_fail never bit")
    return violations


#: the pod transitions the timeline prints (the autoscaler's events print
#: as its own, retries never)
_TIMELINE_EVENTS = (
    "pending",
    "admitted",
    "preempted",
    "evicted",
    "readmitted",
    "fair_share_limited",
)


def render_crunch_report(result: dict) -> str:
    """The crunch as text: a line a tenant, the timeline, the verdict."""
    tenants = result["tenants"]
    lines = [
        f"capacity crunch: {len(tenants)} tenants over a "
        f"{result['pool']['capacity_final']}-chip pool, "
        f"{result['preemptions_total']} preemptions, "
        f"{result['autoscaler']['provisions']} nodes provisioned "
        f"({result['autoscaler']['provision_failures']} failed attempts)",
        "",
        f"{'tenant':<10} {'prio':>4} {'ttc p95':>8} {'worst wait':>11} "
        f"{'evicted':>8} {'final':>6}",
    ]
    for name, t in tenants.items():
        ttc = "-" if t["ttc_p95_s"] is None else f"{t['ttc_p95_s']:.0f}s"
        lines.append(
            f"{name:<10} {t['priority']:>4} {ttc:>8} "
            f"{t['max_pending_stint_s']:>6.0f}/{t['starvation_budget_s']:<3.0f}s "
            f"{t['preemptions_suffered']:>4}/{t['preemption_budget']:<2} "
            f"{t['final_running']:>3}/{t['final_replicas']}"
        )
    lines += ["", "timeline (pod lifecycle + pool events):"]
    for e in result["events"]:
        if e["event"] in _TIMELINE_EVENTS:
            who = f"{e['tenant']}/{e['pod']}"
        elif e["event"].startswith(("provision", "node_")):
            who = "autoscaler"
        else:
            continue
        lines.append(f"  t={e['t']:7.1f}  {who:<28} {e['event']:<19} {e['detail']}")
    lines += [
        "",
        f"pool audits conserved:   {result['pool']['conserved_all']} "
        f"({result['pool']['audit_ticks']} ticks)",
        f"all faults recovered:    {result['all_recovered']}",
        f"autoscaled nodes reaped: {len(result['autoscaler']['reaped'])}",
        "",
    ]
    if result["violations"]:
        lines.append("CONTRACT VIOLATIONS:")
        lines += [f"  - {v}" for v in result["violations"]]
    else:
        lines.append("contract: all clauses hold")
    return "\n".join(lines)
