"""The capacity economy (``control/capacity.py``), the cluster's scheduler
hook, the HPA's capacity conditions and the pipeline's tenants against the
JAX package's.

Every case runs one virtual-clock script on both packages and compares,
second by second, each pod's phase and node, each tenant's status, the
pool's audit and its exposition text, and at the end the scheduler's event
timeline (``t``, ``tenant``, ``pod``, ``event``, ``detail``):

- ``SlicePool.audit`` on a whole cluster and on each way to break it (a
  node off the quantum, a device held by a missing pod or by a pod that
  does not claim it, a pod on a missing node, with the wrong count or a
  device its node does not give it);
- admission by priority; the yield walk, where a pod that fits nowhere
  reserves nothing and small pods backfill; the fair-share gate within a
  priority; eviction with grace (the victim Terminating with its devices,
  then Pending, then readmitted; the budget; a victim deleted during its
  grace);
- the autoscaler: the provisioning delay, the timeout while
  ``provision_fail``'s flag is up, the exponential backoff and its cap,
  ``max_nodes``, and ``reap_idle``;
- the pool's families as exposition text, byte for byte, with and without
  an autoscaler;
- a pipeline with ``capacity=``: the HPA's Unschedulable, Preempting and
  FairShareLimited conditions, the tenant HPAs of ``add_tenant_hpa`` (their
  scale histories; a duplicate refused), ``restart_hpa`` keeping the probe,
  ``restart_adapter`` and ``pipeline_healthy`` over every tenant;
- ``capacity_selfcheck()``;
- a hypothesis property over tenant mixes and demand steps (derandomized,
  no database): the same timeline and states as JAX's, the pool conserved
  at every second.

Tolerance: exact (virtual time throughout).
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_gpu_hpa_tpu.chaos import schedule as jax_schedule
from k8s_gpu_hpa_tpu.control import capacity as jax_capacity
from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.control import loop as jax_loop
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch.chaos import schedule
from k8s_gpu_hpa_tpu_torch.control import capacity, cluster, hpa, loop
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(capacity=capacity, cluster=cluster, clock=clock, hpa=hpa, loop=loop,
            schedule=schedule)
JAX = dict(capacity=jax_capacity, cluster=jax_cluster, clock=jax_clock, hpa=jax_hpa,
           loop=jax_loop, schedule=jax_schedule)


# ---- a virtual-clock script on one package ---------------------------------------


def _world(mods, nodes, tenants, pod_start=5.0, **config):
    """A cluster of ``nodes`` with the economy of ``tenants`` (TenantSpec
    keyword dicts) and ``config`` (CapacityConfig keywords) installed."""
    vclock = mods["clock"].VirtualClock()
    sim = mods["cluster"].SimCluster(vclock, nodes=nodes, pod_start_latency=pod_start)
    cap = mods["capacity"]
    sched = cap.build_capacity(
        sim, cap.CapacityConfig(tenants=[cap.TenantSpec(**t) for t in tenants], **config))
    return vclock, sim, sched


def _state(sim, sched) -> tuple:
    """What one second of a script shows: every pod's phase, node and
    devices; every tenant's status; the audit; the pool's exposition; the
    autoscaler's counters."""
    pods = sorted((p.name, p.phase, p.node, tuple(p.chip_ids)) for p in sim.pods.values())
    tenants = sorted(set(sched.tenants) | set(sim.deployments))
    auto = sched.autoscaler
    autoscaler = None if auto is None else (
        auto.in_flight, auto.backoff_until, auto.consecutive_failures, auto.provisions_total,
        auto.provision_failures_total, tuple(auto.provisioned), auto.failing)
    return (sim.clock.now(), pods, [(t, sched.tenant_status(t)) for t in tenants],
            sched.pool.audit(), _pool_exporter(sched).exposition(), autoscaler,
            sorted(sim.nodes))


def _pool_exporter(sched):
    """The pool's exporter of the scheduler's own package."""
    module = jax_capacity if type(sched).__module__.startswith("k8s_gpu_hpa_tpu.") else capacity
    return module.PoolMetricsExporter(sched)


def _timeline(sched) -> list[tuple]:
    return [(e["t"], e["tenant"], e["pod"], e["event"], e["detail"]) for e in sched.events]


def run_script(mods, nodes, tenants, steps, pod_start=5.0, reap_every=None, **config) -> dict:
    """Run ``steps`` on one package: ("add", name, devices a pod, replicas),
    ("scale", name, replicas), ("run", seconds) a second at a time,
    ("drain" | "restore" | "preempt", node), ("fail", bool) the
    autoscaler's flag, ("kill", n) the n-th pod by name.  With
    ``reap_every`` a monitor calls ``reap_idle(60)`` at that period."""
    vclock, sim, sched = _world(mods, nodes, tenants, pod_start, **config)
    seconds, reaped = [], []
    if reap_every is not None:
        def monitor():
            reaped.extend(sched.autoscaler.reap_idle(idle_s=60.0))
            vclock.call_later(reap_every, monitor)
        vclock.call_later(reap_every, monitor)
    for step in steps:
        op, *args = step
        if op == "add":
            name, chips, replicas = args
            sim.add_deployment(mods["cluster"].SimDeployment(
                sim, name, name, chips_per_pod=chips, load_fn=lambda t: 10.0), replicas=replicas)
        elif op == "scale":
            sim.deployments[args[0]].scale_to(args[1])
        elif op == "run":
            for _ in range(int(args[0])):
                vclock.advance(1.0)
                seconds.append(_state(sim, sched))
        elif op == "drain":
            sim.drain_node(args[0])
        elif op == "restore":
            sim.restore_node(args[0])
        elif op == "preempt":
            sim.preempt_node(args[0])
        elif op == "fail":
            sched.autoscaler.failing = args[0]
        elif op == "kill":
            sim.kill_pod(sorted(sim.pods)[args[0]])
        else:
            raise KeyError(op)
    return {"seconds": seconds, "timeline": _timeline(sched), "reaped": reaped,
            "waits": sched.admission_waits, "stints": sched.max_pending_stint,
            "preemptions": (sched.preemptions_total, sched.preemptions_suffered)}


def both(*args, **kw) -> dict:
    port = run_script(PORT, *args, **kw)
    assert port == run_script(JAX, *args, **kw)
    assert all(s[3]["conserved"] for s in port["seconds"])
    return port


def events(result: dict) -> list[str]:
    return [e[3] for e in result["timeline"]]


# ---- the pool's audit ------------------------------------------------------------


def _broken_cluster(mods, how: str):
    vclock, sim, sched = _world(mods, [("n-0", 4), ("n-1", 4)], [], pod_start=1.0,
                                slice_quantum=2)
    sim.add_deployment(mods["cluster"].SimDeployment(sim, "a", "a", chips_per_pod=2), replicas=3)
    vclock.advance(2.0)
    pods = sorted(sim.pods.values(), key=lambda p: p.name)
    if how == "off_quantum":
        sim.add_node("n-odd", 3)
    elif how == "missing_pod":
        sim.nodes["n-1"].allocations[3] = "ghost"
    elif how == "unclaimed":
        sim.nodes[pods[0].node].allocations[pods[0].chip_ids[0]] = pods[1].name
    elif how == "missing_node":
        pods[0].node = "n-gone"
    elif how == "wrong_count":
        pods[0].chip_ids = pods[0].chip_ids[:1]
    elif how == "node_disagrees":
        del sim.nodes[pods[2].node].allocations[pods[2].chip_ids[1]]
    elif how != "whole":
        raise KeyError(how)
    return sched.pool.audit()


@pytest.mark.parametrize("how", ["whole", "off_quantum", "missing_pod", "unclaimed",
                                 "missing_node", "wrong_count", "node_disagrees"])
def test_the_pool_s_audit_finds_what_jax_s_finds(how):
    port = _broken_cluster(PORT, how)
    assert port == _broken_cluster(JAX, how)
    assert port["conserved"] == (how == "whole")
    assert bool(port["violations"]) == (how != "whole")


def test_the_economy_refuses_what_jax_s_refuses():
    for mods in (PORT, JAX):
        cap = mods["capacity"]
        sim = mods["cluster"].SimCluster(mods["clock"].VirtualClock())
        with pytest.raises(ValueError, match="weight must be > 0"):
            cap.TenantSpec("t", weight=0.0)
        with pytest.raises(ValueError, match="preemption_budget must be >= 0"):
            cap.TenantSpec("t", preemption_budget=-1)
        with pytest.raises(ValueError, match="slice_quantum must be >= 1"):
            cap.SlicePool(sim, slice_quantum=0)
        with pytest.raises(ValueError, match="not a whole number of slice quanta"):
            cap.build_capacity(sim, cap.CapacityConfig(slice_quantum=4, autoscaler_node_chips=6))


# ---- admission, the yield walk, the fair share, preemption ------------------------


def test_a_higher_priority_is_admitted_first_at_saturation():
    got = both([("n-0", 4)], [dict(name="hi", priority=10), dict(name="lo", priority=0,
                                                                 preemption_budget=0)],
               [("add", "lo", 1, 3), ("add", "hi", 1, 3), ("run", 30)])
    last = {p[0]: p[1] for p in got["seconds"][-1][1]}
    assert sum(1 for n, ph in last.items() if n.startswith("hi") and ph == "Running") == 3
    assert sum(1 for n, ph in last.items() if n.startswith("lo") and ph == "Running") == 1
    assert "pending" in events(got) and "preempted" not in events(got)


def test_a_pod_that_fits_nowhere_reserves_nothing_and_small_pods_backfill():
    got = both([("n-0", 4)], [dict(name="big", priority=10, preemption_budget=0),
                              dict(name="fill", priority=5, preemption_budget=0),
                              dict(name="small", priority=0, preemption_budget=0)],
               [("add", "fill", 2, 1), ("run", 10), ("add", "big", 4, 1), ("run", 10),
                ("add", "small", 1, 2), ("run", 20), ("scale", "fill", 0), ("scale", "small", 0),
                ("run", 20)])
    at_30 = {p[0]: p[1] for p in got["seconds"][39][1]}
    assert [ph for n, ph in sorted(at_30.items()) if n.startswith("big")] == ["Pending"]
    assert [ph for n, ph in sorted(at_30.items()) if n.startswith("small")] == ["Running"] * 2
    assert [ph for _, ph, *_ in got["seconds"][-1][1]] == ["Running"]  # big, once room


def test_the_fair_share_gate_holds_a_tenant_over_its_share_within_a_priority():
    got = both([("n-0", 8)], [dict(name="a", priority=0, weight=1.0),
                              dict(name="b", priority=0, weight=1.0)],
               [("add", "a", 1, 8), ("run", 10), ("add", "b", 1, 4), ("run", 10),
                ("scale", "a", 10), ("run", 20), ("scale", "a", 4), ("run", 20)])
    assert "fair_share_limited" in events(got)
    limited = [s[2] for s in got["seconds"] if dict(s[2])["a"]["fair_share_limited"]]
    assert limited
    last = dict(got["seconds"][-1][2])
    assert last["b"]["pending_pods"] == 0 and last["a"]["pending_pods"] == 0


def test_eviction_with_grace_round_trips_its_victim_within_the_budget():
    got = both([("n-0", 4)], [dict(name="hi", priority=100, preemption_budget=0),
                              dict(name="lo", priority=0, preemption_budget=1)],
               [("add", "lo", 2, 2), ("run", 10), ("add", "hi", 2, 2), ("run", 20),
                ("scale", "hi", 0), ("run", 20)], grace_s=3.0)
    assert events(got).count("preempted") == 1 and "evicted" in events(got)
    assert "readmitted" in events(got)
    phases = [{p[0]: p[1] for p in s[1]} for s in got["seconds"]]
    assert any("Terminating" in ph.values() for ph in phases)
    assert got["preemptions"] == (1, {"lo": 1})


def test_a_victim_deleted_in_its_grace_is_not_queued_again():
    got = both([("n-0", 4)], [dict(name="hi", priority=100),
                              dict(name="lo", priority=0, preemption_budget=4)],
               [("add", "lo", 4, 1), ("run", 10), ("add", "hi", 4, 1), ("run", 7),
                ("scale", "lo", 0), ("run", 20)], grace_s=5.0)
    assert events(got).count("preempted") == 1 and "evicted" not in events(got)
    assert dict(got["seconds"][-1][2])["hi"]["pending_pods"] == 0


def test_a_drained_node_s_pods_are_placed_again_by_the_scheduler():
    got = both([("n-0", 4), ("n-1", 4)], [dict(name="a", priority=10)],
               [("add", "a", 2, 3), ("run", 10), ("drain", "n-1"), ("run", 15),
                ("restore", "n-1"), ("run", 15), ("preempt", "n-0"), ("run", 15),
                ("kill", 0), ("run", 10)])
    assert events(got).count("pending") >= 1
    assert dict(got["seconds"][-1][2])["a"]["pending_pods"] == 1  # 2 of 3 fit on n-1


# ---- the autoscaler ---------------------------------------------------------------


def test_the_autoscaler_times_out_backs_off_provisions_and_reaps():
    got = both([("n-0", 2)], [dict(name="t", priority=0)],
               [("add", "t", 2, 1), ("run", 5), ("fail", True), ("scale", "t", 3), ("run", 60),
                ("fail", False), ("run", 60), ("scale", "t", 1), ("run", 200)],
               reap_every=5.0, autoscaler_node_chips=2, autoscaler_max_nodes=2,
               provision_delay_s=10.0, provision_timeout_s=7.0, backoff_base_s=5.0,
               backoff_cap_s=12.0)
    evs = events(got)
    assert evs.count("provision_failed") >= 3 and evs.count("provisioned") == 2
    backoffs = [e[4] for e in got["timeline"] if e[3] == "provision_failed"]
    assert backoffs[:3] == ["failure #1, backing off 5s", "failure #2, backing off 10s",
                            "failure #3, backing off 12s"]
    assert got["reaped"] == ["tpu-auto-0", "tpu-auto-1"]
    assert got["seconds"][-1][6] == ["n-0"]


def test_the_autoscaler_stops_at_max_nodes():
    got = both([("n-0", 2)], [dict(name="t")],
               [("add", "t", 2, 5), ("run", 60)],
               autoscaler_node_chips=2, autoscaler_max_nodes=1, provision_delay_s=10.0)
    assert events(got).count("provision_requested") == 1
    assert dict(got["seconds"][-1][2])["t"]["pending_pods"] == 3


def test_the_pool_s_families_without_an_autoscaler_are_jax_s():
    texts = []
    for mods in (PORT, JAX):
        vclock, sim, sched = _world(mods, [("n-0", 4)], [dict(name="x", priority=1)])
        sim.add_deployment(mods["cluster"].SimDeployment(sim, "y", "y", chips_per_pod=3),
                           replicas=2)
        vclock.advance(30.0)
        texts.append(mods["capacity"].PoolMetricsExporter(sched).exposition())
        assert [f.name for f in mods["capacity"].PoolMetricsExporter(sched).families()] == list(
            mods["capacity"].POOL_METRIC_NAMES)
    assert texts[0] == texts[1]
    assert 'tpu_pool_pending_pods{tenant="y"} 1' in texts[0]
    assert "tpu_pool_provisioned_nodes 0" in texts[0]


def test_capacity_selfcheck_is_jax_s():
    port = capacity.capacity_selfcheck()
    assert port == jax_capacity.capacity_selfcheck()
    assert port["ticks"] == 70 and port["conserved_all"] and port["preemption_roundtrip"]
    assert port["preemptions_total"] == 1 and len(port["events"]) == 10


# ---- the pipeline's tenants --------------------------------------------------------


def _window(mods):
    behavior = mods["hpa"].HPABehavior()
    behavior.scale_down.stabilization_window_seconds = 60.0
    return behavior


def _tenant_pipeline(mods, start_before_tenant: bool = False):
    """Two nodes of 4 devices; prod (priority 100, 2 devices a pod) is the
    primary deployment, batch (priority 0, 1 device, budget 4) a tenant
    HPA, each with a 60 s scale-down window; evictions take a 20 s grace,
    longer than a sync period, so a sync sees them in flight."""
    vclock = mods["clock"].VirtualClock()
    sim = mods["cluster"].SimCluster(vclock, nodes=[("n-0", 4), ("n-1", 4)],
                                     pod_start_latency=5.0)
    cap = mods["capacity"]
    config = cap.CapacityConfig(tenants=[
        cap.TenantSpec("prod", priority=100, weight=2.0, preemption_budget=0),
        cap.TenantSpec("batch", priority=0, weight=1.0, preemption_budget=4)], grace_s=20.0)
    spike = {"on": False}
    prod = mods["cluster"].SimDeployment(
        sim, "prod", "prod", chips_per_pod=2, load_mode="shared",
        load_fn=lambda t: 150.0 if spike["on"] else 30.0)
    batch = mods["cluster"].SimDeployment(
        sim, "batch", "batch", chips_per_pod=1, load_mode="shared",
        load_fn=lambda t: 200.0 if spike["on"] else 30.0)
    sim.add_deployment(prod, replicas=1)
    vclock.advance(10.0)
    pipe = mods["loop"].AutoscalingPipeline(sim, prod, record="prod_tensorcore_avg",
                                            max_replicas=4, capacity=config,
                                            behavior=_window(mods))
    sim.add_deployment(batch, replicas=1)
    if start_before_tenant:
        pipe.start()
    pipe.add_tenant_hpa(batch, max_replicas=6, behavior=_window(mods))
    pipe.start()
    return vclock, pipe, spike


def _tenant_run(mods) -> dict:
    vclock, pipe, spike = _tenant_pipeline(mods)
    healthy, before_restart = [], []
    for t in range(480):
        if t == 60:
            spike["on"] = True
        if t == 180:
            spike["on"] = False
        if t == 150:
            before_restart = pipe.hpa.condition_history
            pipe.restart_hpa()
        vclock.advance(1.0)
        healthy.append(mods["schedule"].pipeline_healthy(pipe))
    return {
        "healthy": healthy,
        "scale": pipe.scale_history,
        "tenant_scale": pipe.tenant_scale_history,
        "conditions": before_restart + pipe.hpa.condition_history,
        "tenant_conditions": pipe.tenant_hpas["batch"].condition_history,
        "timeline": _timeline(pipe.capacity_scheduler),
        "replicas": (pipe.replicas(), pipe.tenant_replicas("batch"), pipe.running(),
                     pipe.tenant_running("batch")),
        "pool": pipe.db.latest("tpu_pool_used_chips", {}),
        "restored_probe": pipe.hpa.capacity_probe is not None,
    }


@pytest.fixture(scope="module")
def tenant_runs():
    return _tenant_run(PORT), _tenant_run(JAX)


def test_the_hpa_s_capacity_conditions_and_the_tenant_hpas_are_jax_s(tenant_runs):
    port, ref = tenant_runs
    assert port == ref
    kinds = {c[1] for c in port["conditions"] + port["tenant_conditions"]}
    assert {"Unschedulable", "Preempting", "FairShareLimited"} <= kinds
    reasons = {c[3] for c in port["conditions"] + port["tenant_conditions"]}
    assert {"PodsPending", "AllPodsScheduled", "EvictionInProgress", "NoVictims"} <= reasons
    assert port["scale"] and port["tenant_scale"]["batch"]
    assert port["restored_probe"] and port["pool"] is not None


def test_pipeline_healthy_judges_every_tenant_as_jax_s(tenant_runs):
    port, _ = tenant_runs
    assert port["healthy"][-1] and not all(port["healthy"])


def test_a_second_hpa_for_a_deployment_is_refused_as_jax_s():
    messages = []
    for mods in (PORT, JAX):
        _, pipe, _ = _tenant_pipeline(mods)
        for name in ("batch", "prod"):
            with pytest.raises(ValueError) as err:
                pipe.add_tenant_hpa(pipe.cluster.deployments[name])
            messages.append(str(err.value))
    assert messages[:2] == messages[2:] == ["deployment batch already has an HPA",
                                            "deployment prod already has an HPA"]


def test_a_tenant_added_after_start_syncs_on_the_shared_clock():
    got = []
    for mods in (PORT, JAX):
        vclock, pipe, spike = _tenant_pipeline(mods, start_before_tenant=True)
        spike["on"] = True
        vclock.advance(120.0)
        got.append((pipe.tenant_scale_history, pipe.adapter.rules.keys() >= {"batch_tensorcore_avg"},
                    [r.record for r in pipe.evaluator.rules if r.record.startswith("batch")]))
    assert got[0] == got[1]
    assert got[0][0]["batch"] and got[0][1] and got[0][2] == ["batch_tensorcore_avg"]


def test_restarts_keep_the_probe_and_the_tenants_on_the_live_adapter():
    for mods in (PORT,):
        _, pipe, _ = _tenant_pipeline(mods)
        probe = pipe.hpa.capacity_probe
        pipe.restart_hpa()
        assert pipe.hpa.capacity_probe is probe
        pipe.restart_adapter()
        assert pipe.hpa.adapter is pipe.adapter
        assert pipe.tenant_hpas["batch"].adapter is pipe.adapter


# ---- the property -------------------------------------------------------------------

_TENANT = st.fixed_dictionaries({
    "priority": st.sampled_from([0, 10, 100]),
    "weight": st.sampled_from([0.5, 1.0, 2.0]),
    "preemption_budget": st.integers(0, 3),
    "chips": st.sampled_from([1, 2, 4]),
})


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(
    st.lists(_TENANT, min_size=2, max_size=3),
    st.lists(st.tuples(st.integers(0, 2), st.integers(0, 5), st.integers(2, 25)),
             min_size=2, max_size=6),
    st.sampled_from([[("n-0", 4)], [("n-0", 8)], [("n-0", 4), ("n-1", 4)]]),
    st.booleans(),
)
def test_tenant_mixes_and_demand_steps_schedule_as_jax_s(tenants, demand, nodes, autoscale):
    specs = [dict(name=f"t{i}", priority=t["priority"], weight=t["weight"],
                  preemption_budget=t["preemption_budget"]) for i, t in enumerate(tenants)]
    steps = [("add", f"t{i}", t["chips"], 1) for i, t in enumerate(tenants)] + [("run", 5)]
    for which, replicas, seconds in demand:
        steps += [("scale", f"t{which % len(tenants)}", replicas), ("run", seconds)]
    config = dict(autoscaler_node_chips=4, provision_delay_s=15.0) if autoscale else {}
    both(nodes, specs, steps + [("run", 30)], grace_s=4.0, slice_quantum=1,
         reap_every=5.0 if autoscale else None, **config)
