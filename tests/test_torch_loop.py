"""The assembled pipeline (``control/loop.py``) over the simulated cluster,
against the JAX package's.

Each scenario of ``tests/test_closed_loop.py`` (its eleven tests, with
their ``make_pipeline`` arguments) runs on both pipelines, each on its own
virtual clock, a second at a time: the recorded series read after every
scrape agree within 1e-9, the scale histories are equal, and the JAX
tests' own assertions hold for the port.  Then the text scrape path, a node
joining and leaving mid-run, a StatefulSet in whole slices, and the
namespace check.
"""

import math

import pytest
import torch

from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.control import loop as jax_loop
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch.control import cluster, hpa, loop
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = (cluster, hpa, loop, clock)
JAX = (jax_cluster, jax_hpa, jax_loop, jax_clock)
RECORD = "tpu_test_tensorcore_avg"


def step_load(t0, low, high):
    return lambda t: high if t >= t0 else low


def make_pipeline(mods, load_fn, load_mode="shared", **kw):
    """tests/test_closed_loop.py's ``make_pipeline`` on one package."""
    cluster_mod, _, loop_mod, clock_mod = mods
    vclock = clock_mod.VirtualClock()
    sim = cluster_mod.SimCluster(
        vclock,
        nodes=kw.pop("nodes", [("tpu-node-0", 8)]),
        pod_start_latency=kw.pop("pod_start_latency", 12.0),
        exporter_sample_interval=kw.pop("exporter_sample_interval", 1.0),
    )
    deployment = cluster_mod.SimDeployment(
        sim, name="tpu-test", app_label="tpu-test", chips_per_pod=kw.pop("chips_per_pod", 1),
        load_fn=load_fn, load_mode=load_mode,
    )
    sim.add_deployment(deployment, replicas=1)
    vclock.advance(15.0)
    return loop_mod.AutoscalingPipeline(sim, deployment, **kw)


def _down():
    raise ConnectionError("exporter down")


def _sever(pipe) -> None:
    for target in list(pipe.scraper.targets):
        if target.name.startswith("exporter/"):
            target.fetch = _down


def _fast_down(h):
    return {"behavior": h.HPABehavior(scale_down=h.ScalingRules(
        stabilization_window_seconds=60.0, policies=[h.ScalingPolicy("Percent", 100, 15.0)]))}


#: name -> (load, load_mode, kwargs of the package's hpa module, plan): the
#: plan runs for each number of seconds in turn, and calls each callable on
#: the pipeline between
SCENARIOS = {
    "steady_low_load_stays_at_min": (lambda t: 20.0, "shared", lambda h: {}, [300.0]),
    "north_star_scale_up_1_to_4_within_60s": (
        step_load(100.0, 20.0, 640.0), "shared", lambda h: {}, [160.0]),
    "shared_load_converges_without_flapping": (
        step_load(50.0, 30.0, 120.0), "shared", lambda h: {}, [600.0]),
    "scale_down_after_load_drops": (
        lambda t: 640.0 if t < 200.0 else 10.0, "shared", _fast_down, [150.0, 350.0]),
    "slow_exporter_reproduces_reference_overshoot": (
        step_load(60.0, 30.0, 90.0), "per_pod",
        lambda h: {"exporter_sample_interval": 10.0,
                   "behavior": h.HPABehavior(scale_up=h.ScalingRules(),
                                             scale_down=h.ScalingRules())},
        [300.0]),
    "behavior_policy_bounds_overshoot": (
        step_load(60.0, 30.0, 120.0), "shared",
        lambda h: {"behavior": h.HPABehavior(
            scale_up=h.ScalingRules(policies=[h.ScalingPolicy("Pods", 1, 30.0)]))},
        [600.0]),
    "multichip_slice_pods": (
        step_load(50.0, 20.0, 200.0), "shared",
        lambda h: {"chips_per_pod": 4, "max_replicas": 2}, [200.0]),
    "capacity_starved_pod_stays_pending_and_metric_ignores_it": (
        step_load(10.0, 20.0, 800.0), "shared",
        lambda h: {"nodes": [("tpu-node-0", 2)], "max_replicas": 4}, [300.0]),
    "multi_node_scrape_aggregates_across_nodes": (
        step_load(50.0, 20.0, 640.0), "shared",
        lambda h: {"nodes": [(f"tpu-node-{i}", 1) for i in range(4)]}, [300.0]),
    "exporter_outage_holds_replicas": (
        step_load(50.0, 20.0, 640.0), "shared", lambda h: {}, [200.0, _sever, 400.0]),
    "ksm_exports_one_hot_pod_phase_and_it_reaches_the_tsdb": (
        lambda t: 20.0, "shared", lambda h: {}, [60.0]),
}


def run_both(load, load_mode, kwargs, plan, record=RECORD, **extra):
    """Both pipelines through the plan a second at a time: (port, jax,
    [(t, port reading, jax reading)] after every scrape)."""
    pipes = [make_pipeline(mods, load, load_mode, **kwargs(mods[1]), **extra)
             for mods in (PORT, JAX)]
    readings = []
    for step in plan:
        if callable(step):
            for pipe in pipes:
                step(pipe)
            continue
        for _ in range(int(step)):
            for pipe in pipes:
                pipe.run_for(1.0)
            readings.append((pipes[0].clock.now(),
                             *(p.db.latest(record, {}) for p in pipes)))
    return pipes[0], pipes[1], readings


def assert_alike(port, ref, readings) -> None:
    assert port.scale_history == ref.scale_history
    for t, got, want in readings:
        if want is None:
            assert got is None, t
        else:
            assert got is not None, t
            assert math.isclose(got, want, rel_tol=0, abs_tol=1e-9), (t, got, want)
    assert (port.replicas(), port.running()) == (ref.replicas(), ref.running())
    assert port.hpa.status.last_reason == ref.hpa.status.last_reason


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_each_closed_loop_scenario_runs_as_jax_s(name):
    port, ref, readings = run_both(*SCENARIOS[name])
    assert_alike(port, ref, readings)
    assert any(r[2] is not None for r in readings)
    CHECKS[name](port)


def _steady(p):
    assert p.replicas() == 1 and p.scale_history == []


def _north_star(p):
    assert p.replicas() == 4 and p.running() == 4
    assert all(ts <= 100.0 + 60.0 for ts, _, _ in p.scale_history)  # the spike at 100 s


def _converges(p):
    assert p.replicas() == 3  # 120 / 3 = 40 a pod, on target
    assert [e for e in p.scale_history if e[0] > 300.0] == []


def _scale_down(p):
    ups = [b for _, a, b in p.scale_history if b > a]
    assert max(ups) == 4 and p.replicas() == 1


def _overshoot(p):
    assert p.replicas() == 4  # every pod reads 90 whatever the count: driven to max


def _bounded(p):
    assert p.replicas() == 3 and max(to for _, _, to in p.scale_history) == 3


def _multichip(p):
    assert p.replicas() == 2 and p.running() == 2
    assert len(p.cluster.nodes["tpu-node-0"].allocations) == 8


def _starved(p):
    assert (p.replicas(), p.running()) == (4, 2)
    assert len(p.cluster.deployment_pods("tpu-test")) == 4


def _multi_node(p):
    assert p.replicas() == 4 and p.running() == 4
    assert len({pod.node for pod in p.cluster.running_pods("tpu-test")}) == 4


def _outage(p):
    assert p.replicas() == 4 and "unavailable" in p.hpa.status.last_reason
    assert p.hpa.status.condition("ScalingActive").reason == "FailedGetObjectMetric"


def _ksm(p):
    (pod,) = p.cluster.running_pods("tpu-test")
    assert p.db.latest("kube_pod_status_phase", {"pod": pod.name, "phase": "Running"}) == 1.0
    assert p.db.latest("kube_pod_status_phase", {"pod": pod.name, "phase": "Pending"}) == 0.0


CHECKS = {
    "steady_low_load_stays_at_min": _steady,
    "north_star_scale_up_1_to_4_within_60s": _north_star,
    "shared_load_converges_without_flapping": _converges,
    "scale_down_after_load_drops": _scale_down,
    "slow_exporter_reproduces_reference_overshoot": _overshoot,
    "behavior_policy_bounds_overshoot": _bounded,
    "multichip_slice_pods": _multichip,
    "capacity_starved_pod_stays_pending_and_metric_ignores_it": _starved,
    "multi_node_scrape_aggregates_across_nodes": _multi_node,
    "exporter_outage_holds_replicas": _outage,
    "ksm_exports_one_hot_pod_phase_and_it_reaches_the_tsdb": _ksm,
}


def test_the_text_scrape_path_records_what_the_structured_path_records():
    load = step_load(50.0, 20.0, 640.0)
    port, ref, readings = run_both(load, "shared", lambda h: {}, [200.0],
                                   structured_scrapes=False)
    assert_alike(port, ref, readings)
    structured, _, fast = run_both(load, "shared", lambda h: {}, [200.0])
    assert port.scale_history == structured.scale_history
    assert [r[1] for r in readings] == [r[1] for r in fast]


def _grow_and_shrink(pipe):
    pipe.cluster.add_node("tpu-node-1", 4)


def _drain_and_remove(pipe):
    pipe.cluster.drain_node("tpu-node-1")
    pipe.cluster.restore_node("tpu-node-1")
    pipe.cluster.drain_node("tpu-node-1")
    pipe.cluster.remove_node("tpu-node-1")


def test_a_node_that_joins_is_scraped_and_one_that_leaves_is_dropped():
    """The cluster's node hooks keep one exporter target a node, on both
    pipelines: a node added mid-run takes the pods that did not fit, and
    its target goes when it is drained and removed."""
    port, ref, readings = run_both(
        step_load(30.0, 20.0, 640.0), "shared",
        lambda h: {"nodes": [("tpu-node-0", 2)]},
        [60.0, _grow_and_shrink, 60.0, _drain_and_remove, 60.0])
    assert_alike(port, ref, readings)
    names = [t.name for t in port.scraper.targets]
    assert names == [t.name for t in ref.scraper.targets]
    assert names == ["exporter/tpu-node-0", "kube-state-metrics"]
    assert port.replicas() == 4 and port.running() == 2


def test_a_statefulset_scales_in_whole_slices_as_jax_s():
    def kwargs(h):
        return {"record": "tpu_test_multihost_tensorcore_avg", "object_kind": "StatefulSet",
                "replica_quantum": 2, "min_replicas": 2, "max_replicas": 8,
                "nodes": [("tpu-node-0", 8)]}

    port, ref, readings = run_both(step_load(40.0, 20.0, 320.0), "shared", kwargs, [200.0],
                                   record="tpu_test_multihost_tensorcore_avg")
    assert_alike(port, ref, readings)
    # from the one pod make_pipeline starts, every step lands on a whole slice
    assert port.scale_history[0][1:] == (1, 2)
    assert all(b % 2 == 0 for _, _, b in port.scale_history) and port.replicas() == 8
    assert port.adapter.rules["tpu_test_multihost_tensorcore_avg"].resource_overrides == {
        "namespace": "namespace", "statefulset": "StatefulSet"}


def test_a_metric_spec_in_another_namespace_is_refused_as_jax_refuses_it():
    errors = []
    for mods in (PORT, JAX):
        h = mods[1]
        spec = h.ExternalMetricSpec("q", target_value=1.0, namespace="prod")
        with pytest.raises(ValueError) as err:
            make_pipeline(mods, lambda t: 0.0, metric_specs=[spec])
        errors.append(str(err.value).replace("k8s_gpu_hpa_tpu_torch", "k8s_gpu_hpa_tpu"))
    assert errors[0] == errors[1] and "namespace 'prod'" in errors[0]


def test_the_constructor_takes_downsample_and_still_refuses_capacity():
    """The constructor's parameters are JAX's, name for name and default
    for default: ``capacity`` (the capacity economy, which an earlier slice
    refused, hence this test's name), ``downsample`` (the rollup tiers),
    ``scrape_shards`` (the metrics plane) and the durability slice's two.
    A capacity pipeline installs its scheduler on the cluster and scrapes
    the pool; a downsampling pipeline gives every TSDB the policy, and a
    restarted TSDB keeps it."""
    import inspect

    from k8s_gpu_hpa_tpu_torch.control.capacity import CapacityConfig, TenantSpec
    from k8s_gpu_hpa_tpu_torch.metrics.downsample import DownsamplePolicy

    def params(cls):
        return [(p.name, p.default) for p in
                inspect.signature(cls.__init__).parameters.values()]

    assert params(loop.AutoscalingPipeline) == params(jax_loop.AutoscalingPipeline)
    economy = make_pipeline(PORT, lambda t: 0.0, capacity=CapacityConfig(
        tenants=[TenantSpec("tpu-test", priority=5)], autoscaler_node_chips=4))
    assert economy.cluster.scheduler is economy.capacity_scheduler
    assert economy.capacity_scheduler.autoscaler.node_chips == 4
    assert "capacity-pool" in [t.name for t in economy.scraper.targets]
    assert economy.hpa.capacity_probe()["pending_pods"] == 0
    plain = make_pipeline(PORT, lambda t: 0.0, capacity=None)
    assert plain.capacity_scheduler is None and plain.cluster.scheduler is None
    assert plain.hpa.capacity_probe is None and plain.tenant_hpas == {}
    policy = DownsamplePolicy()
    tiered = make_pipeline(PORT, lambda t: 0.0, downsample=policy)
    assert tiered.db.downsample_policy is policy and tiered.db.rollup_steps == (300.0, 3600.0)
    tiered.restart_tsdb()
    assert tiered.db.downsample_policy is policy
    sharded_tiers = make_pipeline(PORT, lambda t: 0.0, downsample=policy, scrape_shards=2)
    assert all(db.downsample_policy is policy for db in sharded_tiers.db.members)
    assert make_pipeline(PORT, lambda t: 0.0, downsample=None).db.downsample_policy is None
    pipe = make_pipeline(PORT, lambda t: 0.0, wal=None, checkpoint_store=None)
    assert (pipe.wal, pipe.checkpoint_store, pipe.restart_log) == (None, None, [])
    assert pipe.shard_plane is None and pipe.planner.db is pipe.db
    sharded = make_pipeline(PORT, lambda t: 0.0, scrape_shards=3)
    assert len(sharded.shard_plane.shard_dbs) == 3
    assert sharded.scraper is sharded.shard_plane
    assert sharded.db.members == [sharded.db.global_db, *sharded.shard_plane.shard_dbs]


def _tick_order(mods) -> list[tuple[float, str]]:
    """(time, component) of every tick in a minute, through ``self``."""
    pipe = make_pipeline(mods, step_load(30.0, 20.0, 640.0))
    order = []
    for attr, method in (("scraper", "scrape_once"), ("evaluator", "evaluate_once"),
                         ("hpa", "sync_once")):
        component = getattr(pipe, attr)
        inner = getattr(component, method)
        setattr(component, method, lambda inner=inner, attr=attr: (
            order.append((pipe.clock.now(), attr)), inner())[1])
    pipe.run_for(60.0)
    return order


def test_the_ticks_fire_in_jax_s_order():
    """start() registers scrape, rule evaluation and sync in that order, so
    the first scrape precedes the first evaluation; a sync registered before
    the scrape and evaluation that come due at its instant fires first and
    reads the previous second's rule output.  Any other order gives another
    timeline."""
    order = _tick_order(PORT)
    assert order == _tick_order(JAX)
    assert order[:2] == [(16.0, "scraper"), (16.0, "evaluator")]
    assert [t for t, attr in order if attr == "hpa"] == [30.0, 45.0, 60.0, 75.0]
    assert [a for t, a in order if t == 30.0] == ["hpa", "scraper", "evaluator"]
