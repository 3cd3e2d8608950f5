"""The Resource metric path (metrics.k8s.io) of the port's HPA against the
JAX package's, and bench.py's ``0_cpu_resource`` rung.

- The seven cases of ``tests/test_resource_metrics.py`` run through both
  controllers on the same readings: the same replicas, reasons, metric
  values and conditions after each sync.
- ``metrics_from_manifest`` parses ``deploy/cpu-busyloop-hpa.yaml`` as
  JAX's does, and refuses a Resource target other than Utilization with
  JAX's message.
- The simulated cluster's reader (``SimResourceMetrics``) drives the busy
  loop 1 -> 4 as JAX's does, and ``trial.run_cpu_resource_trial`` gives
  bench.py's ``run_rung_cpu_resource``'s 18.0 s and 4 replicas.
"""

import dataclasses
from pathlib import Path

import pytest
import torch
import yaml

import bench
from k8s_gpu_hpa_tpu.control import adapter as jax_adapter
from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxClock
from k8s_gpu_hpa_tpu_torch.control import adapter, cluster, hpa
from k8s_gpu_hpa_tpu_torch.manifests import load_yaml
from k8s_gpu_hpa_tpu_torch.trial import run_cpu_resource_trial
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

DEPLOY = Path(__file__).resolve().parent.parent / "deploy"


class FakeTarget:
    def __init__(self, replicas=1):
        self.replicas = replicas

    def scale_to(self, n):
        self.replicas = n


class FakeReader:
    def __init__(self, utils):
        self.utils = utils

    def pod_utilizations(self, resource):
        assert resource == "cpu"
        return self.utils


class OneValueAdapter:
    def get_object_metric(self, ref, name):
        return 90.0  # against target 40: ceil(1 * 2.25) = 3


def _case(mod, adapter_mod, clock_cls, name):
    """One case of tests/test_resource_metrics.py built on one package:
    (controller, target)."""
    if name == "mixed":
        target = FakeTarget(1)
        return mod.HPAController(
            target=target,
            metrics=[
                mod.ResourceMetricSpec("cpu", 60.0),  # 30% proposes 1
                mod.ObjectMetricSpec("m", 40.0, adapter_mod.ObjectReference("Deployment", "d")),
            ],
            adapter=OneValueAdapter(),
            clock=clock_cls(),
            resource_metrics=FakeReader([30.0]),
        ), target
    if name == "no_reader":
        target = FakeTarget(2)
        return mod.HPAController(
            target=target, metrics=[mod.ResourceMetricSpec("cpu", 60.0)], adapter=None,
            clock=clock_cls(),
        ), target
    utils, replicas = {
        "scale_up": ([80.0, 100.0], 2),  # mean 90 against 60: ceil(2 * 1.5) = 3
        "within_tolerance": ([63.0], 2),  # ratio 1.05
        "no_pod_metrics": ([], 3),
    }[name]
    target = FakeTarget(replicas)
    return mod.HPAController(
        target=target, metrics=[mod.ResourceMetricSpec("cpu", 60.0)], adapter=None,
        clock=clock_cls(), resource_metrics=FakeReader(utils),
    ), target


def _state(controller, target) -> dict:
    status = controller.status
    return {
        "replicas": target.replicas,
        "desired": status.desired_replicas,
        "reason": status.last_reason,
        "values": dict(status.last_metric_values),
        "conditions": [(c.type, c.status, c.reason, c.message)
                       for c in status.conditions.values()],
        "history": list(controller.condition_history),
    }


@pytest.mark.parametrize(
    "name", ["scale_up", "within_tolerance", "no_pod_metrics", "no_reader", "mixed"])
def test_each_resource_case_decides_as_jax_s_controller(name):
    port, port_target = _case(hpa, adapter, VirtualClock, name)
    ref, ref_target = _case(jax_hpa, jax_adapter, JaxClock, name)
    # the JAX test's one sync, then a second on the same readings
    for sync in range(2):
        port.sync_once()
        ref.sync_once()
        assert _state(port, port_target) == _state(ref, ref_target)
        if sync == 0:
            want = {"scale_up": 3, "within_tolerance": 2, "no_pod_metrics": 3, "no_reader": 2,
                    "mixed": 3}[name]
            assert port_target.replicas == want
    if name == "scale_up":
        assert port.status.last_metric_values["resource/cpu"] == 90.0
    if name in ("no_pod_metrics", "no_reader"):
        assert "metrics unavailable" in port.status.last_reason
        assert port.status.condition("ScalingActive").reason == "FailedGetResourceMetric"


def test_the_cpu_busyloop_manifests_carry_the_rung_s_contract():
    """tests/test_resource_metrics.py's manifest case, read with the port's
    YAML reader: the Deployment asks for no device, 500m of cpu, and the HPA
    scales it on cpu at 60% of that request."""
    dep = load_yaml((DEPLOY / "cpu-busyloop.yaml").read_text())
    doc = load_yaml((DEPLOY / "cpu-busyloop-hpa.yaml").read_text())
    assert "google.com/tpu" not in str(dep) and "nvidia.com/gpu" not in str(dep)
    assert dep["spec"]["template"]["spec"]["containers"][0]["resources"]["requests"]["cpu"] \
        == "500m"
    assert doc["spec"]["scaleTargetRef"]["name"] == dep["metadata"]["name"]
    (metric,) = hpa.metrics_from_manifest(doc)
    (ref,) = jax_hpa.metrics_from_manifest(yaml.safe_load((DEPLOY / "cpu-busyloop-hpa.yaml")
                                                          .read_text()))
    assert dataclasses.asdict(metric) == dataclasses.asdict(ref)
    assert metric == hpa.ResourceMetricSpec("cpu", 60.0)


def test_a_resource_target_other_than_utilization_is_refused_as_jax_refuses_it():
    doc = {"spec": {"metrics": [{"type": "Resource", "resource": {
        "name": "memory", "target": {"type": "AverageValue", "averageValue": "1Gi"}}}]}}
    with pytest.raises(ValueError) as port_err:
        hpa.metrics_from_manifest(doc)
    with pytest.raises(ValueError) as ref_err:
        jax_hpa.metrics_from_manifest(doc)
    assert str(port_err.value) == str(ref_err.value)
    assert "only target.type Utilization" in str(port_err.value)


def _busyloop_loop(cluster_mod, hpa_mod, clock_cls, doc) -> list[tuple[float, int, int]]:
    """tests/test_resource_metrics.py's closed loop: (t, replicas, running)
    after each 15 s sync to 240 s."""
    clock = clock_cls()
    sim = cluster_mod.SimCluster(clock, nodes=[("node-0", 0)], pod_start_latency=3.0)
    dep = cluster_mod.SimDeployment(
        sim, "cpu-busyloop", "cpu-busyloop", chips_per_pod=0,
        load_fn=lambda t: 100.0 if t >= 30.0 else 20.0, load_mode="per_pod",
    )
    sim.add_deployment(dep, replicas=1)
    clock.advance(5.0)
    (metric,) = hpa_mod.metrics_from_manifest(doc)
    controller = hpa_mod.HPAController(
        target=dep, metrics=[metric], adapter=None, clock=clock,
        min_replicas=doc["spec"]["minReplicas"], max_replicas=doc["spec"]["maxReplicas"],
        behavior=hpa_mod.behavior_from_manifest(doc),
        resource_metrics=cluster_mod.SimResourceMetrics(sim, "cpu-busyloop"),
    )
    out = []
    while clock.now() < 240.0:
        clock.advance(15.0)
        controller.sync_once()
        out.append((clock.now(), dep.replicas, len(sim.running_pods(dep.name))))
    return out


def test_the_busyloop_loop_on_the_simulated_cluster_is_jax_s():
    doc = yaml.safe_load((DEPLOY / "cpu-busyloop-hpa.yaml").read_text())
    port = _busyloop_loop(cluster, hpa, VirtualClock, doc)
    assert port == _busyloop_loop(jax_cluster, jax_hpa, JaxClock, doc)
    by_t = {t: r for t, r, _ in port}
    assert by_t[20.0] == 1  # the sync at 20 s reads the load before the spike
    assert by_t[125.0] == 4 and all(r == 4 for t, r, _ in port if t >= 125.0)


def test_the_cpu_rung_is_bench_s():
    result = run_cpu_resource_trial()
    ref = bench.run_rung_cpu_resource()
    assert (result.scale_up_s, result.replicas_reached) == (
        ref["scale_up_s"], ref["replicas_reached"]) == (18.0, 4)
