"""The simulated cluster (``control/cluster.py``) against the JAX package's.

The same operations drive both clusters, each on its own virtual clock:
scale up, scale down (newest pod first), kill, preempt, drain, restore,
crash on start and stop, add and remove a node, with time passing between
them.  After every step these must be equal: the pods (name, phase, node,
devices, restarts), the nodes' allocations, each node exporter's samples
(name, labels, value) on the text path and on the structured path, a
preempted node's refusal, the kube-state-metrics families, and the
metrics.k8s.io stand-in's readings.  A scripted sequence runs first, then
seeded random sequences.
"""

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.metrics.exposition import parse_text as jax_parse_text
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxClock
from k8s_gpu_hpa_tpu_torch.control import cluster
from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

NODES = [("n0", 4), ("n1", 2)]


def _offered(t: float) -> float:
    """A load that moves: 150 (1.5 devices), then 500 from 40 s, 90 from 150 s."""
    return 150.0 if t < 40.0 else 500.0 if t < 150.0 else 90.0


def _build(mod, clock_cls):
    clock = clock_cls()
    sim = mod.SimCluster(clock, nodes=list(NODES), pod_start_latency=12.0,
                         exporter_sample_interval=2.0)
    test = mod.SimDeployment(sim, "tpu-test", "tpu-test", load_fn=_offered)
    multi = mod.SimDeployment(sim, "multi", "multi", chips_per_pod=2, load_fn=_offered,
                              load_mode="per_pod", hosts_per_slice=2, util_cap=60.0)
    return clock, sim, test, multi


def _families(fams) -> list:
    return [(f.name, f.type, [(s.labels, s.value, s.suffix) for s in f.samples]) for f in fams]


def _state(sim, parse) -> dict:
    pods = [(p.name, p.namespace, p.labels, p.deployment, p.phase, p.node, p.chip_ids,
             p.created_at, p.started_at, p.restart_count) for p in sim.pods.values()]
    nodes = {n: (node.num_chips, dict(node.allocations), node.ready, node.schedulable)
             for n, node in sim.nodes.items()}
    exporters = {}
    for name in sim.nodes:
        try:
            text = _families(parse(sim.exporter_fetch(name)))
            structured = _families(sim.exporter_fetch_families(name))
        except ConnectionError as e:
            text = structured = f"down: {e}"
        exporters[name] = (text, structured)
    reader = {d: _reader(sim, d) for d in sim.deployments}
    return {
        "pods": pods, "nodes": nodes, "exporters": exporters,
        "ksm": _families(sim.kube_state_metrics_families()),
        "ksm_text": _families(parse(sim.kube_state_metrics_text())),
        "crashlooping": sorted(sim.crashlooping), "reader": reader,
        "replicas": {d: dep.replicas for d, dep in sim.deployments.items()},
        "ready": {d: dep.ready_pod_names() for d, dep in sim.deployments.items()},
    }


def _reader(sim, deployment: str) -> list[float]:
    mod = cluster if isinstance(sim, cluster.SimCluster) else jax_cluster
    return mod.SimResourceMetrics(sim, deployment).pod_utilizations("cpu")


class Pair:
    """The two clusters driven in step."""

    def __init__(self):
        self.port = _build(cluster, VirtualClock)
        self.ref = _build(jax_cluster, JaxClock)

    def do(self, op: str, *args) -> None:
        """Apply one operation to both; an operation one refuses, the other
        must refuse with the same error."""
        errors = []
        for clock, sim, test, multi in (self.port, self.ref):
            deps = {"tpu-test": test, "multi": multi}
            try:
                if op == "advance":
                    clock.advance(*args)
                elif op == "add":
                    sim.add_deployment(deps[args[0]], replicas=args[1])
                elif op == "scale":
                    deps[args[0]].scale_to(args[1])
                elif op == "kill_nth":
                    running = sorted(sim.pods)
                    sim.kill_pod(running[args[0] % len(running)])
                else:
                    getattr(sim, op)(*args)
                errors.append(None)
            except (KeyError, ValueError) as e:
                errors.append((type(e).__name__, str(e)))
        assert errors[0] == errors[1], (op, args, errors)
        assert _state(self.port[1], parse_text) == _state(self.ref[1], jax_parse_text), (op, args)


SCRIPT = [
    ("add", "tpu-test", 1), ("advance", 15.0),
    ("scale", "tpu-test", 4), ("advance", 13.0),
    ("advance", 30.0),  # past the load step at 40 s
    ("scale", "tpu-test", 2), ("advance", 1.0),  # newest first
    ("kill_nth", 0), ("advance", 13.0),
    ("add", "multi", 2), ("advance", 13.0),  # one node fits one 2-device pod
    ("scale", "multi", 3), ("advance", 13.0),  # the third host idles at the rendezvous
    ("preempt_node", "n1"), ("advance", 6.0), ("advance", 14.0),  # pending retries
    ("restore_node", "n1"), ("advance", 6.0),
    ("drain_node", "n0"), ("advance", 13.0), ("restore_node", "n0"), ("advance", 6.0),
    ("start_crashloop", "tpu-test"), ("kill_nth", 1), ("advance", 12.0), ("advance", 10.0),
    ("advance", 25.0), ("stop_crashloop", "tpu-test"), ("advance", 45.0),
    ("start_crashloop", "nope"), ("kill_pod", "nope"),
    ("add_node", "n2", 4), ("add_node", "n2", 4), ("scale", "tpu-test", 6), ("advance", 13.0),
    ("remove_node", "n2"),  # still holds pods: refused
    ("scale", "tpu-test", 1), ("scale", "multi", 0), ("advance", 1.0),
    ("remove_node", "n2"), ("remove_node", "n2"), ("advance", 20.0),
]


def test_a_scripted_sequence_leaves_both_clusters_alike():
    pair = Pair()
    for op, *args in SCRIPT:
        pair.do(op, *args)
    # the script reached what it meant to: both deployments scaled, a node
    # gone, the crashloop cleared and the last pods running
    _, sim, test, _ = pair.port
    assert "n2" not in sim.nodes and not sim.crashlooping
    assert test.replicas == 1 and len(sim.running_pods("tpu-test")) == 1


def test_scale_down_deletes_the_newest_pods_and_the_reader_splits_shared_load():
    pair = Pair()
    for step in [("add", "tpu-test", 1), ("advance", 15.0), ("scale", "tpu-test", 3),
                 ("advance", 13.0)]:
        pair.do(*step)
    _, sim, test, _ = pair.port
    assert _reader(sim, "tpu-test") == [50.0, 50.0, 50.0]  # 150 over 3 running pods
    pair.do("scale", "tpu-test", 1)
    (pod,) = sim.pods.values()
    assert pod.name == "tpu-test-0000"  # the first pod is kept
    assert _reader(sim, "tpu-test") == [100.0]  # 150 on one pod, capped at 100


def test_crashloop_backs_off_from_10_s_doubling():
    pair = Pair()
    for step in [("add", "tpu-test", 1), ("start_crashloop", "tpu-test"), ("advance", 12.0)]:
        pair.do(*step)
    _, sim, _, _ = pair.port
    (pod,) = sim.pods.values()
    assert (pod.phase, pod.restart_count) == ("CrashLoopBackOff", 1)
    for dt, restarts in ((10.0, 2), (20.0, 3), (40.0, 4)):
        pair.do("advance", dt)
        assert pod.restart_count == restarts
    ksm = {s.labels: s.value for f in sim.kube_state_metrics_families()
           if f.name == "kube_pod_status_phase" for s in f.samples}
    assert ksm[(("namespace", "default"), ("phase", "Pending"), ("pod", pod.name))] == 1.0


@pytest.mark.parametrize("seed", range(6))
def test_a_seeded_random_sequence_leaves_both_clusters_alike(seed):
    rng = np.random.default_rng(seed)
    pair = Pair()
    pair.do("add", "tpu-test", int(rng.integers(1, 4)))
    pair.do("add", "multi", 2 * int(rng.integers(0, 2)))
    added = 0
    for _ in range(40):
        kind = rng.choice(["advance", "scale", "kill", "node", "crash", "grow"],
                          p=[0.4, 0.2, 0.1, 0.15, 0.1, 0.05])
        if kind == "advance":
            pair.do("advance", float(rng.choice([0.5, 1.0, 2.0, 5.0, 12.0, 13.0, 30.0])))
        elif kind == "scale":
            dep = str(rng.choice(["tpu-test", "multi"]))
            pair.do("scale", dep, int(rng.integers(0, 7)))
        elif kind == "kill" and pair.port[1].pods:
            pair.do("kill_nth", int(rng.integers(0, 100)))
        elif kind == "node":
            node = str(rng.choice(sorted(pair.port[1].nodes)))
            pair.do(str(rng.choice(["preempt_node", "drain_node", "restore_node"])), node)
        elif kind == "crash":
            pair.do(str(rng.choice(["start_crashloop", "stop_crashloop"])), "tpu-test")
        elif kind == "grow":
            if added and rng.random() < 0.5:
                pair.do("remove_node", f"x{added - 1}")
            else:
                pair.do("add_node", f"x{added}", int(rng.integers(1, 5)))
                added += 1
