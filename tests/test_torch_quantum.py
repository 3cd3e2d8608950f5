"""Replica quanta: the port's HPA against the JAX package's with a slice
quantum, sync by sync, over generated histories (hypothesis), and the
quantum and behavior the shipped slice HPA declares.

The same metric readings at the same times go to both controllers, each on
its own virtual clock; every sync must give the same desired replica count
and the same target scale, through growth rounded up to whole slices,
shrinking rounded toward the current count, the partial-slice repair, the
bounds snapped inward, and the behavior's policies and windows.  Exact
equality: both sides compute integers from the same floats."""

from pathlib import Path

import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxVirtualClock
from k8s_gpu_hpa_tpu_torch.control import hpa
from k8s_gpu_hpa_tpu_torch.control.adapter import ObjectReference
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

DEPLOY = Path(__file__).resolve().parent.parent / "deploy"
MULTIHOST_HPA = yaml.safe_load((DEPLOY / "tpu-test-multihost-hpa.yaml").read_text())
TPU_TEST_HPA = yaml.safe_load((DEPLOY / "tpu-test-hpa.yaml").read_text())
TARGET = 40.0


class Target:
    def __init__(self, replicas: int):
        self.replicas = replicas

    def scale_to(self, n: int) -> None:
        self.replicas = n


class Reading:
    """An adapter that serves one settable value (None: unavailable)."""

    def __init__(self):
        self.value: float | None = None

    def get_object_metric(self, ref, metric_name):
        return self.value


def _jax_behavior(b: hpa.HPABehavior) -> jax_hpa.HPABehavior:
    def rules(r: hpa.ScalingRules) -> jax_hpa.ScalingRules:
        return jax_hpa.ScalingRules(
            r.stabilization_window_seconds, r.select_policy,
            [jax_hpa.ScalingPolicy(p.type, p.value, p.period_seconds) for p in r.policies],
        )

    return jax_hpa.HPABehavior(rules(b.scale_up), rules(b.scale_down))


def _pair(current: int, min_r: int, max_r: int, quantum: int, behavior: hpa.HPABehavior):
    """The two controllers on one StatefulSet's history: (port, jax), each
    as (controller, target, reading, clock)."""
    ref = ObjectReference("StatefulSet", "tpu-test-multihost")
    port_clock, jax_clock = VirtualClock(), JaxVirtualClock()
    port_target, jax_target = Target(current), Target(current)
    port_read, jax_read = Reading(), Reading()
    port = hpa.HPAController(
        port_target, [hpa.ObjectMetricSpec("m", TARGET, ref)], port_read, port_clock,
        min_replicas=min_r, max_replicas=max_r, behavior=behavior, replica_quantum=quantum,
    )
    ref_hpa = jax_hpa.HPAController(
        jax_target, [jax_hpa.ObjectMetricSpec("m", TARGET, ref)], jax_read, jax_clock,
        min_replicas=min_r, max_replicas=max_r, behavior=_jax_behavior(behavior),
        replica_quantum=quantum,
    )
    return (port, port_target, port_read, port_clock), (ref_hpa, jax_target, jax_read, jax_clock)


policies = st.lists(
    st.builds(hpa.ScalingPolicy, st.sampled_from(["Pods", "Percent"]),
              st.integers(1, 200), st.sampled_from([15.0, 30.0, 60.0])),
    max_size=2,
)
scaling_rules = st.builds(
    hpa.ScalingRules, st.sampled_from([0.0, 30.0, 120.0, 300.0]),
    st.sampled_from(["Max", "Min", "Disabled"]), policies,
)
behaviors = st.one_of(
    st.builds(hpa.shipped_behavior),
    st.builds(hpa.shipped_multihost_behavior, st.integers(1, 4)),
    st.builds(hpa.HPABehavior),
    st.builds(hpa.HPABehavior, scaling_rules, scaling_rules),
)
#: (metric value or None, seconds to the next sync)
syncs = st.lists(
    st.tuples(st.one_of(st.none(), st.floats(0.0, 400.0)), st.sampled_from([1.0, 15.0, 60.0])),
    min_size=1, max_size=12,
)


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(
    current=st.integers(1, 20), min_r=st.integers(1, 10), span=st.integers(0, 12),
    quantum=st.integers(0, 5), behavior=behaviors, history=syncs,
)
def test_the_port_s_quantum_hpa_decides_as_jax_s_at_every_sync(
    current, min_r, span, quantum, behavior, history
):
    max_r = min_r + span
    refusals = []
    for package in (hpa, jax_hpa):
        try:
            package.HPAController(Target(current), [], None, VirtualClock(), min_replicas=min_r,
                                  max_replicas=max_r, replica_quantum=quantum)
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    # both packages refuse the same configurations, in the same words
    assert refusals[0] == refusals[1]
    assert (refusals[0] is not None) == (quantum < 1 or (quantum > 1 and max_r < quantum))
    if refusals[0] is not None:
        return
    port_side, jax_side = _pair(current, min_r, max_r, quantum, behavior)
    for value, dt in history:
        got = []
        for controller, target, reading, clock in (port_side, jax_side):
            reading.value = value
            status = controller.sync_once()
            got.append((status.desired_replicas, target.replicas))
            clock.advance(dt)
        assert got[0] == got[1]
        if quantum > 1 and got[0][1] != current:
            # a scale event lands on a slice boundary
            assert got[0][1] % quantum == 0
        current = got[0][1]


@pytest.mark.parametrize(
    "current,value,min_r,max_r,want",
    [
        (2, 100.0, 2, 8, 6),  # ceil(2 × 2.5) = 5, rounded up to three slices
        (6, 53.3, 2, 8, 8),  # the slice trial's second step
        (6, 100.0, 2, 7, 6),  # max 7 holds 3 whole slices: 6 stays
        (5, TARGET, 2, 8, 4),  # within tolerance on a partial slice: repaired
        (3, TARGET, 4, 8, 4),  # repaired, but not below min
        (8, 25.0, 2, 8, 6),  # ceil(8 × 0.625) = 5: rounded toward current
    ],
)
def test_quantum_rounding_examples(current, value, min_r, max_r, want):
    """Single syncs of the quantum-2 HPA with no policy limit, each against
    the JAX package's."""
    free = hpa.HPABehavior(
        hpa.ScalingRules(0.0, "Max", [hpa.ScalingPolicy("Pods", 100, 15.0)]),
        hpa.ScalingRules(0.0, "Max", [hpa.ScalingPolicy("Pods", 100, 15.0)]),
    )
    got = []
    for controller, target, reading, _ in _pair(current, min_r, max_r, 2, free):
        reading.value = value
        controller.sync_once()
        got.append(target.replicas)
    assert got == [want, want]


def test_quantum_from_the_shipped_slice_hpa_and_from_one_without_the_annotation():
    assert hpa.quantum_from_manifest(MULTIHOST_HPA) == 2 == jax_hpa.quantum_from_manifest(MULTIHOST_HPA)
    assert hpa.quantum_from_manifest(TPU_TEST_HPA) == 1 == jax_hpa.quantum_from_manifest(TPU_TEST_HPA)
    assert hpa.quantum_from_manifest({}) == 1


def test_the_slice_hpa_written_in_code_is_the_shipped_manifest():
    """``shipped_multihost_behavior()`` and the MULTIHOST_* constants are
    deploy/tpu-test-multihost-hpa.yaml's, as the JAX package parses it."""
    assert _jax_behavior(hpa.shipped_multihost_behavior()) == jax_hpa.behavior_from_manifest(
        MULTIHOST_HPA
    )
    spec = MULTIHOST_HPA["spec"]
    metric = spec["metrics"][0]["object"]
    assert (spec["minReplicas"], spec["maxReplicas"]) == (
        hpa.MULTIHOST_MIN_REPLICAS, hpa.MULTIHOST_MAX_REPLICAS
    )
    assert metric["metric"]["name"] == hpa.MULTIHOST_SERIES
    assert float(metric["target"]["value"]) == hpa.MULTIHOST_TARGET
    assert metric["describedObject"]["kind"] == spec["scaleTargetRef"]["kind"] == "StatefulSet"
    assert hpa.quantum_from_manifest(MULTIHOST_HPA) == hpa.MULTIHOST_QUANTUM
    assert MULTIHOST_HPA["metadata"]["annotations"] == {hpa.QUANTUM_ANNOTATION: "2"}
