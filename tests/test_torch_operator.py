"""The slice-quantum operator (``control/operator.py``) against the JAX
package's.

- ``quantum_desired`` over every (current, desired, quantum, min, max) of a
  small grid.
- Both operators, each against its own ``FakeKubeAPI`` (chip_smoke.py's:
  the HPA list, scale subresources, a Lease) through the same script of
  HPA and scale changes: the same repairs, PATCH sequence, log lines and
  ``/metrics`` text at every tick, through growing, shrinking and steady
  slices, the suppression guard, a misconfigured quantum, a malformed
  annotation, an empty target, a kind without a scale path and a held
  target whose HPA vanishes.
- War-freedom: each operator beside a simulated plain HPA that asserts its
  count at every sync; the patches stay bounded and equal.
- Lease election between two replicas (acquire, stand by, take over an
  expired lease, lose a race with 409) and the operator's transition count.
- ``/healthz``, ``/readyz`` and ``/metrics`` of the health server.
- ``OperatorMetrics.render`` text.
- chip_smoke.py's operator run gives its ``OPERATOR_EXPECTED`` with either
  package's operator and doctor.

The doctor's ``check_operator_metrics`` and ``check_capacity_pool`` are
held to JAX's verdicts in tests/test_torch_doctor.py.

Tolerance: exact.
"""

import contextlib
import io
import itertools
import time

import pytest
import torch

import chip_smoke
from k8s_gpu_hpa_tpu import doctor as jax_doctor
from k8s_gpu_hpa_tpu.control import operator as jax_operator
from k8s_gpu_hpa_tpu_torch.control import operator
from chip_smoke import FakeKubeAPI, _get, _slice_hpa
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)


def test_quantum_desired_is_jax_s_over_a_grid():
    grid = itertools.product(range(13), range(13), range(1, 5), range(6), range(13))
    differ = [args for args in grid
              if operator.quantum_desired(*args) != jax_operator.quantum_desired(*args)]
    assert differ == []
    assert operator.quantum_desired(5, 6, 4, 4, 16) == 8  # growing: up
    assert operator.quantum_desired(6, 6, 4, 4, 16) == 6  # steady: held
    assert operator.quantum_desired(7, 5, 4, 4, 16) == 4  # shrinking: down
    assert operator.quantum_desired(3, 3, 4, 2, 3) == 3  # no whole slice fits


# ---- one script on both operators --------------------------------------------------


def _hpa(name: str, desired: int, kind: str = "StatefulSet", quantum: str = "4",
         min_replicas: int = 4, max_replicas: int = 16) -> dict:
    doc = _slice_hpa(name, desired)
    doc["metadata"]["annotations"][operator.QUANTUM_ANNOTATION] = quantum
    doc["spec"].update(scaleTargetRef={"kind": kind, "name": name}, minReplicas=min_replicas,
                       maxReplicas=max_replicas)
    return doc


def _script(mod) -> list:
    """The operator ``mod`` through a script of ticks; after each, what it
    did: its repairs, the API's PATCH log, what it printed, its /metrics."""
    api = FakeKubeAPI(
        [_hpa("grow", 6), _hpa("shrink", 5), _hpa("steady", 6), _hpa("misfit", 3, quantum="5",
                                                                      max_replicas=4),
         _hpa("typo", 6, quantum="four"), _hpa("empty", 2), _hpa("pods", 3, kind="Pod"),
         {"metadata": {"name": "plain"}, "spec": {}}],
        {"grow": 5, "shrink": 6, "steady": 6, "misfit": 3, "empty": 0, "typo": 6})
    op = mod.QuantumOperator(mod.KubeClient(api_base=api.url, token="t"))
    hpas = {h["metadata"]["name"]: h for h in api.hpas}
    edits = [
        lambda: None,
        # the plain HPA reverts the grow repair: suppressed, tick after tick
        lambda: api.scales.update(grow=5),
        lambda: None,
        # the state moves on (the HPA wants 7: repaired again) and the
        # steady target's HPA goes (its gauge drops to 0)
        lambda: (hpas["grow"]["status"].update(desiredReplicas=7),
                 api.hpas.remove(hpas["steady"])),
        # both reverted: grow's repair suppressed, shrink's new state repaired
        lambda: api.scales.update(grow=5, shrink=7),
        lambda: None,
    ]
    ticks = []
    try:
        for edit in edits:
            edit()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                actions = op.tick()
            ticks.append(([(a.hpa, a.target, a.from_replicas, a.to_replicas, a.reason)
                           for a in actions], list(api.patches), out.getvalue(),
                          op.metrics.render()))
    finally:
        api.close()
    return ticks


def test_both_operators_repair_suppress_and_log_alike():
    port = _script(operator)
    assert port == _script(jax_operator)
    actions = [a for tick in port for a in tick[0]]
    assert actions[0][1:4] == ("StatefulSet/grow", 5, 8)
    assert ("StatefulSet/shrink", 6, 4) in [a[1:4] for a in actions]
    logs = "".join(tick[2] for tick in port)
    assert "suppressing repeat repair of StatefulSet/grow" in logs
    assert "HPA misfit: quantum 5 exceeds maxReplicas 4" in logs
    assert logs.count("reconcile error for HPA typo") == 1
    metrics = port[-1][3]
    assert 'quantum_operator_partial_slice_held{target="StatefulSet/steady"} 0' in metrics
    assert "quantum_operator_suppressed_repairs_total 4" in metrics
    assert [len(tick[1]) for tick in port] == [2, 2, 2, 3, 4, 4]
    assert 'quantum_operator_partial_slice_held{target="StatefulSet/steady"} 1' in port[0][3]


def _war(mod, min_replicas: int, cycles: int = 12) -> tuple:
    """A plain HPA that writes its desired count at every sync, beside the
    operator ticking three times a sync: the patches each made."""
    api = FakeKubeAPI([_hpa("slice", 5, quantum="2", min_replicas=min_replicas,
                            max_replicas=8)], {"slice": 3})
    op = mod.QuantumOperator(mod.KubeClient(api_base=api.url, token="t"))
    hpa_writes = 0
    try:
        for cycle in range(cycles):
            desired = [5, 5, 3, 3, 3, 6, 6, 3, 3, 3, 3, 3][cycle]
            api.hpas[0]["status"]["desiredReplicas"] = desired
            api.scales["slice"] = desired
            hpa_writes += 1
            with contextlib.redirect_stdout(io.StringIO()):
                for _ in range(3):
                    op.tick()
    finally:
        api.close()
    return list(api.patches), hpa_writes, op.metrics.suppressed_repairs_total


@pytest.mark.parametrize("min_replicas", [2, 3])
def test_the_operator_does_not_fight_a_plain_hpa(min_replicas):
    port = _war(operator, min_replicas)
    assert port == _war(jax_operator, min_replicas)
    patches, writes, _ = port
    # at most one patch each time the HPA moves, never one a tick
    assert len(patches) <= 4 < writes
    assert all(replicas % 2 == 0 for _, replicas in patches)


# ---- the lease -----------------------------------------------------------------------


def _election(mod, monkeypatch) -> list:
    # a renewTime of its own at every write: the wire format's is whole
    # seconds, which writes 0.3 s apart would share
    stamps = itertools.count()
    monkeypatch.setattr(mod.LeaseElector, "_now", staticmethod(lambda: f"t{next(stamps)}"))
    api = FakeKubeAPI([], {})
    client = mod.KubeClient(api_base=api.url, token="t")
    a = mod.LeaseElector(client, "default", identity="a", lease_duration=0.3)
    b = mod.LeaseElector(client, "default", identity="b", lease_duration=0.3)
    seen = []
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            seen.append(("a", a.ensure_leader()))  # absent: created
            seen.append(("b", b.ensure_leader()))  # held and fresh: stand by
            seen.append(("a", a.ensure_leader()))  # renew
            seen.append(("b", b.ensure_leader()))
            time.sleep(0.4)  # a stops renewing: b sees the same renewTime too long
            seen.append(("b", b.ensure_leader()))
            seen.append(("a", a.still_leader()))  # a's renew is old: it asks again
            seen.append(("holder", api.lease["spec"]["holderIdentity"]))
            # a race: a read the lease as its own, b's renew lands first, and
            # a's patch with the resourceVersion it read gets 409
            stale = {"metadata": dict(api.lease["metadata"]),
                     "spec": {**api.lease["spec"], "holderIdentity": "a"}}
            b.ensure_leader()
            client.get = lambda path: stale
            seen.append(("a-race", a.ensure_leader()))
    finally:
        api.close()
    return seen


def test_two_replicas_elect_one_leader_as_jax_s(monkeypatch):
    port = _election(operator, monkeypatch)
    assert port == _election(jax_operator, monkeypatch)
    assert port == [("a", True), ("b", False), ("a", True), ("b", False), ("b", True),
                    ("a", False), ("holder", "b"), ("a-race", False)]


def test_the_operator_counts_its_lease_transitions():
    counts = []
    for mod in (operator, jax_operator):
        api = FakeKubeAPI([], {})
        client = mod.KubeClient(api_base=api.url, token="t")
        op = mod.QuantumOperator(client, elector=mod.LeaseElector(client, "default", "a"))
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                op.tick()
                api.lease["spec"]["holderIdentity"] = "other"
                api.lease["spec"]["renewTime"] = "changed"
                op.tick()
                op.tick()
        finally:
            api.close()
        counts.append((op.metrics.lease_transitions_total, op.elector.is_leader))
    assert counts == [(1, False), (1, False)]


# ---- the health server and the metrics ----------------------------------------------


def test_the_health_server_answers_liveness_readiness_and_metrics():
    api = FakeKubeAPI([_hpa("steady", 6)], {"steady": 6})
    client = operator.KubeClient(api_base=api.url, token="t")
    op = operator.QuantumOperator(client, elector=operator.LeaseElector(client, "default", "a"))
    stale = operator.QuantumOperator(client)
    servers = [operator.start_health_server(op, 0, host="127.0.0.1"),
               operator.start_health_server(stale, 0, stale_after=0.0, host="127.0.0.1")]
    live, old = (f"http://127.0.0.1:{s.server_port}" for s in servers)
    try:
        assert _get(live + "/readyz") == (503, "stale")  # not the leader yet
        op.tick()
        assert _get(live + "/healthz") == (200, "ok")
        assert _get(live + "/readyz") == (200, "ok")
        assert _get(live + "/metrics") == (200, op.metrics.render())
        assert _get(live + "/other")[0] == 404
        assert _get(old + "/healthz") == (503, "stale")
        assert _get(old + "/readyz") == (503, "stale")
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        api.close()


@pytest.mark.parametrize("state", [
    {},
    {"reconciles_total": 7, "repairs_total": {"up": 2, "down": 1}, "suppressed_repairs_total": 3,
     "lease_transitions_total": 2,
     "partial_slice_held": {"StatefulSet/b": 1.0, "Deployment/a": 0.0}},
])
def test_the_operator_s_metrics_render_as_jax_s(state):
    texts = []
    for mod in (operator, jax_operator):
        m = mod.OperatorMetrics()
        for key, value in state.items():
            setattr(m, key, value)
        texts.append(m.render())
    assert texts[0] == texts[1]


def test_chip_smoke_s_operator_run_is_jax_s(monkeypatch):
    """chip_smoke.py's ``_operator_run`` gives ``OPERATOR_EXPECTED`` with the
    port's operator and doctor, and with the JAX package's."""
    assert chip_smoke._operator_run() == chip_smoke.OPERATOR_EXPECTED
    monkeypatch.setattr(chip_smoke, "KubeClient", jax_operator.KubeClient)
    monkeypatch.setattr(chip_smoke, "QuantumOperator", jax_operator.QuantumOperator)
    monkeypatch.setattr(chip_smoke, "LeaseElector", jax_operator.LeaseElector)
    monkeypatch.setattr(chip_smoke, "check_operator_metrics", jax_doctor.check_operator_metrics)
    monkeypatch.setattr(chip_smoke, "start_health_server",
                        lambda op, port, host: jax_operator.start_health_server(op, port))
    assert chip_smoke._operator_run() == chip_smoke.OPERATOR_EXPECTED
