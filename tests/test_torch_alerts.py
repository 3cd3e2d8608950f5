"""The shipped alerts (``metrics/rules.py``) and the PrometheusRule's alert
groups (``manifests.py``) against the JAX package's.

- ``Aggregate`` and ``Absent``: the same PromQL and the same samples on
  seeded vectors, the empty vector included.
- Each of ``shipped_alert_rules()``: name, ``for:``, labels, annotations
  and ``promql()`` character for character JAX's.
- Firing sets: every shipped alert evaluated each second for 2100 s over
  seeded series of its inputs (exporter up and sample age, the recorded
  series present, zero or gone, the pods' labels, phases and duty cycles,
  the serve bandwidth, total memory, temperature, the operator's partial
  slice), in regimes long enough for every ``for:`` to elapse: the same
  alerts fire at the same second as JAX's.  And on the canned fault storm's
  pipeline, evaluated beside it each second: the same firing alerts as
  JAX's at every second (the recorded series goes absent in the blackout).
- The PrometheusRule: the ``tpu-pipeline-alerts`` and ``tpu-slo-burn``
  groups leaf by leaf JAX's, through the port's YAML writer and reader too;
  a custom alert list or custom groups render as JAX's do.

Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu import chaos as jax_chaos
from k8s_gpu_hpa_tpu import manifests as jax_manifests
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch import chaos, manifests
from k8s_gpu_hpa_tpu_torch.metrics import rules, tsdb
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(rules=rules, tsdb=tsdb, clock=clock, chaos=chaos)
JAX = dict(rules=jax_rules, tsdb=jax_tsdb, clock=jax_clock, chaos=jax_chaos)
ALERT_GROUPS = ("tpu-pipeline-alerts", "tpu-slo-burn")
ALERT_NAMES = [a.alert for a in jax_rules.shipped_alert_rules()]


def _fill(mods, seed: int):
    """A store of ``x`` series over two label sets with seeded values, one
    of the sets gone after a staleness marker when ``seed`` is odd."""
    rng = np.random.default_rng(seed)
    db = mods["tsdb"].TimeSeriesDB(mods["clock"].VirtualClock())
    for i, value in enumerate(rng.normal(10.0, 5.0, 2).tolist()):
        db.append("x", (("i", str(i)),), value, 0.0)
    if seed % 2:
        db.mark_stale("x", (("i", "0"),), 0.0)
    return db


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("op", ["min", "max", "sum", "count", "absent"])
def test_aggregate_and_absent_are_jax_s(op, seed):
    def run(mods):
        r = mods["rules"]
        for child in (r.Select("x"), r.Select("missing")):
            expr = r.Absent(child) if op == "absent" else r.Aggregate(op, child)
            db = _fill(mods, seed)
            yield expr.promql(), sorted(expr.input_names()), [
                (s.value, s.labels) for s in expr.evaluate(db, 0.0)]

    assert list(run(PORT)) == list(run(JAX))


def _alert(rule) -> tuple:
    return rule.alert, rule.expr.promql(), rule.for_seconds, rule.labels, rule.annotations


@pytest.mark.parametrize("index", range(len(ALERT_NAMES)), ids=lambda i: f"{i}-{ALERT_NAMES[i]}")
def test_each_shipped_alert_is_jax_s(index):
    assert _alert(rules.shipped_alert_rules()[index]) == _alert(
        jax_rules.shipped_alert_rules()[index])


@pytest.mark.parametrize("build,args", [
    ("pipeline_alert_rules", ()),
    ("pipeline_alert_rules", ("tpu_serve_hbm_bw_avg", "tpu-serve")),
    ("serve_target_unreachable_alert", (8.0, 60.0)),
    ("flat_zero_alert", ("tpu_train_duty_cycle_avg", "tpu-train")),
    ("chip_hot_alert", (75.5,)),
    ("slice_held_partial_alert", (42.0,)),
    ("device_counters_dead_alert", ()),
])
def test_each_alert_function_renders_jax_s_alerts_for_other_arguments(build, args):
    def alerts(mods):
        out = getattr(mods["rules"], build)(*args)
        return [_alert(a) for a in (out if isinstance(out, list) else [out])]

    assert alerts(PORT) == alerts(JAX)


# ---- firing sets on seeded inputs ------------------------------------------------

SECONDS = 2100
BLOCK = 150  # a regime's length; 700-s regimes for the 300-600 s for: clauses
PODS = (("p0", "tpu-test", "n0"), ("p1", "tpu-test", "n1"), ("s0", "tpu-serve", "n1"))


def _regimes(rng, n_blocks: int, p: float) -> list[bool]:
    return (rng.uniform(0.0, 1.0, n_blocks) < p).tolist()


def _plan(seed: int) -> dict:
    """Each input's regime per block, drawn once so both stores get the same."""
    rng = np.random.default_rng(seed)
    short, long_ = SECONDS // BLOCK + 1, SECONDS // 700 + 1
    return {
        "up0": _regimes(rng, short, 0.3),
        "age": rng.uniform(0.0, 20.0, short).tolist(),
        "record": rng.choice(["live", "zero", "gone"], short, p=[0.5, 0.3, 0.2]).tolist(),
        "running": _regimes(rng, short, 0.8),
        "duty": rng.choice([0.0, 50.0, 95.0], short).tolist(),
        "bw": rng.uniform(0.0, 8.0, long_).tolist(),
        "serve_duty": rng.choice([50.0, 95.0], long_).tolist(),
        "hbm_dead": _regimes(rng, short, 0.3),
        "temp": rng.uniform(60.0, 100.0, short).tolist(),
        "held": _regimes(rng, long_, 0.5),
        "noise": rng.normal(0.0, 1.0, SECONDS).tolist(),
    }


def _write(db, t: float, plan: dict) -> None:
    s, b, long_block = int(t), int(t) // BLOCK, int(t) // 700
    for node in ("n0", "n1"):
        up = 0.0 if node == "n0" and plan["up0"][b] else 1.0
        db.append("tpu_metrics_exporter_up", (("node", node),), up, t)
        db.append("tpu_metrics_exporter_sample_age_seconds", (("node", node),),
                  plan["age"][b] + abs(plan["noise"][s]), t)
        db.append("tpu_hbm_memory_total_bytes", (("chip", "0"), ("node", node)),
                  0.0 if plan["hbm_dead"][b] else 16e9, t)
        db.append("tpu_chip_temperature_celsius", (("chip", "0"), ("node", node)),
                  plan["temp"][b] + plan["noise"][s], t)
    record = (("deployment", "tpu-test"), ("namespace", "default"))
    state = plan["record"][b]
    if state == "gone":
        db.mark_stale("tpu_test_tensorcore_avg", record, t)
    else:
        value = 0.0 if state == "zero" else 40.0 + plan["noise"][s]
        db.append("tpu_test_tensorcore_avg", record, value, t)
    db.append("tpu_serve_hbm_bw_avg", (("deployment", "tpu-serve"), ("namespace", "default")),
              plan["bw"][long_block], t)
    for pod, app, node in PODS:
        db.append("kube_pod_labels", (("label_app", app), ("namespace", "default"), ("pod", pod)),
                  1.0, t)
        running = 1.0 if plan["running"][b] else 0.0
        db.append("kube_pod_status_phase",
                  (("namespace", "default"), ("phase", "Running"), ("pod", pod)), running, t)
        duty = plan["serve_duty"][long_block] if app == "tpu-serve" else plan["duty"][b]
        db.append("tpu_duty_cycle", (("chip", "0"), ("node", node), ("pod", pod)), duty, t)
    db.append("quantum_operator_partial_slice_held", (("target", "tpu-test-multihost"),),
              1.0 if plan["held"][long_block] else 0.0, t)


def _firing(mods, seed: int) -> list[list[str]]:
    plan = _plan(seed)
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    evaluator = mods["rules"].RuleEvaluator(db, [], alerts=mods["rules"].shipped_alert_rules())
    out = []
    for _ in range(SECONDS):
        _write(db, vclock.now(), plan)
        evaluator.evaluate_once()
        out.append(evaluator.firing_alerts())
        vclock.advance(1.0)
    return out


@pytest.mark.parametrize("seed", range(5))
def test_the_shipped_alerts_fire_at_jax_s_seconds(seed):
    port = _firing(PORT, seed)
    assert port == _firing(JAX, seed)


def test_the_seeded_regimes_fire_every_alert_that_their_inputs_reach():
    fired = {name for seed in range(5) for names in _firing(PORT, seed) for name in names}
    assert fired == set(ALERT_NAMES), set(ALERT_NAMES) - fired


def _storm_firing(mods) -> list[tuple[float, list[str]]]:
    """The canned storm with the shipped alerts evaluated on its TSDB each
    second (read only: the storm's own result is unchanged)."""
    out = []

    def attach(pipe, _schedule):
        evaluator = mods["rules"].RuleEvaluator(pipe.db, [], alerts=mods["rules"].shipped_alert_rules())

        def tick():
            evaluator.evaluate_once()
            out.append((pipe.clock.now(), evaluator.firing_alerts()))
            pipe.clock.call_later(1.0, tick)

        pipe.clock.call_later(1.0, tick)

    result = mods["chaos"].run_fault_storm(pod_start_latency=12.0, on_pipeline=attach)
    return out, result


def test_the_shipped_alerts_over_the_fault_storm_are_jax_s():
    port, port_result = _storm_firing(PORT)
    ref, ref_result = _storm_firing(JAX)
    assert port == ref
    assert port_result == ref_result
    blackout = next(f for f in port_result["faults"] if f["kind"] == "scrape_blackout")
    absent = [t for t, names in port if "TpuAutoscaleSignalAbsent" in names]
    assert absent and blackout["injected_at"] < absent[0] < blackout["cleared_at"]


# ---- the PrometheusRule's alert groups ---------------------------------------------


def _alert_groups(rule_doc: dict) -> dict:
    return {g["name"]: g for g in rule_doc["spec"]["groups"] if g["name"] in ALERT_GROUPS}


def test_the_prometheusrule_holds_jax_s_alert_groups_leaf_by_leaf():
    port = _alert_groups(manifests.prometheusrule_manifest())
    ref = _alert_groups(jax_manifests.prometheusrule_manifest())
    assert list(port) == list(ALERT_GROUPS)
    assert port == ref
    assert [r["alert"] for r in port["tpu-pipeline-alerts"]["rules"]] == ALERT_NAMES
    # a for: of whole seconds, and none where the alert fires at once
    for rule, alert in zip(port["tpu-pipeline-alerts"]["rules"], rules.shipped_alert_rules()):
        assert rule.get("for") == (f"{int(alert.for_seconds)}s" if alert.for_seconds else None)


def test_the_alert_groups_round_trip_through_the_port_s_yaml():
    doc = manifests.prometheusrule_manifest()
    (back,) = manifests.load_yaml_all(manifests.to_yaml([doc]))
    assert _alert_groups(back) == _alert_groups(jax_manifests.prometheusrule_manifest())


@pytest.mark.parametrize("groups", [None, [], "one", "two"])
def test_named_and_custom_group_rules_render_as_jax_s(groups):
    """Only the shipped groups (``groups`` None) carry the two alert groups."""
    def render(mods, m):
        kw = {}
        if groups == "one":
            kw["groups"] = [("app", [mods.tpu_test_avg_rule()])]
        elif groups == "two":
            kw["groups"] = [("app", [mods.tpu_test_avg_rule()]),
                            ("multihost", [mods.tpu_test_multihost_avg_rule()])]
        elif groups is not None:
            kw["groups"] = groups
        return m.prometheusrule_manifest("custom", **kw)

    port = render(rules, manifests)
    assert port == render(jax_rules, jax_manifests)
    assert bool(_alert_groups(port)) == (groups is None)
