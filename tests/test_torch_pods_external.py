"""The Pods and External metric paths of the port against the JAX package's:
quantities, the manifest parsers, the controller's decisions, reasons and
status conditions, the adapter's two APIs, the pod-max rule and the HBM
Pods loop.

- ``parse_quantity`` over the quantity grammar, value for value.
- ``metrics_from_manifest`` and ``behavior_from_manifest`` on every shipped
  HPA manifest, field for field, the Resource metric of the cpu rung too.
- Each Pods and External case of the JAX package's own tests through both
  controllers: the same adapter values, decisions, ``last_reason``,
  ``last_metric_values``, conditions and condition histories, exactly.
- ``get_pods_metric`` and ``get_external_metric`` on one exposition scraped
  into both TSDBs; ``tpu_test_pod_max_rule``'s vector and PromQL.
- The HBM loop (bench.py's HBM rung) on a virtual clock with a counting
  hold, through the port's planes and through the JAX package's fed the
  same expositions: the same syncs, readings and reasons; and once in real
  time through the exporter daemon at a small time scale.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from k8s_gpu_hpa_tpu.control import adapter as jax_adapter
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils.quantity import parse_quantity as jax_parse_quantity
from k8s_gpu_hpa_tpu_torch import doctor, trial
from k8s_gpu_hpa_tpu_torch.control import adapter, hpa
from k8s_gpu_hpa_tpu_torch.metrics import exposition, rules, schema, tsdb
from k8s_gpu_hpa_tpu_torch.trial import (
    GIB,
    HBM_CAP,
    HbmHold,
    HbmLoad,
    Pipeline,
    hbm_pods_spec,
    mirror_exposition,
    pod_labels_exposition,
    run_hbm_pods_trial,
    run_trial,
    wire_pipeline,
)
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from k8s_gpu_hpa_tpu_torch.utils.quantity import parse_quantity
from tests.test_torch_cores import confined_to_port_cores, keep_priority  # noqa: F401

torch.set_num_threads(1)

DEPLOY = Path(__file__).resolve().parent.parent / "deploy"
HPA_FILES = sorted(p.name for p in DEPLOY.glob("*hpa*.yaml"))


# ---- quantities ----------------------------------------------------------------


@pytest.mark.parametrize("q", [
    "40", 40, 2.5, "13Gi", "512Mi", "1Ki", "2Ti", "1Pi", "1Ei", "500m", "2k", "3M",
    "1G", "4T", "2P", "1E", "1e3", "1.5", " 7 ", "100", "0", "0.25Gi", "-3",
])
def test_parse_quantity_is_jax_s(q):
    assert parse_quantity(q) == jax_parse_quantity(q)
    assert type(parse_quantity(q)) is float


def test_parse_quantity_exact_values():
    assert parse_quantity("13Gi") == 13 * 2**30
    assert parse_quantity("500m") == 0.5 and parse_quantity("100") == 100.0


@pytest.mark.parametrize("q", ["abc", "m", "", "Gi", "1.2.3k"])
def test_parse_quantity_refuses_what_jax_refuses(q):
    with pytest.raises(ValueError):
        jax_parse_quantity(q)
    with pytest.raises(ValueError):
        parse_quantity(q)


# ---- the manifest parsers -------------------------------------------------------


def _load(name: str) -> dict:
    return yaml.safe_load((DEPLOY / name).read_text())


def _fields(spec) -> tuple:
    return type(spec).__name__, dataclasses.asdict(spec)


@pytest.mark.parametrize("name", HPA_FILES)
def test_manifest_parsers_are_jax_s_on_every_shipped_hpa(name):
    doc = _load(name)
    assert dataclasses.asdict(hpa.behavior_from_manifest(doc)) == dataclasses.asdict(
        jax_hpa.behavior_from_manifest(doc))
    ref = jax_hpa.metrics_from_manifest(doc)
    if any(m["type"] == "Resource" for m in doc["spec"]["metrics"]):
        # the cpu rung's Resource metric, which the port now reads as JAX does
        assert [type(m).__name__ for m in hpa.metrics_from_manifest(doc)] == [
            "ResourceMetricSpec"]
    assert [_fields(m) for m in hpa.metrics_from_manifest(doc)] == [_fields(m) for m in ref]
    assert [_fields(m) for m in hpa.metrics_from_manifest(doc, "prod")] == [
        _fields(m) for m in jax_hpa.metrics_from_manifest(doc, "prod")]


def test_the_hbm_and_queue_constants_are_the_shipped_manifests():
    hbm, queue = _load("tpu-test-hbm-hpa.yaml"), _load("tpu-test-external-hpa.yaml")
    assert [_fields(m) for m in hpa.hbm_metrics()] == [
        _fields(m) for m in hpa.metrics_from_manifest(hbm)]
    assert hpa.hbm_metrics()[0].target_average_value == 13 * 2**30
    (ext,) = hpa.metrics_from_manifest(queue)
    assert (ext.metric_name, ext.selector, ext.target_average_value, ext.target_value) == (
        hpa.QUEUE_SERIES, hpa.QUEUE_SELECTOR, parse_quantity(hpa.QUEUE_TARGET), None)
    shipped = dataclasses.asdict(hpa.shipped_behavior())
    for doc in (hbm, queue):
        assert dataclasses.asdict(hpa.behavior_from_manifest(doc)) == shipped
    assert (hbm["spec"]["minReplicas"], hbm["spec"]["maxReplicas"]) == (
        hpa.HBM_MIN_REPLICAS, hpa.HBM_MAX_REPLICAS)
    assert (queue["spec"]["minReplicas"], queue["spec"]["maxReplicas"]) == (
        hpa.QUEUE_MIN_REPLICAS, hpa.QUEUE_MAX_REPLICAS)
    assert (hbm["metadata"]["name"], queue["metadata"]["name"]) == (hpa.HBM_APP, hpa.QUEUE_HPA)
    assert queue["spec"]["scaleTargetRef"]["name"] == hpa.QUEUE_APP


def test_a_manifest_of_every_kind_and_average_value_parse_as_jax_s():
    doc = {"spec": {"metrics": [
        {"type": "Object", "object": {
            "metric": {"name": "m_obj"}, "describedObject": {"kind": "Deployment", "name": "d"},
            "target": {"type": "AverageValue", "averageValue": "30"}}},
        {"type": "Pods", "pods": {"metric": {"name": "m_pods"},
                                  "target": {"type": "AverageValue", "averageValue": "512Mi"}}},
        {"type": "External", "external": {
            "metric": {"name": "m_ext", "selector": {"matchLabels": {"queue": "q1"}}},
            "target": {"type": "Value", "value": "2k"}}},
        {"type": "External", "external": {"metric": {"name": "m_bare"},
                                          "target": {"type": "AverageValue", "averageValue": 7}}},
    ]}}
    got = hpa.metrics_from_manifest(doc)
    assert [_fields(m) for m in got] == [_fields(m) for m in jax_hpa.metrics_from_manifest(doc)]
    assert got[0].average and got[0].target_value == 30.0
    with pytest.raises(ValueError, match="unsupported"):
        hpa.metrics_from_manifest({"spec": {"metrics": [{"type": "ContainerResource"}]}})


def test_external_spec_requires_exactly_one_target_as_jax_s():
    for cls in (hpa.ExternalMetricSpec, jax_hpa.ExternalMetricSpec):
        with pytest.raises(ValueError, match="exactly one"):
            cls("m")
        with pytest.raises(ValueError, match="exactly one"):
            cls("m", target_value=1.0, target_average_value=1.0)


# ---- the controller: JAX's Pods and External cases through both ----------------


class Target:
    def __init__(self, replicas: int):
        self.replicas = replicas

    def scale_to(self, n: int) -> None:
        self.replicas = n


class Pods:
    def __init__(self, names: list[str]):
        self.names = names

    def ready_pod_names(self) -> list[str]:
        return self.names


def _pods_case(values, listed, replicas, target=10.0):
    series = [("tpu_test_hbm_used_bytes", (("namespace", "default"), ("pod", p)), v)
              for p, v in values.items()]
    rule = {"series": "tpu_test_hbm_used_bytes",
            "resource_overrides": {"namespace": "namespace", "pod": "Pod"}}
    return dict(series=series, rules=[rule], external=[], replicas=replicas,
                metrics=lambda m: [m.PodsMetricSpec("tpu_test_hbm_used_bytes", target)],
                kwargs=dict(max_replicas=8, pod_lister=Pods(listed)))


def _external_case(values, replicas, namespace="default", kwargs=None, **spec):
    series = [("queue_backlog", (("namespace", namespace), ("queue", q)), v)
              for q, v in values.items()]
    return dict(series=series, rules=[], external=["queue_backlog"], replicas=replicas,
                metrics=lambda m: [m.ExternalMetricSpec("queue_backlog", **spec)],
                kwargs=dict(max_replicas=8, **(kwargs or {})))


def _object_average_case():
    series = [("m", (("namespace", "default"), ("deployment", "d")), 90.0)]
    return dict(series=series, rules=[{"series": "m"}], external=[], replicas=1,
                metrics=lambda m: [m.ObjectMetricSpec(
                    "m", 30.0, m.ObjectReference("Deployment", "d"), average=True)],
                kwargs=dict(max_replicas=8))


#: name -> (case, the replicas after the first syncs, as the JAX tests
#: assert them); each case runs two syncs
CASES = {
    "pods_missing_dampen_scale_up": (_pods_case({"a": 10.0, "b": 30.0}, ["a", "b", "c"], 2), [3]),
    "pods_missing_dampen_scale_down": (_pods_case({"a": 2.0, "b": 4.0}, ["a", "b", "c"], 3), [2]),
    "pods_missing_flips_and_holds": (_pods_case({"a": 12.0}, ["a", "b"], 2), [2, 2]),
    "pods_no_missing_pods_unchanged": (_pods_case({"a": 10.0, "b": 30.0}, ["a", "b"], 2), [4]),
    "pods_unavailable_holds": (_pods_case({}, ["a"], 3), [3, 3]),
    "external_value_target_sums": (
        _external_case({"q1": 60.0, "q2": 40.0}, 1, target_value=50.0), [2]),
    "external_selector_scopes": (
        _external_case({"q1": 60.0, "q2": 40.0}, 1, selector={"queue": "q2"}, target_value=10.0),
        [4]),
    "external_average_value_divides_by_replicas": (
        _external_case({"q1": 90.0}, 1, target_average_value=30.0), [3, 3]),
    "external_inherits_controller_namespace": (
        _external_case({"q1": 80.0}, 1, "prod", {"namespace": "prod"}, target_value=20.0), [4]),
    "external_unavailable_holds": (_external_case({}, 2, target_value=20.0), [2, 2]),
    "object_average_value": (_object_average_case(), [3, 3]),
}


def _controller(package, case, clock):
    """One package's TSDB, adapter and controller over the case's series."""
    tsdb_mod, adapter_mod = (tsdb, adapter) if package is hpa else (jax_tsdb, jax_adapter)
    db = tsdb_mod.TimeSeriesDB(clock)
    for name, labels, value in case["series"]:
        db.append(name, labels, value)
    served = adapter_mod.CustomMetricsAdapter(
        db, [adapter_mod.AdapterRule(**r) for r in case["rules"]],
        external_rules=[adapter_mod.ExternalRule(s) for s in case["external"]])
    target = Target(case["replicas"])
    controller = package.HPAController(
        target=target, metrics=case["metrics"](package), adapter=served, clock=clock,
        **case["kwargs"])
    return controller, target, served


def _observed(controller, target) -> dict:
    status = controller.status
    return {
        "replicas": target.replicas, "desired": status.desired_replicas,
        "current": status.current_replicas, "reason": status.last_reason,
        "values": dict(status.last_metric_values), "scale_time": status.last_scale_time,
        "conditions": [c.as_k8s() for c in status.conditions.values()],
        "transitions": {t: c.last_transition_time for t, c in status.conditions.items()},
        "history": list(controller.condition_history),
        "good_sync": controller.last_good_sync_at,
    }


@pytest.mark.parametrize("name", list(CASES))
def test_each_case_decides_as_jax_s_controller(name):
    case, want = CASES[name]
    clock = VirtualClock()
    port, port_target, port_adapter = _controller(hpa, case, clock)
    ref, ref_target, ref_adapter = _controller(jax_hpa, case, clock)
    for i in range(2):
        port.sync_once()
        ref.sync_once()
        got = _observed(port, port_target)
        assert got == _observed(ref, ref_target)
        if i < len(want):
            assert got["replicas"] == want[i]
        clock.advance(15.0)
    assert port_adapter.list_metrics() == ref_adapter.list_metrics()
    assert port_adapter.list_external_metrics() == ref_adapter.list_external_metrics()


def test_the_cases_reasons_and_conditions_say_what_kubernetes_says():
    def run(name):
        case, _ = CASES[name]
        controller, target, served = _controller(hpa, case, VirtualClock())
        controller.sync_once()
        return controller, served

    up, _ = run("pods_missing_dampen_scale_up")
    assert up.status.last_metric_values["pods/tpu_test_hbm_used_bytes"] == 40.0 / 3.0
    assert up.status.last_reason == (
        "scale up 2->3 (policy limit 6) [1/3 pods missing tpu_test_hbm_used_bytes; assumed 0]")
    held, _ = run("pods_missing_flips_and_holds")
    assert held.status.last_reason.endswith("assumed 0; held]")
    for name, reason in (("pods_unavailable_holds", "FailedGetPodsMetric"),
                         ("external_unavailable_holds", "FailedGetExternalMetric")):
        controller, _ = run(name)
        assert controller.status.last_reason == "metrics unavailable; holding"
        active = controller.status.condition("ScalingActive")
        assert (active.status, active.reason) == (False, reason)
        with pytest.raises(AssertionError, match=reason):
            doctor.check_hpa_status(json.dumps({"status": {
                "conditions": controller.status.conditions_as_k8s()}}))
    summed, served = run("external_value_target_sums")
    assert served.list_external_metrics() == ["queue_backlog"]
    assert [h[1:] for h in summed.condition_history] == [
        ("AbleToScale", True, "SucceededGetScale"), ("ScalingActive", True, "ValidMetricFound"),
        ("AbleToScale", True, "SucceededRescale")]
    payload = {"status": {"currentReplicas": 1, "desiredReplicas": 2,
                          "conditions": summed.status.conditions_as_k8s()}}
    assert doctor.check_hpa_status(json.dumps(payload)) == (
        "ScalingActive, replicas current=1 desired=2")


def test_a_controller_without_an_adapter_holds_as_jax_s():
    for package in (hpa, jax_hpa):
        target = Target(2)
        controller = package.HPAController(
            target, [package.PodsMetricSpec("m", 1.0)], None, VirtualClock())
        controller.sync_once()
        assert target.replicas == 2
        assert controller.status.condition("ScalingActive").reason == "FailedGetPodsMetric"


# ---- the adapter's two APIs and the pod-max rule on one exposition -------------


def _exposition(seed: int = 0) -> str:
    """Three pods of two devices each on two nodes, a pod of another app,
    the pods' labels and the queue depth of two queues in two namespaces:
    the values drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    families = []
    attribution = {}
    chips = []
    for i, pod in enumerate(["v5e8-a", "v5e8-a", "v5e8-b", "v5e8-b", "v5e8-c", "other-x"]):
        attribution[i] = ("default", pod)
        chips.append(schema.ChipSample(i, None, None, float(rng.integers(1, 16 * GIB)),
                                       16.0 * GIB, None))
    families += schema.families_from_chips(chips, "node-0", attribution)
    labels = schema.MetricFamily("kube_pod_labels", "gauge")
    for pod in ("v5e8-a", "v5e8-b", "v5e8-c"):
        labels.add(1.0, namespace="default", pod=pod, label_app="tpu-test-v5e8")
    labels.add(1.0, namespace="default", pod="other-x", label_app="other")
    queue = schema.MetricFamily("tpu_test_queue_depth", "gauge")
    for ns, pod, q in (("default", "s-1", "tpu-serve"), ("default", "s-2", "tpu-serve"),
                       ("default", "s-3", "batch"), ("prod", "s-4", "tpu-serve")):
        queue.add(float(rng.uniform(0, 500)), namespace=ns, node="node-0", pod=pod, queue=q)
    return exposition.encode_text(families + [labels, queue])


def _scraped(seed: int):
    """The exposition scraped into the port's TSDB and into the JAX
    package's, at one time, with each package's pod-max rule evaluated."""
    text = _exposition(seed)
    out = []
    for tsdb_mod, rules_mod in ((tsdb, rules), (jax_tsdb, jax_rules)):
        clock = VirtualClock(100.0)
        db = tsdb_mod.TimeSeriesDB(clock)
        scraper = tsdb_mod.Scraper(db)
        scraper.add_target(lambda: text, name="exporter", node="node-0")
        scraper.scrape_once()
        rule = rules_mod.tpu_test_pod_max_rule(app="tpu-test-v5e8")
        rules_mod.RuleEvaluator(db, [rule]).evaluate_once()
        out.append((db, rule))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_pod_max_rule_s_vector_and_promql_are_jax_s(seed):
    (db, rule), (jax_db, jax_rule) = _scraped(seed)
    assert rule.expr.promql() == jax_rule.expr.promql() == (
        "max by(namespace,pod)(tpu_hbm_memory_usage_bytes) * on(pod) group_left(label_app) "
        'max by(pod,label_app)(kube_pod_labels{label_app="tpu-test-v5e8"})')
    assert rule.labels == jax_rule.labels == {}

    def vector(d):
        return sorted((s.labels, s.value) for s in d.instant_vector("tpu_test_hbm_used_bytes"))

    got = vector(db)
    assert got == vector(jax_db)
    # one series a pod of the app, at its hottest device, and no node label
    assert [dict(labels)["pod"] for labels, _ in got] == ["v5e8-a", "v5e8-b", "v5e8-c"]
    assert all("node" not in dict(labels) for labels, _ in got)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_adapter_s_pods_and_external_apis_are_jax_s(seed):
    (db, _), (jax_db, _) = _scraped(seed)
    pod_rule = {"series": "tpu_test_hbm_used_bytes",
                "resource_overrides": {"namespace": "namespace", "pod": "Pod"}}
    port = adapter.CustomMetricsAdapter(
        db, [adapter.AdapterRule(**pod_rule), adapter.AdapterRule("absent_series")],
        [adapter.ExternalRule("tpu_test_queue_depth")])
    ref = jax_adapter.CustomMetricsAdapter(
        jax_db, [jax_adapter.AdapterRule(**pod_rule), jax_adapter.AdapterRule("absent_series")],
        [jax_adapter.ExternalRule("tpu_test_queue_depth")])
    pods = ["v5e8-a", "v5e8-c", "v5e8-gone", "other-x"]
    got = port.get_pods_metric("default", "tpu_test_hbm_used_bytes", pods)
    assert got == ref.get_pods_metric("default", "tpu_test_hbm_used_bytes", pods)
    assert list(got) == ["v5e8-a", "v5e8-c"]
    assert port.get_pods_metric("prod", "tpu_test_hbm_used_bytes", pods) == {}
    assert port.get_pods_metric("default", "absent_series", pods) == {}  # no Pod override
    for ns, selector in (("default", {"queue": "tpu-serve"}), ("default", None),
                         ("prod", {"queue": "tpu-serve"}), ("default", {"queue": "none"})):
        values = port.get_external_metric(ns, "tpu_test_queue_depth", selector)
        assert values == ref.get_external_metric(ns, "tpu_test_queue_depth", selector)
    assert len(port.get_external_metric("default", "tpu_test_queue_depth",
                                        {"queue": "tpu-serve"})) == 2
    assert port.get_external_metric("default", "unknown", {}) == []
    assert port.list_metrics() == ref.list_metrics() == ["tpu_test_hbm_used_bytes"]
    assert port.list_external_metrics() == ref.list_external_metrics()


def test_two_series_for_one_pod_raise_as_jax_s():
    for tsdb_mod, adapter_mod in ((tsdb, adapter), (jax_tsdb, jax_adapter)):
        db = tsdb_mod.TimeSeriesDB(VirtualClock())
        for chip in ("0", "1"):
            db.append("m", (("chip", chip), ("namespace", "default"), ("pod", "p")), 1.0)
        served = adapter_mod.CustomMetricsAdapter(db, [adapter_mod.AdapterRule(
            "m", {"namespace": "namespace", "pod": "Pod"})])
        with pytest.raises(ValueError, match="matched 2 series"):
            served.get_pods_metric("default", "m", ["p"])


# ---- the HBM loop ----------------------------------------------------------------


class CountingHold:
    """``HbmHold``'s arithmetic without memory: whole 1/4 GiB blocks, and
    every target it was set to."""

    def __init__(self):
        self.held = 0
        self.targets: list[float] = []

    def held_bytes(self) -> int:
        return self.held

    def set_target(self, target_bytes: float) -> None:
        self.targets.append(target_bytes)
        while self.held + HbmHold.BLOCK <= target_bytes:
            self.held += HbmHold.BLOCK
        while self.held > target_bytes:
            self.held -= HbmHold.BLOCK

    def clear(self) -> None:
        self.held = 0


def _jax_pipeline(fetch_real, load, clock, time_scale: float) -> Pipeline:
    """The JAX package's TSDB, scraper, pod-max rule, adapter and HPA (the
    shipped HBM manifest's metric, bounds and behavior, scaled as bench.py
    scales them), fed the same expositions as the port's loop: the real
    pod's, the mirror pods' and the pods' labels."""
    spec = hbm_pods_spec(16 * GIB)
    port = wire_pipeline(fetch_real, load.utilization, clock, time_scale, spec=spec)
    deployment = port.deployment
    doc = _load("tpu-test-hbm-hpa.yaml")
    db = jax_tsdb.TimeSeriesDB(clock)
    scraper = jax_tsdb.Scraper(db)
    scraper.add_target(fetch_real, name="exporter/real", node="real-0")
    scraper.add_target(lambda: mirror_exposition(deployment, load.utilization(), spec.mirror_chip),
                       name="exporter/sim", node="sim-0")
    scraper.add_target(lambda: pod_labels_exposition(deployment), name="ksm")
    evaluator = jax_rules.RuleEvaluator(db, [jax_rules.tpu_test_pod_max_rule(
        app="tpu-test-v5e8", record="tpu_test_hbm_used_bytes")])
    served = jax_adapter.CustomMetricsAdapter(db, [jax_adapter.AdapterRule(
        "tpu_test_hbm_used_bytes", {"namespace": "namespace", "pod": "Pod"})])
    behavior = jax_hpa.behavior_from_manifest(doc)
    for r in (behavior.scale_up, behavior.scale_down):
        r.stabilization_window_seconds *= time_scale
        for policy in r.policies:
            policy.period_seconds *= time_scale
    controller = jax_hpa.HPAController(
        target=deployment, metrics=jax_hpa.metrics_from_manifest(doc), adapter=served,
        clock=clock, min_replicas=doc["spec"]["minReplicas"],
        max_replicas=doc["spec"]["maxReplicas"], behavior=behavior, pod_lister=deployment)
    return Pipeline(deployment, db, scraper, evaluator, controller, port.metric, spec)


def _real(load):
    def fetch() -> str:
        chip = schema.ChipSample(0, None, None, load.utilization(), 16.0 * GIB, None)
        return exposition.encode_text(schema.families_from_chips(
            [chip], "real-0", {0: ("default", trial.HBM_POD)}))

    return fetch


@pytest.mark.parametrize("time_scale", [1.0, 0.1])
def test_the_hbm_loop_decides_as_jax_s_planes_fed_the_same_expositions(time_scale):
    results = []
    for jax_side in (False, True):
        clock, hold = VirtualClock(), CountingHold()
        load = HbmLoad(hold)
        if jax_side:
            pipe = _jax_pipeline(_real(load), load, clock, time_scale)
        else:
            pipe = wire_pipeline(_real(load), load.utilization, clock, time_scale,
                                 spec=hbm_pods_spec(16 * GIB))
        results.append((run_trial(load, pipe, clock, time_scale), hold, pipe.hpa))
    (port, port_hold, port_hpa), (ref, _, ref_hpa) = results
    assert port == ref
    assert port_hpa.condition_history == ref_hpa.condition_history
    # bench.py's traffic, block for block: 0.5 GiB, then 14.5 GiB a pod
    # until four pods share 44 GiB at 11 GiB each
    assert sorted(set(port_hold.targets)) == [GIB // 2, 11 * GIB, HBM_CAP]
    # three syncs, each reading 14.5 GiB over 13Gi (ratio 1.115): one pod more each
    assert [r for _, r, _ in port.replicas] == [2, 3, 4, 4]
    assert [v["tpu_test_hbm_used_bytes"] for _, v in port.metrics] == [HBM_CAP] * 3
    assert [r.split(" (")[0] for _, r in port.reasons] == [
        "scale up 1->2", "scale up 2->3", "scale up 3->4"]
    assert port.scale_up_s <= 60.0 * time_scale


def test_run_hbm_pods_trial_on_a_virtual_clock():
    hold = CountingHold()
    result = run_hbm_pods_trial("cpu", 1.0, hold, VirtualClock())
    assert hold.held == 0  # cleared
    # the crossing at the first scrape after the spike, then three syncs a
    # period apart and one pod start: 53.1 s of the 60 s budget
    assert math.isclose(result.scale_up_s, 53.1, abs_tol=0.06)
    assert math.isclose(result.spike_to_cross_s, 1.0, abs_tol=0.06)
    assert result.replicas[-1][1:] == (4, 4)


def test_run_hbm_pods_trial_in_real_time_through_the_exporter_daemon():
    """At a tenth of the time scale: the real pod's held bytes served over
    HTTP by the exporter daemon, the loop on the system clock."""
    result = run_hbm_pods_trial("cpu", 0.1, CountingHold())
    assert result.replicas[-1][1:] == (4, 4)
    assert result.scale_up_s <= 6.0
    assert all(v["tpu_test_hbm_used_bytes"] == HBM_CAP for _, v in result.metrics)


class SmallHold(HbmHold):
    BLOCK = 4096


def test_hbm_hold_holds_whole_blocks_on_the_cpu():
    hold = SmallHold("cpu")
    hold.set_target(10_000)
    assert hold.held_bytes() == 8192 and sum(b.numel() for b in hold._blocks) == 8192
    hold.set_target(4096 * 5)
    assert hold.held_bytes() == 4096 * 5
    hold.set_target(4095)
    assert hold.held_bytes() == 0 and hold._blocks == []
    hold.set_target(4096 * 3)
    hold.clear()
    assert hold.held_bytes() == 0 and hold._blocks == []
