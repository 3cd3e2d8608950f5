"""The alert router (``obs/alerting.py``), the incident correlator and
scorer (``obs/incident.py``) and the evaluator's labelled firing alerts,
against the JAX package's.

- tests/test_alerting.py's 18 cases against the port's modules: matchers,
  silences and inhibition; the grouping and timing state machine
  (group_wait, group_interval, repeat_interval, the flap folded into one
  update); the break-inhibition stamp and the log's violations; the
  canonical export; the correlator's cause kinds and windows, the scorer's
  recall, precision and repeat credit, the ``--why`` timeline; and
  ``firing_alert_instances``.
- Scripted observation sequences driven through both packages' routers
  (with silences, inhibition, the canary, several groupings and timings):
  the same notification log and stats as canonical JSON, the same
  violations, the same self-metric families; the correlator, the scorer
  and both renderings over the same pages and evidence give JAX's dicts
  and text.

Tolerance: exact (virtual time throughout).
"""

import json
import random

import pytest
import torch

from k8s_gpu_hpa_tpu.obs import alerting as jax_alerting
from k8s_gpu_hpa_tpu.obs import incident as jax_incident
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxClock
from k8s_gpu_hpa_tpu_torch.obs import alerting, incident
from k8s_gpu_hpa_tpu_torch.obs.alerting import (
    AlertRouter,
    InhibitRule,
    Matcher,
    Silence,
    notification_log_violations,
    shipped_inhibit_rules,
)
from k8s_gpu_hpa_tpu_torch.obs.incident import correlate, render_incident_why, score_paging
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)


def inst(name, since, **labels):
    return {
        "name": name,
        "labels": labels,
        "annotations": {},
        "active_since": since,
    }


def make_router(clock, **overrides):
    kw = dict(
        group_by=("alertname", "severity"),
        group_wait=10.0,
        group_interval=30.0,
        repeat_interval=120.0,
    )
    kw.update(overrides)
    return AlertRouter(clock, **kw)


def kinds(router):
    return [n["kind"] for n in router.log]


# ---- matchers, silences, inhibition ------------------------------------------


def test_matcher_ops_and_implicit_alertname():
    labels = {"alertname": "RegionDead", "severity": "critical", "region": "us"}
    assert Matcher("alertname", "RegionDead").matches(labels)
    assert Matcher("region", "eu", op="!=").matches(labels)
    assert Matcher("severity", "crit.*", op="=~").matches(labels)
    assert not Matcher("severity", "crit", op="=~").matches(labels)  # a full match
    with pytest.raises(ValueError, match="unknown matcher op '~'"):
        Matcher("x", "y", op="~").matches(labels)


def test_silence_window_half_open_and_matching():
    s = Silence("s1", (Matcher("alertname", "Noisy"),), starts_at=10.0, ends_at=20.0)
    assert not s.active(9.9)
    assert s.active(10.0)
    assert not s.active(20.0)  # [starts, ends)
    assert s.matches({"alertname": "Noisy"})
    assert not s.matches({"alertname": "Other"})


def test_inhibition_equal_labels_and_self_exclusion():
    rule = InhibitRule(
        source=(Matcher("severity", "critical"),),
        target=(Matcher("severity", "warning"),),
        equal=("slo",),
    )
    src = {"severity": "critical", "slo": "edge"}
    tgt = {"severity": "warning", "slo": "edge"}
    other = {"severity": "warning", "slo": "other"}
    assert rule.inhibits(src, tgt)
    assert not rule.inhibits(src, other)  # the equal label disagrees
    # missing on BOTH sides counts as equal (Alertmanager's semantics)
    assert rule.inhibits({"severity": "critical"}, {"severity": "warning"})
    # an alert never inhibits itself (identity, not equality)
    same = {"severity": "critical", "slo": "edge"}
    assert not rule.inhibits(same, same)


def test_router_drops_silenced_and_inhibited_instances():
    clock = VirtualClock()
    router = make_router(
        clock,
        inhibit_rules=shipped_inhibit_rules(),
        silences=(Silence("s1", (Matcher("alertname", "Noisy"),), 0.0, 1e9),),
    )
    clock.advance(1.0)
    router.observe(
        [
            inst("Noisy", 1.0, severity="warning"),
            inst("SloSource", 1.0, severity="critical", slo="edge"),
            inst("SloTwin", 1.0, severity="warning", slo="edge"),
        ]
    )
    clock.advance(15.0)
    router.observe(
        [
            inst("SloSource", 1.0, severity="critical", slo="edge"),
            inst("SloTwin", 1.0, severity="warning", slo="edge"),
        ]
    )
    # only the critical source paged: the twin inhibited, Noisy silenced
    assert [p["group"]["alertname"] for p in router.pages()] == ["SloSource"]
    assert router.silenced_total >= 1
    assert router.inhibited_total >= 1
    assert notification_log_violations(router.log) == []


# ---- the grouping and timing state machine -----------------------------------


def test_group_wait_delays_first_page_and_batches_members():
    clock = VirtualClock()
    router = make_router(clock, group_by=("severity",))
    clock.advance(1.0)
    router.observe([inst("A", 1.0, severity="critical")])
    assert router.pages() == []  # inside group_wait
    clock.advance(5.0)
    # a second alert joins the group during the wait
    router.observe([inst("A", 1.0, severity="critical"), inst("B", 4.0, severity="critical")])
    assert router.pages() == []
    clock.advance(6.0)
    router.observe([inst("A", 1.0, severity="critical"), inst("B", 4.0, severity="critical")])
    pages = router.pages()
    assert len(pages) == 1  # ONE notification covers the burst
    assert [a["name"] for a in pages[0]["alerts"]] == ["A", "B"]


def test_group_resolved_before_group_wait_expires_silently():
    clock = VirtualClock()
    router = make_router(clock)
    clock.advance(1.0)
    router.observe([inst("A", 1.0, severity="critical")])
    clock.advance(2.0)
    router.observe([])  # resolved before group_wait: nothing was ever sent
    clock.advance(60.0)
    router.observe([])
    assert router.log == []


def test_repeat_interval_repages_and_resolve_notifies():
    clock = VirtualClock()
    router = make_router(clock)
    clock.advance(1.0)
    a = inst("A", 1.0, severity="critical")
    router.observe([a])
    clock.advance(11.0)
    router.observe([a])  # page
    clock.advance(125.0)
    router.observe([a])  # still firing past repeat_interval
    clock.advance(35.0)
    router.observe([])  # the group empty and group_interval due
    assert kinds(router) == ["page", "repeat", "resolved"]


def test_flap_within_group_interval_coalesces_into_one_update():
    """pending, firing, resolved and firing again inside group_interval
    gives ONE update of the group, never a second page."""
    clock = VirtualClock()
    router = make_router(clock, group_by=("severity",))
    steady = inst("Steady", 1.0, severity="critical")
    flappy = inst("Flappy", 1.0, severity="critical")
    clock.advance(1.0)
    router.observe([steady, flappy])
    clock.advance(11.0)
    router.observe([steady, flappy])  # the page covers both
    clock.advance(5.0)
    router.observe([steady])  # Flappy resolves...
    clock.advance(5.0)
    refired = inst("Flappy", 22.0, severity="critical")
    router.observe([steady, refired])  # ...and fires again within group_interval
    clock.advance(20.0)
    router.observe([steady, refired])  # group_interval due
    assert kinds(router) == ["page", "update"]  # one update, NO second page
    assert router.flaps_coalesced == 1
    flap_row = next(a for a in router.log[-1]["alerts"] if a["name"] == "Flappy")
    assert flap_row["active_since"] == 22.0  # the new firing's window
    assert notification_log_violations(router.log) == []


def test_update_throttled_by_group_interval():
    clock = VirtualClock()
    router = make_router(clock, group_by=("severity",))
    a = inst("A", 1.0, severity="critical")
    clock.advance(1.0)
    router.observe([a])
    clock.advance(11.0)
    router.observe([a])  # page
    clock.advance(5.0)
    router.observe([a, inst("B", 16.0, severity="critical")])  # the membership grew
    assert kinds(router) == ["page"]  # inside group_interval: no update yet
    clock.advance(30.0)
    router.observe([a, inst("B", 16.0, severity="critical")])
    assert kinds(router) == ["page", "update"]


# ---- the canary, the violations, determinism ---------------------------------


def test_break_inhibition_stamps_would_inhibit_and_trips_violation():
    clock = VirtualClock()
    router = make_router(clock, inhibit_rules=shipped_inhibit_rules(), break_inhibition=True)
    src = inst("SloSource", 1.0, severity="critical", slo="edge")
    twin = inst("SloTwin", 1.0, severity="warning", slo="edge")
    clock.advance(1.0)
    router.observe([src, twin])
    clock.advance(12.0)
    router.observe([src, twin])
    pages = router.pages()
    assert len(pages) == 2  # the twin paged on its own: inhibition bypassed
    twin_page = next(p for p in pages if p["group"]["alertname"] == "SloTwin")
    assert twin_page["would_inhibit"] == 1
    violations = notification_log_violations(router.log)
    assert [v["kind"] for v in violations] == ["uninhibited_duplicate_page"]


def test_notification_log_flags_duplicate_pages():
    # a dedup regression: one group and fingerprint paged twice within
    # repeat_interval with no resolve between
    entry = {
        "seq": 0,
        "t": 100.0,
        "kind": "page",
        "group": {"alertname": "A"},
        "fingerprint": "deadbeef",
        "alerts": [],
        "would_inhibit": 0,
    }
    dup = dict(entry, seq=1, t=150.0)
    assert [v["kind"] for v in notification_log_violations([entry, dup])] == ["duplicate_page"]
    # a resolve between them clears the dedup state
    resolved = dict(entry, seq=1, kind="resolved", t=120.0)
    late = dict(entry, seq=2, t=150.0)
    assert notification_log_violations([entry, resolved, late]) == []


def test_export_json_canonical_and_bit_identical():
    def drive():
        clock = VirtualClock()
        router = make_router(clock)
        a = inst("A", 1.0, severity="critical")
        clock.advance(1.0)
        router.observe([a])
        clock.advance(11.0)
        router.observe([a])
        clock.advance(40.0)
        router.observe([])
        return router

    one, two = drive(), drive()
    assert one.export_json() == two.export_json()
    parsed = json.loads(one.export_json())
    assert set(parsed) == {"notifications", "stats"}
    assert parsed["stats"]["notifications"]["page"] == 1


# ---- correlation and scoring --------------------------------------------------


PAGE = {
    "seq": 0,
    "t": 100.0,
    "kind": "page",
    "group": {"alertname": "PipelineUnhealthy", "severity": "critical"},
    "fingerprint": "0",
    "alerts": [
        {
            "name": "SLOEdgeFastBurn",
            "labels": {"severity": "critical", "slo": "edge", "burn": "fast"},
            "active_since": 90.0,
        }
    ],
    "would_inhibit": 0,
}

FAULT = {
    "fault": "edge_fault",
    "kind": "exporter_outage",
    "injected_at": 80.0,
    "cleared_at": 140.0,
    "recovered_at": 150.0,
    "trace_span_id": 7,
}

EVIDENCE = {
    "faults": [FAULT],
    "scale_events": [(95.0, 2, 3)],
    "capacity_events": [
        {"t": 92.0, "tenant": "tpu-prod", "event": "preempted"},
        {"t": 93.0, "tenant": "tpu-prod", "event": "scheduled"},  # not a denial
    ],
    "evacuation_decisions": [
        {
            "t": 94.0,
            "tenant": "tpu-prod",
            "from": "us",
            "to": "eu",
            "replicas": 2,
            "denied": False,
        }
    ],
}


def test_correlate_attributes_every_cause_kind():
    incidents = correlate([PAGE], EVIDENCE)
    assert len(incidents) == 1
    inc = incidents[0]
    assert inc["id"] == "INC-001"
    assert inc["attributed"] is True
    assert {c["kind"] for c in inc["causes"]} == {
        "fault_window",
        "slo_burn",
        "scale_event",
        "capacity_denial",
        "evacuation",
    }
    fault_cause = next(c for c in inc["causes"] if c["kind"] == "fault_window")
    assert fault_cause["ref"] == 7  # the trace lineage rides the cause
    # the causes arrive ordered in time
    assert [c["t"] for c in inc["causes"]] == sorted(c["t"] for c in inc["causes"])


def test_correlate_scale_events_alone_do_not_attribute():
    page = dict(PAGE, alerts=[{"name": "X", "labels": {}, "active_since": 90.0}])
    incidents = correlate([page], {"scale_events": [(95.0, 2, 3)]})
    assert incidents[0]["attributed"] is False
    assert [c["kind"] for c in incidents[0]["causes"]] == ["scale_event"]


def test_correlate_rejects_evidence_outside_the_page_window():
    stale_fault = dict(FAULT, injected_at=5.0, cleared_at=10.0, recovered_at=12.0)
    page = dict(PAGE, alerts=[{"name": "X", "labels": {}, "active_since": 90.0}])
    incidents = correlate([page], {"faults": [stale_fault]})
    assert incidents[0]["causes"] == []
    assert incidents[0]["attributed"] is False


LATE_FAULT = {
    "fault": "late_fault",
    "kind": "node_preempt",
    "injected_at": 160.0,
    "cleared_at": 260.0,
    "recovered_at": None,
    "trace_span_id": None,
}

REPEAT = {
    "seq": 1,
    "t": 220.0,
    "kind": "repeat",
    "group": PAGE["group"],
    "fingerprint": "0",
    "alerts": PAGE["alerts"],
    "would_inhibit": 0,
}


def test_score_paging_recall_precision_and_repeat_crediting():
    incidents = correlate([PAGE], {"faults": [FAULT]})
    # a second fault no page is attributed to, but covered by a repeat
    # inside its window: an honest, larger time to page
    score = score_paging([FAULT, LATE_FAULT], incidents, [PAGE, REPEAT], 120.0)
    assert score["faults_total"] == 2
    assert score["uncovered_faults"] == []
    assert score["recall"] == 1.0
    assert score["precision"] == 1.0
    assert score["time_to_page_s"]["max"] == 60.0  # 220 - 160, the repeat's credit
    # without the repeat, late_fault goes dark and the recall falls
    score = score_paging([FAULT, LATE_FAULT], incidents, [PAGE], 120.0)
    assert score["uncovered_faults"] == ["late_fault"]
    assert score["recall"] == 0.5


def test_render_incident_why_merges_causes_alerts_and_page():
    incidents = correlate([PAGE], {"faults": [FAULT]})
    text = render_incident_why({"incidents": incidents}, "INC-001")
    assert "INC-001" in text
    assert "fault_window" in text and "[span 7]" in text
    assert "alert_firing" in text and "SLOEdgeFastBurn" in text
    assert text.index("fault_window") < text.index("group paged")
    assert "no incident" in render_incident_why({"incidents": incidents}, "INC-999")


# ---- the evaluator's labelled firing alerts -----------------------------------


def test_firing_alert_instances_carry_labels_and_active_since():
    from k8s_gpu_hpa_tpu_torch.metrics.rules import AlertRule, RuleEvaluator

    class Probe:
        def __init__(self):
            self.on = False

        def evaluate(self, db, at=None):
            return [1.0] if self.on else []

        def input_names(self):
            return frozenset()

    probe = Probe()
    rule = AlertRule(
        alert="ProbeAlert",
        expr=probe,
        for_seconds=5.0,
        labels={"severity": "critical", "region": "us"},
        annotations={"summary": "probe"},
    )
    ev = RuleEvaluator(db=None, rules=[], alerts=[rule])
    rule.evaluate(None, at=0.0)
    assert ev.firing_alert_instances() == []
    probe.on = True
    rule.evaluate(None, at=1.0)  # pending
    assert ev.firing_alert_instances() == []
    rule.evaluate(None, at=7.0)  # fires: active since the transition
    (instance,) = ev.firing_alert_instances()
    assert instance["name"] == "ProbeAlert"
    assert instance["labels"] == {"severity": "critical", "region": "us"}
    assert instance["active_since"] == 7.0
    assert ev.firing_alerts() == ["ProbeAlert"]  # the names alone
    probe.on = False
    rule.evaluate(None, at=8.0)
    assert rule.firing_since is None  # reset on resolve


# ---- against the JAX package ---------------------------------------------------

_NAMES = ("A", "B", "SloSource", "SloTwin", "RegionDead", "TenantUnschedulable", "Noisy")


def _labels_of(name: str, rng: random.Random) -> dict:
    if name == "SloSource":
        return {"severity": "critical", "slo": "edge"}
    if name == "SloTwin":
        return {"severity": "warning", "slo": "edge"}
    if name == "RegionDead":
        return {"severity": "critical", "region": rng.choice(("us", "eu"))}
    if name == "TenantUnschedulable":
        return {"severity": "warning", "region": rng.choice(("us", "eu")),
                "tenant": rng.choice(("tpu-prod", "tpu-batch"))}
    return {"severity": rng.choice(("critical", "warning"))}


def _script(seed: int) -> list[tuple[float, list[dict]]]:
    """A scripted run: each step advances the clock and observes a set of
    firing instances; an instance that stops firing and comes back gets a
    new active_since, as the evaluator gives it."""
    rng = random.Random(seed)
    universe = {}
    for name in _NAMES:
        labels = _labels_of(name, rng)
        universe[(name, tuple(sorted(labels.items())))] = labels
    since: dict = {}
    t = 0.0
    steps = []
    for _ in range(60):
        t += rng.choice((1.0, 5.0, 5.0, 15.0, 30.0, 70.0))
        firing = []
        for key, labels in universe.items():
            on = rng.random() < 0.45
            if on:
                since.setdefault(key, t)
                firing.append({"name": key[0], "labels": dict(labels), "annotations": {},
                               "active_since": since[key]})
            else:
                since.pop(key, None)
        firing.sort(key=lambda i: (i["name"], sorted(i["labels"].items())))
        steps.append((t, firing))
    return steps


def _drive(mod, clock_cls, script, **kw):
    clock = clock_cls()
    silences = (mod.Silence("sil", (mod.Matcher("alertname", "Noisy"),), 100.0, 600.0),)
    router = mod.AlertRouter(
        clock,
        inhibit_rules=mod.shipped_inhibit_rules(),
        silences=silences,
        **kw,
    )
    for t, firing in script:
        clock.advance(t - clock.now())
        router.observe(firing)
    return router


ROUTINGS = {
    "paging": dict(group_by=("alertname", "severity", "region"), group_wait=15.0,
                   group_interval=60.0, repeat_interval=120.0),
    "by_severity": dict(group_by=("severity",), group_wait=10.0, group_interval=30.0,
                        repeat_interval=120.0),
    "canary": dict(group_by=("alertname", "severity", "region"), group_wait=15.0,
                   group_interval=60.0, repeat_interval=120.0, break_inhibition=True),
}


@pytest.mark.parametrize("routing", list(ROUTINGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_routing_is_jax_s(routing, seed):
    script = _script(seed)
    port = _drive(alerting, VirtualClock, script, **ROUTINGS[routing])
    ref = _drive(jax_alerting, JaxClock, script, **ROUTINGS[routing])
    assert port.log, "the script paged nothing"
    assert port.export_json() == ref.export_json()
    assert port.page_latencies == ref.page_latencies
    assert alerting.notification_log_violations(port.log, 120.0) == (
        jax_alerting.notification_log_violations(ref.log, 120.0))
    fams = lambda m, r: [(f.name, f.type, f.help, [(s.value, s.labels)  # noqa: E731
                                                   for s in f.samples])
                         for f in m.alerting_families(r)]
    assert fams(alerting, port) == fams(jax_alerting, ref)
    # the correlator and the scorer over the script's pages, the rendering too
    evidence = dict(EVIDENCE, faults=[FAULT, LATE_FAULT])
    incidents = incident.correlate(port.pages(), evidence)
    assert incidents == jax_incident.correlate(ref.pages(), evidence)
    score = incident.score_paging(evidence["faults"], incidents, port.log, 120.0)
    assert score == jax_incident.score_paging(evidence["faults"], incidents, ref.log, 120.0)
    result = {"scenario": "scripted", "score": score, "incidents": incidents}
    assert incident.render_incident_report(result) == jax_incident.render_incident_report(result)
    for inc in incidents[:3] + [{"id": "INC-999"}]:
        assert incident.render_incident_why(result, inc["id"]) == (
            jax_incident.render_incident_why(result, inc["id"]))


def test_the_module_constants_are_jax_s():
    assert alerting.ALERTING_METRIC_NAMES == jax_alerting.ALERTING_METRIC_NAMES
    assert alerting.NOTIFICATION_KINDS == jax_alerting.NOTIFICATION_KINDS
    assert incident.EVIDENCE_SLACK_S == jax_incident.EVIDENCE_SLACK_S
    assert incident.ROOT_CAUSE_KINDS == jax_incident.ROOT_CAUSE_KINDS
    assert incident.CAPACITY_DENIAL_EVENTS == jax_incident.CAPACITY_DENIAL_EVENTS
    assert repr(alerting.shipped_inhibit_rules()).replace("k8s_gpu_hpa_tpu_torch", "") == (
        repr(jax_alerting.shipped_inhibit_rules()).replace("k8s_gpu_hpa_tpu", ""))
