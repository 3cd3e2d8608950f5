"""The pipeline's self-metrics (``obs/selfmetrics.py``), the histogram they
render (``metrics/schema.Histogram``), the SLO recorders and burn-rate
alerts (``obs/slo.py``, ``metrics/rules.py``) and the doctor's self-metrics
probe, against the JAX package's.

- ``Histogram``: the same seeded observations give JAX's family, text and
  cumulative buckets exactly, and the text round-trips through the port's
  ``parse_text`` with its exemplars; ``bucket_quantile``, ``percentile``
  and ``histogram_quantiles`` equal JAX's on seeded inputs and the edges.
- ``PipelineSelfMetrics``: the same reports give JAX's exposition byte for
  byte, with and without a query engine attached (its six counters).
- The SLO machinery on hand-built TSDBs, after
  ``tests/test_histogram_slo.py``: the recorders in gauge and counter mode,
  ``BurnRate`` and the alert pairs evaluated every second beside JAX's
  (clean, blackout, recovery), "no traffic is no evidence", ``for:``
  semantics, the shipped alerts' PromQL.
- A traced pipeline: every recorded series equal to JAX's at every scrape
  (the SLO counters, ``up``, ``signal_propagation_seconds_*`` and the
  workload's, the query engine's counters), save the wall-clock families;
  a clean run fires no SLO alert and a total scrape blackout fires the
  fast alert at the second JAX's does.
- ``doctor.check_self_metrics`` passes on the port's pipeline and fails as
  JAX's does.

Tolerance: exact throughout (the same float operations in the same order).
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu import doctor as jax_doctor
from k8s_gpu_hpa_tpu import obs as jax_obs
from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.control import loop as jax_loop
from k8s_gpu_hpa_tpu.metrics import exposition as jax_exposition
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.obs import selfmetrics as jax_selfmetrics
from k8s_gpu_hpa_tpu.obs import slo as jax_slo
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch import doctor, obs
from k8s_gpu_hpa_tpu_torch.control import cluster, loop
from k8s_gpu_hpa_tpu_torch.metrics import exposition, rules, schema, tsdb
from k8s_gpu_hpa_tpu_torch.obs import selfmetrics, slo
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(cluster=cluster, loop=loop, clock=clock, obs=obs, rules=rules, schema=schema,
            tsdb=tsdb, slo=slo, exposition=exposition)
JAX = dict(cluster=jax_cluster, loop=jax_loop, clock=jax_clock, obs=jax_obs, rules=jax_rules,
           schema=jax_schema, tsdb=jax_tsdb, slo=jax_slo, exposition=jax_exposition)
BOUNDS = (5.0, 10.0, 15.0, 20.0, 30.0, 45.0, 60.0, 90.0, 120.0)


def _samples(family) -> list[tuple]:
    return [(s.value, s.labels, s.suffix,
             None if s.exemplar is None else (s.exemplar.value, s.exemplar.trace_id,
                                              s.exemplar.span_id, s.exemplar.ts))
            for s in family.samples]


def _observed(mods, seed: int, bounds=None):
    """A histogram fed seeded observations over two label sets, every third
    with an exemplar."""
    rng = np.random.default_rng(seed)
    kw = {} if bounds is None else {"bounds": bounds}
    hist = mods["schema"].Histogram("x_seconds", "help text", **kw)
    hi = 3.0 if bounds is None else 150.0
    for i, v in enumerate(rng.uniform(0.0, hi, 60).tolist()):
        ex = mods["schema"].Exemplar(v, trace_id=i, span_id=i, ts=float(i)) if i % 3 == 0 else None
        hist.observe(v, ex, target="a" if i % 2 else "b")
    return hist


# ---- Histogram ------------------------------------------------------------------


@pytest.mark.parametrize("bounds", [None, BOUNDS, (1.0, float("inf"))])
@pytest.mark.parametrize("seed", [0, 1])
def test_a_histogram_renders_jax_s_family_and_text(seed, bounds):
    port, ref = _observed(PORT, seed, bounds), _observed(JAX, seed, bounds)
    assert port.bounds == ref.bounds
    assert _samples(port.family()) == _samples(ref.family())
    assert (port.family().name, port.family().type, port.family().help) == (
        ref.family().name, ref.family().type, ref.family().help)
    text = exposition.encode_text([port.family()])
    assert text == jax_exposition.encode_text([ref.family()])
    for labels in ((("target", "a"),), (("target", "b"),), ()):
        assert port.cumulative_buckets(labels) == ref.cumulative_buckets(labels)


def test_a_histogram_round_trips_through_the_port_s_parser_with_exemplars():
    hist = schema.Histogram("hpa_sync_latency_seconds", "sync cost")
    hist.observe(0.003, schema.Exemplar(0.003, trace_id=7, span_id=7, ts=12.5))
    hist.observe(0.3, schema.Exemplar(0.3, trace_id=9, span_id=9))
    text = exposition.encode_text([hist.family()])
    assert 'le="+Inf"' in text
    assert '# {trace_id="7",span_id="7"} 0.003 12.5' in text
    (fam,) = exposition.parse_text(text)
    assert fam.type == "histogram"
    back = {(name, s.labels, s.suffix): s for name, s in exposition.flatten([fam])}
    orig = {(name, s.labels, s.suffix): s for name, s in exposition.flatten([hist.family()])}
    assert set(back) == set(orig)
    for key, s in orig.items():
        assert back[key].value == s.value
        assert back[key].exemplar == s.exemplar


def test_a_histogram_needs_a_bound_as_jax_s_does():
    with pytest.raises(ValueError) as got:
        schema.Histogram("h", bounds=())
    with pytest.raises(ValueError) as want:
        jax_schema.Histogram("h", bounds=())
    assert str(got.value) == str(want.value)
    assert schema.DEFAULT_DURATION_BUCKETS == jax_schema.DEFAULT_DURATION_BUCKETS
    for bound in (0.001, 0.5, 1.0, 30.0, 1e-7, float("inf")):
        assert schema.format_le(bound) == jax_schema.format_le(bound)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.95, 0.99, 1.0, -0.5, 1.5])
def test_bucket_quantile_and_percentile_are_jax_s(seed, q):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 150.0, int(rng.integers(1, 200))).tolist()
    hist = schema.Histogram("h", bounds=BOUNDS)
    for v in values:
        hist.observe(v)
    buckets = hist.cumulative_buckets()
    assert rules.bucket_quantile(buckets, q) == jax_rules.bucket_quantile(buckets, q)
    shuffled = [buckets[i] for i in rng.permutation(len(buckets))]
    assert rules.bucket_quantile(shuffled, q) == jax_rules.bucket_quantile(shuffled, q)
    assert obs.percentile(values, q * 100) == jax_obs.percentile(values, q * 100)


@pytest.mark.parametrize("buckets", [
    [], [(1.0, 3.0)], [(math.inf, 0.0)], [(1.0, 0.0), (2.0, 0.0), (math.inf, 0.0)],
    [(1.0, 0.0), (2.0, 2.0), (math.inf, 5.0)], [(1.0, 2.0), (2.0, 2.0), (math.inf, 2.0)],
    [(math.inf, 4.0)], [(4.0, 1.0), (math.inf, 9.0)],
])
def test_bucket_quantile_edges_are_jax_s(buckets):
    for q in (0.0, 0.5, 1.0):
        assert rules.bucket_quantile(buckets, q) == jax_rules.bucket_quantile(buckets, q)


def test_percentile_and_histogram_quantiles_edges_are_jax_s():
    for values in ([], [7.5], [5.0, 1.0, 3.0], list(range(1, 101))):
        for q in (-3, 0, 1, 50, 95, 99, 100, 250):
            assert obs.percentile(values, q) == jax_obs.percentile(values, q)
    empty = schema.Histogram("x", bounds=BOUNDS)
    assert obs.histogram_quantiles(empty) == {"p50": None, "p95": None, "p99": None}
    port, ref = _observed(PORT, 3, BOUNDS), _observed(JAX, 3, BOUNDS)
    for labels in ((("target", "a"),), ()):
        assert obs.histogram_quantiles(port, labels=labels) == jax_obs.histogram_quantiles(
            ref, labels=labels)


# ---- PipelineSelfMetrics ------------------------------------------------------


def _reported(mods_selfmetrics, clock_mod, seed: int):
    rng = np.random.default_rng(seed)
    vclock = clock_mod.VirtualClock()
    sm = mods_selfmetrics.PipelineSelfMetrics(clock=vclock)
    reasons = ["scale up 1->3 (policy limit 4)", "scale down 4->2 (policy limit 2)",
               "within tolerance / stabilized", "metrics unavailable; holding",
               "repair partial slice 3->2"]
    for i in range(40):
        vclock.advance(1.0)
        sm.observe_sync(float(rng.uniform(0, 0.01)), reasons[i % 5], span_id=i if i % 2 else None)
        sm.observe_scrape(f"exporter/n{i % 3}", float(rng.uniform(0, 0.2)), span_id=100 + i)
        sm.observe_rule_eval("r1", float(rng.uniform(0, 3)),
                             duration=float(rng.uniform(0, 1)) if i % 4 else None, span_id=i)
        sm.observe_rule_eval("r2", float("nan") if i % 7 == 0 else float(i), duration=0.01)
        sm.observe_adapter_query(float(rng.uniform(0, 0.05)), span_id=200 + i)
        if i % 6 == 0:
            sm.observe_propagation(float(rng.uniform(0, 130)), span_id=300 + i)
    return sm


@pytest.mark.parametrize("seed", [0, 1])
def test_the_self_metrics_expose_jax_s_text(seed):
    port = _reported(selfmetrics, clock, seed)
    ref = _reported(jax_selfmetrics, jax_clock, seed)
    assert port.exposition() == ref.exposition()
    counts = np.random.default_rng(seed).integers(0, 10_000, 6).tolist()
    stats = SimpleNamespace(fastpath=counts[0], fallback=counts[1],
                            series_cache_hits=counts[2], series_resolves=counts[3])
    db = SimpleNamespace(decode_cache_hits=counts[4], decode_cache_misses=counts[5])
    port.attach_query_engine(stats, db)
    ref.attach_query_engine(stats, db)
    assert port.exposition() == ref.exposition()
    assert port.decisions == ref.decisions and port.sync_durations == ref.sync_durations
    assert obs.histogram_quantiles(port.hist_propagation) == jax_obs.histogram_quantiles(
        ref.hist_propagation)
    names = {f.name for f in exposition.parse_text(port.exposition())}
    assert names == set(selfmetrics.SELF_METRIC_NAMES) | set(selfmetrics.SELF_HISTOGRAM_NAMES)


def test_an_empty_self_metrics_exposes_jax_s_text():
    assert selfmetrics.PipelineSelfMetrics().exposition() == (
        jax_selfmetrics.PipelineSelfMetrics().exposition())


def test_the_self_metric_names_are_jax_s():
    for name in ("HPA_SYNC_DURATION", "SCRAPE_DURATION", "RULE_EVAL_STALENESS",
                 "HPA_DECISION_TOTAL", "PLANNER_FASTPATH_TOTAL", "PLANNER_FALLBACK_TOTAL",
                 "PLANNER_SERIES_CACHE_HITS", "PLANNER_SERIES_RESOLVES", "DECODE_CACHE_HITS",
                 "DECODE_CACHE_MISSES", "HPA_SYNC_LATENCY", "SCRAPE_LATENCY",
                 "RULE_EVAL_LATENCY", "ADAPTER_QUERY_LATENCY", "SIGNAL_PROPAGATION",
                 "SELF_HISTOGRAM_NAMES", "SELF_HISTOGRAM_SERIES", "SIGNAL_PROPAGATION_BUCKETS",
                 "SELF_TARGET_NAME", "DECISION_REASONS"):
        assert getattr(selfmetrics, name) == getattr(jax_selfmetrics, name), name
    assert selfmetrics.SELF_METRIC_NAMES == jax_selfmetrics.SELF_METRIC_NAMES
    for reason in ("scale up 1->2", "scale down 3->1", "repair partial slice 3->2",
                   "metrics unavailable; holding", "within tolerance / stabilized", ""):
        assert selfmetrics.decision_reason_label(reason) == (
            jax_selfmetrics.decision_reason_label(reason))


# ---- the SLO machinery on hand-built TSDBs (tests/test_histogram_slo.py) --------


def _gauge_slo(mods):
    return mods["slo"].SLODefinition(name="scrape-success", objective=0.99,
                                     description="scrapes succeed", source="gauge",
                                     good_series="up")


def _gauge_recorder_run(mods):
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    rec = mods["slo"].SLORecorder(_gauge_slo(mods))
    labels = dict(rec.slo.labels)
    written = [rec.evaluate_into(db)]
    assert db.latest(mods["slo"].SLO_EVENTS_TOTAL, labels) is None
    for t in range(3):
        db.append("up", (("target", "a"),), 1.0, ts=vclock.now())
        db.append("up", (("target", "b"),), 1.0 if t < 2 else 0.0, ts=vclock.now())
        written.append(rec.evaluate_into(db))
        vclock.advance(1.0)
    return written, db.latest(mods["slo"].SLO_EVENTS_TOTAL, labels), db.latest(
        mods["slo"].SLO_GOOD_TOTAL, labels)


def test_the_gauge_recorder_counts_up_events_as_jax_s_does():
    port = _gauge_recorder_run(PORT)
    assert port == _gauge_recorder_run(JAX)
    assert port == ([0, 2, 2, 2], 6.0, 5.0)


def _counter_recorder_run(mods):
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    s = mods["slo"]
    definition = next(d for d in s.shipped_slos() if d.source == "counter")
    labels = dict(definition.labels)
    out = [s.SLORecorder(definition).evaluate_into(db)]  # source absent: no write
    rec = s.SLORecorder(definition)
    db.append(definition.good_series, (("le", "30"),), 3.0, ts=vclock.now())
    db.append(definition.total_series, (), 4.0, ts=vclock.now())
    rec.evaluate_into(db)
    out.append((db.latest(s.SLO_GOOD_TOTAL, labels), db.latest(s.SLO_EVENTS_TOTAL, labels)))
    # a recorder built over the same TSDB seeds from its counters
    vclock.advance(1.0)
    rec2 = s.SLORecorder(definition)
    db.append(definition.good_series, (("le", "30"),), 3.0, ts=vclock.now())
    db.append(definition.total_series, (), 5.0, ts=vclock.now())
    rec2.evaluate_into(db)
    out.append((db.latest(s.SLO_GOOD_TOTAL, labels), db.latest(s.SLO_EVENTS_TOTAL, labels)))
    # the source dropping back is not a reset: the counters never regress
    vclock.advance(1.0)
    db.append(definition.total_series, (), 2.0, ts=vclock.now())
    rec2.evaluate_into(db)
    out.append((db.latest(s.SLO_GOOD_TOTAL, labels), db.latest(s.SLO_EVENTS_TOTAL, labels)))
    return out


def test_the_counter_recorder_is_monotonic_and_seeds_as_jax_s_does():
    port = _counter_recorder_run(PORT)
    assert port == _counter_recorder_run(JAX)
    assert port == [0, (3.0, 4.0), (3.0, 5.0), (3.0, 5.0)]


def _drive(mods, db, vclock, evaluator, seconds, good_rate, log):
    labels = (("slo", "scrape-success"),)
    s = mods["slo"]
    good = db.latest(s.SLO_GOOD_TOTAL, dict(labels)) or 0.0
    total = db.latest(s.SLO_EVENTS_TOTAL, dict(labels)) or 0.0
    for _ in range(int(seconds)):
        total += 1.0
        good += good_rate
        db.append(s.SLO_GOOD_TOTAL, labels, good, ts=vclock.now())
        db.append(s.SLO_EVENTS_TOTAL, labels, total, ts=vclock.now())
        evaluator.evaluate_once()
        log.append((evaluator.firing_alert_instances(), [
            [x.value for x in a.expr.left.child.evaluate(db)] for a in evaluator.alerts]))
        vclock.advance(1.0)


def _burn_run(mods):
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    alerts = mods["slo"].burn_rate_alerts(_gauge_slo(mods))
    evaluator = mods["rules"].RuleEvaluator(db, [], alerts=alerts)
    log: list = []
    _drive(mods, db, vclock, evaluator, 400, 1.0, log)
    clean = evaluator.firing_alerts()
    _drive(mods, db, vclock, evaluator, 90, 0.0, log)
    blackout = evaluator.firing_alerts()
    _drive(mods, db, vclock, evaluator, 400, 1.0, log)
    return log, clean, blackout, evaluator.firing_alerts()


def test_the_burn_alerts_fire_and_clear_at_jax_s_seconds():
    """Every second: the firing instances and each alert's short-window
    burn equal JAX's.  Silent on clean traffic, both pairs firing after a
    blackout, the fast pair cleared by the recovery."""
    port = _burn_run(PORT)
    ref = _burn_run(JAX)
    assert port[0] == ref[0]
    assert port[1:] == ref[1:]
    _, clean, blackout, recovered = port
    assert clean == []
    assert {"SLOScrapeSuccessFastBurn", "SLOScrapeSuccessSlowBurn"} <= set(blackout)
    assert "SLOScrapeSuccessFastBurn" not in recovered


def _no_traffic(mods):
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    evaluator = mods["rules"].RuleEvaluator(db, [], alerts=mods["slo"].burn_rate_alerts(
        _gauge_slo(mods)))
    evaluator.evaluate_once()
    out = [evaluator.firing_alerts()]
    labels = (("slo", "scrape-success"),)
    db.append(mods["slo"].SLO_GOOD_TOTAL, labels, 5.0, ts=vclock.now())
    db.append(mods["slo"].SLO_EVENTS_TOTAL, labels, 5.0, ts=vclock.now())
    vclock.advance(30.0)
    evaluator.evaluate_once()  # counters present but unmoved
    burn = mods["rules"].BurnRate(mods["slo"].SLO_GOOD_TOTAL, mods["slo"].SLO_EVENTS_TOTAL,
                                  0.99, 10.0, dict(labels), dict(labels))
    return out + [evaluator.firing_alerts(), burn.evaluate(db)]


def test_no_traffic_is_no_evidence_as_in_jax():
    port = _no_traffic(PORT)
    assert port == [[], [], []]
    assert port == _no_traffic(JAX)


def _burn_rate_cases(mods):
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    rng = np.random.default_rng(5)
    good = total = 0.0
    out = []
    for step in range(120):
        total += float(rng.integers(0, 4))
        good = min(total, good + float(rng.integers(0, 4)))
        if step == 70:
            total, good = 3.0, 2.0  # a counter reset
        db.append("g", (("slo", "x"),), good, ts=vclock.now())
        db.append("t", (("slo", "x"),), total, ts=vclock.now())
        for window in (5.0, 30.0, 300.0):
            expr = mods["rules"].BurnRate("g", "t", 0.9, window, {"slo": "x"}, {"slo": "x"})
            out.append([(s.value, s.labels) for s in expr.evaluate(db)])
        vclock.advance(1.0)
    return out


def test_burn_rate_is_jax_s_on_seeded_counters_with_a_reset():
    assert _burn_rate_cases(PORT) == _burn_rate_cases(JAX)


def _for_semantics(mods):
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    r = mods["rules"]
    alert = r.AlertRule("Hot", r.Cmp(r.Select("x"), ">=", 2.0), for_seconds=3.0,
                        labels={"severity": "page"})
    gate = r.AlertRule("Gated", r.AndOn(r.Select("x"), r.Select("y")))
    evaluator = r.RuleEvaluator(db, [], alerts=[alert, gate])
    out = []
    for t, (x, y) in enumerate([(1, None), (2, None), (3, 1), (2, 1), (2, None), (0, 1),
                                (5, 1), (5, 1), (5, 1), (5, 1)]):
        db.append("x", (), float(x), ts=vclock.now())
        if y is not None:
            db.append("y", (), float(y), ts=vclock.now())
        else:
            db.mark_stale("y", (), ts=vclock.now())
        evaluator.evaluate_once()
        out.append((alert.firing, alert.firing_since, gate.firing,
                    evaluator.firing_alert_instances()))
        vclock.advance(1.0)
    return out


def test_alert_for_semantics_and_the_gate_are_jax_s():
    port = _for_semantics(PORT)
    assert port == _for_semantics(JAX)
    assert [p[0] for p in port] == [False, False, False, False, True, False, False, False,
                                    False, True]


def test_the_shipped_alerts_are_jax_s():
    port = slo.shipped_slo_alerts()
    ref = jax_slo.shipped_slo_alerts()
    assert [(a.alert, a.labels, a.annotations, a.for_seconds, a.expr.promql())
            for a in port] == [(a.alert, a.labels, a.annotations, a.for_seconds, a.expr.promql())
                               for a in ref]
    assert {a.alert for a in port} == {"SLOSignalPropagationFastBurn",
                                       "SLOSignalPropagationSlowBurn",
                                       "SLOScrapeSuccessFastBurn", "SLOScrapeSuccessSlowBurn"}
    assert [r.record for r in slo.shipped_slo_recorders()] == [
        r.record for r in jax_slo.shipped_slo_recorders()]
    assert slo.shipped_slos() == [slo.SLODefinition(**vars(d)) for d in jax_slo.shipped_slos()]
    assert slo.PROPAGATION_BUDGET_SECONDS in selfmetrics.SIGNAL_PROPAGATION_BUCKETS
    for seconds in (45.0, 300.0, 1800.0, 3600.0, 21600.0, 90.0):
        assert rules._fmt_window(seconds) == jax_rules._fmt_window(seconds)
    cmp = rules.Cmp(rules.Select("x"), "<", 0.25)
    assert cmp.promql() == jax_rules.Cmp(jax_rules.Select("x"), "<", 0.25).promql()


@pytest.mark.parametrize("kw", [
    dict(objective=1.5, source="gauge"), dict(objective=0.0, source="gauge"),
    dict(objective=0.9, source="event"), dict(objective=0.9, source="counter"),
])
def test_an_slo_definition_is_refused_with_jax_s_message(kw):
    with pytest.raises(ValueError) as got:
        slo.SLODefinition(name="bad", description="", good_series="x_bucket", **kw)
    with pytest.raises(ValueError) as want:
        jax_slo.SLODefinition(name="bad", description="", good_series="x_bucket", **kw)
    assert str(got.value) == str(want.value)


# ---- a traced pipeline: recorded series, SLO alerts ------------------------------

#: families whose values are wall-clock durations
WALL_CLOCK = {"scrape_duration_seconds", "hpa_sync_duration_seconds"} | {
    name + suffix for name in ("hpa_sync_latency_seconds", "scrape_latency_seconds",
                               "rule_eval_latency_seconds", "adapter_query_latency_seconds")
    for suffix in ("_bucket", "_sum", "_count")}


def _snapshot(db) -> dict:
    """Every recorded series at its latest value, the query engine's
    counters included, the wall-clock families left out."""
    return {(name, s.labels): s.value
            for name in db.series_names() if name not in WALL_CLOCK
            for s in db.instant_vector(name)}


def _staircase(t: float) -> float:
    """``simulate._slo_load``'s staircase, a step up every 60 s."""
    level = 20.0
    for at, value in ((60.0, 95.0), (120.0, 150.0), (180.0, 210.0), (240.0, 270.0)):
        if t >= at:
            level = value
    return level


def slo_pipeline(mods):
    """``simulate._slo_pipeline`` on one package: two nodes of 4 devices,
    the staircase traced, the pipeline's defaults."""
    vclock = mods["clock"].VirtualClock()
    tracer = mods["obs"].Tracer(vclock)
    sim = mods["cluster"].SimCluster(vclock, nodes=[("tpu-node-0", 4), ("tpu-node-1", 4)])
    dep = mods["cluster"].SimDeployment(sim, "tpu-test", "tpu-test", load_fn=_staircase,
                                        load_mode="shared")
    sim.add_deployment(dep, replicas=1)
    vclock.advance(15.0)
    base = vclock.now()
    dep.load_fn = mods["obs"].TracedLoad(lambda t: _staircase(t - base), tracer)
    pipe = mods["loop"].AutoscalingPipeline(sim, dep, tracer=tracer)
    pipe.start()
    return pipe


def _refused(name):
    def fetch():
        raise ConnectionError(f"{name}: scrape blackout (chaos)")
    return fetch


def _slo_run(mods, seconds: float, blackout: tuple[float, float] | None = None):
    """Step the SLO pipeline a second at a time; with ``blackout`` every
    scrape target refuses from its first second to its last.  Returns the
    TSDB snapshot and the firing SLO alerts after each second."""
    pipe = slo_pipeline(mods)
    saved = []
    out = []
    for second in range(1, int(seconds) + 1):
        if blackout and second == blackout[0]:
            saved = [(t, t.fetch) for t in pipe.scraper.targets]
            for t, _ in saved:
                t.fetch = _refused(t.name)
        if blackout and second == blackout[1]:
            for t, fetch in saved:
                t.fetch = fetch
        pipe.clock.advance(1.0)
        out.append((_snapshot(pipe.db), pipe.evaluator.firing_alerts()))
    return out, pipe


def test_every_recorded_series_is_jax_s_at_every_scrape():
    port, port_pipe = _slo_run(PORT, 260.0)
    ref, ref_pipe = _slo_run(JAX, 260.0)
    for second, (got, want) in enumerate(zip(port, ref), start=1):
        assert got == want, second
    final = port[-1][0]
    names = {name for name, _ in final}
    assert {"slo_good_total", "slo_events_total", "up", "signal_propagation_seconds_bucket",
            "signal_propagation_seconds_count", "rule_eval_staleness_seconds",
            "hpa_decision_total", "tpu_test_tensorcore_avg"} <= names
    assert final[("slo_events_total", (("slo", "signal-propagation"),))] >= 2.0
    assert [f for _, f in port] == [[]] * len(port)  # a clean run fires nothing
    assert port_pipe.scale_history == ref_pipe.scale_history


def test_a_scrape_blackout_fires_the_fast_alert_at_jax_s_second():
    port, _ = _slo_run(PORT, 300.0, blackout=(120, 270))
    ref, _ = _slo_run(JAX, 300.0, blackout=(120, 270))
    firing = [f for _, f in port]
    assert firing == [f for _, f in ref]
    first = {}
    for second, names in enumerate(firing, start=1):
        for name in names:
            first.setdefault(name, second)
    assert first.get("SLOScrapeSuccessFastBurn", 10**6) - 120 <= 60
    assert all(second > 120 for second in first.values())
    assert [s for s, _ in port] == [s for s, _ in ref]


# ---- the doctor's self-metrics probe ------------------------------------------


def _payload(results) -> str:
    return json.dumps({"status": "success", "data": {"result": results}})


def test_the_probe_passes_on_the_port_s_traced_pipeline():
    """The pipeline-self target lands in the TSDB; the probe passes on the
    self-metric series read from it, as Prometheus would answer
    ``SELF_METRICS_QUERY``."""
    pipe = slo_pipeline(PORT)
    pipe.clock.advance(120.0)
    assert any(t.name == selfmetrics.SELF_TARGET_NAME for t in pipe.scraper.targets)
    results = [{"metric": {"__name__": name, **dict(s.labels)}, "value": [0, str(s.value)]}
               for name in selfmetrics.SELF_METRIC_NAMES for s in pipe.db.instant_vector(name)]
    detail = f"all 10 self-metric families fresh ({len(results)} series)"
    assert doctor.check_self_metrics(_payload(results)) == detail
    assert jax_doctor.check_self_metrics(_payload(results)) == detail
    families = {f.name: f for f in exposition.parse_text(pipe.selfmetrics.exposition())}
    for name in selfmetrics.SELF_METRIC_NAMES:
        assert families[name].samples, name
    assert doctor.SELF_METRICS_QUERY == '{__name__=~"%s"}' % "|".join(
        selfmetrics.SELF_METRIC_NAMES)


def test_the_probe_flags_what_jax_s_flags():
    for results, match in (
        ([], "no pipeline self-metric"),
        ([{"metric": {"__name__": "hpa_sync_duration_seconds"}, "value": [0, "0.01"]}],
         "missing or stale"),
        ([{"metric": {"__name__": n, "target": "exporter/n0", "rule": "r",
                      "reason": "scale_up"}, "value": [0, "1"]}
          for n in jax_selfmetrics.SELF_METRIC_NAMES], "pipeline-self"),
    ):
        for check in (doctor.check_self_metrics, jax_doctor.check_self_metrics):
            with pytest.raises(AssertionError, match=match):
                check(_payload(results))
    failed = json.dumps({"status": "error", "error": "bad query"})
    with pytest.raises(AssertionError) as got:
        doctor.check_self_metrics(failed)
    with pytest.raises(AssertionError) as want:
        jax_doctor.check_self_metrics(failed)
    assert str(got.value) == str(want.value)
