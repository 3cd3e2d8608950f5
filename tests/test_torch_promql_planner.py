"""The PromQL front end (``metrics/promql.py``) and the query planner
(``metrics/planner.py``) against the JAX package's.

- Every recording and alert rule the port ships (``manifests``' rule
  groups, ``shipped_alert_rules``, the SLO alerts) parses through
  ``parse`` back to its own AST and through ``parse_query`` to the same
  ``promql()`` as JAX's; the query-only constructs parse to JAX's
  renderings, and what JAX's parser refuses the port's refuses with the
  same message.
- Planned and naive evaluation are bit-identical (same length, order,
  labels and float bits) on seeded TSDB layouts (several sealed chunks a
  series, NaN markers, a live head, windows cutting mid-chunk, a series
  created after planning), generated with hypothesis as
  tests/test_promql.py generates them with ``random``, and the planned
  vectors and the planner's counters are JAX's.
- ``explain`` renders JAX's text for every shipped rule and the basket, and
  ``planner_selfcheck`` returns JAX's dict.

Tolerance: exact.
"""

import math
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_gpu_hpa_tpu.metrics import planner as jax_planner
from k8s_gpu_hpa_tpu.metrics import promql as jax_promql
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch.control.scale_harness import _vectors_identical
from k8s_gpu_hpa_tpu_torch.manifests import shipped_rule_groups
from k8s_gpu_hpa_tpu_torch.metrics import planner, promql, rules, tsdb
from k8s_gpu_hpa_tpu_torch.obs.slo import shipped_slo_alerts
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(planner=planner, promql=promql, rules=rules, tsdb=tsdb, clock=clock)
JAX = dict(planner=jax_planner, promql=jax_promql, rules=jax_rules, tsdb=jax_tsdb,
           clock=jax_clock)


def _shipped():
    out = [(f"{group}/{rule.record}", rule.expr)
           for group, group_rules in shipped_rule_groups() for rule in group_rules]
    out += [(f"alert/{a.alert}", a.expr)
            for a in rules.shipped_alert_rules() + shipped_slo_alerts()]
    return out


SHIPPED = _shipped()


@pytest.mark.parametrize("expr", [e for _, e in SHIPPED], ids=[n for n, _ in SHIPPED])
def test_each_shipped_rule_parses_to_jax_s_promql(expr):
    text = expr.promql()
    assert promql.parse(text) == expr
    assert promql.parse_query(text) == expr
    assert promql.parse_query(text).promql() == jax_promql.parse_query(text).promql() == text
    assert jax_promql.parse(text).promql() == text


QUERIES = [
    "rate(m[5m])",
    'sum by(reason)(increase(decisions_total{job="hpa"}[1h]))',
    'max by(pod)(m{pod!=""})',
    'count(ALERTS{alertname=~"Tpu.+",alertstate="firing"}) or vector(0)',
    "sum(held) or vector(0)",
    "histogram_quantile(0.5, sum by(le)(rate(h_bucket[5m])))",
    "histogram_quantile(0.99, h_bucket)",
    'increase(m{state!~"idle"}[5m])',
    "avg_over_time(m[5m])",
    '(sum(a_sum{job="x"})) / (sum(a_count{job="x"}))',
    "min by(shard)(m)",
]


@pytest.mark.parametrize("text", QUERIES)
def test_the_query_subset_renders_as_jax_s(text):
    got = promql.parse_query(text)
    assert got.promql() == jax_promql.parse_query(text).promql() == text
    assert type(got).__name__ == type(jax_promql.parse_query(text)).__name__


BAD = [
    ("m + n", False), ("m * n", False), ("avg(m) extra", False),
    ("(1 - (increase(g[5m]) / increase(t[6m]))) / 0.05", False), ("avg(m", False),
    ('m{job=~"x"}', False), ("3", False), ("rate(m[5m])", False),
    ("sum(m) or vector(0)", False), ("increase(m[5m])", False),
    ("rate(m[5m]) or vector", True), ('avg_over_time(m{pod!=""}[5m])', True),
    ("or vector(0)", True), ("rate(sum(m)[5m])", True), ("m $ 2", True),
]


@pytest.mark.parametrize("text,query", BAD)
def test_what_jax_s_parser_refuses_the_port_s_refuses_alike(text, query):
    fn = "parse_query" if query else "parse"
    with pytest.raises(promql.PromQLError) as got:
        getattr(promql, fn)(text)
    with pytest.raises(jax_promql.PromQLError) as want:
        getattr(jax_promql, fn)(text)
    assert str(got.value) == str(want.value)
    assert promql.parse_duration("6h") == jax_promql.parse_duration("6h") == 21600.0


def lbl(**kw):
    return tuple(sorted(kw.items()))


def _random_db(mods, seed: int, downsample=None):
    """tests/test_promql.py's layout: chunk_size 16, so ~200 ticks seal
    ~12 chunks a series; scrape gaps, NaN markers, a live head.  The draws
    are made once, with ``random.Random(seed)``, and fed to each package.
    ``downsample`` is a DownsamplePolicy of the package's, or None."""
    rng = random.Random(seed)
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock, lookback=300.0, retention=86400.0, chunk_size=16,
                                   downsample=downsample)
    pods = [f"p{i}" for i in range(rng.randint(3, 7))]
    for _ in range(rng.randint(150, 220)):
        vclock.advance(rng.choice((1.0, 5.0, 5.0, 15.0)))
        for i, pod in enumerate(pods):
            if rng.random() < 0.15:
                continue
            value = float("nan") if rng.random() < 0.08 else rng.uniform(0.0, 100.0)
            db.append("m", lbl(pod=pod, shard=str(i % 2), job="fleet"), value)
    return db, pods, rng


def _basket(mods, window: float):
    r = mods["rules"]
    return [
        r.Select("m", {}),
        r.Select("m", {"shard": "0"}),
        r.Avg(r.Select("m", {"job": "fleet"})),
        r.MaxBy(("pod",), r.Select("m", {})),
        r.Aggregate("sum", r.Select("m", {})),
        r.AggregateBy("sum", ("shard",), r.Select("m", {})),
        r.AvgOverTime("m", window, {}),
        r.Avg(r.AvgOverTime("m", window, {"shard": "1"})),
        r.Cmp(r.Avg(r.Select("m", {})), ">", 50.0),
        r.Ratio(r.Aggregate("sum", r.Select("m", {})), r.Aggregate("count", r.Select("m", {}))),
    ]


def _run(mods, seed: int, window: float):
    """Both evaluations of the basket, before and after more points and a
    series created after planning; returns the planned vectors, whether
    each agreed with the naive one bit for bit, and the planner's stats."""
    db, pods, rng = _random_db(mods, seed)
    qp = mods["planner"].QueryPlanner(db)
    exprs = _basket(mods, window)
    plans = [qp.plan(e) for e in exprs]
    out, agree = [], []
    for phase in range(2):
        if phase:
            for _ in range(40):
                db.clock.advance(5.0)
                for i, pod in enumerate(pods):
                    db.append("m", lbl(pod=pod, shard=str(i % 2), job="fleet"),
                              rng.uniform(0.0, 100.0))
            db.append("m", lbl(pod="late-joiner", shard="0", job="fleet"), 42.0)
        for expr, plan in zip(exprs, plans):
            naive, planned = expr.evaluate(db), plan.evaluate(db)
            agree.append(_vectors_identical(naive, planned))
            out.append([(s.labels, np.float64(s.value).view(np.uint64).item()) for s in planned])
    s = qp.stats
    return out, agree, (s.fastpath, s.fallback, s.series_cache_hits, s.series_resolves,
                        s.plans_built, db.decode_cache_hits, db.decode_cache_misses)


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(st.integers(min_value=0, max_value=10_000), st.sampled_from([120.0, 300.0, 700.0]))
def test_planned_is_bit_identical_to_naive_and_to_jax_s(seed, window):
    port = _run(PORT, seed, window)
    ref = _run(JAX, seed, window)
    assert all(port[1]) and all(ref[1])
    assert port == ref
    fastpath, fallback = port[2][:2]
    assert fastpath > 0 and fallback > 0  # both range paths ran


def _jax_expr(expr):
    return jax_promql.parse(expr.promql())


def test_explain_is_jax_s_for_every_shipped_rule_and_the_basket():
    port_db, _, _ = _random_db(PORT, 5)
    ref_db, _, _ = _random_db(JAX, 5)
    port_qp, ref_qp = planner.QueryPlanner(port_db), jax_planner.QueryPlanner(ref_db)
    exprs = [e for _, e in SHIPPED] + _basket(PORT, 300.0)
    for expr in exprs:
        text = port_qp.explain(expr)
        assert text == ref_qp.explain(_jax_expr(expr)), expr.promql()
    assert "RangeAgg avg_over_time[300s] m  [chunk-summary pushdown" in port_qp.explain(
        exprs[-4])


def _tiered_db(mods, ds):
    """``_random_db`` with 1m/5m rollup tiers, its clock then moved to an
    instant aligned to 5 minutes, and every pod written on for 15 minutes
    past it (explicit timestamps), so the tiers cover that instant and a
    20-minute window read there is served from them."""
    db, pods, _ = _random_db(mods, 99, ds.DownsamplePolicy(steps=(60.0, 300.0), horizon=120.0))
    at = (math.floor(db.clock.now() / 300.0) + 1) * 300.0
    for k in range(1, 61):
        for i, pod in enumerate(pods):
            db.append("m", lbl(pod=pod, shard=str(i % 2), job="fleet"), float(k % 7 + i),
                      ts=at + 15.0 * k)
    db.clock.advance(at - db.clock.now())
    return db


def test_planner_selfcheck_and_its_rollup_counters_are_jax_s_on_a_downsampling_db():
    from k8s_gpu_hpa_tpu.metrics import downsample as jax_downsample
    from k8s_gpu_hpa_tpu_torch.metrics import downsample

    port_db, ref_db = _tiered_db(PORT, downsample), _tiered_db(JAX, jax_downsample)
    port_rules = [r for _, group in shipped_rule_groups() for r in group] + [
        rules.RecordingRule("m_avg", rules.Avg(rules.AvgOverTime("m", 1200.0))),
        # a window no tier divides: the raw path and its chunk-summary pushdown
        rules.RecordingRule("m_avg_raw", rules.Avg(rules.AvgOverTime("m", 1190.0))),
        rules.RecordingRule("m_by_shard", rules.AggregateBy("avg", ("shard",),
                                                            rules.Select("m"))),
    ]
    ref_rules = [jax_rules.RecordingRule(r.record, _jax_expr(r.expr), dict(r.labels))
                 for r in port_rules]
    got = planner.planner_selfcheck(port_db, port_rules)
    assert got == jax_planner.planner_selfcheck(ref_db, ref_rules)
    assert got["agree_all"] is True and got["fastpath"] > 0
    assert got["rollup_reads"] == {"5m": 1} and got["rollup_fallbacks"] == 0
