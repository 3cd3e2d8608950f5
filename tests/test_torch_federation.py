"""The sharded scrape plane and TSDB federation (``metrics/federation.py``)
against the JAX package's.

- ``HashRing`` places every key on JAX's shard, for several shard and
  virtual-node counts, and refuses zero shards alike.
- ``ShardedScrapePlane`` registers each target on JAX's shard, its
  ``shard_status`` is JAX's, and a sharded scrape ingests what one scraper
  would; the shards' pre-reductions and the federated ``Ratio`` record
  JAX's fleet average (the port's shards run their rules one after
  another; JAX's plane runs them on its thread pool), over 2 and 4 shards.
- ``FederatedTSDB``'s reads are JAX's: instant vectors, ``latest`` and its
  ambiguity error, ``range_avg`` with the pushdown, the read capture's
  fan-out, the summed versions and generations, the exemplars and the
  storage counters.
- The sharded pipeline: the shipped HPA's scenarios over 2 shards give
  JAX's reports and query-engine counters, the traced spike JAX's spans
  with complete lineages, ``restart_tsdb`` raises JAX's error, and the
  doctor's ``check_shards`` says what JAX's says on a healthy and on each
  broken topology.

Tolerance: exact.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from k8s_gpu_hpa_tpu import doctor as jax_doctor
from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.control import cluster as jax_cluster
from k8s_gpu_hpa_tpu.control import loop as jax_loop
from k8s_gpu_hpa_tpu.control import scale_harness as jax_harness
from k8s_gpu_hpa_tpu.metrics import federation as jax_federation
from k8s_gpu_hpa_tpu.metrics import planner as jax_planner
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch import doctor, simulate
from k8s_gpu_hpa_tpu_torch.control import cluster, loop
from k8s_gpu_hpa_tpu_torch.control import scale_harness
from k8s_gpu_hpa_tpu_torch.manifests import load_yaml
from k8s_gpu_hpa_tpu_torch.metrics import federation, planner, rules, schema, tsdb
from k8s_gpu_hpa_tpu_torch.obs import index_spans, lineage_of
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_simulate import assert_reports_alike
from tests.test_torch_trace import assert_traces_equal

torch.set_num_threads(1)

PORT = dict(federation=federation, rules=rules, schema=schema, tsdb=tsdb, clock=clock,
            planner=planner, cluster=cluster, loop=loop)
JAX = dict(federation=jax_federation, rules=jax_rules, schema=jax_schema, tsdb=jax_tsdb,
           clock=jax_clock, planner=jax_planner, cluster=jax_cluster, loop=jax_loop)


@pytest.mark.parametrize("shards,vnodes", [(1, 64), (3, 64), (4, 64), (8, 64), (5, 7)])
def test_the_ring_places_keys_as_jax_s(shards, vnodes):
    port = federation.HashRing(shards, vnodes)
    ref = jax_federation.HashRing(shards, vnodes)
    keys = [f"fleet/synt-{i:05d}" for i in range(2000)] + [
        "kube-state-metrics", "pipeline-self", "exporter/tpu-node-0", ""]
    assert [port.shard_for(k) for k in keys] == [ref.shard_for(k) for k in keys]
    assert (port._hashes, port._owners) == (ref._hashes, ref._owners)


def test_zero_shards_is_refused_as_jax_s():
    with pytest.raises(ValueError) as got:
        federation.HashRing(0)
    with pytest.raises(ValueError) as want:
        jax_federation.HashRing(0)
    assert str(got.value) == str(want.value)


def _gauge_fetch(mods, name: str, value: float):
    def fetch():
        fam = mods["schema"].MetricFamily("fleet_duty_cycle", "gauge")
        fam.add(value, job="fleet", instance=name)
        return [fam]

    return fetch


def _plane(mods, shards: int, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    vclock = mods["clock"].VirtualClock()
    plane = mods["federation"].ShardedScrapePlane(vclock, shards, interval=15.0)
    for i in range(n):
        plane.add_target(_gauge_fetch(mods, f"fleet/synt-{i:03d}",
                                      float(rng.uniform(0, 100))), name=f"fleet/synt-{i:03d}")
    return vclock, plane


def _dump(db) -> dict:
    return {name: sorted((s.labels, s.value) for s in db.instant_vector(name))
            for name in db.series_names()}


@pytest.mark.parametrize("shards", [2, 4])
def test_the_plane_s_shard_status_and_ingest_are_jax_s(shards):
    (pc, port), (jc, ref) = _plane(PORT, shards, 60), _plane(JAX, shards, 60)
    assert port.shard_status() == ref.shard_status()
    assert port.shard_status_json() == ref.shard_status_json()
    for vclock, plane in ((pc, port), (jc, ref)):
        vclock.advance(15.0)
        plane.scrape_once()
    assert [_dump(db) for db in port.shard_dbs] == [_dump(db) for db in ref.shard_dbs]
    assert [t.name for t in port.targets] == [t.name for t in ref.targets]
    assert sum(1 for db in port.shard_dbs if db.series_count()) > 1
    # one scraper over one DB ingests the same samples
    single_clock = clock.VirtualClock()
    single_db = tsdb.TimeSeriesDB(single_clock)
    single = tsdb.Scraper(single_db, interval=15.0)
    rng = np.random.default_rng(0)
    for i in range(60):
        single.add_target(_gauge_fetch(PORT, f"fleet/synt-{i:03d}", float(rng.uniform(0, 100))),
                          name=f"fleet/synt-{i:03d}")
    single_clock.advance(15.0)
    single.scrape_once()
    fed = federation.FederatedTSDB(tsdb.TimeSeriesDB(pc), port.shard_dbs)
    assert _dump(fed) == _dump(single_db)
    target = port.targets[5]
    port.remove_target(target)
    assert target.name not in [t.name for t in port.targets]


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_pre_reductions_and_the_federated_ratio_are_jax_s(shards):
    got = []
    for mods in (PORT, JAX):
        vclock, plane = _plane(mods, shards, 80, seed=1)
        harness = scale_harness if mods is PORT else jax_harness
        plane.add_shard_rules(harness.fleet_shard_rules)
        fed = mods["federation"].FederatedTSDB(mods["tsdb"].TimeSeriesDB(vclock),
                                               plane.shard_dbs)
        federated = harness.fleet_federated_rule()
        evaluator = mods["rules"].RuleEvaluator(fed, [federated],
                                                planner=mods["planner"].QueryPlanner(fed))
        out = []
        for _ in range(3):
            vclock.advance(15.0)
            plane.scrape_once()
            plane.evaluate_rules_once()
            evaluator.evaluate_once()
            out.append(fed.latest("fleet_duty_cycle_avg", {"deployment": "fleet"}))
        got.append((out, _dump(fed)))
    assert got[0] == got[1]
    plain = [v for v in got[0][1]["fleet_duty_cycle"]]
    assert math.isclose(got[0][0][-1], sum(v for _, v in plain) / len(plain), rel_tol=1e-12)


def _fed(mods, seed: int):
    """A global DB and two shard DBs, fed the same seeded points: each
    shard its own instances, the global DB the recorded series."""
    rng = np.random.default_rng(seed)
    vclock = mods["clock"].VirtualClock()
    shard_dbs = [mods["tsdb"].TimeSeriesDB(vclock, retention=1800.0) for _ in range(2)]
    fed = mods["federation"].FederatedTSDB(mods["tsdb"].TimeSeriesDB(vclock), shard_dbs)
    Exemplar = mods["schema"].Exemplar
    for tick in range(300):
        vclock.advance(float(rng.choice([1.0, 5.0])))
        for i in range(6):
            value = math.nan if rng.random() < 0.05 else float(rng.uniform(0, 100))
            shard_dbs[i % 2].append("m", (("instance", f"i{i}"), ("job", "fleet")), value,
                                    origin=int(rng.integers(1, 99)))
        ex = Exemplar(0.5, tick + 1, tick + 1, vclock.now()) if tick % 7 == 0 else None
        shard_dbs[tick % 2].append("h_bucket", (("le", "1"),), float(tick), exemplar=ex)
        fed.append("rec", (("deployment", "fleet"),), float(rng.uniform(0, 100)))
    return fed


def test_the_federated_reads_are_jax_s():
    port, ref = _fed(PORT, 3), _fed(JAX, 3)
    now = port.clock.now()
    assert _dump(port) == _dump(ref)
    for at in (now, now - 100.0, now - 400.0):
        for matchers in (None, {"instance": "i3"}, {"job": "fleet"}):
            assert [(s.labels, s.value) for s in port.instant_vector("m", matchers, at)] == [
                (s.labels, s.value) for s in ref.instant_vector("m", matchers, at)]
            pstats, jstats = planner.PlannerStats(), jax_planner.PlannerStats()
            port.begin_capture()
            ref.begin_capture()
            got = [(s.labels, s.value) for s in port.range_avg(
                "m", matchers, 300.0, at, use_summaries=True, stats=pstats)]
            want = [(s.labels, s.value) for s in ref.range_avg(
                "m", matchers, 300.0, at, use_summaries=True, stats=jstats)]
            assert got == want and port.end_capture() == ref.end_capture()
            assert (pstats.fastpath, pstats.fallback) == (jstats.fastpath, jstats.fallback)
    assert port.latest("rec", {"deployment": "fleet"}) == ref.latest("rec", {"deployment": "fleet"})
    for db in (port, ref):
        with pytest.raises(ValueError, match="matched 6 series"):
            db.latest("m")
    for name in ("m", "h_bucket", "rec", "absent"):
        assert port.version(name) == ref.version(name)
        assert port.series_generation(name) == ref.series_generation(name)
    assert {k: (e.value, e.span_id, e.ts) for k, e in port.exemplars_of("h_bucket").items()} == {
        k: (e.value, e.span_id, e.ts) for k, e in ref.exemplars_of("h_bucket").items()}
    ex, jex = port.exemplar("h_bucket", (("le", "1"),)), ref.exemplar("h_bucket", (("le", "1"),))
    assert (ex.value, ex.span_id, ex.ts) == (jex.value, jex.span_id, jex.ts)
    assert port.exemplar("m", (("instance", "i0"),)) is None
    for attr in ("total_points", "total_appends", "retained_bytes", "series_count",
                 "series_names", "gc"):
        assert getattr(port, attr)() == getattr(ref, attr)(), attr
    assert (port.decode_cache_hits, port.decode_cache_misses) == (
        ref.decode_cache_hits, ref.decode_cache_misses)
    assert (port.lookback, port.retention, port.wal, port.last_recovery) == (
        ref.lookback, ref.retention, None, None)


HPA_DOC = "deploy/tpu-test-hpa.yaml"


@pytest.mark.parametrize("scenario", ["spike", "outage", "crash"])
def test_the_sharded_pipeline_plays_as_jax_s(scenario):
    repo = Path(__file__).resolve().parent.parent
    text = (repo / HPA_DOC).read_text()
    port = simulate.run_scenario(load_yaml(text), scenario, shards=2, duration=240.0)
    ref = jax_simulate.run_scenario(yaml.safe_load(text), scenario, shards=2, duration=240.0)
    assert_reports_alike(port, ref)
    assert port.query_engine == ref.query_engine
    assert port.query_engine["series_cache_hits"] > 0


def test_the_sharded_traced_spike_is_jax_s_with_complete_lineages():
    text = (Path(__file__).resolve().parent.parent / HPA_DOC).read_text()
    port = simulate.run_scenario(load_yaml(text), "spike", duration=150.0, trace=True,
                                 shards=2, explain=True)
    ref = jax_simulate.run_scenario(yaml.safe_load(text), "spike", duration=150.0, trace=True,
                                    shards=2, explain=True)
    assert_traces_equal(port.tracer.spans, ref.tracer.spans)
    assert port.plan_explain == ref.plan_explain and "IndexScan" in port.plan_explain
    events = port.tracer.spans_of("scale_event")
    by_id = index_spans(port.tracer.spans)
    assert events and all(lineage_of(ev, by_id)["complete"] for ev in events)


def test_a_sharded_pipeline_refuses_restart_tsdb_as_jax_s():
    errors = []
    for mods in (PORT, JAX):
        vclock = mods["clock"].VirtualClock()
        sim = mods["cluster"].SimCluster(vclock, nodes=[("n0", 4)])
        dep = mods["cluster"].SimDeployment(sim, "tpu-test", "tpu-test", load_fn=lambda t: 50.0)
        sim.add_deployment(dep, replicas=1)
        vclock.advance(15.0)
        pipe = mods["loop"].AutoscalingPipeline(sim, dep, scrape_shards=2)
        with pytest.raises(RuntimeError) as err:
            pipe.restart_tsdb()
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "shard" in errors[0]


def _statuses() -> list[dict]:
    healthy = _plane(PORT, 3, 20)[1].shard_status()
    out = [healthy, {"shards": [], "fleet": []}]
    down = json.loads(json.dumps(healthy))
    down["shards"][1]["reachable"] = False
    twice = json.loads(json.dumps(healthy))
    twice["shards"][0]["targets"].append(twice["shards"][2]["targets"][0])
    orphan = json.loads(json.dumps(healthy))
    orphan["fleet"].append("fleet/never-owned")
    return out + [down, twice, orphan]


@pytest.mark.parametrize("case", range(5), ids=["healthy", "empty", "down", "twice", "orphan"])
def test_check_shards_says_what_jax_s_says(case):
    payload = json.dumps(_statuses()[case])
    outcomes = []
    for fn in (doctor.check_shards, jax_doctor.check_shards):
        try:
            outcomes.append((True, fn(payload)))
        except AssertionError as e:
            outcomes.append((False, str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == (case == 0)


# ---- the plane's knobs: lookback, retention, chunk_size, ring, rule sinks ----

KNOB_SHARDS = 3


def _knob_fetch(mods, i: int, vclock):
    """Target ``i``'s gauge, moving with the clock so every scrape writes a
    new point."""

    def fetch():
        fam = mods["schema"].MetricFamily("fleet_duty_cycle", "gauge")
        fam.add(float((i * 37 + int(vclock.now()) * 13) % 101), job="fleet",
                instance=f"fleet/synt-{i:03d}")
        return [fam]

    return fetch


def _knob_plane(mods, n: int = 40, ticks: int = 60):
    vclock = mods["clock"].VirtualClock()
    ring = mods["federation"].HashRing(KNOB_SHARDS, vnodes=16)
    plane = mods["federation"].ShardedScrapePlane(
        vclock, KNOB_SHARDS, interval=5.0, lookback=60.0, retention=120.0, chunk_size=16,
        ring=ring)
    for i in range(n):
        plane.add_target(_knob_fetch(mods, i, vclock), name=f"fleet/synt-{i:03d}")
    for _ in range(ticks):
        vclock.advance(5.0)
        plane.scrape_once()
    return vclock, plane


def _retained(db) -> dict:
    """Every series' retained points and timestamps, decoded, and its
    sealed chunk count."""
    return {(name, labels): (series.points, series.ts, len(series.chunks))
            for name, by_labels in db._data.items() for labels, series in by_labels.items()}


def test_the_plane_s_lookback_retention_chunks_and_ring_are_jax_s():
    """A small fleet scraped for 300 s under retention 120, chunks of 16 and
    a ring of 16 virtual nodes a shard: the series, the ring's ownership and
    every retained point equal JAX's."""
    (pc, port), (jc, ref) = _knob_plane(PORT), _knob_plane(JAX)
    assert [(db.lookback, db.retention, db.chunk_size) for db in port.shard_dbs] == [
        (db.lookback, db.retention, db.chunk_size) for db in ref.shard_dbs] == [
        (60.0, 120.0, 16)] * KNOB_SHARDS
    assert (port.ring.vnodes, port.interval, port.clock) == (16, 5.0, pc)
    assert (port.ring._hashes, port.ring._owners) == (ref.ring._hashes, ref.ring._owners)
    assert port.shard_status() == ref.shard_status()
    assert [port.shard_of(t) for t in port.targets] == [ref.shard_of(t) for t in ref.targets]
    assert [_dump(db) for db in port.shard_dbs] == [_dump(db) for db in ref.shard_dbs]
    got, want = [_retained(db) for db in port.shard_dbs], [_retained(db) for db in ref.shard_dbs]
    assert got == want
    # retention dropped whole sealed chunks: 60 points were scraped a series
    for shard in got:
        for points, ts, chunks in shard.values():
            assert len(points) < 60 and ts == [p[0] for p in points] and chunks >= 1
    for at in (pc.now(), pc.now() - 50.0, pc.now() - 100.0):
        for db, jdb in zip(port.shard_dbs, ref.shard_dbs):
            for labels, series in db._data["fleet_duty_cycle"].items():
                want_series = jdb._data["fleet_duty_cycle"][labels]
                assert series.latest_at(at, db.lookback) == want_series.latest_at(
                    at, jdb.lookback)


def test_a_ring_of_other_shards_is_refused_as_jax_s():
    errors = []
    for mods in (PORT, JAX):
        with pytest.raises(ValueError) as err:
            mods["federation"].ShardedScrapePlane(
                mods["clock"].VirtualClock(), 3, ring=mods["federation"].HashRing(4))
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "ring has 4 shards, plane wants 3"


def test_shard_rules_take_jax_s_interval_tracer_and_selfmetrics():
    """``add_shard_rules(interval=, tracer=, selfmetrics=)``: each shard's
    evaluator carries them, the sinks send the pass down the serial loop in
    both packages, and the records and the spans are JAX's."""
    from k8s_gpu_hpa_tpu.obs import selfmetrics as jax_selfmetrics
    from k8s_gpu_hpa_tpu.obs import trace as jax_trace
    from k8s_gpu_hpa_tpu_torch.obs import selfmetrics as port_selfmetrics
    from k8s_gpu_hpa_tpu_torch.obs import trace as port_trace

    out = []
    for mods, harness, trace, selfm in ((PORT, scale_harness, port_trace, port_selfmetrics),
                                        (JAX, jax_harness, jax_trace, jax_selfmetrics)):
        vclock, plane = _plane(mods, 3, 50, seed=4)
        tracer = trace.Tracer(vclock)
        sink = selfm.PipelineSelfMetrics(clock=vclock)
        plane.add_shard_rules(harness.fleet_shard_rules, interval=5.0, tracer=tracer,
                              selfmetrics=sink)
        evaluators = [ev for ev in plane.shard_evaluators if ev is not None]
        assert [(ev.interval, ev.tracer, ev.selfmetrics) for ev in evaluators] == [
            (5.0, tracer, sink)] * len(evaluators)
        for _ in range(3):
            vclock.advance(15.0)
            plane.scrape_once()
            plane.evaluate_rules_once()
        kinds = sorted(s.kind for s in tracer.spans)
        out.append(([_dump(db) for db in plane.shard_dbs], kinds))
    assert out[0] == out[1]
    assert "rule_eval" in out[0][1]
