"""The downsampled rollup tiers (``metrics/downsample.py`` and the TSDB's
rollup members) against the JAX package's.

The contracts of tests/test_downsample.py, each on the same seeded appends
(numpy) through both packages:

- the policy refuses what JAX's refuses, with its message; tier labels and
  bucket ends are JAX's;
- the rollup rows equal a pure-Python fold and JAX's rows; a bucket of NaN
  markers alone emits no row while coverage moves past it;
- a rollup read equals its raw twin (``range_avg_bucketed``) bit for bit,
  over seeds, and both equal JAX's; the reads that cannot be faithful fall
  back (None) where JAX's do, and a series born after the window does not
  force one;
- the planner picks the coarsest aligned tier, and its ``rollup_reads``,
  ``rollup_fallbacks`` and rollup chunk counters are JAX's;
- compact on evict, rollup retention and the storage stats are JAX's;
- a federated read merges the shards' tiers as JAX's does;
- the sealed rollup chunks' blobs (and the tier heads) are JAX's byte for
  byte, at a chunk size small enough that chunks seal.

Tolerance: exact (the same float operations in the same order).
"""

import math

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.control import scale_harness as jax_harness
from k8s_gpu_hpa_tpu.metrics import downsample as jax_downsample
from k8s_gpu_hpa_tpu.metrics import federation as jax_federation
from k8s_gpu_hpa_tpu.metrics import planner as jax_planner
from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch.control import scale_harness
from k8s_gpu_hpa_tpu_torch.metrics import downsample, federation, planner, rules, tsdb
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(ds=downsample, tsdb=tsdb, clock=clock, planner=planner, rules=rules,
            federation=federation, harness=scale_harness)
JAX = dict(ds=jax_downsample, tsdb=jax_tsdb, clock=jax_clock, planner=jax_planner,
           rules=jax_rules, federation=jax_federation, harness=jax_harness)
BOTH = (PORT, JAX)

#: tiers sized so a few hundred 5 s appends compact: 1m/5m buckets, raw
#: chunks aged 2 minutes past the newest append are ingested
POLICY = dict(steps=(60.0, 300.0), horizon=120.0)


def lbl(**kw):
    return tuple(sorted(kw.items()))


def _db(mods, policy=POLICY, chunk_size=4, lookback=300.0, retention=10**9):
    return mods["tsdb"].TimeSeriesDB(
        mods["clock"].VirtualClock(), lookback=lookback, retention=retention,
        chunk_size=chunk_size, downsample=mods["ds"].DownsamplePolicy(**policy))


def _values(n: int, seed: int, nan_share: float = 0.0) -> list[float]:
    """``n`` seeded values with one to three decimals, NaN markers on a
    drawn ``nan_share`` of them."""
    rng = np.random.default_rng(seed)
    out = []
    for v, digits, mark in zip(rng.uniform(-5.0, 100.0, n), rng.integers(0, 4, n),
                               rng.random(n)):
        out.append(math.nan if mark < nan_share else float(np.round(v, int(digits))))
    return out


def _pure_fold(points, step):
    """The bucket rows a straight pass over ``(ts, value)`` pairs gives, in
    append order: the oracle both storages must reproduce bit for bit."""
    buckets: dict[float, list] = {}
    for ts, v in points:
        end = math.ceil(ts / step) * step
        b = buckets.setdefault(end, [0, 0.0, math.inf, -math.inf, math.nan])
        if v == v:
            b[0] += 1
            b[1] += v
            b[2] = min(b[2], v)
            b[3] = max(b[3], v)
            b[4] = v
    return {end: tuple(b) for end, b in buckets.items() if b[0]}


def _pairs(vec):
    return None if vec is None else sorted((s.labels, s.value) for s in vec)


def _rows(db, step, name="m"):
    return [(labels, rows) for labels, rows in db.rollup_rows(name, step=step)]


def _error(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


# ---- the policy and the bucket grammar ----------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(steps=()), dict(steps=(300.0, 60.0)), dict(steps=(0.0,)), dict(horizon=0.0),
    dict(retention=600.0),
], ids=["no-steps", "descending", "zero-step", "zero-horizon", "short-retention"])
def test_the_policy_refuses_what_jax_s_refuses(kw):
    got = [_error(lambda m=mods: m["ds"].DownsamplePolicy(**kw)) for mods in BOTH]
    assert got[0] == got[1]
    assert downsample.DownsamplePolicy() == downsample.DownsamplePolicy(
        steps=(300.0, 3600.0), horizon=1800.0, retention=7 * 86400.0)
    assert downsample.DownsamplePolicy().labels() == jax_downsample.DownsamplePolicy().labels()


def test_tier_labels_and_bucket_ends_are_jax_s():
    for step in (300.0, 3600.0, 7200.0, 45.0, 60.0, 90.0, 86400.0):
        assert downsample.tier_label(step) == jax_downsample.tier_label(step)
    assert [downsample.tier_label(s) for s in (300.0, 3600.0, 7200.0, 45.0)] == [
        "5m", "1h", "2h", "45s"]
    rng = np.random.default_rng(7)
    for ts in [60.0, 60.0001, 59.9, *rng.uniform(0.0, 10_000.0, 50).tolist()]:
        for step in (60.0, 300.0, 3600.0):
            assert downsample.bucket_end(ts, step) == jax_downsample.bucket_end(ts, step)
    # left-open right-closed: a boundary point closes its bucket
    assert downsample.bucket_end(60.0, 60.0) == 60.0
    assert downsample.bucket_end(60.0001, 60.0) == 120.0


# ---- the bucket rows on a live DB --------------------------------------------------


def test_rollup_rows_equal_a_pure_python_fold_and_jax_s():
    values = _values(400, seed=1)
    points = [(5.0 * (i + 1), v) for i, v in enumerate(values)]
    dbs = []
    for mods in BOTH:
        db = _db(mods)
        for ts, v in points:
            db.append("m", lbl(pod="p0"), v, ts=ts)
        dbs.append(db)
    port, ref = dbs
    for ti, step in enumerate(POLICY["steps"]):
        tier = port._data["m"][lbl(pod="p0")].rollup.tiers[ti]
        assert tier.covered_through > 0
        assert tier.covered_through == ref._data["m"][lbl(pod="p0")].rollup.tiers[ti].covered_through
        stored = {row[0]: row[1:] for _, rows in _rows(port, step) for row in rows}
        expected = _pure_fold(points, step)
        assert stored == {end: row for end, row in expected.items()
                          if end <= tier.covered_through}
        assert _rows(port, step) == _rows(ref, step)
    # at a 5 s cadence the point at ts=60 closes the bucket ending at 60
    assert _pure_fold(points, 60.0)[60.0][0] == 12


def test_a_nan_only_bucket_drops_its_row_but_coverage_moves_on():
    got = []
    for mods in BOTH:
        db = _db(mods, policy=dict(steps=(60.0,), horizon=120.0))
        for i in range(60):
            ts = 10.0 * (i + 1)
            db.append("m", lbl(pod="p0"), math.nan if 60.0 < ts <= 120.0 else float(i), ts=ts)
        tier = db._data["m"][lbl(pod="p0")].rollup.tiers[0]
        ends = {row[0] for _, rows in _rows(db, 60.0) for row in rows}
        vec = db.rollup_range_avg("m", None, 180.0, 180.0, 60.0)
        twin = db.range_avg_bucketed("m", None, 180.0, 180.0, step=60.0)
        got.append((tier.covered_through, sorted(ends), _pairs(vec), _pairs(twin)))
    assert got[0] == got[1]
    covered, ends, vec, twin = got[0]
    assert covered >= 180.0 and 60.0 in ends and 180.0 in ends and 120.0 not in ends
    assert vec is not None and vec == twin


# ---- the raw twin: bit identity on tier-aligned windows ---------------------------


@pytest.mark.parametrize("seed", range(3))
def test_a_rollup_read_is_its_raw_twin_bit_for_bit_and_jax_s(seed):
    rng = np.random.default_rng(seed)
    pods = [f"p{i}" for i in range(int(rng.integers(2, 6)))]
    ticks = 400
    writes = []
    values = rng.uniform(0.0, 100.0, (ticks, len(pods)))
    marks = rng.random((ticks, len(pods)))
    for i in range(ticks):
        for j, pod in enumerate(pods):
            # markers sprinkled in, the tail live so no series is ended
            live = i >= ticks - 30 or marks[i, j] >= 0.05
            writes.append((lbl(pod=pod), float(values[i, j]) if live else math.nan,
                           5.0 * (i + 1)))
    reads = []
    for mods in BOTH:
        db = _db(mods)
        for labels, v, ts in writes:
            db.append("m", labels, v, ts=ts)
        got = []
        for step in (60.0, 300.0):
            for window in (step, 600.0, 1500.0):
                vec = db.rollup_range_avg("m", None, window, 1800.0, step)
                assert vec is not None and len(vec) == len(pods)
                assert _pairs(vec) == _pairs(
                    db.range_avg_bucketed("m", None, window, 1800.0, step=step))
                got.append(_pairs(vec))
        reads.append(got)
    assert reads[0] == reads[1]


def test_reads_that_cannot_be_faithful_fall_back_and_a_late_series_does_not():
    got = []
    for mods in BOTH:
        db = _db(mods)
        for i in range(400):
            db.append("m", lbl(pod="p0"), float(i % 7), ts=5.0 * (i + 1))
        out = [
            db.rollup_range_avg("m", None, 630.0, 1800.0, 300.0),  # window unaligned
            db.rollup_range_avg("m", None, 600.0, 1807.0, 300.0),  # at unaligned
            db.rollup_range_avg("m", None, 60.0, 1800.0, 300.0),  # window < step
            db.rollup_range_avg("m", None, 600.0, 1800.0, 120.0),  # unknown tier
            db.rollup_range_avg("ghost", None, 600.0, 1800.0, 300.0),  # no series
        ]
        raw_only = mods["tsdb"].TimeSeriesDB(mods["clock"].VirtualClock(), retention=10**9)
        raw_only.append("m", lbl(pod="p0"), 1.0, ts=5.0)
        out += [raw_only.rollup_range_avg("m", None, 600.0, 1800.0, 300.0),
                raw_only.rollup_steps, raw_only.downsample_policy]
        # born after the instant: invisible to the window, so no fallback
        db.append("m", lbl(pod="late"), 42.0, ts=1900.0)
        vec = db.rollup_range_avg("m", None, 600.0, 1800.0, 300.0)
        twin = db.range_avg_bucketed("m", None, 600.0, 1800.0, step=300.0)
        got.append(([_pairs(v) if isinstance(v, list) else v for v in out],
                    _pairs(vec), _pairs(twin)))
    assert got[0] == got[1]
    fallbacks, vec, twin = got[0]
    assert fallbacks == [None, None, None, None, [], None, (), None]
    assert vec is not None and [labels for labels, _ in vec] == [lbl(pod="p0")]
    assert vec == twin


# ---- the planner's tier selection --------------------------------------------------


def test_the_planner_picks_the_coarsest_aligned_tier_and_counts_as_jax_s():
    got = []
    for mods in BOTH:
        db = _db(mods)
        pods = [lbl(pod=f"p{i}") for i in range(3)]
        for i in range(400):
            for j, labels in enumerate(pods):
                db.append("m", labels, float(j * 50 + i % 11), ts=5.0 * (i + 1))
        db.clock.advance(1800.0 - db.clock.now())
        qp = mods["planner"].QueryPlanner(db)
        R = mods["rules"]
        same = mods["harness"]._vectors_identical
        plan, naive = qp.plan(R.AvgOverTime("m", 600.0, {})), R.AvgOverTime("m", 600.0, {})
        steps = [same(plan.evaluate(db), naive.evaluate(db))]
        counts = [dict(qp.stats.rollup_reads)]
        fine = qp.plan(R.AvgOverTime("m", 60.0, {}))
        steps.append(same(fine.evaluate(db), R.AvgOverTime("m", 60.0, {}).evaluate(db)))
        counts.append(dict(qp.stats.rollup_reads))
        # an unaligned instant is not tier-eligible: raw serves it, no counter moves
        db.clock.advance(7.0)
        steps.append(same(plan.evaluate(db), naive.evaluate(db)))
        counts.append((dict(qp.stats.rollup_reads), qp.stats.rollup_fallbacks))
        # a matching series not compacted through `at` sends the query to raw
        db.append("m", lbl(pod="hole"), 1.0, ts=1700.0)
        steps.append(same(plan.evaluate(db, at=1800.0), naive.evaluate(db, at=1800.0)))
        counts.append((qp.stats.rollup_fallbacks, qp.stats.rollup_fastpath,
                       qp.stats.rollup_fallback, qp.stats.fastpath, qp.stats.fallback))
        got.append((steps, counts, _pairs(plan.evaluate(db, at=1800.0)), qp.explain(plan)))
    assert got[0] == got[1]
    steps, counts, _, explain = got[0]
    assert steps == [True] * 4
    assert counts[0] == {"5m": 1} and counts[1] == {"5m": 1, "1m": 1}
    assert counts[2] == ({"5m": 1, "1m": 1}, 0) and counts[3][0] == 1
    assert "tier selection over 5m/1m rollups, then chunk-summary pushdown" in explain


# ---- compaction triggers and retention ---------------------------------------------


def test_compaction_on_evict_keeps_history_raw_retention_forgot():
    got = []
    for mods in BOTH:
        # the 1 h horizon is never reached in the 50-minute run: every bucket
        # exists because eviction compacted its chunk on the way out
        db = _db(mods, policy=dict(steps=(60.0,), horizon=3600.0), lookback=60.0,
                 retention=240.0)
        for i in range(600):
            db.append("m", lbl(pod="p0"), float(i % 9), ts=5.0 * (i + 1))
        got.append((_rows(db, 60.0), db.rollup_storage_stats(),
                    db._data["m"][lbl(pod="p0")].chunks[0].first_ts))
    assert got[0] == got[1]
    rows, stats, raw_first = got[0]
    ends = sorted(row[0] for _, r in rows for row in r)
    assert ends[0] == 60.0 and ends[-1] >= 2400.0 and stats["ingested_chunks"] > 0
    assert raw_first > ends[0]


def test_rollup_retention_trims_the_front_as_jax_s():
    got = []
    for mods in BOTH:
        db = _db(mods, policy=dict(steps=(60.0,), horizon=120.0, retention=600.0))
        for i in range(600):
            db.append("m", lbl(pod="p0"), float(i % 9), ts=5.0 * (i + 1))
        got.append((_rows(db, 60.0), db.rollup_storage_stats()))
    assert got[0] == got[1]
    rows, stats = got[0]
    ends = sorted(row[0] for _, r in rows for row in r)
    # whole rollup chunks (4 buckets) drop once past now - retention
    assert ends and ends[0] >= 3000.0 - 600.0 - 4 * 60.0
    assert stats["dropped_buckets"] > 0


# ---- accounting, federation and the blobs ------------------------------------------


def test_the_storage_stats_are_jax_s():
    for mods in BOTH:
        raw_only = mods["tsdb"].TimeSeriesDB(mods["clock"].VirtualClock())
        assert raw_only.rollup_storage_stats() == {"enabled": False, "tiers": {}}
    got = []
    for mods in BOTH:
        db = _db(mods)
        for i, v in enumerate(_values(400, seed=3)):
            db.append("m", lbl(pod="p0"), v, ts=5.0 * (i + 1))
        got.append(db.rollup_storage_stats())
    assert got[0] == got[1]
    stats = got[0]
    m1, m5 = stats["tiers"]["1m"], stats["tiers"]["5m"]
    assert m1["series"] == m5["series"] == 1 and m1["buckets"] > m5["buckets"] > 0
    assert m1["chunks"] >= 2
    assert stats["rollup_bytes"] == m1["bytes"] + m5["bytes"] > 0
    assert stats["sealed_buckets"] >= m1["buckets"] + m5["buckets"]


def test_federated_rollup_reads_merge_the_shards_as_jax_s():
    got = []
    for mods in BOTH:
        vclock = mods["clock"].VirtualClock()
        policy = mods["ds"].DownsamplePolicy(**POLICY)
        shards = [mods["tsdb"].TimeSeriesDB(vclock, retention=10**9, chunk_size=4,
                                            downsample=policy) for _ in range(2)]
        fed = mods["federation"].FederatedTSDB(
            mods["tsdb"].TimeSeriesDB(vclock, retention=10**9), shards)
        for i in range(400):
            for s, db in enumerate(shards):
                db.append("m", lbl(pod=f"shard{s}"), float(s * 10 + i % 5), ts=5.0 * (i + 1))
        got.append((fed.rollup_steps, fed.downsample_policy == policy,
                    _pairs(fed.rollup_range_avg("m", None, 600.0, 1800.0, 300.0)),
                    _pairs(fed.range_avg_bucketed("m", None, 600.0, 1800.0, step=300.0)),
                    fed.rollup_rows("m", step=60.0), fed.rollup_storage_stats(),
                    [db.rollup_storage_stats()["tiers"]["5m"]["buckets"] for db in shards]))
    assert got[0] == got[1]
    steps, same_policy, vec, twin, _, merged, per_shard = got[0]
    assert steps == (60.0, 300.0) and same_policy
    assert vec is not None and len(vec) == 2 and vec == twin
    assert merged["enabled"] and merged["tiers"]["5m"]["buckets"] == sum(per_shard)


def _tier_columns(db) -> list:
    """Every tier's sealed chunks (blobs, stamps, seal summaries) and head
    streams, series by series."""
    out = []
    for name in sorted(db._data):
        for labels, series in db._data[name].items():
            for tier in series.rollup.tiers:
                out.append((name, labels, tier.step, tier.covered_through, tier.open_end,
                            tier.o_count, tier.o_sum, [
                                (c.count, c.ts_blob, c.val_blobs, c.first_ts, c.last_ts,
                                 c.ts_mode, c.summaries) for c in tier.chunks],
                            [(bytes(e.ts_buf), bytes(e.val_buf), e.count, e.ts_mode)
                             for e in tier.encs]))
    return out


@pytest.mark.parametrize("chunk_size", [3, 8])
def test_sealed_rollup_chunks_are_jax_s_byte_for_byte(chunk_size):
    values = _values(900, seed=11, nan_share=0.03)
    rng = np.random.default_rng(12)
    gaps = rng.choice([5.0, 2.5, 15.0, 0.25], 300)
    got = []
    for mods in BOTH:
        db = _db(mods, chunk_size=chunk_size)
        ts = 0.0
        for i in range(300):
            ts += float(gaps[i])
            for j in range(3):
                db.append("m", lbl(pod=f"p{j}"), values[3 * i + j], ts=ts)
        got.append(_tier_columns(db))
    assert got[0] == got[1]
    assert any(len(entry[7]) >= 2 for entry in got[0])  # sealed rollup chunks
