"""The rollup tiers across a restart, against the JAX package's: format-3
snapshots with rollups (``metrics/tsdb.py``'s ``snapshot_payload`` and
``recover``, ``metrics/downsample.py``'s ``serialize_rollup`` and
``restore_rollup``).

The contracts of tests/test_recovery.py's rollup section, each on the same
seeded appends through both packages:

- ``snapshot_payload`` with rollups (each series' ``rollup`` entry and the
  ``downsample`` block) is JSON-equal to JAX's;
- the port recovers JAX's format-3 payloads with rollups, and JAX recovers
  the port's, each to the other's state (raw points, rollup rows, tier
  coverage, ``last_recovery``), and the compactor goes on after it;
- a format 1 or 2 payload, or a raw-only format 3 one recovered with a
  policy, rebuilds the rollups from the raw chunks as JAX's does, and the
  rebuilt reads equal their raw twin;
- ``downsample=None`` takes the policy the payload records;
- a WAL killed at any byte of its last segment, with the downsampler
  running, recovers the raw state and the rollup rows a reference DB gets
  from the records that landed, in both packages.

Tolerance: exact.
"""

import json
import math
import shutil

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.metrics import downsample as jax_downsample
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.metrics import wal as jax_wal
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch.metrics import downsample, tsdb, wal
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(ds=downsample, tsdb=tsdb, wal=wal, clock=clock)
JAX = dict(ds=jax_downsample, tsdb=jax_tsdb, wal=jax_wal, clock=jax_clock)
BOTH = (PORT, JAX)

SERIES = [
    ("tpu_duty_cycle", (("chip", "0"), ("node", "n0"))),
    ("tpu_duty_cycle", (("chip", "1"), ("node", "n0"))),
    ("tpu_test_avg", (("deployment", "d"), ("namespace", "default"))),
]


def _policy(mods, **kw):
    """Tiers that compact a few hundred 5 s appends: 1m/5m buckets, chunks
    aged 2 minutes past the newest append ingested."""
    return mods["ds"].DownsamplePolicy(**{"steps": (60.0, 300.0), "horizon": 120.0, **kw})


def _writes(ticks: int = 240, seed: int = 0) -> list[tuple]:
    """A 5 s cadence over 20 minutes, far past the 2-minute horizon, so both
    tiers hold sealed buckets (and at chunk size 4 sealed rollup chunks):
    seeded values, an origin on a third of the points, a marker now and
    then."""
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 100.0, (ticks, len(SERIES))).round(2)
    origins = rng.integers(1, 10_000, (ticks, len(SERIES)))
    draws = rng.random((ticks, len(SERIES), 2))
    out = []
    for i in range(ticks):
        for k, (name, labels) in enumerate(SERIES):
            value = math.nan if draws[i, k, 0] < 0.02 and i < ticks - 10 else float(values[i, k])
            origin = int(origins[i, k]) if draws[i, k, 1] < 1 / 3 else None
            out.append((name, labels, value, 5.0 * (i + 1), origin))
    return out


def _fill(mods, writes, directory=None, policy=True, segment=8192, **kw):
    log = None if directory is None else mods["wal"].WriteAheadLog(
        directory, segment_max_records=segment)
    db = mods["tsdb"].TimeSeriesDB(
        mods["clock"].VirtualClock(), wal=log, chunk_size=4,
        downsample=_policy(mods) if policy else None, **kw)
    for name, labels, value, ts, origin in writes:
        db.clock.advance(max(0.0, ts - db.clock.now()))
        db.append(name, labels, value, ts=ts, origin=origin)
    return db, log


def _rollup_state(db) -> dict:
    """Every stored rollup row and each tier's coverage and open bucket."""
    ds = db._downsampler
    if ds is None:
        return {}
    out: dict = {}
    for step in ds.steps:
        for name in sorted(db._data):
            for labels, rows in db.rollup_rows(name, step=step):
                out[(name, labels, step)] = tuple(rows)
    for name in sorted(db._data):
        for labels, series in db._data[name].items():
            if series.rollup is not None:
                out[("ingested", name, labels)] = (series.rollup.ingested, series.rollup.upto)
                for tier in series.rollup.tiers:
                    out[("tier", name, labels, tier.step)] = (
                        tier.covered_through, tier.open_end, tier.o_count, tier.o_sum,
                        tier.o_min, tier.o_max,
                        None if tier.o_last != tier.o_last else tier.o_last,
                        [(c.count, c.ts_blob, c.val_blobs, c.ts_mode) for c in tier.chunks])
    return out


def _raw_state(db, at: float) -> dict:
    out: dict = {"total_points": db.total_points()}
    for name in sorted(db._data):
        out[name] = sorted((s.labels, s.value) for s in db.instant_vector(name, at=at))
        out[f"version:{name}"] = db.version(name)
    return out


def _recover(mods, directory, **kw):
    return mods["tsdb"].TimeSeriesDB.recover(
        mods["wal"].WriteAheadLog(directory), mods["clock"].VirtualClock(), chunk_size=4, **kw)


def _write_snapshot(mods, directory, payload):
    log = mods["wal"].WriteAheadLog(directory)
    log.write_snapshot(payload)
    log.close()


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(retention=600.0)), (2, dict(retention=300.0, lookback=120.0)),
], ids=["default", "retention-600", "retention-300"])
def test_the_snapshot_payload_with_rollups_is_jax_s(seed, kw):
    writes = _writes(seed=seed)
    port, _ = _fill(PORT, writes, **kw)
    ref, _ = _fill(JAX, writes, **kw)
    payload = port.snapshot_payload()
    assert json.dumps(payload, allow_nan=False) == json.dumps(ref.snapshot_payload(),
                                                              allow_nan=False)
    assert payload["downsample"] == {"steps": [60.0, 300.0], "horizon": 120.0,
                                     "retention": 7 * 86400.0}
    assert all("rollup" in entry for entry in payload["series"])
    assert any(t["chunks"] for e in payload["series"] for t in e["rollup"]["tiers"])


@pytest.mark.parametrize("source", ["port", "jax"])
def test_each_package_recovers_the_other_s_rollup_snapshot(source, tmp_path):
    """A WAL directory either package wrote (snapshot with rollups, then a
    tail) recovers in both to the same raw and rollup state, with the
    recorded policy taken over, and both compactors go on alike."""
    writes = _writes(seed=5)
    writer = PORT if source == "port" else JAX
    db, log = _fill(writer, writes[:600], tmp_path / "wal")
    db.snapshot()
    for name, labels, value, ts, origin in writes[600:]:
        db.clock.advance(max(0.0, ts - db.clock.now()))
        db.append(name, labels, value, ts=ts, origin=origin)
    log.close()
    port, ref = _recover(PORT, tmp_path / "wal"), _recover(JAX, tmp_path / "wal")
    for mods, got in ((PORT, port), (JAX, ref)):
        assert got.downsample_policy == _policy(mods)
    assert port.last_recovery == ref.last_recovery
    assert port.last_recovery["rollup_series_restored"] == len(SERIES)
    assert port.last_recovery["rollup_series_rebuilt"] == 0
    assert port.last_recovery["rollup_enabled"] is True
    assert _rollup_state(port) == _rollup_state(ref) == _rollup_state(db)
    assert _raw_state(port, 1200.0) == _raw_state(ref, 1200.0) == _raw_state(db, 1200.0)
    for step in (60.0, 300.0):
        reads = [_vec(d.rollup_range_avg(SERIES[0][0], None, 4 * step, 900.0, step))
                 for d in (port, ref, db)]
        assert reads[0] is not None and reads[0] == reads[1] == reads[2]
    # the compactor keeps running on the recovered DBs, alike
    for got in (port, ref):
        got.wal = None
        for i in range(240, 400):
            got.append(SERIES[0][0], SERIES[0][1], float(i), ts=5.0 * (i + 1))
    assert port.rollup_storage_stats() == ref.rollup_storage_stats()
    assert _rollup_state(port) == _rollup_state(ref)


def _vec(samples):
    return None if samples is None else sorted((s.labels, s.value) for s in samples)


@pytest.mark.parametrize("fmt", [1, 2, 3])
def test_a_payload_without_rollups_rebuilds_them_as_jax_s(fmt, tmp_path):
    """A raw-only writer's snapshot, as format 1 (per-point triples), 2 or
    3, recovered with a policy: both packages rebuild the rollups from the
    installed raw chunks, equal to each other and to their raw twin."""
    writes = _writes(seed=7)
    db, log = _fill(PORT, writes, tmp_path / "raw", policy=False)
    payload = db.snapshot_payload()
    log.close()
    assert "downsample" not in payload
    if fmt == 2:
        payload = dict(payload, format=2)
    elif fmt == 1:
        payload = {k: v for k, v in payload.items() if k != "format"}
        payload["series"] = [
            {"name": name, "labels": list(labels),
             "points": [[t, None if v != v else v, o] for t, v, o in series.points]}
            for name, by_name in db._data.items() for labels, series in by_name.items()]
    got = []
    for mods in BOTH:
        directory = tmp_path / f"v{fmt}-{mods['tsdb'].__name__}"
        _write_snapshot(mods, directory, payload)
        rec = _recover(mods, directory, downsample=_policy(mods))
        got.append((rec.last_recovery, _rollup_state(rec), rec.rollup_storage_stats()))
        for step in (60.0, 300.0):
            for name, _ in SERIES:
                read = rec.rollup_range_avg(name, None, 4 * step, 900.0, step)
                assert read is not None
                assert _vec(read) == _vec(rec.range_avg_bucketed(name, None, 4 * step, 900.0,
                                                                 step=step))
    assert got[0] == got[1]
    info, _, stats = got[0]
    assert info["rollup_series_rebuilt"] == len(SERIES) and info["rollup_series_restored"] == 0
    assert stats["sealed_buckets"] > 0


def test_downsample_none_takes_the_recorded_policy_and_a_given_one_wins(tmp_path):
    db, log = _fill(PORT, _writes(seed=9), tmp_path / "wal")
    db.snapshot()
    log.close()
    for mods in BOTH:
        adopted = _recover(mods, tmp_path / "wal")
        assert adopted.downsample_policy == _policy(mods)
        assert adopted.rollup_steps == (60.0, 300.0)
        # a given policy wins over the payload's, and the rollups are
        # restored into it tier by tier (a new tier is built by later ingests)
        given = _recover(mods, tmp_path / "wal", downsample=_policy(mods, steps=(60.0,)))
        assert given.rollup_steps == (60.0,)
        assert given.last_recovery["rollup_series_restored"] == len(SERIES)
        assert given.rollup_rows(SERIES[0][0], step=60.0) == adopted.rollup_rows(
            SERIES[0][0], step=60.0)


def test_a_wal_killed_at_any_byte_with_rollups_recovers_as_the_landed_records(tmp_path):
    """Whatever byte the crash lands on, the replay through ``append``
    rebuilds the raw store and the rollup rows and coverage a reference DB
    gets from the same landed records, in both packages (compaction is a
    function of the append stream: it logs nothing of its own)."""
    wal_dir = tmp_path / "wal"
    db, log = _fill(PORT, _writes(seed=3), wal_dir, segment=64)
    assert db.rollup_storage_stats()["sealed_buckets"] > 0
    log.close()
    segments = sorted(wal_dir.glob("wal-*.jsonl"))
    final_bytes = segments[-1].read_bytes()
    prefix = [json.loads(line) for seg in segments[:-1] for line in seg.read_text().splitlines()]
    for cut in list(range(0, len(final_bytes), 173)) + [len(final_bytes)]:
        case = tmp_path / f"cut-{cut}"
        shutil.copytree(wal_dir, case)
        (case / segments[-1].name).write_bytes(final_bytes[:cut])
        landed = list(prefix)
        for line in final_bytes[:cut].split(b"\n"):
            try:
                landed.append(json.loads(line))
            except ValueError:
                pass
        states = []
        for mods in BOTH:
            recovered = _recover(mods, case, downsample=_policy(mods))
            reference = mods["tsdb"].TimeSeriesDB(
                mods["clock"].VirtualClock(), chunk_size=4, downsample=_policy(mods))
            for rec in landed:
                labels = tuple((k, v) for k, v in rec["labels"])
                value = math.nan if rec["op"] == "stale" else rec["value"]
                reference.append(rec["name"], labels, value, ts=rec["ts"],
                                 origin=rec.get("origin"))
            assert _raw_state(recovered, 1200.0) == _raw_state(reference, 1200.0), cut
            assert _rollup_state(recovered) == _rollup_state(reference), cut
            states.append(_rollup_state(recovered))
        assert states[0] == states[1], cut
