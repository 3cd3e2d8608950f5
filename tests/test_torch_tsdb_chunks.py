"""The TSDB on Gorilla chunks (``metrics/tsdb.py``) against the JAX
package's.

The same seeded appends (numpy: values, origins on a third of the points,
staleness markers, irregular cadences, exemplars on histogram buckets) go
into both packages' ``TimeSeriesDB``:

- ``snapshot_payload`` is JSON-equal to JAX's (format 3: each series'
  sealed chunks and head as base64 Gorilla blobs, the version counters,
  the stale map, the exemplars), after chunks sealed and retention dropped
  whole chunks;
- the port recovers JAX's format 1, 2 and 3 payloads, and JAX recovers the
  port's, each to the other's state, a payload carrying downsampled
  rollups included;
- ``range_avg`` (naive and with the chunk-summary pushdown and its
  counters), historical instant reads, the decode cache's hits and misses,
  ``series_for``, ``series_generation``, ``retained_bytes``,
  ``total_points``, ``total_appends``, ``series_count`` and the exemplars
  are JAX's;
- a scraped histogram's exemplars land in the DB and in the WAL's records
  as JAX's do, and survive a recovery.

Tolerance: exact (the same float operations in the same order).
"""

import base64
import json
import math

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.metrics import schema as jax_schema
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.metrics import wal as jax_wal
from k8s_gpu_hpa_tpu.metrics.planner import PlannerStats as JaxStats
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch.metrics import downsample, schema, tsdb, wal
from k8s_gpu_hpa_tpu_torch.metrics.planner import PlannerStats
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(tsdb=tsdb, wal=wal, clock=clock, schema=schema, stats=PlannerStats)
JAX = dict(tsdb=jax_tsdb, wal=jax_wal, clock=jax_clock, schema=jax_schema, stats=JaxStats)

SERIES = [
    ("fleet_duty_cycle", (("instance", f"synt-{i}"), ("job", "fleet"))) for i in range(4)
] + [("latency_bucket", (("le", le),)) for le in ("0.1", "1", "+Inf")]
#: a series a marker ends for good
GONE = ("fleet_duty_cycle", (("instance", "gone"), ("job", "fleet")))


def _writes(n: int = 400, seed: int = 0) -> list[tuple]:
    """(name, labels, value, ts, origin, exemplar triple or None): the
    seeded mix.  Each tick writes every series at an irregular cadence; a
    third of the points carry an origin, a bucket point an exemplar now and
    then, one series is ended by a marker mid-way and comes back, ``GONE``
    ends for good."""
    rng = np.random.default_rng(seed)
    gaps = rng.choice([1.0, 5.0, 15.0, 2.5], n)
    out = []
    ts = 100.0
    for tick in range(n):
        ts += float(gaps[tick])
        for k, (name, labels) in enumerate(SERIES):
            value = float(np.round(rng.uniform(0.0, 100.0), int(rng.integers(0, 4))))
            if name == "latency_bucket":
                value = float(tick * (k + 1))
            if k == 0 and tick == n // 2:
                value = math.nan
            origin = int(rng.integers(1, 10_000)) if rng.random() < 1 / 3 else None
            exemplar = None
            if name == "latency_bucket" and rng.random() < 0.2:
                exemplar = (float(rng.uniform(0, 1)), int(rng.integers(1, 999)), ts)
            out.append((name, labels, value, ts, origin, exemplar))
        if tick < 30:
            out.append((*GONE, float(tick), ts, None, None))
        elif tick == 30:
            out.append((*GONE, math.nan, ts, None, None))
    return out


def _fill(mods, writes, **kw):
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock, **kw)
    Exemplar = mods["schema"].Exemplar
    for name, labels, value, ts, origin, ex in writes:
        vclock.advance(max(0.0, ts - vclock.now()))
        exemplar = None if ex is None else Exemplar(ex[0], ex[1], ex[1], ex[2])
        db.append(name, labels, value, ts=ts, origin=origin, exemplar=exemplar)
    return db


def _ex(ex) -> tuple | None:
    return None if ex is None else (ex.value, ex.trace_id, ex.span_id, ex.ts)


def _points(db) -> dict:
    return {(name, labels): [(t, None if v != v else v, o) for t, v, o in series.points]
            for name, by_name in db._data.items() for labels, series in by_name.items()}


def _state(db) -> dict:
    """Everything a read can see, for equality across the packages."""
    names = db.series_names()
    return {
        "points": _points(db),
        "versions": dict(db._versions),
        "stale": dict(db._stale_pending),
        "exemplars": {k: _ex(v) for k, v in db._exemplars.items()},
        "counts": (db.total_points(), db.series_count(), db.retained_bytes(),
                   db.total_appends()),
        "vectors": {n: [(s.labels, s.value) for s in db.instant_vector(n)] for n in names},
        "generations": {n: db.series_generation(n) for n in names},
    }


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(retention=900.0)),
    (2, dict(retention=300.0, chunk_size=16, lookback=120.0)),
], ids=["default", "retention-900", "chunk-16"])
def test_the_snapshot_payload_is_jax_s(seed, kw):
    writes = _writes(seed=seed)
    port, ref = _fill(PORT, writes, **kw), _fill(JAX, writes, **kw)
    payload = port.snapshot_payload()
    assert json.dumps(payload, allow_nan=False) == json.dumps(ref.snapshot_payload(),
                                                              allow_nan=False)
    assert payload["format"] == 3 and "downsample" not in payload
    assert all("rollup" not in e for e in payload["series"])
    # chunks sealed and retention dropped whole ones: the payload holds both
    assert any(e["chunks"] for e in payload["series"])
    assert port.total_appends() > port.total_points()
    assert _state(port) == _state(ref)


def _wal_with(mods, directory, payload):
    log = mods["wal"].WriteAheadLog(directory)
    log.write_snapshot(payload)
    log.close()


def _as_format(payload: dict, fmt: int, db) -> dict:
    """JAX's payload as format ``fmt``: 3 as written, 2 the same columns
    under format 2, 1 per-point triples (``points``) with no format field,
    as JAX's first snapshots were."""
    if fmt == 3:
        return payload
    if fmt == 2:
        return dict(payload, format=2)
    v1 = {k: v for k, v in payload.items() if k != "format"}
    v1["series"] = [{"name": name, "labels": list(labels), "points": [list(p) for p in pts]}
                    for (name, labels), pts in _points(db).items()]
    return v1


@pytest.mark.parametrize("fmt", [1, 2, 3])
def test_each_package_recovers_the_other_s_snapshots(fmt, tmp_path):
    writes = _writes(seed=3)
    ref = _fill(JAX, writes, retention=600.0)
    port_db = _fill(PORT, writes, retention=600.0)
    for source, db, readers in (("jax", ref, (PORT, JAX)), ("port", port_db, (PORT, JAX))):
        payload = _as_format(db.snapshot_payload(), fmt, db)
        states = []
        for mods in readers:
            directory = tmp_path / f"{source}-{mods['tsdb'].__name__}"
            _wal_with(mods, directory, payload)
            got = mods["tsdb"].TimeSeriesDB.recover(
                mods["wal"].WriteAheadLog(directory), mods["clock"].VirtualClock())
            states.append((_points(got), dict(got._versions), dict(got._stale_pending),
                           {k: _ex(v) for k, v in got._exemplars.items()},
                           got.total_points(), got.series_count(), got.last_recovery))
        assert states[0] == states[1], (source, fmt)
        assert states[0][0] == _points(db)


def test_a_rollup_payload_round_trips_between_the_packages(tmp_path):
    """A snapshot with rollups (each series' ``rollup`` entry and the
    ``downsample`` block), written by the port's TSDB with 1m/5m tiers,
    recovers in both packages to the same state, rollups included, and
    each recovered DB snapshots the same payload again."""
    writes = _writes(n=100)
    port_ds = downsample.DownsamplePolicy(steps=(60.0, 300.0), horizon=120.0)
    db = _fill(PORT, writes, downsample=port_ds)
    payload = db.snapshot_payload()
    assert "downsample" in payload and all("rollup" in e for e in payload["series"])
    states = []
    for mods in (PORT, JAX):
        directory = tmp_path / mods["tsdb"].__name__
        _wal_with(mods, directory, payload)
        got = mods["tsdb"].TimeSeriesDB.recover(mods["wal"].WriteAheadLog(directory),
                                                mods["clock"].VirtualClock())
        got.wal = None
        states.append((_points(got), got.last_recovery,
                       [got.rollup_rows(name, step=60.0) for name in got.series_names()],
                       got.rollup_storage_stats()))
        again = got.snapshot_payload()
        again["at"] = payload["at"]
        assert json.dumps(again) == json.dumps(payload)
    assert states[0] == states[1]
    assert states[0][1]["rollup_series_restored"] == len(payload["series"])
    assert states[0][3]["tiers"]["1m"]["buckets"] > 0


@pytest.mark.parametrize("window", [60.0, 299.0, 1200.0, 5000.0])
def test_range_avg_and_its_pushdown_are_jax_s(window):
    writes = _writes(seed=4)
    port, ref = _fill(PORT, writes, retention=3600.0), _fill(JAX, writes, retention=3600.0)
    end = port.clock.now()
    for at in (end, end - 123.5, end - 700.0):
        for matchers in (None, {"job": "fleet"}, {"instance": "synt-2"}):
            got = []
            for mods, db in ((PORT, port), (JAX, ref)):
                stats = mods["stats"]()
                db.begin_capture()
                naive = db.range_avg("fleet_duty_cycle", matchers, window, at)
                planned = db.range_avg("fleet_duty_cycle", matchers, window, at,
                                       use_summaries=True, stats=stats)
                captured = db.end_capture()
                got.append(([(s.labels, s.value) for s in naive],
                            [(s.labels, s.value) for s in planned],
                            stats.fastpath, stats.fallback, captured))
            assert got[0] == got[1]
            assert got[0][0] == got[0][1]  # the pushdown is bit-identical
    assert (port.decode_cache_hits, port.decode_cache_misses) == (
        ref.decode_cache_hits, ref.decode_cache_misses)
    assert port.decode_cache_misses > 0


def test_historical_reads_and_the_decode_cache_are_jax_s():
    writes = _writes(seed=5)
    port, ref = _fill(PORT, writes, retention=3600.0), _fill(JAX, writes, retention=3600.0)
    end = port.clock.now()
    for at in np.linspace(end - 3000.0, end, 41).tolist():
        assert ([(s.labels, s.value) for s in port.instant_vector("fleet_duty_cycle", at=at)]
                == [(s.labels, s.value) for s in ref.instant_vector("fleet_duty_cycle", at=at)])
    assert (port.decode_cache_hits, port.decode_cache_misses) == (
        ref.decode_cache_hits, ref.decode_cache_misses)
    assert port.decode_cache_hits > 0 and port.decode_cache_misses > 0
    for labels, series in port._data["fleet_duty_cycle"].items():
        ref_series = ref._data["fleet_duty_cycle"][labels]
        for at in np.linspace(end - 2000.0, end + 400.0, 25).tolist():
            assert series.latest_point_at(at, port.lookback, port._chunk_arrays) == (
                ref_series.latest_point_at(at, ref.lookback, ref._chunk_arrays))
    for matchers in (None, {"job": "fleet"}, {"le": "1"}, {"job": "none"}):
        for name in ("fleet_duty_cycle", "latency_bucket", "absent"):
            assert [s.labels for s in port.series_for(name, matchers)] == [
                s.labels for s in ref.series_for(name, matchers)]


def test_the_exemplars_are_jax_s():
    writes = _writes(seed=6)
    port, ref = _fill(PORT, writes), _fill(JAX, writes)
    got = {labels: _ex(ex) for labels, ex in port.exemplars_of("latency_bucket").items()}
    assert got == {labels: _ex(ex) for labels, ex in ref.exemplars_of("latency_bucket").items()}
    assert len(got) == 3
    for labels in got:
        assert _ex(port.exemplar("latency_bucket", labels)) == got[labels]
    assert port.exemplar("fleet_duty_cycle", SERIES[0][1]) is None
    assert port.exemplars_of("fleet_duty_cycle") == {}


def _histogram_target(mods, seed: int):
    """A target serving one histogram whose observations carry exemplars."""
    rng = np.random.default_rng(seed)
    hist = mods["schema"].Histogram("rpc_latency_seconds", "latency")
    state = {"n": 0}

    def fetch():
        for _ in range(3):
            state["n"] += 1
            hist.observe(float(rng.uniform(0, 2)),
                         mods["schema"].Exemplar(0.5, state["n"], state["n"], float(state["n"])))
        return [hist.family()]

    return fetch


def test_a_scraped_histogram_s_exemplars_travel_the_wal_as_jax_s(tmp_path):
    got = {}
    for label, mods in (("port", PORT), ("jax", JAX)):
        vclock = mods["clock"].VirtualClock()
        log = mods["wal"].WriteAheadLog(tmp_path / label, segment_max_records=10_000)
        db = mods["tsdb"].TimeSeriesDB(vclock, wal=log, snapshot_every=40)
        scraper = mods["tsdb"].Scraper(db)
        scraper.add_target(_histogram_target(mods, 0), name="rpc", node="n0")
        for _ in range(12):
            vclock.advance(1.0)
            scraper.scrape_once()
        log.close()
        segments = sorted((tmp_path / label).glob("wal-*.jsonl"))
        recovered = mods["tsdb"].TimeSeriesDB.recover(mods["wal"].WriteAheadLog(tmp_path / label),
                                                      mods["clock"].VirtualClock())
        got[label] = ([seg.read_bytes() for seg in segments],
                      {k: _ex(v) for k, v in db.exemplars_of("rpc_latency_seconds_bucket").items()},
                      {k: _ex(v) for k, v in
                       recovered.exemplars_of("rpc_latency_seconds_bucket").items()})
    assert got["port"] == got["jax"]
    assert got["port"][1] and got["port"][1] == got["port"][2]
    assert any(b'"exemplar"' in seg for seg in got["port"][0])


def test_snapshot_blobs_decode_to_the_points():
    db = _fill(PORT, _writes(n=120, seed=7))
    for entry in db.snapshot_payload()["series"]:
        for count, tsb, vb, _origins, first_ts, last_ts, mode in entry["chunks"]:
            assert len(base64.b64decode(tsb)) >= 8 and count == 64
            assert first_ts <= last_ts and mode in (0, 1)
        assert entry["head"][0] < 64
