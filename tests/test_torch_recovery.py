"""Durability against the JAX package's: the TSDB's write-ahead log and
snapshots (``metrics/wal.py``, ``metrics/tsdb.py``), the stale-series GC,
the scrape stagger after a recovery, and the HPA's checkpoints
(``control/checkpoint.py``, ``control/hpa.py``).

The contracts of tests/test_recovery.py, each on the same seeded write mix
through both packages:

- a WAL round trip restores every point with its origin, the version
  counters and the stale map; the segments are JAX's byte for byte;
- a kill at every byte of the last segment recovers a DB equal to one fed
  exactly the records that fully landed, without and with a snapshot;
- a recovery from snapshot and tail equals the uninterrupted DB (points,
  origins, versions, stale map), and still does after 200 more appends,
  so that the 64-point retention groups line up;
- a tail at the newest timestamp appends, a regression is dropped (in the
  replay) or raises (live); a torn line mid-log raises ``WALCorruption``;
  ``truncate_tail`` counts what it destroyed;
- ``gc`` drops what JAX's drops, called and every ``GC_EVERY`` appends;
- ``stagger_after_recovery`` gives JAX's ``next_attempt_at`` and never
  moves a target ahead of its backoff;
- both checkpoint stores: a torn file loads as None, the in-memory store
  is as strict about JSON as the file.

Across the packages: a WAL directory the port wrote (snapshot and tail)
recovers in JAX's ``TimeSeriesDB.recover`` to the port's own recovered
state; a directory of JAX's segments recovers in the port to JAX's state;
a JAX format-3 snapshot carrying downsampled rollups recovers in the port
to JAX's state (the rollups' own contracts: tests/test_torch_rollup_recovery.py);
the port's snapshot is JAX's format 3; a checkpoint file either
HPA wrote restores in the other; an HPA restarted mid-window from its
checkpoint recommends ``[4, 4, 4, 4, 4, 4, 1, 1]`` as an uninterrupted one
does, in both packages, and a cold restart scales down early.

Tolerance: exact (the same appends, the same float operations).
"""

import json
import math
import shutil

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.control import adapter as jax_adapter
from k8s_gpu_hpa_tpu.control import checkpoint as jax_checkpoint
from k8s_gpu_hpa_tpu.control import hpa as jax_hpa
from k8s_gpu_hpa_tpu.metrics import downsample as jax_downsample
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.metrics import wal as jax_wal
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch.control import adapter, checkpoint, hpa
from k8s_gpu_hpa_tpu_torch.metrics import tsdb, wal
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(tsdb=tsdb, wal=wal, clock=clock, checkpoint=checkpoint, hpa=hpa, adapter=adapter)
JAX = dict(tsdb=jax_tsdb, wal=jax_wal, clock=jax_clock, checkpoint=jax_checkpoint, hpa=jax_hpa,
           adapter=jax_adapter)
BOTH = pytest.mark.parametrize("mods", [PORT, JAX], ids=["port", "jax"])

SERIES = [
    ("tpu_duty_cycle", (("chip", "0"), ("node", "n0"))),
    ("tpu_duty_cycle", (("chip", "1"), ("node", "n0"))),
    ("tpu_test_avg", (("deployment", "d"), ("namespace", "default"))),
]
#: a series a marker ends for good, so the stale map is not empty at the end
GONE = ("tpu_duty_cycle", (("chip", "2"), ("node", "n1")))


def _writes(n: int = 60, seed: int = 0) -> list[tuple]:
    """The seeded write mix: three series in turn, a value drawn with numpy,
    an origin on a drawn third of the points, a staleness marker on series
    0 half way (which comes back) and one on ``GONE`` (which does not):
    everything a recovery must carry."""
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 100.0, n).round(3)
    origins = rng.integers(1, 10_000, n)
    traced = rng.random(n) < 1 / 3
    out = []
    for i in range(n):
        name, labels = SERIES[i % len(SERIES)]
        origin = int(origins[i]) if traced[i] else None
        out.append((name, labels, float(values[i]), float(i), origin))
        if i == n // 2:
            out.append((*SERIES[0], math.nan, float(i), None))
        if i < 4:
            out.append((*GONE, float(i), float(i), None))
        elif i == 4:
            out.append((*GONE, math.nan, float(i), None))
    return out


def _populate(db, writes) -> None:
    for name, labels, value, ts, origin in writes:
        db.append(name, labels, value, ts=ts, origin=origin)


def _points(db) -> dict:
    """Every retained point as ``(ts, value or None for a marker, origin)``,
    by series: the port's lists or JAX's decoded chunks."""
    out = {}
    for name, by_name in db._data.items():
        for labels, series in by_name.items():
            if hasattr(series, "points"):  # JAX's Gorilla series
                pts = series.points
            else:
                pts = zip(series.ts, series.values, series.origins)
            out[(name, labels)] = [(t, None if v != v else v, o) for t, v, o in pts]
    return out


def _state(db, at: float) -> dict:
    """Everything a read sees, for equality across DBs and packages."""
    out: dict = {"total_points": db.total_points(), "series_count": db.series_count()}
    for name in sorted(db._data):
        vec = db.instant_vector(name, at=at)
        out[name] = sorted((s.labels, s.value) for s in vec)
        out[f"version:{name}"] = db.version(name)
    return out


def _full(db, at: float) -> dict:
    return {"state": _state(db, at), "points": _points(db),
            "stale": dict(db._stale_pending), "versions": dict(db._versions)}


def _apply_records(db, records: list[dict]) -> None:
    for rec in records:
        labels = tuple((k, v) for k, v in rec["labels"])
        value = float("nan") if rec["op"] == "stale" else rec["value"]
        db.append(rec["name"], labels, value, ts=rec["ts"], origin=rec.get("origin"))


def _written(mods, directory, writes, **kw):
    """A DB with a WAL in ``directory``, fed ``writes``, its WAL closed."""
    log = mods["wal"].WriteAheadLog(directory, segment_max_records=kw.pop("segment", 16))
    db = mods["tsdb"].TimeSeriesDB(mods["clock"].VirtualClock(), wal=log, **kw)
    _populate(db, writes)
    log.close()
    return db, log


def _recover(mods, directory, **kw):
    return mods["tsdb"].TimeSeriesDB.recover(
        mods["wal"].WriteAheadLog(directory), mods["clock"].VirtualClock(), **kw)


# ---- the WAL round trip ----------------------------------------------------------


def test_a_round_trip_restores_everything_as_jax_s(tmp_path):
    writes = _writes()
    got = {}
    for label, mods in (("port", PORT), ("jax", JAX)):
        db, _ = _written(mods, tmp_path / label, writes)
        recovered = _recover(mods, tmp_path / label)
        assert _full(recovered, 59.0) == _full(db, 59.0)
        got[label] = (_full(recovered, 59.0), recovered.last_recovery)
    assert got["port"] == got["jax"]
    info = got["port"][1]
    assert (info["snapshot_restored"], info["replayed_records"], info["dropped_records"]) == (
        False, 66, 0)  # 60 appends and a marker, GONE's 4 and its marker
    assert got["port"][0]["stale"] == {GONE: 4.0}
    # origins cross the restart
    assert any(o is not None for pts in got["port"][0]["points"].values() for _, _, o in pts)


def test_the_segments_are_jax_s_byte_for_byte(tmp_path):
    writes = _writes(seed=3)
    for label, mods in (("port", PORT), ("jax", JAX)):
        _written(mods, tmp_path / label, writes)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"wal-{i:08d}.jsonl" for i in range(5)]  # 66 records of 16
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("snapshot_every", [8192, 25], ids=["segments", "snapshot"])
def test_a_kill_at_every_byte_recovers_the_records_that_landed(tmp_path, snapshot_every):
    """The last segment cut at every byte: recovery never fails and equals
    a DB fed exactly the records that landed (a line without its newline is
    the torn tail a kill leaves); JAX's recovery of every 13th cut equals
    the port's."""
    wal_dir = tmp_path / "wal"
    _written(PORT, wal_dir, _writes(), snapshot_every=snapshot_every, segment=8)
    log = wal.WriteAheadLog(wal_dir)
    payload, _ = log.read()
    segments = sorted(wal_dir.glob("wal-*.jsonl"))
    assert len(segments) > 1 and log.has_snapshot() == (snapshot_every == 25)
    final = segments[-1].read_bytes()
    before = [json.loads(line) for seg in segments[:-1] for line in seg.read_text().splitlines()]
    case = tmp_path / "case"
    shutil.copytree(wal_dir, case)
    for cut in range(len(final) + 1):
        (case / segments[-1].name).write_bytes(final[:cut])
        recovered = _recover(PORT, case)
        landed = list(before)
        for line in final[:cut].split(b"\n"):
            if line:
                try:
                    landed.append(json.loads(line))
                except ValueError:
                    pass  # the torn last record
        reference = tsdb.TimeSeriesDB(clock.VirtualClock())
        if payload is not None:
            reference = _recover(PORT, _snapshot_only(tmp_path / "snap", payload))
            reference.wal = None
        _apply_records(reference, landed)
        assert _full(recovered, 59.0) == _full(reference, 59.0), f"cut at byte {cut}"
        if cut % 13 == 0:
            assert _state(_recover(JAX, case), 59.0) == _state(recovered, 59.0), f"JAX, byte {cut}"


def _snapshot_only(directory, payload):
    if directory.exists():
        shutil.rmtree(directory)
    log = wal.WriteAheadLog(directory)
    log.write_snapshot(payload)
    log.close()
    return directory


@BOTH
def test_a_snapshot_takes_the_segments_and_recovery_is_exact(tmp_path, mods):
    db, log = _written(mods, tmp_path / "wal", _writes(), snapshot_every=25, segment=8)
    assert log.has_snapshot()
    assert log.segment_count() < math.ceil(66 / 8)  # snapshots at 25 and 50 took theirs
    recovered = _recover(mods, tmp_path / "wal")
    assert recovered.last_recovery["snapshot_restored"] is True
    assert recovered.last_recovery["replayed_records"] == 16
    assert _full(recovered, 59.0) == _full(db, 59.0)
    assert recovered._stale_pending == {GONE: 4.0}  # from the snapshot: the GC resumes


def _long_writes(n: int, start: int = 0, seed: int = 1) -> list[tuple]:
    """A long seeded mix that crosses the retention: three series, a point
    every 3 s each, markers and comebacks on series 1, and ``GONE`` ended
    for good at 650 s."""
    rng = np.random.default_rng(seed)
    values = rng.normal(50.0, 20.0, n).round(4)
    out = []
    for j in range(n):
        i = start + j
        name, labels = SERIES[i % len(SERIES)]
        value = math.nan if (i % len(SERIES) == 1 and i % 97 < 3) else float(values[j])
        out.append((name, labels, value, float(i), i if i % 5 == 0 else None))
        if i <= 650 and i % 10 == 0:
            out.append((*GONE, math.nan if i == 650 else float(values[j]), float(i), None))
    return out


def test_recovery_equals_the_uninterrupted_db_and_jax_s_after_more_appends(tmp_path):
    """Snapshot and tail into a DB whose retention drops groups: the
    recovered DB equals the uninterrupted one, and after 200 more appends
    to each both equal JAX's uninterrupted DB point for point, so the
    recovered series drop their 64-point groups at the same boundaries."""
    first, more = _long_writes(700), _long_writes(200, start=700)
    kw = dict(lookback=60.0, snapshot_every=150, segment=64)
    db, _ = _written(PORT, tmp_path / "port", first, **kw)
    ref, _ = _written(JAX, tmp_path / "jax", first, **kw)
    recovered = _recover(PORT, tmp_path / "port")
    assert recovered.last_recovery["snapshot_restored"] is True
    assert _full(recovered, 699.0) == _full(db, 699.0) == _full(ref, 699.0)
    recovered.wal.close()
    for d in (db, recovered, ref):
        d.wal = None
        _populate(d, more)
    for at in (899.0, 860.0, 800.0, 700.0):
        assert _state(recovered, at) == _state(db, at) == _state(ref, at), at
    assert _points(recovered) == _points(db) == _points(ref)


@BOTH
def test_a_tail_at_the_newest_ts_appends_and_a_regression_does_not(tmp_path, mods):
    db, log = _written(mods, tmp_path / "wal", _writes())
    name, labels = SERIES[0]
    # a record that lands out of order in the replay is dropped, not fatal
    tail = mods["wal"].WriteAheadLog(tmp_path / "wal")
    tail.log_append(name, labels, 1.0, 10.0)
    tail.close()
    recovered = _recover(mods, tmp_path / "wal")
    assert (recovered.last_recovery["replayed_records"],
            recovered.last_recovery["dropped_records"]) == (66, 1)
    newest = _points(recovered)[(name, labels)][-1][0]
    recovered.append(name, labels, 99.0, ts=newest)  # equal ts: appends
    with pytest.raises(ValueError):
        recovered.append(name, labels, 99.0, ts=newest - 1.0)


@BOTH
def test_a_torn_record_mid_log_raises_wal_corruption(tmp_path, mods):
    _written(mods, tmp_path / "wal", _writes())
    segments = sorted((tmp_path / "wal").glob("wal-*.jsonl"))
    # a torn segment before the last: no kill leaves that
    segments[0].write_text(segments[0].read_text() + '{"op":"append","na')
    with pytest.raises(mods["wal"].WALCorruption, match="torn record mid-log"):
        _recover(mods, tmp_path / "wal")


def test_an_unreadable_snapshot_raises_wal_corruption(tmp_path):
    _written(PORT, tmp_path / "wal", _writes(), snapshot_every=25)
    (tmp_path / "wal" / wal.SNAPSHOT_NAME).write_text('{"covered_through": 1, "payl')
    with pytest.raises(wal.WALCorruption, match="unreadable snapshot"):
        _recover(PORT, tmp_path / "wal")


@pytest.mark.parametrize("records,tear", [(10, True), (10, False), (500, True)])
def test_truncate_tail_counts_as_jax_s(tmp_path, records, tear):
    got = []
    for label, mods in (("port", PORT), ("jax", JAX)):
        _, log = _written(mods, tmp_path / label, _writes(), segment=1024)
        lost = log.truncate_tail(records=records, tear=tear)
        recovered = _recover(mods, tmp_path / label)
        (segment,) = (tmp_path / label).glob("wal-00000000.jsonl")
        got.append((lost, recovered.last_recovery["replayed_records"],
                    recovered.last_recovery["dropped_records"], segment.read_bytes(),
                    _state(recovered, 59.0)))
    assert got[0] == got[1]
    assert got[0][:3] == (min(records, 66), 66 - min(records, 66), 0)  # the tear is tolerated


def test_truncate_tail_of_an_empty_log_loses_nothing(tmp_path):
    assert wal.WriteAheadLog(tmp_path / "wal").truncate_tail() == 0


# ---- the stale-series GC -----------------------------------------------------------


def _marked(mods, seed: int):
    """A DB with 12 series, some ended by a marker at a seeded time."""
    rng = np.random.default_rng(seed)
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock, lookback=30.0)
    ends = rng.integers(5, 60, 12)
    ended = rng.random(12) < 0.6
    for t in range(60):
        for k in range(12):
            labels = (("k", str(k)),)
            if t < ends[k]:
                db.append(f"s{k % 3}", labels, float(t * k), float(t))
            elif t == ends[k] and ended[k]:
                db.mark_stale(f"s{k % 3}", labels, float(t))
    return db, vclock


@pytest.mark.parametrize("seed", range(3))
def test_gc_drops_what_jax_s_drops(seed):
    port, port_clock = _marked(PORT, seed)
    ref, ref_clock = _marked(JAX, seed)
    assert dict(port._stale_pending) == dict(ref._stale_pending)
    # each marker's own edge (now - marker == lookback: kept), then past it
    edges = sorted({ts + 30.0 for ts in port._stale_pending.values()} | {60.0, 200.0})
    for now in edges:
        port_clock.advance(now - port_clock.now())
        ref_clock.advance(now - ref_clock.now())
        assert port.gc() == ref.gc()
        assert _full(port, now) == _full(ref, now)
        assert port.series_names() == ref.series_names()
    assert port._stale_pending == {}


def test_the_gc_runs_every_gc_every_appends_as_jax_s():
    """Churning series, a marker each, written past ``GC_EVERY`` twice: the
    GC drops the aged ones at the same appends in both packages."""
    assert tsdb.TimeSeriesDB.GC_EVERY == jax_tsdb.TimeSeriesDB.GC_EVERY == 4096
    counts = []
    for mods in (PORT, JAX):
        vclock = mods["clock"].VirtualClock()
        db = mods["tsdb"].TimeSeriesDB(vclock, lookback=30.0)
        seen = []
        for i in range(9000):
            vclock.advance(0.05)
            labels = (("pod", str(i // 20)),)
            if i % 20 == 19:
                db.mark_stale("churn", labels)
            else:
                db.append("churn", labels, float(i))
            if i % 500 == 0:
                seen.append((db.series_count(), db.total_points()))
        counts.append((seen, _full(db, vclock.now())))
    assert counts[0] == counts[1]
    assert counts[0][0][-1][0] < 450  # the sweeps really dropped series


def test_the_gc_runs_in_the_replay_as_jax_s(tmp_path):
    """A replay past ``GC_EVERY`` records on a clock at the log's end (a
    restart's): the GC drops the aged series mid-replay in both packages,
    so the recovered series are JAX's."""
    writes = []
    for i in range(5000):
        labels = (("pod", str(i // 20)),)
        value = math.nan if i % 20 == 19 else float(i)
        writes.append(("churn", labels, value, i * 0.05, None))
    got = []
    for label, mods in (("port", PORT), ("jax", JAX)):
        _written(mods, tmp_path / label, writes, lookback=30.0, segment=1024)
        vclock = mods["clock"].VirtualClock()
        vclock.advance(250.0)
        db = mods["tsdb"].TimeSeriesDB.recover(mods["wal"].WriteAheadLog(tmp_path / label),
                                               vclock, lookback=30.0)
        got.append((_full(db, 250.0), db.last_recovery))
    assert got[0] == got[1]
    assert got[0][1]["recovered_series"] < 250 - 30 / (20 * 0.05)  # the GC dropped some


def test_a_point_after_a_marker_cancels_the_gc():
    db = tsdb.TimeSeriesDB(clock.VirtualClock())
    db.mark_stale("x", (("a", "1"),), ts=0.0)
    assert db._stale_pending == {("x", (("a", "1"),)): 0.0}
    db.append("x", (("a", "1"),), 1.0, ts=1.0)
    assert db._stale_pending == {}


# ---- the scrape stagger after a recovery ---------------------------------------------


def _scraper(mods, n: int, interval: float = 1.0):
    scraper = mods["tsdb"].Scraper(mods["tsdb"].TimeSeriesDB(mods["clock"].VirtualClock()),
                                   interval=interval)
    for i in range(n):
        scraper.add_target(lambda: "", name=f"exporter/node-{i}", node=f"node-{i}")
    scraper.add_target(lambda: "", name="kube-state-metrics")
    return scraper


@pytest.mark.parametrize("n,interval", [(8, 1.0), (40, 1.0), (12, 15.0)])
def test_the_stagger_is_jax_s(n, interval):
    port, ref = _scraper(PORT, n, interval), _scraper(JAX, n, interval)
    port.db.clock.advance(100.0)
    ref.db.clock.advance(100.0)
    port.stagger_after_recovery()
    ref.stagger_after_recovery()
    slots = [t.next_attempt_at for t in port.targets]
    assert slots == [t.next_attempt_at for t in ref.targets]
    assert all(100.0 <= s <= 100.0 + 4.0 * interval for s in slots)
    assert len(set(slots)) > 1


def test_the_stagger_never_moves_a_target_ahead_of_its_backoff():
    for mods in (PORT, JAX):
        scraper = _scraper(mods, 3)
        scraper.targets[0].next_attempt_at = 100.0  # a backoff in force
        scraper.stagger_after_recovery(spread=8.0)
        assert scraper.targets[0].next_attempt_at == 100.0
        assert all(t.next_attempt_at <= 8.0 for t in scraper.targets[1:])


def test_a_target_counts_its_attempts_as_jax_s():
    def down():
        raise ConnectionError("down")

    got = []
    for mods in (PORT, JAX):
        scraper = _scraper(mods, 1)
        scraper.targets[0].fetch = down
        for _ in range(40):
            scraper.db.clock.advance(1.0)
            scraper.scrape_once()
        got.append([t.attempts for t in scraper.targets])
    assert got[0] == got[1]
    assert got[0][1] == 40 and got[0][0] < 40  # the down target backs off


# ---- the checkpoint stores -----------------------------------------------------------


@BOTH
def test_the_file_store_round_trips_and_loads_a_torn_file_as_none(tmp_path, mods):
    store = mods["checkpoint"].FileCheckpointStore(tmp_path / "ckpt.json")
    assert store.load() is None  # a cold start, never an error
    store.save({"version": 1, "recommendations": [[0.0, 4]]})
    assert store.load() == {"version": 1, "recommendations": [[0.0, 4]]}
    (tmp_path / "ckpt.json").write_text('{"version": 1, "recomm')
    assert store.load() is None


@BOTH
def test_the_in_memory_store_is_strict_about_json(mods):
    store = mods["checkpoint"].InMemoryCheckpointStore()
    with pytest.raises(ValueError):
        store.save({"bad": float("nan")})
    store.save({"ok": 1, "t": (1, 2)})
    assert store.load() == {"ok": 1, "t": [1, 2]}
    assert store.saves == 1


def test_the_checkpoint_version_is_jax_s():
    assert checkpoint.CHECKPOINT_VERSION == jax_checkpoint.CHECKPOINT_VERSION == 1


# ---- across the packages: WAL directories -------------------------------------------


def test_a_wal_directory_the_port_wrote_recovers_in_jax_to_the_port_s_state(tmp_path):
    writes = _long_writes(700)
    _written(PORT, tmp_path / "wal", writes, lookback=60.0, snapshot_every=150, segment=64)
    assert (tmp_path / "wal" / wal.SNAPSHOT_NAME).exists()
    port = _recover(PORT, tmp_path / "wal")  # a recovery writes nothing
    ref = _recover(JAX, tmp_path / "wal")
    for at in (699.0, 680.0, 650.0):
        assert _state(ref, at) == _state(port, at)
    assert _points(ref) == _points(port)
    assert ref._stale_pending == port._stale_pending
    assert ref.last_recovery == port.last_recovery


def test_jax_s_segments_recover_in_the_port_to_jax_s_state(tmp_path):
    writes = _long_writes(400, seed=5)
    _written(JAX, tmp_path / "wal", writes, lookback=60.0, segment=64)
    assert not (tmp_path / "wal" / wal.SNAPSHOT_NAME).exists()
    port = _recover(PORT, tmp_path / "wal")
    ref = _recover(JAX, tmp_path / "wal")
    assert _full(port, 399.0) == _full(ref, 399.0)
    assert port.last_recovery == ref.last_recovery


def test_a_jax_format_3_snapshot_with_rollups_is_recovered_as_jax_s(tmp_path):
    """A format-3 snapshot with downsampled rollups (a JAX DB with a
    downsample policy) recovers in the port to JAX's state: the recorded
    policy taken over, each series' rollups restored, and the recovered
    DB's own snapshot JAX's."""
    _written(JAX, tmp_path / "wal", _writes(), snapshot_every=25,
             downsample=jax_downsample.DownsamplePolicy())
    payload, _ = jax_wal.WriteAheadLog(tmp_path / "wal").read()
    assert payload["format"] == 3 and "downsample" in payload
    port, ref = _recover(PORT, tmp_path / "wal"), _recover(JAX, tmp_path / "wal")
    assert port.last_recovery == ref.last_recovery
    assert port.last_recovery["rollup_series_restored"] == sum(
        "rollup" in entry for entry in payload["series"]) > 0
    assert port.last_recovery["rollup_enabled"] is True
    assert port.rollup_steps == ref.rollup_steps == (300.0, 3600.0)
    assert _full(port, 59.0) == _full(ref, 59.0)
    assert json.dumps(port.snapshot_payload()) == json.dumps(ref.snapshot_payload())


def test_the_port_writes_format_1_which_jax_reads(tmp_path):
    """A format-1 payload (per-point triples), written by the port's WAL,
    recovers in JAX's package and in the port to the port's state; so does
    the format-3 payload the port's TSDB snapshots now (Gorilla blobs, no
    rollups)."""
    db = tsdb.TimeSeriesDB(clock.VirtualClock())
    _populate(db, _writes())
    payload = db.snapshot_payload()
    assert payload["format"] == tsdb.SNAPSHOT_FORMAT == jax_tsdb.SNAPSHOT_FORMAT == 3
    assert set(payload) == {"format", "at", "lookback", "retention", "series", "versions",
                            "stale_pending", "exemplars"}
    json.dumps(payload, allow_nan=False)  # the blobs carry every marker
    v1 = dict(payload, format=1, series=[
        {"name": name, "labels": list(labels),
         "points": [[t, None if v != v else v, o] for t, v, o in points]}
        for (name, labels), points in _points(db).items()
    ])
    for label, snap in (("v1", v1), ("v3", payload)):
        log = wal.WriteAheadLog(tmp_path / label)
        log.write_snapshot(snap)
        log.close()
        for mods in (JAX, PORT):
            back = _recover(mods, tmp_path / label)
            assert _full(back, 59.0) == _full(db, 59.0), (label, mods["tsdb"].__name__)


# ---- across the packages: the HPA's checkpoints --------------------------------------


class ScriptedAdapter:
    """An Object-metric adapter whose value the test sets before each sync."""

    def __init__(self) -> None:
        self.value = 0.0

    def get_object_metric(self, described_object, metric_name):
        return self.value


class FakeTarget:
    def __init__(self, replicas=1):
        self.replicas = replicas

    def scale_to(self, n):
        self.replicas = n


def _controller(mods, vclock, scripted, target, store):
    """tests/test_recovery.py's controller: AverageValue 10, 60 s down
    window, at most 8 replicas."""
    h = mods["hpa"]
    return h.HPAController(
        target=target,
        metrics=[h.ObjectMetricSpec(
            "m", 10.0, mods["adapter"].ObjectReference("Deployment", "d", "default"),
            average=True)],
        adapter=scripted,
        clock=vclock,
        max_replicas=8,
        behavior=h.HPABehavior(scale_down=h.ScalingRules(stabilization_window_seconds=60.0)),
        checkpoint_store=store,
    )


def _drive(ctrl, scripted, vclock, values):
    out = []
    for v in values:
        scripted.value = v
        ctrl.sync_once()
        out.append((ctrl.status.desired_replicas, ctrl.target.replicas))
        vclock.advance(15.0)
    return out


# 40 scales to 4; then 5 recommends 1, held by the 60 s window until the
# last recommendation of 4 leaves it (the seventh sync)
LOAD = [40.0, 40.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0]


def _restarted(mods, store_for, reload_in=None):
    """Four syncs, a restart from the checkpoint, four more; ``reload_in``
    builds the second controller in the other package."""
    vclock = mods["clock"].VirtualClock()
    scripted, target = ScriptedAdapter(), FakeTarget(1)
    store = store_for(mods)
    first = _drive(_controller(mods, vclock, scripted, target, store), scripted, vclock, LOAD[:4])
    second_mods = reload_in or mods
    ctrl = _controller(second_mods, vclock, scripted, target, store_for(second_mods, store))
    assert ctrl.restored_from_checkpoint is True and ctrl._recommendations
    return first + _drive(ctrl, scripted, vclock, LOAD[4:]), ctrl


def _memory(mods, reuse=None):
    return reuse or mods["checkpoint"].InMemoryCheckpointStore()


@BOTH
def test_a_restarted_hpa_recommends_as_an_uninterrupted_one(mods):
    vclock = mods["clock"].VirtualClock()
    scripted = ScriptedAdapter()
    uninterrupted = _drive(_controller(mods, vclock, scripted, FakeTarget(1), None), scripted,
                           vclock, LOAD)
    restarted, _ = _restarted(mods, _memory)
    assert restarted == uninterrupted
    assert [r for _, r in uninterrupted] == [4, 4, 4, 4, 4, 4, 1, 1]


@BOTH
def test_a_cold_restart_scales_down_early(mods):
    vclock = mods["clock"].VirtualClock()
    scripted, target = ScriptedAdapter(), FakeTarget(1)
    _drive(_controller(mods, vclock, scripted, target, None), scripted, vclock, LOAD[:4])
    cold = _controller(mods, vclock, scripted, target, None)
    assert cold.restored_from_checkpoint is False
    assert _drive(cold, scripted, vclock, LOAD[4:])[0][1] == 1


@pytest.mark.parametrize("first,second", [(PORT, JAX), (JAX, PORT)], ids=["port→jax", "jax→port"])
def test_a_checkpoint_file_restores_in_the_other_package(tmp_path, first, second):
    path = tmp_path / "hpa-checkpoint.json"

    def file_store(mods, _reuse=None):
        return mods["checkpoint"].FileCheckpointStore(path)

    restarted, ctrl = _restarted(first, file_store, reload_in=second)
    assert [r for _, r in restarted] == [4, 4, 4, 4, 4, 4, 1, 1]
    # the file the second package saved last is the schema the first writes
    own, _ = _restarted(second, _memory)
    assert restarted == own
    state = json.loads(path.read_text())
    assert set(state) == {"version", "saved_at", "recommendations", "scale_events",
                          "last_good_sync_at", "status", "condition_history"}
    assert state == {**ctrl._checkpoint_state(), "saved_at": state["saved_at"]}


def test_both_controllers_write_the_same_checkpoint():
    states = []
    for mods in (PORT, JAX):
        vclock = mods["clock"].VirtualClock()
        scripted, store = ScriptedAdapter(), mods["checkpoint"].InMemoryCheckpointStore()
        _drive(_controller(mods, vclock, scripted, FakeTarget(1), store), scripted, vclock, LOAD)
        states.append((store.load(), store.saves))
    assert states[0] == states[1]
    assert states[0][1] == len(LOAD)  # one save a sync
