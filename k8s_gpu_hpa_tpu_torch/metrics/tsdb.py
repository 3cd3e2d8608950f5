"""Mini time-series database + scrape manager (the L3 stand-in).

Counterpart of ``k8s_gpu_hpa_tpu/metrics/tsdb.py``, cut to what the port's
paths read.  In production L3 is kube-prometheus-stack; this module
reproduces the two Prometheus behaviors the pipeline depends on:

- **scrape**: pull exposition from targets every interval (the reference
  scrapes at 1 s, kube-prometheus-stack-values.yaml:5) and attach target
  metadata labels — the ``node`` relabel of
  kube-prometheus-stack-values.yaml:13-16.  Targets serve text exposition or
  pre-parsed ``MetricFamily`` lists (the structured path: the same samples,
  no text round trip).
- **instant query with staleness**: the newest point per series within a
  lookback window (Prometheus default 5 min), which is what both the
  recording-rule engine and the custom-metrics adapter consume.  A NaN point
  is a staleness marker and ends its series at once.

Series keep a bounded retention window, labels are interned and
inverted-indexed so a matcher query touches only candidate series, every
write bumps a per-name version counter (the dirty bit incremental rule
evaluation watches), and a series ended by a staleness marker is dropped by
``gc`` once the marker is older than the lookback, every ``GC_EVERY``
appends.

Columnar storage: each series is a run of sealed immutable
:class:`~k8s_gpu_hpa_tpu_torch.metrics.gorilla.GorillaChunk` columns and a
compressed head that appends encode into (metrics/gorilla.py).  The head
seals into a chunk every ``chunk_size`` points, and retention drops whole
chunks from the front once their last point is older than ``retention``.
Cached last-point scalars serve the ``at >= newest`` read with no decode;
a historical read decodes one chunk into numpy arrays (a bounded cache,
``decode_cache_hits``/``decode_cache_misses``) and ``searchsorted``s it.
``range_avg`` is ``avg_over_time``, with the query planner's chunk-summary
pushdown (metrics/planner.py).

For metric lineage every point may carry an ``origin``, the id of the span
that wrote it (obs/trace.py): the scraper's ``scrape`` span or a rule's
``rule_eval`` span.  A read bracketed by ``begin_capture``/``end_capture``
learns the origin of every point it returned.  A histogram bucket's newest
traced observation is kept as the series' exemplar (``exemplar``,
``exemplars_of``).

Durability: constructed with a ``WriteAheadLog`` (metrics/wal.py), the DB
logs every accepted append (markers and exemplars too) before the call
returns and cuts a snapshot every ``snapshot_every`` logged records;
``TimeSeriesDB.recover`` rebuilds the store from the snapshot and a replay
of the tail.  The snapshot is JAX's format 3, the Gorilla blobs verbatim;
``recover`` reads formats 1, 2 and 3.  Each sweep is a ``scrape:sweep``
profile stage and each healthy target's ingest a ``tsdb:append`` one
(obs/profile.py).

Long-horizon rollups: constructed with a
:class:`~k8s_gpu_hpa_tpu_torch.metrics.downsample.DownsamplePolicy`, sealed
raw chunks aging past the policy horizon compact into per-tier rollup rows
(count, sum, min, max, last) from the append path, and a chunk evicted by
raw retention before reaching the horizon is ingested on its way out, so
rollups never lose data to a short raw window.  ``rollup_range_avg`` serves
tier-aligned range queries from the rollups (the planner's tier
selection), ``range_avg_bucketed`` is its raw twin for bit-identity checks,
and format-3 snapshots carry the rollup state verbatim beside the raw
columns.

Targets may report how long serving took (``TimedExposition``,
``StructuredExposition``): a fetch past its target's ``deadline`` counts as
a failed scrape (``ScrapeTimeout``), which is how the chaos plane's
``slow_scrape`` bites on virtual time.
"""

from __future__ import annotations

import base64
import math
import random
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from k8s_gpu_hpa_tpu_torch.metrics.downsample import (
    DownsamplePolicy,
    Downsampler,
    fold_avg as _ds_fold_avg,
    newest_bucket_in_window as _ds_newest_bucket,
    raw_fold as _ds_raw_fold,
    restore_rollup as _ds_restore_rollup,
    serialize_rollup as _ds_serialize_rollup,
    tier_segments as _ds_tier_segments,
)
from k8s_gpu_hpa_tpu_torch.metrics.exposition import parse_text
from k8s_gpu_hpa_tpu_torch.metrics.gorilla import (
    GorillaChunk,
    GorillaEncoder,
    decode as gorilla_decode,
)
from k8s_gpu_hpa_tpu_torch.metrics.schema import Exemplar, MetricFamily, Sample
from k8s_gpu_hpa_tpu_torch.obs import profile
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock, SystemClock

LabelSet = tuple[tuple[str, str], ...]

#: the snapshot payload format ``TimeSeriesDB.snapshot`` writes, JAX's:
#: 1 = per-point JSON triples; 2 = Gorilla chunk blobs; 3 = 2 plus each
#: series' downsampled rollups (metrics/downsample.py).  ``recover`` reads
#: all three: a payload without a ``format`` field is format 1, and a
#: format 1 or 2 payload recovered into a downsampling DB rebuilds its
#: rollups from the installed raw chunks.
SNAPSHOT_FORMAT = 3


class _Series:
    """One labeled series: sealed Gorilla chunks + a compressed head.

    Points live in two places, both sorted by construction
    (``TimeSeriesDB.append`` rejects time travel):

    - ``chunks``: immutable :class:`GorillaChunk` runs of ``chunk_size``
      points, decoded lazily (and cached, bounded by the owning DB) for
      historical reads;
    - the head: a streaming :class:`GorillaEncoder` the hot append path
      writes into directly.  Keeping the head compressed matters — at a
      15 s scrape cadence a 300 s window holds ~20 points/series, *fewer*
      than one chunk, so an uncompressed head would dominate retained
      bytes and erase the whole compression win.

    ``last_ts``/``last_val``/``last_origin`` mirror the newest point so the
    dominant ``at >= newest`` read never touches the encoder.  Retention
    drops whole chunks from the front once their ``last_ts`` ages out; a
    staleness marker can only be dropped together with every point BEFORE
    it (chunk drops are strict prefixes), so trimming can never resurrect
    an ended series: a historical read that would have hit the marker now
    finds nothing at all, which reads the same (None).
    """

    __slots__ = ("labels", "chunks", "enc", "head_origins", "head_first_ts",
                 "last_ts", "last_val", "last_origin", "_head_cache", "rollup")

    def __init__(self, labels: LabelSet):
        self.labels = labels
        self.chunks: list[GorillaChunk] = []
        self.enc = GorillaEncoder()
        #: origin span ids parallel to the head stream (obs/trace.py), or
        #: None while every head point is untraced (the common case)
        self.head_origins: list[int | None] | None = None
        self.head_first_ts = 0.0
        self.last_ts = -math.inf
        self.last_val = math.nan
        self.last_origin: int | None = None
        #: memoized head decode, invalidated by count (appends bump it)
        self._head_cache: tuple | None = None
        #: SeriesRollups (metrics/downsample.py) once the owning DB's
        #: downsampler has touched this series, else None
        self.rollup = None

    def push(self, ts: float, value: float, origin: int | None) -> None:
        """Store one point (``TimeSeriesDB.append`` and the restore paths).
        Caller seals/trims."""
        enc = self.enc
        if enc.count == 0:
            self.head_first_ts = ts
        enc.append(ts, value)
        origins = self.head_origins
        if origin is not None:
            if origins is None:
                origins = self.head_origins = [None] * (enc.count - 1)
            origins.append(origin)
        elif origins is not None:
            origins.append(None)
        self._head_cache = None
        self.last_ts = ts
        self.last_val = value
        self.last_origin = origin

    def seal_head(self) -> None:
        """Freeze the head streams into an immutable chunk — O(1) in the
        point count (the byte buffers are copied, never re-encoded)."""
        enc = self.enc
        origins = self.head_origins
        self.chunks.append(
            GorillaChunk(
                enc.count,
                bytes(enc.ts_buf),
                bytes(enc.val_buf),
                self.head_first_ts,
                self.last_ts,
                None if origins is None else tuple(origins),
                enc.ts_mode,
                enc.summary(),
            )
        )
        enc.reset()
        self.head_origins = None
        self._head_cache = None

    def head_arrays(self):
        """Decoded (ts, values) arrays of the head stream, memoized until
        the next append."""
        enc = self.enc
        cache = self._head_cache
        if cache is not None and cache[0] == enc.count:
            return cache[1], cache[2]
        ts_arr, val_arr = gorilla_decode(
            bytes(enc.ts_buf), bytes(enc.val_buf), enc.count, enc.ts_mode
        )
        self._head_cache = (enc.count, ts_arr, val_arr)
        return ts_arr, val_arr

    def npoints(self) -> int:
        return self.enc.count + sum(c.count for c in self.chunks)

    def nbytes(self) -> int:
        """Retained compressed bytes (blobs + 8 per tracked origin)."""
        enc = self.enc
        n = len(enc.ts_buf) + len(enc.val_buf)
        if self.head_origins is not None:
            n += 8 * len(self.head_origins)
        for chunk in self.chunks:
            n += chunk.nbytes()
        return n

    def _locate(self, at: float, chunk_arrays=None):
        """Newest (ts, value, origin) at/before ``at`` — no staleness or
        lookback policy (callers apply it).  ``chunk_arrays`` is the owning
        DB's cached decoder; defaults to uncached decode."""
        enc = self.enc
        if enc.count and at >= self.head_first_ts:
            ts_arr, val_arr = self.head_arrays()
            idx = int(ts_arr.searchsorted(at, side="right")) - 1
            if idx >= 0:
                origins = self.head_origins
                return (
                    float(ts_arr[idx]),
                    float(val_arr[idx]),
                    None if origins is None else origins[idx],
                )
        for chunk in reversed(self.chunks):
            if chunk.first_ts <= at:
                if chunk_arrays is None:
                    ts_arr, val_arr = chunk.arrays()
                else:
                    ts_arr, val_arr = chunk_arrays(chunk)
                idx = int(ts_arr.searchsorted(at, side="right")) - 1
                if idx < 0:
                    return None
                origins = chunk.origins
                return (
                    float(ts_arr[idx]),
                    float(val_arr[idx]),
                    None if origins is None else origins[idx],
                )
        return None

    def latest_point_at(
        self, at: float, lookback: float, chunk_arrays=None
    ) -> tuple[float, float, int | None] | None:
        """The newest (ts, value, origin) at or before ``at``, unless it is
        a staleness marker or older than the lookback: the per-series read
        of ``TimeSeriesDB.latest_of``, which ``instant_vector`` and the
        planner's scans share."""
        # Fast path: the common ``at=now`` read lands at/after the newest
        # point, served from the cached scalars with no decode at all.
        last_ts = self.last_ts
        if at >= last_ts:
            if last_ts == -math.inf:
                return None
            value = self.last_val
            # A NaN point is a staleness marker (Prometheus semantics:
            # written when a scrape fails or a rule's output series
            # disappears) and ends the series immediately.  value != value
            # is the allocation-free math.isnan.
            if value != value or at - last_ts > lookback:
                return None
            return (last_ts, value, self.last_origin)
        point = self._locate(at, chunk_arrays)
        if point is None:
            return None
        value = point[1]
        if value != value or at - point[0] > lookback:
            return None
        return point

    # -- decoded views (tests, tooling; not on any hot path) -----------------

    @property
    def points(self) -> list[tuple[float, float, int | None]]:
        """All retained (ts, value, origin) tuples, decoded: the view a
        format-1 snapshot carries."""
        out: list[tuple[float, float, int | None]] = []
        for chunk in self.chunks:
            ts_arr, val_arr = chunk.arrays()
            origins = chunk.origins
            if origins is None:
                origins = (None,) * chunk.count
            out.extend(zip(ts_arr.tolist(), val_arr.tolist(), origins))
        if self.enc.count:
            ts_arr, val_arr = self.head_arrays()
            origins = self.head_origins
            if origins is None:
                origins = (None,) * self.enc.count
            out.extend(zip(ts_arr.tolist(), val_arr.tolist(), origins))
        return out


class TimeSeriesDB:
    """Store of named series with bounded retention, queried as instant vectors."""

    #: amortized GC cadence: every this-many appends, sweep series whose
    #: staleness marker has aged out of the lookback window
    GC_EVERY = 4096

    #: chunks allowed to hold a decoded numpy cache at once (historical
    #: reads cluster on recent chunks; the blobs themselves always stay)
    DECODE_CACHE_CHUNKS = 32

    def __init__(
        self,
        clock: Clock | None = None,
        lookback: float = 300.0,
        retention: float | None = None,
        wal=None,
        snapshot_every: int = 8192,
        chunk_size: int = 64,
        downsample: DownsamplePolicy | None = None,
    ):
        self.clock = clock or SystemClock()
        self.lookback = lookback
        #: per-series retained window; never below lookback (a shorter
        #: retention would drop points still visible to ``at >= newest``
        #: queries).  Historical queries older than this see trimmed data.
        self.retention = lookback if retention is None else max(retention, lookback)
        self._data: dict[str, dict[LabelSet, _Series]] = {}
        #: inverted label index per name: (key, value) -> ordered set of the
        #: label sets carrying that pair (dict-as-ordered-set keeps matcher
        #: query results deterministic run-to-run, unlike a hash set)
        self._index: dict[str, dict[tuple[str, str], dict[LabelSet, None]]] = {}
        #: label-set interning pool: every stored series shares one canonical
        #: tuple object per distinct label set, so dict probes on the hot
        #: append path win the identity comparison before any tuple compare
        self._intern: dict[LabelSet, LabelSet] = {}
        #: per-name monotonic write counters — the dirty bits incremental
        #: rule evaluation (rules.py) compares between evals
        self._versions: dict[str, int] = {}
        #: (name, labels) -> marker ts for series ended by a staleness
        #: marker; the GC sweep drops them once the marker ages out
        self._stale_pending: dict[tuple[str, LabelSet], float] = {}
        #: (name, labels) -> latest Exemplar attached to that series (the
        #: metrics→traces bridge: a histogram bucket's newest traced
        #: observation).  Persisted through WAL records and snapshots.
        self._exemplars: dict[tuple[str, LabelSet], Exemplar] = {}
        #: seal the compressed head into an immutable chunk every this-many
        #: points per series (Prometheus defaults to 120; 64 keeps retention
        #: granularity fine enough for the 300 s default window)
        self.chunk_size = chunk_size
        #: chunks currently holding a decoded cache, eviction order (each
        #: chunk appears at most once: it joins on decode, leaves on evict)
        self._decoded_chunks: deque[GorillaChunk] = deque()
        #: decoded-window cache traffic (the planner/self-metrics surface:
        #: a hit serves a sealed chunk's columns without a Gorilla decode)
        self.decode_cache_hits = 0
        self.decode_cache_misses = 0
        #: per-name series-SET generation: bumped only when a series is
        #: created or GC-dropped for that name — the planner's cheap validity
        #: check for a resolved series set (unlike ``_versions``, which
        #: bumps on every append)
        self._series_gen: dict[str, int] = {}
        self._total_points = 0
        self._appends_since_gc = 0
        #: active read-capture sink (see begin_capture), else None
        self._capture: (
            list[tuple[str, LabelSet, float, float, int | None, str]] | None
        ) = None
        #: metrics.wal.WriteAheadLog, or None for the memory-only default;
        #: every accepted append is logged, and a snapshot is cut every
        #: ``snapshot_every`` logged records (bounding restart replay)
        self.wal = wal
        self.snapshot_every = snapshot_every
        self._wal_records_since_snapshot = 0
        #: True while ``recover`` replays the WAL tail: suspends re-logging
        self._replaying = False
        #: stats of the recovery that built this instance (``recover``), or
        #: None for a cold-started DB
        self.last_recovery: dict | None = None
        #: the rollup compaction engine (metrics/downsample.py), or None for
        #: a raw-only store (the default: rollups cost ingest work and only
        #: long-horizon surfaces read them)
        self._downsampler = (
            None if downsample is None else Downsampler(downsample, chunk_size)
        )

    def append(
        self,
        name: str,
        labels: LabelSet,
        value: float,
        ts: float | None = None,
        origin: int | None = None,
        exemplar: Exemplar | None = None,
    ) -> None:
        ts = self.clock.now() if ts is None else ts
        by_name = self._data.get(name)
        if by_name is None:
            by_name = self._data[name] = {}
        series = by_name.get(labels)
        if series is None:
            labels = self._intern.setdefault(labels, labels)
            series = by_name[labels] = _Series(labels)
            index = self._index.setdefault(name, {})
            for pair in labels:
                index.setdefault(pair, {})[labels] = None
            self._series_gen[name] = self._series_gen.get(name, 0) + 1
        elif ts < series.last_ts:
            # Out-of-order appends would silently break the sorted-columns/
            # scan-from-end invariant every read relies on; reject loudly.
            # Equal timestamps are allowed (a re-write within one tick wins).
            raise ValueError(
                f"out-of-order append to {name}{dict(series.labels)}: "
                f"ts {ts} < newest {series.last_ts}"
            )
        # Store the point, seal a full head into a chunk, then drop whole
        # aged-out chunks from the front: amortized O(1), and a strict
        # prefix drop can never resurrect a marker-ended series.
        series.push(ts, value, origin)
        if series.enc.count >= self.chunk_size:
            series.seal_head()
        dropped = 0
        chunks = series.chunks
        ds = self._downsampler
        if ds is None:
            roll = None
        else:
            # rollup compaction: ingest the sealed chunks aged past the
            # horizon (the guard is one list probe and a compare an append)
            roll = series.rollup
            if roll is None:
                roll = series.rollup = ds.new_state()
            k = roll.ingested
            if k < len(chunks) and chunks[k].last_ts < ts - ds.horizon:
                ds.ingest_pending(roll, chunks, ts)
        if chunks:
            cutoff = ts - self.retention
            while chunks and chunks[0].last_ts < cutoff:
                if roll is not None:
                    if roll.ingested:
                        roll.ingested -= 1
                    else:
                        # compact on evict: a chunk dropped before aging past
                        # the horizon is ingested on its way out, so a raw
                        # window shorter than the horizon loses nothing
                        ds.ingest_chunk(roll, chunks[0])
                dropped += chunks.pop(0).count
        self._total_points += 1 - dropped
        self._versions[name] = self._versions.get(name, 0) + 1
        if value != value:  # NaN marker: schedule the ended series for GC
            self._stale_pending[(name, series.labels)] = ts
        elif self._stale_pending:
            # a live point resurrects a marker-ended series: cancel its GC
            self._stale_pending.pop((name, series.labels), None)
        if exemplar is not None:
            self._exemplars[(name, series.labels)] = exemplar
        self._appends_since_gc += 1
        if self._appends_since_gc >= self.GC_EVERY:
            self.gc()
        if self.wal is not None and not self._replaying:
            self.wal.log_append(name, series.labels, value, ts, origin, exemplar)
            self._wal_records_since_snapshot += 1
            if self._wal_records_since_snapshot >= self.snapshot_every:
                self.snapshot()

    def gc(self) -> int:
        """Drop series whose staleness marker has aged out of the lookback
        window: no ``at >= marker + lookback`` query can distinguish the
        dropped series from the marker it already could not see past.  Runs
        amortized from ``append`` (every GC_EVERY writes); callable directly
        by harnesses.  Returns the number of series dropped."""
        self._appends_since_gc = 0
        if not self._stale_pending:
            return 0
        now = self.clock.now()
        dropped = 0
        for key, marker_ts in list(self._stale_pending.items()):
            if now - marker_ts <= self.lookback:
                continue
            del self._stale_pending[key]
            self._exemplars.pop(key, None)
            name, labels = key
            by_name = self._data.get(name)
            series = by_name.pop(labels, None) if by_name is not None else None
            if series is None:
                continue
            self._total_points -= series.npoints()
            index = self._index.get(name)
            if index is not None:
                for pair in labels:
                    bucket = index.get(pair)
                    if bucket is not None:
                        bucket.pop(labels, None)
                        if not bucket:
                            del index[pair]
                if not index:
                    del self._index[name]
            if not by_name:
                del self._data[name]
            self._series_gen[name] = self._series_gen.get(name, 0) + 1
            dropped += 1
        return dropped

    # ---- durability (WAL snapshot + recovery) ------------------------------

    def snapshot(self) -> None:
        """Cut a full-state snapshot into the WAL and truncate the segments
        it subsumes.  Captures everything a restart needs byte-for-byte:
        retained points WITH their origin span ids (so lineage survives the
        restart boundary), the per-name version counters (so incremental rule
        eval's dirty-bit comparisons stay semantically exact), and the
        pending-staleness map (so marker GC resumes where it left off).

        Format 3 (:meth:`snapshot_payload`): the compressed columns travel
        verbatim — sealed chunks and the head stream are base64 blobs, so
        NaN markers, ±inf, and every bit of every float round-trip exactly (no JSON float re-encoding,
        and no reliance on JSON's non-standard NaN literal)."""
        if self.wal is None:
            return
        self.wal.write_snapshot(self.snapshot_payload())
        self._wal_records_since_snapshot = 0

    def snapshot_payload(self) -> dict:
        """The format-3 snapshot payload, built without touching the WAL:
        each series' sealed chunks and head as base64 Gorilla blobs with
        their origins and its rollups, the version counters, the
        pending-staleness map, the exemplars and the downsample policy.  It is JSON-equal to the JAX package's for the same
        appends, and :meth:`recover` of either package restores it."""
        b64 = base64.b64encode
        series_out = []
        for name, by_name in self._data.items():
            for series in by_name.values():
                enc = series.enc
                entry = {
                    "name": name,
                    "labels": list(series.labels),
                    "chunks": [
                        [
                            c.count,
                            b64(c.ts_blob).decode("ascii"),
                            b64(c.val_blob).decode("ascii"),
                            None if c.origins is None else list(c.origins),
                            c.first_ts,
                            c.last_ts,
                            c.ts_mode,
                        ]
                        for c in series.chunks
                    ],
                    "head": [
                        enc.count,
                        b64(bytes(enc.ts_buf)).decode("ascii"),
                        b64(bytes(enc.val_buf)).decode("ascii"),
                        None
                        if series.head_origins is None
                        else list(series.head_origins),
                        enc.ts_mode,
                    ],
                }
                if series.rollup is not None:
                    # format 3: the rollup columns travel verbatim beside the
                    # raw ones, so compaction survives the restart
                    entry["rollup"] = _ds_serialize_rollup(series.rollup, b64)
                series_out.append(entry)
        payload = {
            "format": SNAPSHOT_FORMAT,
            "at": self.clock.now(),
            "lookback": self.lookback,
            "retention": self.retention,
            "series": series_out,
            "versions": dict(self._versions),
            "stale_pending": [
                [name, list(labels), ts]
                for (name, labels), ts in self._stale_pending.items()
            ],
            "exemplars": [
                [name, list(labels), ex.value, ex.trace_id, ex.span_id, ex.ts]
                for (name, labels), ex in self._exemplars.items()
            ],
        }
        ds = self._downsampler
        if ds is not None:
            payload["downsample"] = {
                "steps": list(ds.steps),
                "horizon": ds.horizon,
                "retention": ds.retention,
            }
        return payload

    @classmethod
    def recover(
        cls,
        wal,
        clock: Clock | None = None,
        lookback: float = 300.0,
        retention: float | None = None,
        snapshot_every: int = 8192,
        chunk_size: int = 64,
        downsample: DownsamplePolicy | None = None,
    ) -> "TimeSeriesDB":
        """Rebuild a TSDB from its durable state: restore the snapshot, then
        replay the WAL tail in append order.  Replay goes through ``append``
        itself, so the inverted index, the interning pool, the version
        counters, retention and the staleness bookkeeping are rebuilt by the
        code that built them the first time.  A tail record at the newest
        timestamp of its series appends (a snapshot cut inside a tick); one
        that lands out of order (after a ``wal_truncate`` tear) is dropped,
        never fatal.

        The snapshot's format is read here: format 2 or 3 installs the
        Gorilla blobs verbatim (chunks byte for byte, the head encoder
        resumed mid-stream); a payload without a ``format`` field is format
        1, whose per-point triples re-encode through the columnar path.
        Format 3 adds each series' rollups, restored verbatim when the
        recovered DB downsamples; a format 1 or 2 payload (or a newly
        enabled policy) rebuilds them by re-ingesting the installed raw
        chunks, and ``downsample=None`` takes the policy the payload
        records, so a restart keeps compacting without being told how.

        The DB takes over ``wal`` and stamps ``last_recovery`` with the
        replay's stats; ``replay_gap_seconds`` is the clock's time less the
        newest timestamp recovered."""
        payload, tail = wal.read()
        if downsample is None and payload is not None:
            ds_payload = payload.get("downsample")
            if ds_payload is not None:
                downsample = DownsamplePolicy(
                    tuple(ds_payload["steps"]),
                    ds_payload["horizon"],
                    ds_payload["retention"],
                )
        db = cls(
            clock,
            lookback=(payload or {}).get("lookback", lookback),
            retention=(payload or {}).get("retention", retention),
            snapshot_every=snapshot_every,
            chunk_size=chunk_size,
            downsample=downsample,
        )
        newest_ts = -math.inf
        recovered_points = 0
        rollup_restored = 0
        rollup_rebuilt = 0
        if payload is not None:
            fmt = payload.get("format", 1)
            b64 = base64.b64decode
            for entry in payload["series"]:
                name = entry["name"]
                labels = tuple((k, v) for k, v in entry["labels"])
                labels = db._intern.setdefault(labels, labels)
                series = _Series(labels)
                if fmt >= 2:
                    for count, tsb, vb, origins, first_ts, last_ts, mode in entry[
                        "chunks"
                    ]:
                        series.chunks.append(
                            GorillaChunk(
                                count,
                                b64(tsb),
                                b64(vb),
                                first_ts,
                                last_ts,
                                None if origins is None else tuple(origins),
                                mode,
                            )
                        )
                    hcount, htsb, hvb, horigins, hmode = entry["head"]
                    if hcount:
                        series.enc.restore(b64(htsb), b64(hvb), hcount, hmode)
                        series.head_origins = (
                            None if horigins is None else list(horigins)
                        )
                        ts_arr, val_arr = series.head_arrays()
                        series.head_first_ts = float(ts_arr[0])
                        series.last_ts = float(ts_arr[-1])
                        series.last_val = float(val_arr[-1])
                        series.last_origin = (
                            None
                            if series.head_origins is None
                            else series.head_origins[-1]
                        )
                    elif series.chunks:
                        last = series.chunks[-1]
                        ts_arr, val_arr = db._chunk_arrays(last)
                        series.last_ts = float(ts_arr[-1])
                        series.last_val = float(val_arr[-1])
                        series.last_origin = (
                            None if last.origins is None else last.origins[-1]
                        )
                else:
                    # v1: per-point triples (NaN as null), re-encoded through
                    # the same storage path that builds live series
                    for ts, value, origin in entry["points"]:
                        series.push(
                            ts, float("nan") if value is None else value, origin
                        )
                        if series.enc.count >= db.chunk_size:
                            series.seal_head()
                if series.last_ts == -math.inf:
                    continue  # empty series: nothing to install
                ds = db._downsampler
                if ds is not None:
                    roll_payload = entry.get("rollup") if fmt >= 3 else None
                    if roll_payload is not None:
                        series.rollup = _ds_restore_rollup(ds, roll_payload, b64)
                        rollup_restored += 1
                    elif series.chunks:
                        # no rollups in the payload: rebuild them from the
                        # aged raw chunks, aged against the series' own
                        # newest timestamp (the "now" of its last append;
                        # the snapshot's ``at`` may be another clock's)
                        roll = series.rollup = ds.new_state()
                        ds.ingest_pending(roll, series.chunks, series.last_ts)
                        rollup_rebuilt += 1
                db._data.setdefault(name, {})[labels] = series
                index = db._index.setdefault(name, {})
                for pair in labels:
                    index.setdefault(pair, {})[labels] = None
                npts = series.npoints()
                db._total_points += npts
                recovered_points += npts
                newest_ts = max(newest_ts, series.last_ts)
            db._versions.update(payload.get("versions", {}))
            for name, labels, ts in payload.get("stale_pending", []):
                labels = tuple((k, v) for k, v in labels)
                labels = db._intern.setdefault(labels, labels)
                db._stale_pending[(name, labels)] = ts
            for name, labels, value, trace_id, span_id, ex_ts in payload.get(
                "exemplars", []
            ):
                labels = tuple((k, v) for k, v in labels)
                labels = db._intern.setdefault(labels, labels)
                db._exemplars[(name, labels)] = Exemplar(
                    value, trace_id, span_id, ex_ts
                )
        replayed = 0
        dropped = 0
        db._replaying = True
        try:
            for rec in tail:
                labels = tuple((k, v) for k, v in rec["labels"])
                value = float("nan") if rec["op"] == "stale" else rec["value"]
                ex_rec = rec.get("exemplar")
                exemplar = (
                    None
                    if ex_rec is None
                    else Exemplar(
                        ex_rec["value"],
                        ex_rec["trace_id"],
                        ex_rec["span_id"],
                        ex_rec.get("ts"),
                    )
                )
                try:
                    db.append(
                        rec["name"],
                        labels,
                        value,
                        rec["ts"],
                        rec.get("origin"),
                        exemplar=exemplar,
                    )
                except ValueError:
                    dropped += 1
                    continue
                replayed += 1
                recovered_points += 1
                newest_ts = max(newest_ts, rec["ts"])
        finally:
            db._replaying = False
        db.wal = wal
        now = db.clock.now()
        db.last_recovery = {
            "snapshot_restored": payload is not None,
            "recovered_series": db.series_count(),
            "recovered_points": recovered_points,
            "replayed_records": replayed,
            "dropped_records": dropped,
            "newest_ts": None if newest_ts == -math.inf else newest_ts,
            "replay_gap_seconds": (
                max(0.0, now - newest_ts) if newest_ts != -math.inf else None
            ),
            "rollup_series_restored": rollup_restored,
            "rollup_series_rebuilt": rollup_rebuilt,
            "rollup_enabled": db._downsampler is not None,
        }
        return db

    # ---- read capture (metric lineage) ------------------------------------
    #
    # Rule evaluations and adapter queries learn their exact inputs by
    # bracketing their reads: every point an instant query returns while a
    # capture is active is recorded with its origin span id.  This keeps
    # lineage out of the expression AST and the adapter's query logic — the
    # DB is the one chokepoint every read goes through, index or not.

    def begin_capture(self) -> None:
        self._capture = []

    def end_capture(
        self,
    ) -> list[tuple[str, LabelSet, float, float, int | None, str]]:
        """Stop capturing; returns (name, labels, ts, value, origin, tier)
        per point read since begin_capture — ``tier`` names the storage the
        read was served from (``"raw"``, or a rollup label like ``"5m"``)."""
        captured, self._capture = self._capture or [], None
        return captured

    def series_for(
        self, name: str, matchers: dict[str, str] | None = None
    ) -> list:
        """Resolve the matching ``_Series`` set via the inverted index —
        the label-matcher pushdown the planner caches per plan, validated
        against :meth:`series_generation`, and resolved afresh on each
        :meth:`instant_vector`."""
        by_name = self._data.get(name)
        if not by_name:
            return []
        if not matchers:
            return list(by_name.values())
        index = self._index.get(name, {})
        buckets: list[dict[LabelSet, None]] = []
        for pair in matchers.items():
            bucket = index.get(pair)
            if not bucket:
                return []
            buckets.append(bucket)
        buckets.sort(key=len)
        smallest, rest = buckets[0], buckets[1:]
        if rest:
            return [by_name[ls] for ls in smallest if all(ls in b for b in rest)]
        return [by_name[ls] for ls in smallest]

    def series_generation(self, name: str) -> int:
        """Monotonic counter bumped when a series of ``name`` is created or
        dropped (NOT on appends): the planner's series-set cache validator."""
        return self._series_gen.get(name, 0)

    def instant_vector(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        at: float | None = None,
    ) -> list[Sample]:
        """All series of ``name`` matching label equalities, at their latest value."""
        at = self.clock.now() if at is None else at
        return self.latest_of(name, self.series_for(name, matchers), at)

    def latest_of(self, name: str, series_list, at: float) -> list[Sample]:
        """Each series' newest point at ``at`` (``_Series.latest_point_at``:
        staleness markers and lookback-expired points end a series), as
        samples, recorded in the read capture: the instant read that
        :meth:`instant_vector` and the planner's cached series sets share."""
        lookback = self.lookback
        capture = self._capture
        chunk_arrays = self._chunk_arrays
        out: list[Sample] = []
        for series in series_list:
            point = series.latest_point_at(at, lookback, chunk_arrays)
            if point is None:
                continue
            if capture is not None:
                capture.append((name, series.labels, *point, "raw"))
            out.append(Sample(point[1], series.labels))
        return out

    def range_avg(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        window_s: float = 0.0,
        at: float | None = None,
        use_summaries: bool = False,
        stats=None,
    ) -> list[Sample]:
        """``avg_over_time(name{matchers}[window])``: per-series mean over
        points in ``(at - window_s, at]``, NaN staleness markers excluded
        (range-vector semantics: markers are not samples, and lookback does
        not apply).  The window is left-open (a point exactly at
        ``at - window_s`` is out), as Prometheus 3's range selectors and
        the JAX package's rollup tiers read it.

        Both execution paths produce **bit-identical** floats by sharing one
        accumulation shape: each segment (sealed chunk, then head) reduces to
        a left-to-right subtotal over its in-window slice, and subtotals fold
        into the running sum in segment order.  With ``use_summaries`` a chunk
        fully inside the window contributes its seal-time summary — the same
        left-to-right sum its decode-scan would produce — without touching
        the Gorilla blobs (``stats.fastpath``); partial chunks and the head
        decode as usual (``stats.fallback``).

        Capture records the newest in-window non-NaN point per contributing
        series (the provenance hop lineage walks), identically on both paths.
        """
        at = self.clock.now() if at is None else at
        start = at - window_s
        capture = self._capture
        chunk_arrays = self._chunk_arrays
        out: list[Sample] = []
        for series in self.series_for(name, matchers):
            n = 0
            total = 0.0
            for chunk in series.chunks:
                if chunk.last_ts <= start or chunk.first_ts > at:
                    continue
                if use_summaries and chunk.first_ts > start:
                    # sorted columns: last_ts <= at is implied unless the
                    # query cuts mid-chunk, checked explicitly
                    if chunk.last_ts <= at:
                        sc, ssum = chunk.ensure_summary()[:2]
                        if stats is not None:
                            stats.fastpath += 1
                        if sc:
                            n += sc
                            total += ssum
                        continue
                if stats is not None:
                    stats.fallback += 1
                ts_arr, val_arr = chunk_arrays(chunk)
                lo = int(ts_arr.searchsorted(start, side="right"))
                hi = int(ts_arr.searchsorted(at, side="right"))
                sub_n = 0
                sub = 0.0
                for v in val_arr[lo:hi].tolist():
                    if v == v:
                        sub_n += 1
                        sub += v
                if sub_n:
                    n += sub_n
                    total += sub
            if (
                series.enc.count
                and series.last_ts > start
                and series.head_first_ts <= at
            ):
                ts_arr, val_arr = series.head_arrays()
                lo = int(ts_arr.searchsorted(start, side="right"))
                hi = int(ts_arr.searchsorted(at, side="right"))
                sub_n = 0
                sub = 0.0
                for v in val_arr[lo:hi].tolist():
                    if v == v:
                        sub_n += 1
                        sub += v
                if sub_n:
                    n += sub_n
                    total += sub
            if n == 0:
                continue
            if capture is not None:
                point = self._newest_in_window(series, start, at)
                if point is not None:
                    capture.append(
                        (name, series.labels, point[0], point[1], point[2], "raw")
                    )
            out.append(Sample(total / n, series.labels))
        return out

    def _newest_in_window(
        self, series: _Series, start: float, at: float
    ) -> tuple[float, float, int | None] | None:
        """Newest non-NaN point with ``start < ts <= at`` — the capture
        representative of a range read (head first, then chunks newest-first)."""
        if series.enc.count and series.head_first_ts <= at:
            ts_arr, val_arr = series.head_arrays()
            hi = int(ts_arr.searchsorted(at, side="right"))
            for i in range(hi - 1, -1, -1):
                if float(ts_arr[i]) <= start:
                    break
                v = float(val_arr[i])
                if v == v:
                    origins = series.head_origins
                    return (
                        float(ts_arr[i]),
                        v,
                        None if origins is None else origins[i],
                    )
        for chunk in reversed(series.chunks):
            if chunk.first_ts > at:
                continue
            if chunk.last_ts <= start:
                break
            ts_arr, val_arr = self._chunk_arrays(chunk)
            hi = int(ts_arr.searchsorted(at, side="right"))
            for i in range(hi - 1, -1, -1):
                if float(ts_arr[i]) <= start:
                    break
                v = float(val_arr[i])
                if v == v:
                    origins = chunk.origins
                    return (
                        float(ts_arr[i]),
                        v,
                        None if origins is None else origins[i],
                    )
        return None

    # ---- downsampled rollup tiers (metrics/downsample.py) ------------------

    @property
    def rollup_steps(self) -> tuple[float, ...]:
        """Configured tier resolutions, finest first; empty when raw-only.
        The planner's tier-selection menu."""
        ds = self._downsampler
        return () if ds is None else ds.steps

    @property
    def downsample_policy(self) -> DownsamplePolicy | None:
        ds = self._downsampler
        return None if ds is None else ds.policy

    def rollup_range_avg(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        window_s: float = 0.0,
        at: float | None = None,
        step: float | None = None,
        stats=None,
    ) -> list[Sample] | None:
        """``avg_over_time`` served from the ``step`` rollup tier, or None
        when the tier cannot serve it faithfully (no downsampler, unknown
        step, or any matching series not compacted through ``at`` yet) —
        the caller falls back to :meth:`range_avg`.

        The window is the tier-aligned ``(at - window_s, at]``; bucket rows
        fold through the shared segment shape (full rollup chunks via their
        seal-time column sums, boundary chunks and the head decoded), so the
        result is bit-identical to :meth:`range_avg_bucketed` — the raw twin
        — by construction.  Capture records the newest in-window bucket per
        series with the tier's label (``"5m"``/``"1h"``), origin None:
        rollups aggregate many origins, and lineage stays honest by naming
        the tier instead of inventing a span."""
        series_list = self.series_for(name, matchers)
        if not series_list:
            return []
        ds = self._downsampler
        if ds is None:
            return None
        ti = ds.tier_index(step)
        if ti is None:
            return None
        at = self.clock.now() if at is None else at
        # tier alignment is enforced here, not trusted from the caller: an
        # unaligned window cuts buckets mid-span and silently diverges from
        # raw semantics, so it must fall back instead
        if window_s < step or window_s % step != 0.0 or at % step != 0.0:
            return None
        start = at - window_s
        label = ds.labels[ti]
        capture = self._capture
        chunk_arrays = self._chunk_arrays
        out: list[Sample] = []
        for series in series_list:
            roll = series.rollup
            tier = None if roll is None else roll.tiers[ti]
            if tier is None or tier.covered_through < at:
                # a series born after the window contributes nothing either
                # way; anything else forces the whole query back to raw
                if series.chunks:
                    first_ts = series.chunks[0].first_ts
                elif series.enc.count:
                    first_ts = series.head_first_ts
                else:
                    first_ts = math.inf
                if first_ts > at:
                    continue
                return None
            n, total = _ds_fold_avg(
                _ds_tier_segments(tier, chunk_arrays), start, at, stats
            )
            if n == 0:
                continue
            if capture is not None:
                bucket = _ds_newest_bucket(tier, start, at, chunk_arrays)
                if bucket is not None:
                    capture.append(
                        (name, series.labels, bucket[0], bucket[5], None, label)
                    )
            out.append(Sample(total / n, series.labels))
        if stats is not None:
            stats.rollup_reads[label] = stats.rollup_reads.get(label, 0) + 1
        return out

    def range_avg_bucketed(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        window_s: float = 0.0,
        at: float | None = None,
        step: float | None = None,
    ) -> list[Sample]:
        """The raw twin of :meth:`rollup_range_avg`: regenerate ``step``
        bucket rows from the retained RAW points and run the identical
        segment fold over ``(at - window_s, at]``.  Exists for the
        differential gates (bench, doctor, tests): where raw retention still
        covers the span, its floats must equal the rollup read's bit for
        bit.  No capture — this is a verification surface, not a query
        path."""
        if step is None or step <= 0:
            raise ValueError(f"range_avg_bucketed needs a positive step: {step}")
        at = self.clock.now() if at is None else at
        start = at - window_s
        chunk_arrays = self._chunk_arrays
        out: list[Sample] = []
        for series in self.series_for(name, matchers):
            n, total = _ds_raw_fold(
                series, step, self.chunk_size, start, at, chunk_arrays
            )
            if n == 0:
                continue
            out.append(Sample(total / n, series.labels))
        return out

    def rollup_rows(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        start: float = -math.inf,
        at: float = math.inf,
        step: float | None = None,
    ) -> list[tuple[LabelSet, list[tuple]]]:
        """Stored rollup rows per matching series — ``(labels, rows)`` with
        each row ``(end, count, sum, min, max, last)`` and end in
        ``(start, at]``.  The flight recorder's bulk read; empty when the
        tier is absent."""
        ds = self._downsampler
        if ds is None:
            return []
        ti = ds.tier_index(step)
        if ti is None:
            return []
        chunk_arrays = self._chunk_arrays
        out = []
        for series in self.series_for(name, matchers):
            roll = series.rollup
            if roll is None:
                continue
            rows: list[tuple] = []
            for seg in _ds_tier_segments(roll.tiers[ti], chunk_arrays):
                if seg.last_ts <= start or seg.first_ts > at:
                    continue
                ends, cols = seg.cols()
                for i in range(len(ends)):
                    end = float(ends[i])
                    if end <= start or end > at:
                        continue
                    rows.append((end,) + tuple(float(c[i]) for c in cols))
            if rows:
                out.append((series.labels, rows))
        return out

    def rollup_storage_stats(self) -> dict:
        """Rollup-plane accounting for the bench/doctor surface: per-tier
        chunk/bucket/byte totals plus the downsampler's lifetime counters."""
        ds = self._downsampler
        if ds is None:
            return {"enabled": False, "tiers": {}}
        per_tier: dict[str, dict] = {
            label: {"series": 0, "chunks": 0, "buckets": 0, "bytes": 0}
            for label in ds.labels
        }
        total_bytes = 0
        for by_name in self._data.values():
            for series in by_name.values():
                roll = series.rollup
                if roll is None:
                    continue
                for label, tier in zip(ds.labels, roll.tiers):
                    buckets = tier.nbuckets()
                    if not buckets and not tier.chunks:
                        continue
                    entry = per_tier[label]
                    entry["series"] += 1
                    entry["chunks"] += len(tier.chunks)
                    entry["buckets"] += buckets
                    nbytes = tier.nbytes()
                    entry["bytes"] += nbytes
                    total_bytes += nbytes
        return {
            "enabled": True,
            "tiers": per_tier,
            "rollup_bytes": total_bytes,
            "ingested_points": ds.ingested_points,
            "ingested_chunks": ds.ingested_chunks,
            "ingested_bytes": ds.ingested_bytes,
            "sealed_buckets": ds.sealed_buckets,
            "dropped_buckets": ds.dropped_buckets,
        }

    def _chunk_arrays(self, chunk: GorillaChunk):
        """Decoded (ts, values) arrays of a sealed chunk, cached on the
        chunk itself; at most ``DECODE_CACHE_CHUNKS`` caches stay live (a
        chunk joins the eviction queue on decode and leaves on evict, so
        membership is unique by construction)."""
        arrs = chunk._decoded
        if arrs is None:
            self.decode_cache_misses += 1
            arrs = chunk._decoded = chunk.arrays()
            cache = self._decoded_chunks
            cache.append(chunk)
            if len(cache) > self.DECODE_CACHE_CHUNKS:
                cache.popleft()._decoded = None
        else:
            self.decode_cache_hits += 1
        return arrs

    def latest(self, name: str, matchers: dict[str, str] | None = None) -> float | None:
        """Scalar convenience: value of the single matching series, else None."""
        vec = self.instant_vector(name, matchers)
        if not vec:
            return None
        if len(vec) > 1:
            raise ValueError(f"query for {name} matched {len(vec)} series, expected 1")
        return vec[0].value

    def mark_stale(
        self,
        name: str,
        labels: LabelSet,
        ts: float | None = None,
        origin: int | None = None,
    ) -> None:
        """Write a staleness marker ending the series now (Prometheus writes
        these when a target fails to scrape or a rule stops producing)."""
        self.append(name, labels, float("nan"), ts, origin=origin)

    def exemplar(self, name: str, labels: LabelSet) -> Exemplar | None:
        """Latest exemplar attached to the series, else None."""
        return self._exemplars.get((name, labels))

    def exemplars_of(self, name: str) -> dict[LabelSet, Exemplar]:
        """All exemplars for series of ``name`` (bucket series of a
        histogram), keyed by label set — the lint/doctor traversal."""
        return {
            labels: ex
            for (n, labels), ex in self._exemplars.items()
            if n == name
        }

    def version(self, name: str) -> int:
        """Monotonic write counter for ``name``: bumps on every append to any
        series of the name (staleness markers included).  Incremental rule
        evaluation compares these between evals to detect dirty inputs."""
        return self._versions.get(name, 0)

    def total_points(self) -> int:
        """Points currently retained across all series — the bench's memory
        proxy (bounded retention keeps this flat over any horizon)."""
        return self._total_points

    def retained_bytes(self) -> int:
        """Compressed sample-storage bytes currently retained: Gorilla blob
        lengths plus 8 per tracked origin span id.  Excludes per-series
        fixed overhead (labels, index entries — identical under any point
        representation); divide by ``total_points()`` for the bytes/sample
        the ``sim_scale_10k`` rung gates against the 16-byte uncompressed
        (ts, value) baseline."""
        total = 0
        for by_name in self._data.values():
            for series in by_name.values():
                total += series.nbytes()
        return total

    def total_appends(self) -> int:
        """Lifetime appends across all names (trim/GC never subtract)."""
        return sum(self._versions.values())

    def series_count(self) -> int:
        return sum(len(by_name) for by_name in self._data.values())

    def series_names(self) -> list[str]:
        return sorted(self._data)


class ScrapeTimeout(Exception):
    """A fetch whose (simulated) duration exceeded the target's deadline."""


@dataclass
class TimedExposition:
    """Exposition text plus how long serving it took.  A fetch callable may
    return this instead of a plain string so virtual-time harnesses can model
    slow endpoints; the scraper enforces the per-target deadline against
    ``duration`` (in production the HTTP client's timeout does this)."""

    text: str
    duration: float = 0.0


@dataclass
class StructuredExposition:
    """Pre-parsed exposition: the structured scrape fast path with a modeled
    duration.  Same deadline semantics as ``TimedExposition``; the families
    skip the text encode/parse round trip entirely.  Sample label tuples must
    be canonically sorted (``Sample.make`` / ``MetricFamily.add`` guarantee
    this) — they become TSDB series keys verbatim."""

    families: list[MetricFamily]
    duration: float = 0.0


@dataclass
class ScrapeTarget:
    """One endpoint: ``fetch`` returns exposition — text (HTTP GET in
    production), or pre-parsed families (``list[MetricFamily]`` /
    ``StructuredExposition``) for in-process targets on the fast path.

    ``attached_labels`` are merged onto every scraped sample, overriding any
    collision — this implements the reference's relabel_config that stamps the
    Kubernetes node name onto each sample (kube-prometheus-stack-values.yaml:13-16).
    """

    fetch: Callable[[], "str | TimedExposition | list[MetricFamily] | StructuredExposition"]
    attached_labels: dict[str, str] = field(default_factory=dict)
    name: str = ""
    healthy: bool = True
    #: series produced by the last successful scrape, for staleness marking
    last_series: set[tuple[str, LabelSet]] = field(default_factory=set)
    #: per-target scrape deadline (Prometheus ``scrape_timeout``): a fetch
    #: reporting a longer duration counts as a failed scrape
    deadline: float = 10.0
    #: failure streak driving the exponential backoff
    consecutive_failures: int = 0
    #: do not re-attempt before this timestamp (backoff gate)
    next_attempt_at: float = -math.inf
    #: total fetch attempts, for observability/tests
    attempts: int = 0
    #: optional provider of the upstream span id a successful fetch's data
    #: came from (the node exporter's last collection sweep) — the scrape
    #: span links to it, rooting metric lineage at the raw chip samples
    trace_origin: "Callable[[], int | None] | None" = None
    #: lazily cached ``up`` label set (attached labels + target name are
    #: fixed after add_target; rebuilding the tuple per scrape was waste)
    up_labels: LabelSet | None = field(default=None, repr=False)
    #: sample labels -> merged+sorted TSDB key, cached because a target
    #: exposes the same label sets scrape after scrape
    merge_cache: dict[LabelSet, LabelSet] = field(default_factory=dict, repr=False)


class Scraper:
    """Pulls all targets into the TSDB; drive via ``scrape_once`` on a schedule.

    Failure handling (the chaos-hardening contract):

    - a failing or deadline-busting target gets staleness markers and an
      ``up{target=...} 0`` sample — the degradation is *observable*, never a
      frozen value;
    - consecutive failures back the target off exponentially (base doubles up
      to ``backoff_cap``) with deterministic jitter, so a dead endpoint is not
      hammered every interval and recovery probes stay bounded by the cap.
    """

    def __init__(
        self,
        db: TimeSeriesDB,
        interval: float = 1.0,
        backoff_base: float = 1.0,
        backoff_cap: float = 30.0,
        backoff_jitter: float = 0.1,
        tracer=None,
        selfmetrics=None,
    ):
        self.db = db
        self.interval = interval
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_jitter = backoff_jitter
        #: obs.Tracer: emits one ``scrape`` span per attempt and stamps its
        #: id as the origin of every point ingested (metric lineage)
        self.tracer = tracer
        #: obs.PipelineSelfMetrics: per-target scrape durations
        self.selfmetrics = selfmetrics
        #: seeded so virtual-time runs are reproducible event-for-event
        self._rng = random.Random(0)
        self.targets: list[ScrapeTarget] = []

    def add_target(
        self, fetch: Callable[[], str], name: str = "", **attached_labels: str
    ) -> ScrapeTarget:
        target = ScrapeTarget(fetch=fetch, attached_labels=attached_labels, name=name)
        self.targets.append(target)
        return target

    def remove_target(self, target: ScrapeTarget) -> None:
        self.targets.remove(target)

    def _up_labels(self, target: ScrapeTarget) -> LabelSet:
        if target.up_labels is None:
            labels = dict(target.attached_labels)
            labels["target"] = target.name or "?"
            target.up_labels = tuple(sorted(labels.items()))
        return target.up_labels

    def _record_up(self, target: ScrapeTarget, value: float, ts: float) -> None:
        self.db.append("up", self._up_labels(target), value, ts)

    def _backoff(self, target: ScrapeTarget, now: float) -> None:
        # exp=10 already exceeds any sane cap; bounding it keeps the streak
        # counter free to grow without overflowing the power
        exponent = min(target.consecutive_failures - 1, 10)
        delay = min(self.backoff_cap, self.backoff_base * 2.0**exponent)
        target.next_attempt_at = now + delay * (
            1.0 + self.backoff_jitter * self._rng.random()
        )

    def stagger_after_recovery(self, spread: float | None = None) -> None:
        """Thundering-herd guard for the first sweep after a TSDB restart:
        every target's gap expired while the DB was down, so without this
        the whole fleet (~1000 targets at scale) lands on one tick.  Each
        target gets a deterministic slot inside ``spread`` (default 4
        intervals) keyed by a CRC of its interned ``up`` label set — stable
        across processes (unlike ``hash()``, which is salted per run), so
        two recoveries of the same fleet stagger identically.  Never moves a
        target earlier than an in-force backoff gate."""
        if spread is None:
            spread = 4.0 * self.interval
        now = self.db.clock.now()
        for target in self.targets:
            labels = self._up_labels(target)
            frac = (zlib.crc32(repr(labels).encode()) % 1024) / 1024.0
            target.next_attempt_at = max(target.next_attempt_at, now + spread * frac)

    def scrape_once(self) -> int:
        """Scrape every due target.  A failing target gets staleness markers on
        all series it produced last time (Prometheus semantics: a down target's
        series go stale at the next scrape, they don't linger for the lookback
        window), an ``up`` sample of 0, and an exponential backoff before the
        next attempt.  Returns number of samples ingested."""
        with profile.stage("scrape:sweep"):
            return self._scrape_once()

    def _scrape_once(self) -> int:
        count = 0
        # per-sweep invariants, hoisted: a 1000-target fleet pays every
        # per-target attribute chase 1000 times per tick (the clock cannot
        # advance inside a sweep, so one ts per sweep is not a semantic
        # change for virtual time and is sub-ms skew for wall time)
        ts = self.db.clock.now()
        tracer = self.tracer
        selfmetrics = self.selfmetrics
        db_append = self.db.append
        for target in self.targets:
            if ts < target.next_attempt_at:
                continue  # backing off after consecutive failures
            target.attempts += 1
            span = (
                tracer.open("scrape", {"target": target.name or "?"})
                if tracer is not None
                else None
            )
            origin = None if span is None else span.span_id
            # wall_start only feeds self-metrics; skip the syscall pair per
            # target when nothing consumes it (1000-target fleets scrape hot)
            wall_start = 0.0 if selfmetrics is None else time.perf_counter()
            duration: float | None = None
            try:
                fetched = target.fetch()
                families: list[MetricFamily] | None
                # dispatch cheapest-first: bare family lists are the fleet
                # fast path and the common case at scale
                if type(fetched) is list:
                    families = fetched
                elif isinstance(fetched, str):
                    families = None
                elif isinstance(fetched, TimedExposition):
                    duration = fetched.duration
                    families = None
                elif isinstance(fetched, StructuredExposition):
                    duration = fetched.duration
                    families = fetched.families
                else:  # e.g. a list subclass: still the structured path
                    families = list(fetched)
                if duration is not None and duration > target.deadline:
                    raise ScrapeTimeout(
                        f"{target.name or '?'}: scrape took "
                        f"{duration:.1f}s > deadline "
                        f"{target.deadline:.1f}s"
                    )
                if families is None:
                    # the text path: parse the exposition as a real scraper
                    # would (a malformed one is a failed scrape)
                    families = parse_text(
                        fetched.text if isinstance(fetched, TimedExposition) else fetched
                    )
            except Exception as exc:
                if target.healthy:
                    for name, labels in target.last_series:
                        self.db.mark_stale(name, labels, ts, origin=origin)
                target.healthy = False
                target.last_series = set()
                target.consecutive_failures += 1
                self._backoff(target, ts)
                self._record_up(target, 0.0, ts)
                if selfmetrics is not None:
                    self._observe_scrape(target, wall_start, duration, origin)
                if span is not None:
                    tracer.close(span, ok=False, error=str(exc))
                continue
            target.healthy = True
            target.consecutive_failures = 0
            target.next_attempt_at = -math.inf
            with profile.stage("tsdb:append"):
                produced: set[tuple[str, LabelSet]] = set()
                attached = target.attached_labels
                merge_cache = target.merge_cache
                for fam in families:
                    fam_name = fam.name
                    for sample in fam.samples:
                        if attached:
                            key = merge_cache.get(sample.labels)
                            if key is None:
                                merged = dict(sample.labels)
                                merged.update(attached)
                                key = tuple(sorted(merged.items()))
                                merge_cache[sample.labels] = key
                        else:
                            # parse_text and Sample.make both emit sorted
                            # label tuples, so the sample's labels ARE the
                            # series key
                            key = sample.labels
                        # histogram samples carry a suffix: the TSDB series
                        # is the full wire name (x_bucket/x_sum/x_count)
                        series_name = (
                            fam_name + sample.suffix
                            if sample.suffix
                            else fam_name
                        )
                        db_append(
                            series_name,
                            key,
                            sample.value,
                            ts,
                            origin=origin,
                            exemplar=sample.exemplar,
                        )
                        produced.add((series_name, key))
                        count += 1
                # series that vanished from the exposition also go stale
                for name, labels in target.last_series - produced:
                    self.db.mark_stale(name, labels, ts, origin=origin)
                target.last_series = produced
                self._record_up(target, 1.0, ts)
            if selfmetrics is not None:
                self._observe_scrape(target, wall_start, duration, origin)
            if span is not None:
                links: tuple[int, ...] = ()
                if target.trace_origin is not None:
                    upstream = target.trace_origin()
                    if upstream is not None:
                        links = (upstream,)
                tracer.close(span, links, ok=True, samples=len(produced))
        return count

    def _observe_scrape(
        self,
        target: ScrapeTarget,
        wall_start: float,
        duration: float | None,
        span_id: int | None = None,
    ) -> None:
        """Report the scrape's duration: the modeled one when the target
        returned a TimedExposition (virtual-time harnesses), wall-clock
        otherwise (production semantics).  ``span_id`` (this attempt's
        scrape span) becomes the histogram bucket's exemplar."""
        if self.selfmetrics is None:
            return
        if duration is None:
            duration = time.perf_counter() - wall_start
        self.selfmetrics.observe_scrape(target.name or "?", duration, span_id)
