"""Downsampled rollup tiers: long-horizon retention over the columnar TSDB.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/downsample.py``, whole, with its
``downsample:compact`` profile stage around ``Downsampler.ingest_chunk``
(obs/profile.py).  Rollup chunks are the port's own ``GorillaEncoder``
columns, byte for byte JAX's, and every fold is JAX's float for float.

Raw Gorilla chunks answer every query the live control loop asks, but they
die at the bounded retention window: nothing can say what duty cycle or SLO
burn looked like over last week's virtual run.  As sealed raw chunks age
past a configurable ``horizon``, a :class:`Downsampler` compacts them into
per-step **rollup rows** ``(count, sum, min, max, last)`` at each configured
tier (5m and 1h by default), stored in the same sealed-chunk discipline as
raw: one delta-of-delta timestamp column shared across five XOR-compressed
value columns (:class:`RollupChunk`), sealed every ``chunk_size`` rows with
seal-time column summaries, trimmed by a much longer rollup retention.

Bucket semantics are Prometheus range semantics: a bucket is left-open
right-closed ``(end - step, end]`` and stamped at its END, so a tier-aligned
query window ``(at - window, at]`` tiles exactly into buckets.  A bucket
seals once a later point arrives (per-series appends are monotonic, so a
sealed bucket is final); buckets holding only NaN staleness markers are
never emitted, but ``covered_through`` still advances past them: coverage
is about finality, not density.

Bit-exactness: rollup reads and the **raw twin** (:func:`raw_fold` /
``TimeSeriesDB.range_avg_bucketed``) share one accumulation shape, per-bucket
``(count, sum)`` subtotals folded left to right, full segments of
``chunk_size`` buckets contributing their seal-time column sums (the same
left-to-right fold their decode would produce).  The twin regenerates the
identical bucket rows from raw points with :func:`raw_bucket_rows` and
groups them into the identical segments, so ``avg/sum/count`` over
tier-aligned windows agree float for float; ``run_downsample_bench``'s
randomized differential and the doctor's ``check_downsampling`` both hold
them to that.  The twin is only meaningful while raw retention still covers
the compared span; the min/max columns bound quantile error instead of
reproducing it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from k8s_gpu_hpa_tpu_torch.metrics.gorilla import (
    GorillaEncoder,
    decode as gorilla_decode,
    summarize_values,
)
from k8s_gpu_hpa_tpu_torch.obs import profile

#: rollup row columns, in storage order (``RollupChunk.val_blobs`` /
#: ``_TierState.encs`` are parallel to this)
COLUMNS = ("count", "sum", "min", "max", "last")

_INF = math.inf
_NAN = math.nan


def tier_label(step: float) -> str:
    """``300.0`` → ``"5m"``, ``3600.0`` → ``"1h"`` — the storage-tier name
    trace output and planner counters use (``"raw"`` is reserved for the
    un-downsampled store)."""
    s = int(step)
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


def bucket_end(ts: float, step: float) -> float:
    """END stamp of the bucket ``(end - step, end]`` containing ``ts`` —
    a point exactly on a boundary belongs to the bucket it closes."""
    return math.ceil(ts / step) * step


@dataclass(frozen=True)
class DownsamplePolicy:
    """What to roll up, when, and for how long.

    - ``steps``: tier resolutions in seconds, ascending (finest first).
    - ``horizon``: age (vs the newest append) past which a sealed raw chunk
      is compacted into every tier.  Raw chunks are NOT dropped at the
      horizon — raw retention still owns that — but eviction doubles as a
      compaction trigger: a chunk reaching raw retention before the horizon
      is ingested on its way out, so rollups never lose data to a short
      raw window.
    - ``retention``: rollup retention; whole rollup chunks older than this
      drop from the front, exactly like raw chunks under raw retention.
    """

    steps: tuple[float, ...] = (300.0, 3600.0)
    horizon: float = 1800.0
    retention: float = 7 * 86400.0

    def __post_init__(self):
        if not self.steps:
            raise ValueError("downsample policy needs at least one tier step")
        if any(s <= 0 for s in self.steps):
            raise ValueError(f"tier steps must be positive: {self.steps}")
        if list(self.steps) != sorted(self.steps):
            raise ValueError(f"tier steps must ascend: {self.steps}")
        if self.horizon <= 0:
            raise ValueError(f"horizon must be positive: {self.horizon}")
        if self.retention < max(self.steps):
            raise ValueError(
                f"rollup retention {self.retention} shorter than the "
                f"coarsest tier step {max(self.steps)}"
            )

    def labels(self) -> tuple[str, ...]:
        return tuple(tier_label(s) for s in self.steps)


class RollupChunk:
    """A sealed run of ``count`` rollup rows: one timestamp column (bucket
    ends, delta-of-delta) shared by five XOR value columns, plus seal-time
    per-column summaries.  Same immutability/caching contract as
    :class:`~k8s_gpu_hpa_tpu_torch.metrics.gorilla.GorillaChunk` — ``_decoded``
    caches the arrays and the owning TSDB's decode cache bounds how many
    stay live (``nbytes`` never counts the cache)."""

    __slots__ = ("count", "ts_blob", "val_blobs", "ts_mode",
                 "first_ts", "last_ts", "summaries", "_decoded")

    def __init__(
        self,
        count: int,
        ts_blob: bytes,
        val_blobs: tuple[bytes, ...],
        first_ts: float,
        last_ts: float,
        ts_mode: int,
        summaries: tuple | None = None,
    ):
        self.count = count
        self.ts_blob = ts_blob
        self.val_blobs = val_blobs
        self.ts_mode = ts_mode
        self.first_ts = first_ts
        self.last_ts = last_ts
        #: per-column ``(count, sum, min, max, nan_count)`` recorded at seal
        #: time; None after snapshot recovery (recomputed lazily, bit-equal
        #: by the shared left-to-right accumulation)
        self.summaries = summaries
        self._decoded = None

    def arrays(self):
        """Decode (uncached) into ``(bucket_ends, (col_arrays...))``."""
        ts_arr = None
        cols = []
        for blob in self.val_blobs:
            t, v = gorilla_decode(self.ts_blob, blob, self.count, self.ts_mode)
            if ts_arr is None:
                ts_arr = t
            cols.append(v)
        return ts_arr, tuple(cols)

    def ensure_summaries(self) -> tuple:
        if self.summaries is None:
            _, cols = self.arrays()
            self.summaries = tuple(summarize_values(c) for c in cols)
        return self.summaries

    def nbytes(self) -> int:
        return len(self.ts_blob) + sum(len(b) for b in self.val_blobs)


class _TierState:
    """One series' rollup storage at one tier: sealed chunks + a compressed
    head (five encoders sharing identical timestamp streams) + the open
    bucket accumulator."""

    __slots__ = ("step", "chunks", "encs", "head_first_ts",
                 "open_end", "o_count", "o_sum", "o_min", "o_max", "o_last",
                 "covered_through", "_head_cache")

    def __init__(self, step: float):
        self.step = step
        self.chunks: list[RollupChunk] = []
        self.encs = tuple(GorillaEncoder() for _ in COLUMNS)
        self.head_first_ts = 0.0
        #: END of the currently-accumulating bucket, or None before the
        #: first ingested point
        self.open_end: float | None = None
        self.o_count = 0
        self.o_sum = 0.0
        self.o_min = _INF
        self.o_max = -_INF
        self.o_last = _NAN
        #: every bucket ending at/before this is final (sealed or provably
        #: empty); the tier-selection coverage check is exactly
        #: ``covered_through >= at``
        self.covered_through = -_INF
        self._head_cache: tuple | None = None

    # -- storage ------------------------------------------------------------

    def append_row(self, end: float, row: tuple, chunk_size: int) -> None:
        if self.encs[0].count == 0:
            self.head_first_ts = end
        for enc, val in zip(self.encs, row):
            enc.append(end, float(val))
        self._head_cache = None
        if self.encs[0].count >= chunk_size:
            self.seal_head()

    def seal_head(self) -> None:
        encs = self.encs
        lead = encs[0]
        ts_arr = gorilla_decode(
            bytes(lead.ts_buf), bytes(lead.val_buf), lead.count, lead.ts_mode
        )[0]
        self.chunks.append(
            RollupChunk(
                lead.count,
                bytes(lead.ts_buf),
                tuple(bytes(e.val_buf) for e in encs),
                float(ts_arr[0]),
                float(ts_arr[-1]),
                lead.ts_mode,
                tuple(e.summary() for e in encs),
            )
        )
        for e in encs:
            e.reset()
        self._head_cache = None

    def head_arrays(self):
        """Decoded ``(bucket_ends, (col_arrays...))`` of the head streams,
        memoized until the next row."""
        lead = self.encs[0]
        cache = self._head_cache
        if cache is not None and cache[0] == lead.count:
            return cache[1], cache[2]
        ts_arr = None
        cols = []
        for e in self.encs:
            t, v = gorilla_decode(
                bytes(e.ts_buf), bytes(e.val_buf), e.count, e.ts_mode
            )
            if ts_arr is None:
                ts_arr = t
            cols.append(v)
        cols = tuple(cols)
        self._head_cache = (lead.count, ts_arr, cols)
        return ts_arr, cols

    def nbytes(self) -> int:
        n = len(self.encs[0].ts_buf) + sum(len(e.val_buf) for e in self.encs)
        for chunk in self.chunks:
            n += chunk.nbytes()
        return n

    def nbuckets(self) -> int:
        return self.encs[0].count + sum(c.count for c in self.chunks)

    def last_end(self) -> float:
        """End of the newest STORED bucket (≤ ``covered_through`` when the
        newest final buckets were empty), or -inf with nothing stored."""
        if self.encs[0].count:
            return self.head_arrays()[0][-1]
        if self.chunks:
            return self.chunks[-1].last_ts
        return -_INF


class SeriesRollups:
    """Per-series compaction state: how far raw has been ingested, plus one
    :class:`_TierState` per policy step (attached to ``_Series.rollup``, so
    snapshots and GC see it exactly where the raw columns live)."""

    __slots__ = ("ingested", "upto", "tiers")

    def __init__(self, tiers: tuple[_TierState, ...]):
        #: how many of the series' CURRENT front chunks are already ingested
        #: (raw retention pops decrement this in step with the chunk list)
        self.ingested = 0
        #: newest raw timestamp the rollups have seen (exclusive frontier)
        self.upto = -_INF
        self.tiers = tiers


class Downsampler:
    """The compaction engine one :class:`TimeSeriesDB` owns.

    ``ingest_pending`` runs from the append hot path behind a cheap age
    guard; it decodes newly-aged sealed chunks once (no cache pollution),
    feeds every tier's open-bucket accumulator, and trims rollup chunks
    past rollup retention.  All state lives on the series
    (:class:`SeriesRollups`); the engine itself carries only the policy
    and lifetime counters."""

    def __init__(self, policy: DownsamplePolicy, chunk_size: int = 64):
        self.policy = policy
        self.chunk_size = chunk_size
        self.steps = tuple(policy.steps)
        self.horizon = policy.horizon
        self.retention = policy.retention
        self.labels = policy.labels()
        # lifetime counters (never decremented; the doctor/bench surface)
        self.ingested_points = 0
        self.ingested_chunks = 0
        self.ingested_bytes = 0
        self.sealed_buckets = 0
        self.dropped_buckets = 0

    def new_state(self) -> SeriesRollups:
        return SeriesRollups(tuple(_TierState(s) for s in self.steps))

    def tier_index(self, step: float) -> int | None:
        try:
            return self.steps.index(step)
        except ValueError:
            return None

    # -- compaction ----------------------------------------------------------

    def ingest_pending(self, roll: SeriesRollups, chunks: list, now_ts: float) -> None:
        """Ingest every sealed chunk aged past the horizon, then trim
        rollup chunks past rollup retention."""
        cutoff = now_ts - self.horizon
        while roll.ingested < len(chunks):
            chunk = chunks[roll.ingested]
            if chunk.last_ts >= cutoff:
                break
            self.ingest_chunk(roll, chunk)
            roll.ingested += 1
        rcutoff = now_ts - self.retention
        for tier in roll.tiers:
            tchunks = tier.chunks
            while tchunks and tchunks[0].last_ts < rcutoff:
                self.dropped_buckets += tchunks.pop(0).count

    def ingest_chunk(self, roll: SeriesRollups, chunk) -> None:
        """Feed one sealed raw chunk's points into every tier accumulator.
        Decodes directly (aged chunks are cold; caching them would evict
        hot query decodes for data read exactly once)."""
        with profile.stage("downsample:compact"):
            self._ingest_chunk(roll, chunk)

    def _ingest_chunk(self, roll: SeriesRollups, chunk) -> None:
        ts_arr, val_arr = chunk.arrays()
        ts_list = ts_arr.tolist()
        val_list = val_arr.tolist()
        chunk_size = self.chunk_size
        for tier in roll.tiers:
            step = tier.step
            open_end = tier.open_end
            for ts, v in zip(ts_list, val_list):
                end = math.ceil(ts / step) * step
                if open_end is None:
                    tier.open_end = open_end = end
                elif end > open_end:
                    self._seal_bucket(tier, chunk_size)
                    # everything ending before the new open bucket is final,
                    # including buckets the gap skipped (appends are
                    # monotonic, so no later point can land in them)
                    tier.open_end = open_end = end
                    tier.covered_through = end - step
                if v == v:  # NaN staleness markers roll up to nothing
                    tier.o_count += 1
                    tier.o_sum += v
                    if v < tier.o_min:
                        tier.o_min = v
                    if v > tier.o_max:
                        tier.o_max = v
                    tier.o_last = v
        self.ingested_points += len(ts_list)
        self.ingested_chunks += 1
        self.ingested_bytes += chunk.nbytes()
        roll.upto = chunk.last_ts

    def _seal_bucket(self, tier: _TierState, chunk_size: int) -> None:
        tier.covered_through = tier.open_end
        if tier.o_count:
            tier.append_row(
                tier.open_end,
                (tier.o_count, tier.o_sum, tier.o_min, tier.o_max, tier.o_last),
                chunk_size,
            )
            self.sealed_buckets += 1
        tier.o_count = 0
        tier.o_sum = 0.0
        tier.o_min = _INF
        tier.o_max = -_INF
        tier.o_last = _NAN


# -- the shared fold ---------------------------------------------------------
#
# One accumulation shape serves the rollup read AND the raw twin: segments
# (sealed rollup chunks / chunk_size-sized row groups) fold left-to-right; a
# segment fully inside the window contributes its seal-time column sums, a
# boundary segment folds its in-window rows one by one into a subtotal that
# joins the running total as one addition.  Mirrors TimeSeriesDB.range_avg's
# chunk/summary shape exactly, at bucket granularity.


class _ChunkSeg:
    """Fold segment over a sealed :class:`RollupChunk`."""

    __slots__ = ("chunk", "_arrays_fn")

    def __init__(self, chunk: RollupChunk, arrays_fn):
        self.chunk = chunk
        self._arrays_fn = arrays_fn

    @property
    def first_ts(self):
        return self.chunk.first_ts

    @property
    def last_ts(self):
        return self.chunk.last_ts

    def sums(self):
        s = self.chunk.summaries
        if s is None:
            s = self.chunk.ensure_summaries()
        return s[0][1], s[1][1]

    def cols(self):
        ts_arr, cols = self._arrays_fn(self.chunk)
        return ts_arr, cols

    def fastpath(self) -> bool:
        return True


class _HeadSeg:
    """Fold segment over a tier's mutable head streams."""

    __slots__ = ("tier",)

    def __init__(self, tier: _TierState):
        self.tier = tier

    @property
    def first_ts(self):
        return self.tier.head_first_ts

    @property
    def last_ts(self):
        return float(self.tier.head_arrays()[0][-1])

    def sums(self):
        encs = self.tier.encs
        return encs[0].summary()[1], encs[1].summary()[1]

    def cols(self):
        return self.tier.head_arrays()

    def fastpath(self) -> bool:
        return False


class _RowSeg:
    """Fold segment over raw-derived bucket rows (the twin's stand-in for a
    sealed rollup chunk; ``sums`` folds left-to-right like a seal summary)."""

    __slots__ = ("ends", "counts", "sums_col", "mins", "maxs", "lasts", "_sums")

    def __init__(self, ends, counts, sums_col, mins, maxs, lasts):
        self.ends = ends
        self.counts = counts
        self.sums_col = sums_col
        self.mins = mins
        self.maxs = maxs
        self.lasts = lasts
        self._sums = None

    @property
    def first_ts(self):
        return self.ends[0]

    @property
    def last_ts(self):
        return self.ends[-1]

    def sums(self):
        if self._sums is None:
            c = 0.0
            s = 0.0
            for v in self.counts:
                c += v
            for v in self.sums_col:
                s += v
            self._sums = (c, s)
        return self._sums

    def cols(self):
        return self.ends, (self.counts, self.sums_col, self.mins,
                           self.maxs, self.lasts)

    def fastpath(self) -> bool:
        return False


def _searchsorted(seq, x, right: bool) -> int:
    """numpy.searchsorted for arrays, bisect for plain lists."""
    ss = getattr(seq, "searchsorted", None)
    if ss is not None:
        return int(ss(x, side="right" if right else "left"))
    import bisect

    return bisect.bisect_right(seq, x) if right else bisect.bisect_left(seq, x)


def fold_avg(segments, start: float, at: float, stats=None):
    """``(count_total, sum_total)`` over buckets with end in ``(start, at]``
    across ``segments`` in order — THE accumulation both the rollup read and
    the raw twin execute.  ``stats`` (PlannerStats) counts summary-served vs
    decoded rollup segments."""
    n = 0.0
    total = 0.0
    for seg in segments:
        if seg.last_ts <= start or seg.first_ts > at:
            continue
        if seg.first_ts > start and seg.last_ts <= at:
            sc, ssum = seg.sums()
            if stats is not None and seg.fastpath():
                stats.rollup_fastpath += 1
            if sc:
                n += sc
                total += ssum
            continue
        if stats is not None and seg.fastpath():
            stats.rollup_fallback += 1
        ends, cols = seg.cols()
        lo = _searchsorted(ends, start, right=True)
        hi = _searchsorted(ends, at, right=True)
        sub_n = 0.0
        sub = 0.0
        c_slice = cols[0][lo:hi]
        s_slice = cols[1][lo:hi]
        if hasattr(c_slice, "tolist"):  # numpy columns → plain floats,
            c_slice = c_slice.tolist()  # matching range_avg's fold idiom
            s_slice = s_slice.tolist()
        for c in c_slice:
            sub_n += c
        for s in s_slice:
            sub += s
        if sub_n:
            n += sub_n
            total += sub
    return n, total


def newest_bucket_in_window(tier: _TierState, start: float, at: float,
                            arrays_fn):
    """Newest stored bucket with end in ``(start, at]`` as
    ``(end, count, sum, min, max, last)`` — the capture representative of a
    rollup read (head first, then chunks newest-first), or None."""
    segs: list = [_ChunkSeg(c, arrays_fn) for c in tier.chunks]
    if tier.encs[0].count:
        segs.append(_HeadSeg(tier))
    for seg in reversed(segs):
        if seg.first_ts > at:
            continue
        if seg.last_ts <= start:
            break
        ends, cols = seg.cols()
        hi = _searchsorted(ends, at, right=True)
        for i in range(hi - 1, -1, -1):
            end = float(ends[i])
            if end <= start:
                break
            return (end,) + tuple(float(c[i]) for c in cols)
    return None


def tier_segments(tier: _TierState, arrays_fn):
    """Fold segments of one tier in storage order (sealed chunks, head).
    ``arrays_fn`` is the owning DB's bounded decode cache."""
    segs: list = [_ChunkSeg(c, arrays_fn) for c in tier.chunks]
    if tier.encs[0].count:
        segs.append(_HeadSeg(tier))
    return segs


# -- the raw twin -------------------------------------------------------------


def raw_bucket_rows(series, step: float, arrays_fn=None):
    """Regenerate the tier's bucket rows from the series' retained RAW
    points: ``(ends, counts, sums, mins, maxs, lasts)`` parallel lists over
    every CLOSED bucket (the trailing open bucket is withheld, mirroring the
    compactor).  The per-bucket accumulation is the same left-to-right
    arithmetic ``Downsampler.ingest_chunk`` runs, so rows are bit-identical
    wherever raw retention still covers the span."""
    ends: list[float] = []
    counts: list[float] = []
    sums: list[float] = []
    mins: list[float] = []
    maxs: list[float] = []
    lasts: list[float] = []
    open_end = None
    c = 0
    s = 0.0
    mn = _INF
    mx = -_INF
    last = _NAN

    def flush():
        if c:
            ends.append(open_end)
            counts.append(float(c))
            sums.append(s)
            mins.append(mn)
            maxs.append(mx)
            lasts.append(last)

    sources = []
    for chunk in series.chunks:
        ts_arr, val_arr = chunk.arrays() if arrays_fn is None else arrays_fn(chunk)
        sources.append((ts_arr.tolist(), val_arr.tolist()))
    if series.enc.count:
        ts_arr, val_arr = series.head_arrays()
        sources.append((ts_arr.tolist(), val_arr.tolist()))
    for ts_list, val_list in sources:
        for ts, v in zip(ts_list, val_list):
            end = math.ceil(ts / step) * step
            if open_end is None:
                open_end = end
            elif end > open_end:
                flush()
                open_end = end
                c = 0
                s = 0.0
                mn = _INF
                mx = -_INF
                last = _NAN
            if v == v:
                c += 1
                s += v
                if v < mn:
                    mn = v
                if v > mx:
                    mx = v
                last = v
    # the open bucket is NOT flushed: it has not sealed in the real tier
    return ends, counts, sums, mins, maxs, lasts


def raw_segments(rows, chunk_size: int):
    """Group twin rows into the segments the real tier would hold: full
    ``chunk_size`` groups (stand-ins for sealed chunks) plus the remainder
    (the head)."""
    ends = rows[0]
    segs = []
    for i in range(0, len(ends), chunk_size):
        segs.append(_RowSeg(*(col[i:i + chunk_size] for col in rows)))
    return segs


def raw_fold(series, step: float, chunk_size: int, start: float, at: float,
             arrays_fn=None):
    """The twin in one call: bucket the series' raw points at ``step`` and
    run the shared fold over ``(start, at]``."""
    rows = raw_bucket_rows(series, step, arrays_fn)
    if not rows[0]:
        return 0.0, 0.0
    return fold_avg(raw_segments(rows, chunk_size), start, at)


# -- serialization (WAL snapshot format 3) ------------------------------------


def serialize_rollup(roll: SeriesRollups, b64) -> dict:
    tiers = []
    for tier in roll.tiers:
        lead = tier.encs[0]
        tiers.append(
            {
                "step": tier.step,
                "chunks": [
                    [
                        c.count,
                        b64(c.ts_blob).decode("ascii"),
                        [b64(vb).decode("ascii") for vb in c.val_blobs],
                        c.first_ts,
                        c.last_ts,
                        c.ts_mode,
                    ]
                    for c in tier.chunks
                ],
                "head": [
                    lead.count,
                    b64(bytes(lead.ts_buf)).decode("ascii"),
                    [b64(bytes(e.val_buf)).decode("ascii") for e in tier.encs],
                    lead.ts_mode,
                ],
                "open": (
                    None
                    if tier.open_end is None
                    else [tier.open_end, tier.o_count, tier.o_sum,
                          # ±inf/NaN are not JSON; the open accumulator's
                          # sentinels ride as nulls and restore exactly
                          None if tier.o_min == _INF else tier.o_min,
                          None if tier.o_max == -_INF else tier.o_max,
                          None if tier.o_last != tier.o_last else tier.o_last]
                ),
                "covered_through": (
                    None if tier.covered_through == -_INF
                    else tier.covered_through
                ),
            }
        )
    return {
        "ingested": roll.ingested,
        "upto": None if roll.upto == -_INF else roll.upto,
        "tiers": tiers,
    }


def restore_rollup(ds: Downsampler, payload: dict, b64) -> SeriesRollups:
    roll = ds.new_state()
    roll.ingested = payload["ingested"]
    upto = payload["upto"]
    roll.upto = -_INF if upto is None else upto
    by_step = {t["step"]: t for t in payload["tiers"]}
    for tier in roll.tiers:
        entry = by_step.get(tier.step)
        if entry is None:
            continue  # tier added since the snapshot: rebuilt by later ingests
        for count, tsb, vbs, first_ts, last_ts, mode in entry["chunks"]:
            tier.chunks.append(
                RollupChunk(
                    count,
                    b64(tsb),
                    tuple(b64(vb) for vb in vbs),
                    first_ts,
                    last_ts,
                    mode,
                )
            )
        hcount, htsb, hvbs, hmode = entry["head"]
        if hcount:
            ts_blob = b64(htsb)
            for enc, vb in zip(tier.encs, hvbs):
                enc.restore(ts_blob, b64(vb), hcount, hmode)
            tier.head_first_ts = float(tier.head_arrays()[0][0])
        open_acc = entry["open"]
        if open_acc is not None:
            end, c, s, mn, mx, last = open_acc
            tier.open_end = end
            tier.o_count = c
            tier.o_sum = s
            tier.o_min = _INF if mn is None else mn
            tier.o_max = -_INF if mx is None else mx
            tier.o_last = _NAN if last is None else last
        covered = entry["covered_through"]
        tier.covered_through = -_INF if covered is None else covered
    return roll


def downsample_selfcheck(db, names, max_buckets: int = 64) -> dict:
    """JSON-able health report for the doctor's ``check_downsampling``
    probe: per-tier storage/coverage stats plus a rollup-vs-raw-twin
    agreement differential on tier-aligned windows.

    For each ``name`` and configured tier, picks the widest aligned window
    that (a) every matching series' rollup covers end-to-end and (b) raw
    retention still covers — the only span where the twin is meaningful —
    capped at ``max_buckets`` buckets, then evaluates it through BOTH
    :meth:`TimeSeriesDB.rollup_range_avg` and the raw twin
    :meth:`TimeSeriesDB.range_avg_bucketed` and compares float-for-float.
    Windows with no rollup/raw overlap are recorded as skipped, not
    failed (compact-on-evict deployments legitimately outlive their raw
    window).  Works against a :class:`~.federation.FederatedTSDB` too —
    every surface it touches fans out."""
    policy = getattr(db, "downsample_policy", None)
    out: dict = {
        "enabled": policy is not None,
        "tiers": {},
        "agreement": [],
        "windows_served": 0,
        "windows_skipped": 0,
        "agree_all": True,
    }
    if policy is None:
        return out
    storage = db.rollup_storage_stats()
    for label in policy.labels():
        entry = dict(storage["tiers"].get(label, {}))
        entry.setdefault("buckets", 0)
        entry.setdefault("bytes", 0)
        entry.setdefault("series", 0)
        entry["coverage_lag_s"] = None
        out["tiers"][label] = entry
    out["rollup_bytes"] = storage.get("rollup_bytes", 0)
    out["ingested_points"] = storage.get("ingested_points", 0)
    now = db.clock.now()
    retention = getattr(db, "retention", _INF)
    raw_floor = now - retention if math.isfinite(retention) else -_INF
    for name in names:
        for step in policy.steps:
            label = tier_label(step)
            per_series = db.rollup_rows(name, step=step)
            if not per_series:
                continue
            firsts = [min(r[0] for r in rows) for _, rows in per_series]
            lasts = [max(r[0] for r in rows) for _, rows in per_series]
            at = min(lasts)
            lag = now - at
            tier_entry = out["tiers"][label]
            if tier_entry["coverage_lag_s"] is None or lag > tier_entry["coverage_lag_s"]:
                tier_entry["coverage_lag_s"] = lag
            # the window must start where EVERY series has rollup data and
            # the raw store still holds the points the twin re-buckets
            lo_end = max(firsts)
            if math.isfinite(raw_floor):
                lo_end = max(lo_end, bucket_end(raw_floor, step) + step)
            if at < lo_end:
                out["windows_skipped"] += 1
                out["agreement"].append(
                    {
                        "name": name,
                        "tier": label,
                        "served": False,
                        "reason": "no rollup/raw overlap (raw already evicted)",
                    }
                )
                continue
            n_buckets = int((at - lo_end) // step) + 1
            if n_buckets > max_buckets:
                lo_end = at - (max_buckets - 1) * step
            window_s = at - lo_end + step
            rolled = db.rollup_range_avg(
                name, None, window_s=window_s, at=at, step=step
            )
            twin = db.range_avg_bucketed(
                name, None, window_s=window_s, at=at, step=step
            )
            served = rolled is not None
            agree = served and (
                sorted((s.labels, s.value) for s in rolled)
                == sorted((s.labels, s.value) for s in twin)
            )
            out["agreement"].append(
                {
                    "name": name,
                    "tier": label,
                    "window_s": window_s,
                    "at": at,
                    "series": len(per_series),
                    "served": served,
                    "agree": agree,
                }
            )
            if served:
                out["windows_served"] += 1
                if not agree:
                    out["agree_all"] = False
            else:
                out["windows_skipped"] += 1
    return out
