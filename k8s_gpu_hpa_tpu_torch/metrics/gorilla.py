"""Byte-aligned Gorilla codec: the columnar chunk format behind the TSDB.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/gorilla.py``, whole: the same
blobs, byte for byte, for the same points, so a snapshot either package
writes installs its chunks verbatim in the other.

Facebook's Gorilla paper (Pelkonen et al., VLDB 2015) compresses in-memory
time series two ways: timestamps as delta-of-delta (a regular scrape cadence
makes the second difference almost always zero) and values as the XOR of
consecutive float64 bit patterns (a slowly moving gauge keeps its exponent
and leading mantissa bits, so the XOR is mostly zeros).  This is a
byte-aligned variant: Gorilla proper packs bits; whole bytes cost about one
bit a sample on the paper's data but keep the encoder a handful of integer
operations an append, and let decode hand whole columns to numpy.

**Timestamp column**, in one of two modes a stream:

- ``TS_NANOS`` (the default): a ts exactly representable as integer
  nanoseconds (``t = round(ts * 1e9)`` with ``t / 1e9 == ts`` bit for bit,
  the division the decoder performs).  Point 0 is 8 raw little-endian
  signed bytes of ``t``; every later point stores ``dod = delta_i -
  delta_{i-1}`` (``delta_0 := 0``) as a zigzag varint, so a fixed cadence
  costs one ``0x00`` byte a point after the first delta.
- ``TS_BITS``: the first ts that is not representable so (sub-ns
  fractions, |ts| beyond about 2^62 ns, NaN or inf, -0.0) switches the
  whole stream to delta-of-delta over signed int64 bit patterns, exact for
  any float64 at a worse ratio.  The switch re-encodes the head, at most
  one chunk, in place.

**Value column**: point 0 is the 8 raw bytes of its float64; every later
point stores ``xor = bits_i ^ bits_{i-1}``: ``0x00`` when it is 0 (a
repeated value), else a header byte ``(trailing_zero_bytes << 4) |
significant_bytes`` and the significant bytes, little-endian.

NaN staleness markers (any payload), +-inf, -0.0 and counter resets all
decode to the 8 bytes that went in.  The encoder is a streaming head (one a
live series): ``append`` extends two bytearrays, and the TSDB's seal freezes
them into an immutable :class:`GorillaChunk`.  Decode rebuilds both columns
as numpy arrays (a Python loop over at most one chunk of points) for
``searchsorted`` reads and vectorized scans.
"""

from __future__ import annotations

import math
import struct

import numpy as np

_pack_d = struct.Struct("<d").pack
_unpack_q = struct.Struct("<q").unpack_from

#: timestamp-column modes (stored per chunk / per head stream)
TS_NANOS = 0  #: dod varints over integer nanoseconds (the common case)
TS_BITS = 1  #: dod varints over signed int64 bit patterns (exact fallback)

#: nanosecond magnitudes beyond this fall back to TS_BITS so every partial
#: sum the decoder reconstructs stays inside int64
_NANOS_LIMIT = 1 << 62

_copysign = math.copysign


def _float_bits_signed(value: float) -> int:
    """Signed int64 bit pattern of a float64 (two's complement)."""
    u = int.from_bytes(_pack_d(value), "little")
    return u - (1 << 64) if u >= (1 << 63) else u


def _ts_int(ts: float, mode: int) -> int | None:
    """The integer this ts occupies in ``mode``'s time domain, or None when
    TS_NANOS cannot represent it exactly (the caller escapes to TS_BITS)."""
    if mode == TS_BITS:
        return _float_bits_signed(ts)
    try:
        t = round(ts * 1e9)
    except (ValueError, OverflowError):  # NaN / inf timestamps
        return None
    if t > _NANOS_LIMIT or t < -_NANOS_LIMIT or t / 1e9 != ts:
        return None
    if t == 0 and ts == 0.0 and _copysign(1.0, ts) < 0.0:
        return None  # -0.0: nanos would decode to +0.0, not bit-exact
    return t


class GorillaEncoder:
    """Streaming byte-aligned Gorilla encoder for one series head.

    Mutable state is three integers (last timestamp in the stream's time
    domain, last delta, last value bits) plus the two output bytearrays;
    ``append`` is a handful of int ops on the TSDB's hottest path.
    """

    __slots__ = ("count", "ts_buf", "val_buf", "ts_mode",
                 "_t_last", "_t_delta", "_v_bits",
                 "_s_count", "_s_sum", "_s_min", "_s_max", "_s_nans")

    def __init__(self) -> None:
        self.count = 0
        self.ts_buf = bytearray()
        self.val_buf = bytearray()
        self.ts_mode = TS_NANOS
        self._t_last = 0
        self._t_delta = 0
        self._v_bits = 0
        self._s_count = 0
        self._s_sum = 0.0
        self._s_min = math.inf
        self._s_max = -math.inf
        self._s_nans = 0

    def summary(self) -> "tuple | None":
        """Running ``(count, sum, min, max, nan_count)`` over the head's
        non-NaN values — the same left-to-right accumulation a decode-and-scan
        of the sealed chunk would perform, so planned aggregation over the
        sealed summary is bit-identical to the naive path (planner.py).
        None while the head is empty."""
        if self.count == 0:
            return None
        if self._s_count == 0:  # all points are NaN staleness markers
            return (0, 0.0, None, None, self._s_nans)
        return (self._s_count, self._s_sum, self._s_min, self._s_max,
                self._s_nans)

    def append(self, ts: float, value: float) -> None:
        t = _ts_int(ts, self.ts_mode)
        if t is None:
            self._escape_to_bits()
            t = _float_bits_signed(ts)
        v_raw = _pack_d(value)
        v_bits = int.from_bytes(v_raw, "little")
        if self.count == 0:
            self.ts_buf += t.to_bytes(8, "little", signed=True)
            self.val_buf += v_raw
        else:
            delta = t - self._t_last
            dod = delta - self._t_delta
            # zigzag so small negative dods stay one byte, then varint
            # (Python ints are unbounded, so the sign-branch form is exact
            # even when consecutive bit patterns straddle the int64 range)
            u = (dod << 1) if dod >= 0 else ((-dod << 1) - 1)
            buf = self.ts_buf
            while u >= 0x80:
                buf.append((u & 0x7F) | 0x80)
                u >>= 7
            buf.append(u)
            self._t_delta = delta
            xor = v_bits ^ self._v_bits
            if xor == 0:
                self.val_buf.append(0)
            else:
                # trailing-zero BYTES; strip them and the leading-zero bytes
                tz = ((xor & -xor).bit_length() - 1) >> 3
                sig_val = xor >> (tz << 3)
                sig = (sig_val.bit_length() + 7) >> 3
                self.val_buf.append((tz << 4) | sig)
                self.val_buf += sig_val.to_bytes(sig, "little")
        self._t_last = t
        self._v_bits = v_bits
        self.count += 1
        if value != value:  # NaN staleness marker: excluded from aggregates
            self._s_nans += 1
        else:
            self._s_count += 1
            self._s_sum += value
            if value < self._s_min:
                self._s_min = value
            if value > self._s_max:
                self._s_max = value

    def _escape_to_bits(self) -> None:
        """Re-encode the timestamp column over bit patterns (values stay).
        At most one chunk of points, and at most once per stream."""
        old_ts = (
            decode_ts(bytes(self.ts_buf), self.count, TS_NANOS)
            if self.count
            else ()
        )
        self.ts_mode = TS_BITS
        self.ts_buf = bytearray()
        self._t_last = 0
        self._t_delta = 0
        prev_delta = 0
        prev = 0
        for i, ts in enumerate(old_ts):
            t = _float_bits_signed(float(ts))
            if i == 0:
                self.ts_buf += t.to_bytes(8, "little", signed=True)
            else:
                delta = t - prev
                dod = delta - prev_delta
                u = (dod << 1) if dod >= 0 else ((-dod << 1) - 1)
                while u >= 0x80:
                    self.ts_buf.append((u & 0x7F) | 0x80)
                    u >>= 7
                self.ts_buf.append(u)
                prev_delta = delta
            prev = t
            self._t_last = t
            self._t_delta = prev_delta

    def reset(self) -> None:
        """Clear all state (after sealing the buffers into a chunk)."""
        self.count = 0
        self.ts_buf = bytearray()
        self.val_buf = bytearray()
        self.ts_mode = TS_NANOS
        self._t_last = 0
        self._t_delta = 0
        self._v_bits = 0
        self._s_count = 0
        self._s_sum = 0.0
        self._s_min = math.inf
        self._s_max = -math.inf
        self._s_nans = 0

    def restore(self, ts_blob: bytes, val_blob: bytes, count: int,
                ts_mode: int = TS_NANOS) -> None:
        """Adopt a previously-encoded stream (snapshot recovery): the
        continuation state is fully derivable from the decoded tail."""
        self.count = count
        self.ts_buf = bytearray(ts_blob)
        self.val_buf = bytearray(val_blob)
        self.ts_mode = ts_mode
        self._s_count = 0
        self._s_sum = 0.0
        self._s_min = math.inf
        self._s_max = -math.inf
        self._s_nans = 0
        if count == 0:
            self._t_last = self._t_delta = self._v_bits = 0
            return
        ts_arr, val_arr = decode(ts_blob, val_blob, count, ts_mode)
        for v in val_arr.tolist():  # left-to-right: matches append order
            if v != v:
                self._s_nans += 1
            else:
                self._s_count += 1
                self._s_sum += v
                if v < self._s_min:
                    self._s_min = v
                if v > self._s_max:
                    self._s_max = v
        last = _ts_int(float(ts_arr[-1]), ts_mode)
        assert last is not None  # it came out of this very codec
        self._t_last = last
        if count == 1:
            self._t_delta = 0
        else:
            prev = _ts_int(float(ts_arr[-2]), ts_mode)
            assert prev is not None
            self._t_delta = last - prev
        self._v_bits = int(val_arr.view(np.uint64)[-1])


class GorillaChunk:
    """An immutable sealed chunk: compressed columns + scan metadata.

    ``origins`` is None when no point in the chunk carried an origin span id
    (the overwhelmingly common case — only rule outputs and traced scrapes
    do), else a tuple parallel to the decoded arrays.  ``_decoded`` caches
    the (ts, values) numpy pair; the owning TSDB bounds how many chunks hold
    a live cache at once.

    ``summary`` is ``(count, sum, min, max, nan_count)`` over the chunk's
    non-NaN values, accumulated left-to-right at seal time (the planner's
    decode-free aggregation pushdown).  Chunks recovered from snapshots carry
    None — the format-2 snapshot layout is positional and frozen — and the
    planner recomputes it lazily via :meth:`ensure_summary`.
    """

    __slots__ = ("count", "ts_blob", "val_blob", "ts_mode",
                 "first_ts", "last_ts", "origins", "summary", "_decoded")

    def __init__(
        self,
        count: int,
        ts_blob: bytes,
        val_blob: bytes,
        first_ts: float,
        last_ts: float,
        origins: tuple | None = None,
        ts_mode: int = TS_NANOS,
        summary: tuple | None = None,
    ):
        self.count = count
        self.ts_blob = ts_blob
        self.val_blob = val_blob
        self.ts_mode = ts_mode
        self.first_ts = first_ts
        self.last_ts = last_ts
        self.origins = origins
        self.summary = summary
        self._decoded: tuple[np.ndarray, np.ndarray] | None = None

    def ensure_summary(self) -> tuple:
        """The chunk's summary, computing and caching it from a decode when
        the seal didn't provide one (snapshot-recovered chunks).  The scan is
        left-to-right, the same association the encoder's running sum uses."""
        if self.summary is None:
            self.summary = summarize_values(self.arrays()[1])
        return self.summary

    def nbytes(self) -> int:
        """Retained payload bytes: both blobs plus 8 per tracked origin."""
        n = len(self.ts_blob) + len(self.val_blob)
        if self.origins is not None:
            n += 8 * self.count
        return n

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Decode (uncached) into parallel (timestamps, values) arrays."""
        return decode(self.ts_blob, self.val_blob, self.count, self.ts_mode)


def summarize_values(values) -> tuple:
    """``(count, sum, min, max, nan_count)`` over an iterable of float64s,
    skipping NaN staleness markers, accumulated strictly left-to-right —
    the single definition of chunk-aggregate semantics shared by the
    encoder's running summary, snapshot-recovered chunks, and the naive
    reference path the planner is differential-tested against."""
    n = 0
    total = 0.0
    vmin = math.inf
    vmax = -math.inf
    nans = 0
    seq = values.tolist() if hasattr(values, "tolist") else values
    for v in seq:
        if v != v:
            nans += 1
        else:
            n += 1
            total += v
            if v < vmin:
                vmin = v
            if v > vmax:
                vmax = v
    if n == 0:
        return (0, 0.0, None, None, nans)
    return (n, total, vmin, vmax, nans)


def decode_ts(ts_blob: bytes, count: int, ts_mode: int) -> np.ndarray:
    """Decode the timestamp column alone into a float64 array."""
    if count == 0:
        return np.empty(0, dtype=np.float64)
    t = _unpack_q(ts_blob, 0)[0]
    delta = 0
    pos = 8
    if ts_mode == TS_NANOS:
        out = [0.0] * count
        out[0] = t / 1e9
        for k in range(1, count):
            u = 0
            shift = 0
            while True:
                b = ts_blob[pos]
                pos += 1
                u |= (b & 0x7F) << shift
                if b < 0x80:
                    break
                shift += 7
            delta += (u >> 1) ^ -(u & 1)
            t += delta
            out[k] = t / 1e9  # the exact division append() verified
        return np.array(out, dtype=np.float64)
    bits = [0] * count
    bits[0] = t
    for k in range(1, count):
        u = 0
        shift = 0
        while True:
            b = ts_blob[pos]
            pos += 1
            u |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
        delta += (u >> 1) ^ -(u & 1)
        t += delta
        bits[k] = t
    return np.array(bits, dtype=np.int64).view(np.float64)


def decode(
    ts_blob: bytes, val_blob: bytes, count: int, ts_mode: int = TS_NANOS
) -> tuple[np.ndarray, np.ndarray]:
    """Decode both columns into float64 numpy arrays (bit-exact).

    The varint/XOR walk is a Python loop over at most one chunk of points;
    the reconstructed columns become arrays (zero-copy bit-pattern views
    where possible), so range queries (``searchsorted``) and scans run
    vectorized.
    """
    ts_arr = decode_ts(ts_blob, count, ts_mode)
    if count == 0:
        return ts_arr, np.empty(0, dtype=np.float64)
    val_bits = [0] * count
    v = int.from_bytes(val_blob[0:8], "little")
    val_bits[0] = v
    pos = 8
    for k in range(1, count):
        header = val_blob[pos]
        pos += 1
        if header:
            sig = header & 0x0F
            v ^= int.from_bytes(val_blob[pos:pos + sig], "little") << (
                (header >> 4) << 3
            )
            pos += sig
        val_bits[k] = v
    val_arr = np.array(val_bits, dtype=np.uint64).view(np.float64)
    return ts_arr, val_arr


def encode(points: "list[tuple[float, float]]") -> tuple[bytes, bytes, int, int]:
    """Whole-sequence convenience encoder (tests, tooling): returns
    ``(ts_blob, val_blob, count, ts_mode)`` for (ts, value) pairs."""
    enc = GorillaEncoder()
    for ts, value in points:
        enc.append(ts, value)
    return bytes(enc.ts_buf), bytes(enc.val_buf), enc.count, enc.ts_mode
