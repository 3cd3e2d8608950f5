"""The Gorilla codec (``metrics/gorilla.py``) against the JAX package's.

The same points, made from a seed with numpy, go through both encoders;
the blobs must be equal byte for byte and decode to the same bits:

- every timestamp mode of ``_ts_int``: integer nanoseconds (a regular
  cadence, fractional cadences, irregular gaps) and the escape to int64
  bit patterns (a sub-nanosecond fraction, a NaN or infinite timestamp,
  -0.0, a magnitude past 2^62 ns), whether it comes at the first point or
  mid-stream;
- values with NaN staleness markers of any payload, +-inf, -0.0, repeats
  and counter resets;
- the streaming encoder's running summary, a head restored from its blobs
  (snapshot recovery) and appended to, ``summarize_values`` and
  ``GorillaChunk``'s accounting;
- a hypothesis property over generated streams.

Tolerance: exact (bytes and float bit patterns).
"""

import math
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_gpu_hpa_tpu.metrics import gorilla as jax_gorilla
from k8s_gpu_hpa_tpu_torch.metrics import gorilla
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

NAN_PAYLOAD = struct.unpack("<d", struct.pack("<Q", 0x7FF8_0000_0000_1234))[0]


def _same(a, b) -> bool:
    """Equal summaries, a NaN sum (inf + -inf) equal to a NaN sum."""
    return repr(a) == repr(b)


def _bits(arr: np.ndarray) -> list[int]:
    return arr.astype(np.float64).view(np.uint64).tolist()


def _values(rng: np.random.Generator, n: int) -> list[float]:
    """A gauge that drifts, repeats, resets, and carries markers."""
    out = []
    level = 0.0
    for i in range(n):
        r = rng.random()
        if r < 0.08:
            out.append(math.nan)
        elif r < 0.10:
            out.append(NAN_PAYLOAD)
        elif r < 0.25 and out:
            out.append(out[-1])  # a repeat: the one-byte XOR
        elif r < 0.28:
            level = 0.0  # a counter reset
            out.append(level)
        else:
            level += float(rng.uniform(0.0, 50.0))
            out.append(round(level, int(rng.integers(0, 6))))
    return out


def _stream(kind: str, seed: int, n: int = 150) -> list[tuple[float, float]]:
    rng = np.random.default_rng(seed)
    if kind == "cadence_1s":
        ts = [float(i) for i in range(1, n + 1)]
    elif kind == "cadence_15s":
        ts = [15.0 * i + 1_700_000_000.0 for i in range(n)]
    elif kind == "fractional":
        ts = [round(0.1 * i, 1) for i in range(n)]
    elif kind == "irregular":
        ts = np.cumsum(rng.choice([1.0, 5.0, 15.0, 0.5, 2.25], n)).tolist()
    elif kind == "sub_ns":  # the first point already escapes to bit patterns
        ts = [1e-10 * (i + 1) + i for i in range(n)]
    elif kind == "escape_mid_stream":  # nanoseconds, then an inexact ts
        ts = [float(i) for i in range(n)]
        ts[n // 2] = ts[n // 2] + 1e-12
    elif kind == "huge":
        ts = [2.0 ** 63 + 2.0 ** 20 * i for i in range(n)]
    elif kind == "special":
        ts = [-0.0] + [float(i) for i in range(1, n - 2)] + [math.inf, math.nan]
    else:
        raise ValueError(kind)
    values = _values(rng, n)
    values[:4] = [math.inf, -math.inf, -0.0, 0.0]
    return list(zip(ts, values))


KINDS = ["cadence_1s", "cadence_15s", "fractional", "irregular", "sub_ns",
         "escape_mid_stream", "huge", "special"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_the_blobs_are_jax_s_byte_for_byte(kind, seed):
    points = _stream(kind, seed)
    port = gorilla.encode(points)
    ref = jax_gorilla.encode(points)
    assert port == ref
    ts_blob, val_blob, count, mode = port
    assert count == len(points)
    assert mode == (gorilla.TS_NANOS if kind in ("cadence_1s", "cadence_15s", "fractional",
                                                  "irregular") else gorilla.TS_BITS)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_gives_jax_s_bits_and_the_points_that_went_in(kind):
    points = _stream(kind, 7)
    ts_blob, val_blob, count, mode = gorilla.encode(points)
    ts, vals = gorilla.decode(ts_blob, val_blob, count, mode)
    ref_ts, ref_vals = jax_gorilla.decode(ts_blob, val_blob, count, mode)
    assert _bits(ts) == _bits(ref_ts) and _bits(vals) == _bits(ref_vals)
    assert _bits(ts) == _bits(np.array([t for t, _ in points]))
    assert _bits(vals) == _bits(np.array([v for _, v in points]))
    assert _bits(gorilla.decode_ts(ts_blob, count, mode)) == _bits(
        jax_gorilla.decode_ts(ts_blob, count, mode))


def test_ts_int_maps_each_mode_as_jax_s():
    samples = [0.0, -0.0, 1.0, 0.1, 1e-10, 1.5e-9, 2.0 ** 62 / 1e9, 2.0 ** 63, -5.25,
               math.inf, -math.inf, math.nan, 1_700_000_000.123456789]
    for ts in samples:
        for mode in (gorilla.TS_NANOS, gorilla.TS_BITS):
            assert gorilla._ts_int(ts, mode) == jax_gorilla._ts_int(ts, mode), (ts, mode)


@pytest.mark.parametrize("kind", ["irregular", "escape_mid_stream", "special"])
def test_the_streaming_encoder_s_summary_is_jax_s(kind):
    port, ref = gorilla.GorillaEncoder(), jax_gorilla.GorillaEncoder()
    assert port.summary() is None and ref.summary() is None
    for ts, value in _stream(kind, 3):
        port.append(ts, value)
        ref.append(ts, value)
        assert _same(port.summary(), ref.summary())
    assert (bytes(port.ts_buf), bytes(port.val_buf), port.ts_mode) == (
        bytes(ref.ts_buf), bytes(ref.val_buf), ref.ts_mode)
    values = [v for _, v in _stream(kind, 3)]
    assert _same(gorilla.summarize_values(values), jax_gorilla.summarize_values(values))
    assert _same(gorilla.summarize_values(np.array(values)), port.summary())


def test_an_all_marker_summary_is_jax_s():
    values = [math.nan] * 5
    assert gorilla.summarize_values(values) == jax_gorilla.summarize_values(values) == (
        0, 0.0, None, None, 5)


@pytest.mark.parametrize("kind", ["cadence_15s", "irregular", "sub_ns", "special"])
def test_a_restored_head_continues_as_an_uninterrupted_one(kind):
    """Snapshot recovery: a head adopted from its blobs appends the rest of
    the stream to JAX's bytes, and keeps JAX's summary."""
    points = _stream(kind, 11)
    cut = len(points) // 3
    first = gorilla.encode(points[:cut])
    port = gorilla.GorillaEncoder()
    port.restore(first[0], first[1], first[2], first[3])
    ref = jax_gorilla.GorillaEncoder()
    ref.restore(first[0], first[1], first[2], first[3])
    assert _same(port.summary(), ref.summary())
    for ts, value in points[cut:]:
        port.append(ts, value)
        ref.append(ts, value)
    whole = jax_gorilla.encode(points)
    assert (bytes(port.ts_buf), bytes(port.val_buf), port.count, port.ts_mode) == whole
    assert (bytes(ref.ts_buf), bytes(ref.val_buf)) == whole[:2]
    assert _same(port.summary(), ref.summary())


def test_a_sealed_chunk_accounts_as_jax_s():
    points = _stream("irregular", 5, n=64)
    ts_blob, val_blob, count, mode = gorilla.encode(points)
    origins = tuple(range(count))
    for with_origins in (None, origins):
        port = gorilla.GorillaChunk(count, ts_blob, val_blob, points[0][0], points[-1][0],
                                    with_origins, mode)
        ref = jax_gorilla.GorillaChunk(count, ts_blob, val_blob, points[0][0], points[-1][0],
                                       with_origins, mode)
        assert port.nbytes() == ref.nbytes()
        assert _same(port.ensure_summary(), ref.ensure_summary())
        assert [_bits(a) for a in port.arrays()] == [_bits(a) for a in ref.arrays()]


_floats = st.floats(allow_nan=True, allow_infinity=True)
_gaps = st.one_of(st.sampled_from([0.0, 1.0, 5.0, 15.0, 0.1]),
                  st.floats(min_value=0.0, max_value=1e6, allow_nan=False))


@settings(max_examples=60, deadline=None)
@given(st.floats(min_value=-1e9, max_value=1e9, allow_nan=False),
       st.lists(st.tuples(_gaps, _floats), min_size=1, max_size=80))
def test_any_stream_encodes_to_jax_s_bytes(start, steps):
    ts = start
    points = []
    for gap, value in steps:
        ts = ts + gap
        points.append((ts, value))
    port = gorilla.encode(points)
    assert port == jax_gorilla.encode(points)
    got_ts, got_vals = gorilla.decode(*port)
    assert _bits(got_ts) == _bits(np.array([t for t, _ in points]))
    assert _bits(got_vals) == _bits(np.array([v for _, v in points]))
