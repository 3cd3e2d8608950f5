"""The TSDB's retention (``metrics/tsdb.py``) against the JAX package's.

JAX's store drops whole sealed chunks of ``chunk_size`` points (64),
counted from a series' first point, once a chunk's last point is older than
``retention`` (the lookback unless a larger one is given), and never its
open head; so a read older than the lookback still sees the points of a
chunk that has not gone yet.  The port keeps plain lists and drops them in
the same groups.

- ``instant_vector`` at ``now - w`` for w in 300, 1800 and 3600 s, on one
  series appended at 1, 5, 15 and 30 s cadence, and at every 37th second of
  a seeded jittered series with staleness markers, a larger retention and
  another chunk size: the same samples as JAX's.
- ``BurnRate`` over each shipped window (5m, 30m, 1h, 6h) on SLO counters
  written at each cadence, errors from 3000 s, read at every 97th second:
  the same burn as JAX's (trimmed point by point, the 30m window over 30 s
  counters reads 12.69 where JAX's reads 28.33).

Tolerance: exact (the same float operations on the same points).
"""

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu.metrics import rules as jax_rules
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.obs import slo as jax_slo
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch.metrics import rules, tsdb
from k8s_gpu_hpa_tpu_torch.obs import slo
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(tsdb=tsdb, rules=rules, clock=clock, slo=slo)
JAX = dict(tsdb=jax_tsdb, rules=jax_rules, clock=jax_clock, slo=jax_slo)
LABELS = (("job", "x"),)
CADENCES = (1.0, 5.0, 15.0, 30.0)
WINDOWS = (300.0, 1800.0, 3600.0)
END = 3990.0


def _series(mods, cadence: float, **kw):
    """One series, its value its timestamp, appended every ``cadence`` s
    from 0 to ``END``; returns the store and the last timestamp."""
    db = mods["tsdb"].TimeSeriesDB(mods["clock"].VirtualClock(), **kw)
    t = 0.0
    while t <= END:
        db.append("x", LABELS, t, t)
        last, t = t, t + cadence
    return db, last


def _read(db, at: float) -> list:
    return [(s.value, s.labels) for s in db.instant_vector("x", None, at)]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("cadence", CADENCES)
def test_a_read_before_the_lookback_sees_jax_s_points(cadence, window):
    port, now = _series(PORT, cadence)
    ref, _ = _series(JAX, cadence)
    assert _read(port, now - window) == _read(ref, now - window)


def test_the_thirty_second_series_answers_an_hour_old_read_half_way_as_jax_s():
    """The input the fault was found on: at 3990 s the chunk of the points
    at 1920-3810 s ends after the cutoff at 3690 s, so it stays, and a read
    at ``now - 1800`` finds the point at 2190 s."""
    port, now = _series(PORT, 30.0)
    ref, _ = _series(JAX, 30.0)
    assert now == 3990.0
    assert _read(port, now - 1800.0) == _read(ref, now - 1800.0) == [(2190.0, LABELS)]


@pytest.mark.parametrize("retention,chunk_size", [
    (None, 64), (100.0, 64), (900.0, 64), (3600.0, 64), (None, 16), (1200.0, 8),
])
def test_retention_and_chunk_size_are_jax_s(retention, chunk_size):
    port, now = _series(PORT, 5.0, retention=retention, chunk_size=chunk_size)
    ref, _ = _series(JAX, 5.0, retention=retention, chunk_size=chunk_size)
    assert (port.retention, port.chunk_size) == (ref.retention, ref.chunk_size)
    for back in range(0, 4000, 50):
        assert _read(port, now - back) == _read(ref, now - back), back


def _jittered(mods, seed: int):
    """A series at seeded intervals of 0.5-40 s, one point in 25 a
    staleness marker, read at every 37th second back from the end."""
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(0.5, 40.0, 300).tolist()
    stale = (rng.uniform(0.0, 1.0, 300) < 0.04).tolist()
    values = rng.normal(50.0, 20.0, 300).tolist()
    db = mods["tsdb"].TimeSeriesDB(mods["clock"].VirtualClock())
    t = 0.0
    for gap, marker, value in zip(gaps, stale, values):
        t += gap
        if marker:
            db.mark_stale("x", LABELS, t)
        else:
            db.append("x", LABELS, value, t)
    return [_read(db, t - back) for back in range(0, int(t) + 37, 37)]


@pytest.mark.parametrize("seed", range(5))
def test_a_jittered_series_with_markers_reads_as_jax_s_at_every_age(seed):
    assert _jittered(PORT, seed) == _jittered(JAX, seed)


def _burn(mods, cadence: float, window: float) -> list:
    """The SLO counters written every ``cadence`` s (one event a second,
    all good until 3000 s, then half), the burn over ``window`` read at
    every 97th second, as the slow alert's 30m half reads it."""
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock)
    s = mods["slo"]
    labels = (("slo", "scrape-success"),)
    burn = mods["rules"].BurnRate(
        s.SLO_GOOD_TOTAL, s.SLO_EVENTS_TOTAL, 0.99, window,
        good_matchers=dict(labels), total_matchers=dict(labels),
    )
    good = total = 0.0
    out = []
    t = 0.0
    while t <= 4200.0:
        total += cadence
        good += cadence if t < 3000.0 else cadence / 2
        db.append(s.SLO_GOOD_TOTAL, labels, good, t)
        db.append(s.SLO_EVENTS_TOTAL, labels, total, t)
        if int(t) % 97 < cadence:
            out.append((t, [x.value for x in burn.evaluate(db, t)]))
        t += cadence
    return out


@pytest.mark.parametrize("window", slo.FAST_WINDOWS + slo.SLOW_WINDOWS)
@pytest.mark.parametrize("cadence", CADENCES)
def test_burn_rate_over_the_shipped_windows_is_jax_s(cadence, window):
    port = _burn(PORT, cadence, window)
    assert port == _burn(JAX, cadence, window)
    assert any(values for _, values in port)


def test_the_shipped_windows_are_jax_s():
    assert slo.FAST_WINDOWS + slo.SLOW_WINDOWS == jax_slo.FAST_WINDOWS + jax_slo.SLOW_WINDOWS
