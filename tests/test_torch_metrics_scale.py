"""The metrics plane at scale (``control/scale_harness.py``'s
``run_fleet_scale`` and ``run_query_bench``, ``trial.py``'s three rungs)
against the JAX package's.

- ``run_fleet_scale`` unsharded and over hash-ring shards, and
  ``run_query_bench``, give JAX's result at small sizes on every field that
  does not read the wall clock: retained points and bytes, compression,
  appends, series, the fleet vector, the rule's full and skipped
  evaluations, replicas, scale events, the ring's invariants, identical
  vectors, the planner's and the decode cache's counts.
- At bench.py's smoke sizes, the port's ``sim_scale_rung``,
  ``sim_scale_10k_rung`` and ``query_bench_rung`` carry bench.py's keys and
  give the constants ``chip_smoke.py``'s ``metrics_scale`` phase holds the
  card's run to (``METRICS_SCALE_EXPECTED``), and bench.py's own rungs give
  the same constants.

Tolerance: exact on the deterministic fields; the wall-clock fields
(speedups, query percentiles, appends a second, the naive and planned
times) are only checked to exist.
"""

import functools

import pytest
import torch

import bench
import chip_smoke
from k8s_gpu_hpa_tpu.control import scale_harness as jax_harness
from k8s_gpu_hpa_tpu_torch import trial
from k8s_gpu_hpa_tpu_torch.control import scale_harness
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

#: a time scale below 1, which picks bench.py's smoke sizes
BENCH_SMOKE_TIME_SCALE = 0.1
#: the fields that read the wall clock
WALL = {"wall_s", "speedup", "appends_per_sec", "query_p50_ms", "query_p95_ms",
        "federated_scan_p95_ms", "exprs", "naive_ms", "planned_ms", "meets_floor", "ok"}


def _deterministic(result: dict) -> dict:
    return {k: v for k, v in result.items() if k not in WALL}


@pytest.mark.parametrize("kw", [
    dict(targets=60, horizon_s=300.0),
    dict(targets=80, horizon_s=450.0, scrape_interval=5.0, rule_interval=1.0),
    dict(targets=200, horizon_s=300.0, shards=3),
    dict(targets=120, horizon_s=360.0, shards=4),
], ids=["60", "80-fast-cadence", "200-shards-3", "120-shards-4"])
def test_run_fleet_scale_is_jax_s(kw):
    port = scale_harness.run_fleet_scale(**kw)
    ref = jax_harness.run_fleet_scale(**kw)
    assert set(port) == set(ref)
    assert _deterministic(port) == _deterministic(ref)
    assert port["fleet_vector_size"] == kw["targets"] and port["scale_events"] > 0
    if kw.get("shards"):
        assert port["shards_disjoint"] and port["shards_cover_fleet"]


@pytest.mark.parametrize("kw", [
    dict(targets=100, shards=4, horizon_s=900.0),
    dict(targets=60, shards=2, horizon_s=1200.0, window_s=700.0, scrape_interval=2.5),
], ids=["100x4", "60x2-window-700-cadence-2.5"])
def test_run_query_bench_is_jax_s(kw):
    port = scale_harness.run_query_bench(iters=1, p95_iters=3, **kw)
    ref = jax_harness.run_query_bench(iters=1, p95_iters=3, **kw)
    assert set(port) == set(ref) and set(port["exprs"]) == set(ref["exprs"])
    assert _deterministic(port) == _deterministic(ref)
    assert port["identical"] and port["planner_fastpath"] > 0 and port["planner_fallback"] > 0


@functools.cache
def _port_rungs() -> dict:
    return {"sim_scale": trial.sim_scale_rung(),
            "sim_scale_10k": trial.sim_scale_10k_rung(),
            "query_bench": trial.query_bench_rung()}


@pytest.mark.parametrize("rung", ["sim_scale", "sim_scale_10k", "query_bench"])
def test_the_smoke_rungs_give_the_chip_smoke_constants(rung):
    result = _port_rungs()[rung]
    expected = chip_smoke.METRICS_SCALE_EXPECTED[rung]
    assert {k: result[k] for k in expected} == expected
    assert result["speedup"] > 0 and result["query_p95_ms"] > 0
    assert result["speedup_floor"] in (100.0, 50.0, 2.0)


def test_bench_s_smoke_rungs_give_the_same_constants_and_keys(monkeypatch):
    monkeypatch.setattr(bench, "TIME_SCALE", BENCH_SMOKE_TIME_SCALE)
    ref = {"sim_scale": bench.run_rung_sim_scale(),
           "sim_scale_10k": bench.run_rung_sim_scale_10k(),
           "query_bench": bench.run_rung_query_bench()}
    port = _port_rungs()
    for rung, expected in chip_smoke.METRICS_SCALE_EXPECTED.items():
        assert {k: ref[rung][k] for k in expected} == expected, rung
        assert set(port[rung]) == set(ref[rung]), rung
        assert _deterministic(port[rung]) == _deterministic(ref[rung]), rung
