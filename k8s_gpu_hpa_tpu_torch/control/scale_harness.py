"""Fleet-scale harnesses of the metrics plane, and the recovery drill.

Counterpart of ``k8s_gpu_hpa_tpu/control/scale_harness.py``.

- ``run_fleet_scale`` (bench.py's ``sim_scale`` and ``sim_scale_10k``
  rungs, ``trial.sim_scale_rung`` and ``trial.sim_scale_10k_rung``): N
  synthetic structured targets beside the real exporter, kube-state-metrics
  and HPA loop on one virtual clock, driven for a long virtual horizon and
  measured in wall time.  It exercises the structured scrape path, the
  inverted label index, bounded retention on Gorilla chunks, incremental
  rule evaluation (``rule_interval < scrape_interval``, so most fleet-rule
  ticks skip) and, with ``shards``, the hash-ring scrape plane with its
  per-shard pre-reductions and the federated ``Ratio``.
- ``run_query_bench`` (bench.py's ``query_bench`` rung,
  ``trial.query_bench_rung``): the fleet-aggregate rule basket evaluated
  naive and planned over one populated sharded TSDB.
- ``run_downsample_bench`` (bench.py's ``downsample_bench`` rung,
  ``trial.downsample_bench_rung``): a day of fleet history aged through the
  5m/1h compactor, a tier-aligned fleet query read from the 1h rollups
  against the cold raw rescan, the rollups' bytes, and a randomized
  rollup-against-raw-twin differential.
- ``run_recovery_drill`` (the ``drill`` scenario and bench.py's
  ``recovery_drill`` rung, ``trial.recovery_drill_rung``): each durable
  component of the control plane crashed and rebuilt mid-run.

Everything is deterministic (a virtual clock, no randomness in the
synthetic load), so two runs differ only in their wall-clock numbers.
"""

from __future__ import annotations

import gc
import random
import tempfile
import time
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.chaos import ChaosSchedule, FaultSpec
from k8s_gpu_hpa_tpu_torch.control.checkpoint import FileCheckpointStore
from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
from k8s_gpu_hpa_tpu_torch.control.hpa import HPABehavior, ScalingPolicy, ScalingRules
from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline, PipelineIntervals
from k8s_gpu_hpa_tpu_torch.metrics.downsample import DownsamplePolicy, raw_bucket_rows
from k8s_gpu_hpa_tpu_torch.metrics.federation import FederatedTSDB
from k8s_gpu_hpa_tpu_torch.metrics.planner import QueryPlanner
from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    Aggregate,
    Avg,
    AvgOverTime,
    Ratio,
    RecordingRule,
    Select,
)
from k8s_gpu_hpa_tpu_torch.metrics.schema import MetricFamily
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.metrics.wal import WriteAheadLog
from k8s_gpu_hpa_tpu_torch.obs import Tracer, index_spans, lineage_of, profile
from k8s_gpu_hpa_tpu_torch.perfgates import UNCOMPRESSED_BYTES_PER_SAMPLE
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

#: how many prebaked exposition variants each synthetic target cycles
#: through — values must CHANGE between scrapes so every scrape dirties the
#: fleet series (the worst case for incremental eval's signature check)
_VARIANTS = 4


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def _synthetic_fetch(index: int):
    """A structured fetch for one fleet member: one ``fleet_duty_cycle``
    gauge whose value cycles through ``_VARIANTS`` prebaked families.
    Families are built once; the scraper's fast path ingests them with no
    per-tick text round trip and (labels already sorted by ``Sample.make``)
    no per-sample label merge."""
    variants: list[list[MetricFamily]] = []
    for v in range(_VARIANTS):
        fam = MetricFamily(
            "fleet_duty_cycle", "gauge", "synthetic fleet member duty cycle"
        )
        fam.add(
            30.0 + (index % 40) + 5.0 * v, job="fleet", instance=f"synt-{index:04d}"
        )
        variants.append([fam])
    state = {"tick": 0}

    def fetch() -> list[MetricFamily]:
        out = variants[state["tick"] % _VARIANTS]
        state["tick"] += 1
        return out

    return fetch


def fleet_rule() -> RecordingRule:
    """``fleet_duty_cycle_avg = avg(fleet_duty_cycle{job="fleet"})`` — the
    fleet-wide aggregate whose input set is the full N-target series
    population (the expensive eval incremental skipping must avoid)."""
    return RecordingRule(
        record="fleet_duty_cycle_avg",
        expr=Avg(Select("fleet_duty_cycle", {"job": "fleet"})),
        labels={"namespace": "default", "deployment": "fleet"},
    )


def fleet_shard_rules(shard: int) -> list[RecordingRule]:
    """Per-shard pre-reductions (the Prometheus federation pattern): each
    shard records the sum and count over ITS slice of the fleet, labeled by
    shard, so the global average never re-scans raw series."""
    sel = Select("fleet_duty_cycle", {"job": "fleet"})
    labels = {"job": "fleet-agg", "shard": str(shard)}
    return [
        RecordingRule(
            record="fleet_duty_cycle_sum",
            expr=Aggregate("sum", sel),
            labels=dict(labels),
        ),
        RecordingRule(
            record="fleet_duty_cycle_count",
            expr=Aggregate("count", sel),
            labels=dict(labels),
        ),
    ]


def fleet_federated_rule() -> RecordingRule:
    """The federated fleet average: ``sum(shard sums) / sum(shard counts)``
    over the S pre-reduced series — O(shards) per eval instead of O(fleet).
    Same output series as :func:`fleet_rule`, so every consumer (adapter
    read, drill timeline) is oblivious to which plane computed it."""
    return RecordingRule(
        record="fleet_duty_cycle_avg",
        expr=Ratio(
            Aggregate("sum", Select("fleet_duty_cycle_sum", {"job": "fleet-agg"})),
            Aggregate("sum", Select("fleet_duty_cycle_count", {"job": "fleet-agg"})),
        ),
        labels={"namespace": "default", "deployment": "fleet"},
    )


def run_fleet_scale(
    targets: int = 1000,
    horizon_s: float = 3600.0,
    scrape_interval: float = 15.0,
    rule_interval: float = 5.0,
    sample_every: float = 60.0,
    shards: int = 0,
) -> dict:
    """Drive a full ``AutoscalingPipeline`` plus ``targets`` synthetic fleet
    targets for ``horizon_s`` virtual seconds; return scale metrics.

    The returned dict is the ``sim_scale``/``sim_scale_10k`` bench-rung
    payload: wall time, virtual/wall ``speedup``, ``peak_retained_points``
    (retention bound), retained-bytes accounting (``bytes_per_sample`` and
    ``compression_ratio`` vs the 16-byte uncompressed point), query latency
    percentiles, appends/sec, and the rule evaluator's full/skipped split.

    ``shards > 0`` runs the sharded plane: targets split across hash-ring
    scraper shards, per-shard sum/count pre-reductions, and the federated
    ``Ratio`` fleet average.  The gated ``query_p95_ms`` then times the
    queries the plane actually serves steady-state — per-shard fleet scans
    (each ~targets/shards series, like-for-like with the unsharded fleet
    scan) and the adapter's federated single-series read — while the full
    cross-shard union scan is reported separately as
    ``federated_scan_p95_ms`` (it exists for completeness, not on any
    steady-state path)."""
    clock = VirtualClock()
    cluster = SimCluster(
        clock,
        nodes=[(f"tpu-node-{i}", 8) for i in range(4)],
        exporter_sample_interval=scrape_interval,
    )

    def offered(t: float) -> float:
        # slow staircase: one genuine scale event per ~quarter horizon, so
        # the HPA/feedback layers do real work without thrashing
        phase = t / max(horizon_s, 1.0)
        return 35.0 + 120.0 * min(1.0, phase * 1.5)

    dep = SimDeployment(
        cluster, "tpu-test", "tpu-test", load_fn=offered, load_mode="shared"
    )
    cluster.add_deployment(dep, replicas=1)
    clock.advance(scrape_interval)

    intervals = PipelineIntervals(
        scrape=scrape_interval,
        rule_eval=rule_interval,
        hpa_sync=15.0,
    )
    rule = fleet_federated_rule() if shards else fleet_rule()
    pipe = AutoscalingPipeline(
        cluster,
        dep,
        target_value=40.0,
        max_replicas=8,
        intervals=intervals,
        extra_rules=[rule],
        scrape_shards=shards,
    )
    if shards:
        pipe.shard_plane.add_shard_rules(fleet_shard_rules, interval=rule_interval)
    for i in range(targets):
        pipe.scraper.add_target(_synthetic_fetch(i), name=f"fleet/synt-{i:04d}")

    db = pipe.db
    pipe.start()

    query_times_ms: list[float] = []
    fed_times_ms: list[float] = []
    peak_points = db.total_points()
    peak_bytes = db.retained_bytes()
    # The drive loop's allocations are acyclic (tuples and lists, freed by
    # refcount); pausing the cyclic collector keeps a large host process
    # (millions of heap objects a gen-2 sweep) from taxing the measured
    # window.
    gc_was_enabled = gc.isenabled()
    gc.disable()
    wall_start = time.perf_counter()
    try:
        elapsed = 0.0
        while elapsed < horizon_s:
            step = min(sample_every, horizon_s - elapsed)
            clock.advance(step)
            elapsed += step
            with profile.stage("harness:observe"):
                peak_points = max(peak_points, db.total_points())
                peak_bytes = max(peak_bytes, db.retained_bytes())
                if shards:
                    # the steady-state query shapes of the sharded plane:
                    # each shard's local fleet scan (what its recording
                    # rules run over, ~targets/shards series apiece) and
                    # the adapter's federated single-series read
                    for shard_db in pipe.shard_plane.shard_dbs:
                        q0 = time.perf_counter()
                        shard_db.instant_vector(
                            "fleet_duty_cycle", {"job": "fleet"}
                        )
                        query_times_ms.append((time.perf_counter() - q0) * 1e3)
                    q0 = time.perf_counter()
                    db.latest("fleet_duty_cycle_avg", {"deployment": "fleet"})
                    query_times_ms.append((time.perf_counter() - q0) * 1e3)
                    # the full cross-shard union scan — not on any
                    # steady-state path (rules read pre-reductions),
                    # reported ungated
                    q0 = time.perf_counter()
                    vec = db.instant_vector("fleet_duty_cycle", {"job": "fleet"})
                    fed_times_ms.append((time.perf_counter() - q0) * 1e3)
                else:
                    # the two query shapes the plane serves: a matcher scan
                    # over the whole fleet (index path) and the adapter's
                    # single-series read (last-point fast path)
                    q0 = time.perf_counter()
                    vec = db.instant_vector("fleet_duty_cycle", {"job": "fleet"})
                    q1 = time.perf_counter()
                    db.latest("fleet_duty_cycle_avg", {"deployment": "fleet"})
                    q2 = time.perf_counter()
                    query_times_ms.append((q1 - q0) * 1e3)
                    query_times_ms.append((q2 - q1) * 1e3)
        wall = time.perf_counter() - wall_start
    finally:
        if gc_was_enabled:
            gc.enable()

    query_times_ms.sort()
    fed_times_ms.sort()
    total_points = db.total_points()
    bytes_per_sample = db.retained_bytes() / total_points if total_points else 0.0
    result = {
        "targets": targets,
        "horizon_s": horizon_s,
        "shards": shards,
        "wall_s": round(wall, 3),
        "speedup": round(horizon_s / wall, 1) if wall > 0 else float("inf"),
        "peak_retained_points": peak_points,
        "final_retained_points": total_points,
        "peak_retained_bytes": peak_bytes,
        "bytes_per_sample": round(bytes_per_sample, 3),
        "compression_ratio": round(
            UNCOMPRESSED_BYTES_PER_SAMPLE / bytes_per_sample, 2
        )
        if bytes_per_sample
        else 0.0,
        "total_appends": db.total_appends(),
        "appends_per_sec": round(db.total_appends() / wall, 0) if wall > 0 else 0.0,
        "series_count": db.series_count(),
        "fleet_vector_size": len(vec),
        "query_p50_ms": round(_percentile(query_times_ms, 0.50), 4),
        "query_p95_ms": round(_percentile(query_times_ms, 0.95), 4),
        "rule_full_evals": rule.full_evals,
        "rule_skipped_evals": rule.skipped_evals,
        "final_replicas": pipe.replicas(),
        "scale_events": len(pipe.scale_history),
    }
    if shards:
        status = pipe.shard_plane.shard_status()
        fleet_names = status["fleet"]
        synth = {f"fleet/synt-{i:04d}" for i in range(targets)}
        owned = set(fleet_names)
        result["federated_scan_p95_ms"] = round(_percentile(fed_times_ms, 0.95), 4)
        result["shards_disjoint"] = len(fleet_names) == len(owned)
        result["shards_cover_fleet"] = synth <= owned
    return result


# ---- query bench: planned vs naive rule evaluation ---------------------------


def _vectors_identical(a, b) -> bool:
    """Bit-identical vector equality: same length, same order, same labels,
    and per-sample float equality (NaN matching NaN)."""
    return len(a) == len(b) and all(
        x.labels == y.labels
        and (x.value == y.value or (x.value != x.value and y.value != y.value))
        for x, y in zip(a, b)
    )


def run_query_bench(
    targets: int = 1000,
    shards: int = 4,
    horizon_s: float = 1800.0,
    scrape_interval: float = 5.0,
    window_s: float | None = None,
    iters: int = 3,
    p95_iters: int = 30,
) -> dict:
    """Planned-vs-naive evaluation of the fleet-wide aggregate rule basket
    over a populated sharded TSDB — the ``query_bench`` rung's payload.

    The population mirrors the sim_scale_10k steady state: ``targets``
    fleet series spread round-robin across ``shards`` shard DBs behind a
    ``FederatedTSDB``, scraped at ``scrape_interval`` for ``horizon_s``
    virtual seconds, so each series ends with several sealed Gorilla chunks
    plus a live head.  The basket is the two fleet-aggregate shapes rules
    actually run: the instant fleet average and a windowed
    ``avg(avg_over_time(...))`` whose window covers most sealed chunks in
    full (the chunk-summary pushdown case) but starts mid-chunk (so the
    boundary-decode path stays honest).

    Both paths evaluate the SAME logical exprs at the SAME instant;
    ``identical`` asserts the result vectors are bit-identical before any
    timing is trusted.  ``query_p95_ms`` times the steady-state planned
    queries the sharded plane serves — per-shard fleet scans plus the
    federated single-series read — against
    ``perfgates.MAX_FLEET_QUERY_P95_MS``."""
    if window_s is None:
        # cover all but the first ~300 s so the window starts mid-chunk
        window_s = horizon_s - 300.0
    clock = VirtualClock()
    retention = horizon_s + 60.0
    global_db = TimeSeriesDB(clock, retention=retention)
    shard_dbs = [TimeSeriesDB(clock, retention=retention) for _ in range(shards)]
    db = FederatedTSDB(global_db, shard_dbs)

    labels = [
        tuple(sorted({"job": "fleet", "instance": f"synt-{i:05d}"}.items()))
        for i in range(targets)
    ]
    ts = 0.0
    for tick in range(int(horizon_s / scrape_interval)):
        ts += scrape_interval
        clock.advance(scrape_interval)
        for i, lbl in enumerate(labels):
            shard_dbs[i % shards].append(
                "fleet_duty_cycle", lbl, 30.0 + (i % 40) + 5.0 * (tick % _VARIANTS), ts
            )
    # the adapter's steady-state read target: the recorded fleet aggregate
    # (rule outputs land in the global member on a sharded plane)
    global_db.append(
        "fleet_duty_cycle_avg",
        tuple(sorted({"namespace": "default", "deployment": "fleet"}.items())),
        42.0,
        ts,
    )

    basket = {
        "instant": Avg(Select("fleet_duty_cycle", {"job": "fleet"})),
        "range": Avg(AvgOverTime("fleet_duty_cycle", window_s, {"job": "fleet"})),
    }
    planner = QueryPlanner(db)
    at = clock.now()

    # warmup + the identity check the speedup claim rests on
    identical = True
    for expr in basket.values():
        naive_vec = expr.evaluate(db, at)
        planned_vec = planner.plan(expr).evaluate(db, at)
        identical = identical and _vectors_identical(naive_vec, planned_vec)

    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        per_expr = {}
        naive_total = planned_total = 0.0
        for key, expr in basket.items():
            plan = planner.plan(expr)
            t0 = time.perf_counter()
            for _ in range(iters):
                expr.evaluate(db, at)
            naive_s = (time.perf_counter() - t0) / iters
            t0 = time.perf_counter()
            for _ in range(iters):
                plan.evaluate(db, at)
            planned_s = (time.perf_counter() - t0) / iters
            naive_total += naive_s
            planned_total += planned_s
            per_expr[key] = {
                "naive_ms": round(naive_s * 1e3, 3),
                "planned_ms": round(planned_s * 1e3, 3),
                "speedup": round(naive_s / planned_s, 2) if planned_s else 0.0,
            }

        # steady-state fleet queries: per-shard planned scans + the
        # adapter's federated single-series read (one plan per shard DB —
        # a plan's series cache binds to the view it evaluates against)
        shard_plans = [
            planner.plan(Select("fleet_duty_cycle", {"job": "fleet"}))
            for _ in shard_dbs
        ]
        single_plan = planner.plan(
            Select("fleet_duty_cycle_avg", {"deployment": "fleet"})
        )
        query_times_ms: list[float] = []
        for _ in range(p95_iters):
            for shard_db, plan in zip(shard_dbs, shard_plans):
                q0 = time.perf_counter()
                plan.evaluate(shard_db, at)
                query_times_ms.append((time.perf_counter() - q0) * 1e3)
            q0 = time.perf_counter()
            single_plan.evaluate(db, at)
            query_times_ms.append((time.perf_counter() - q0) * 1e3)
    finally:
        if gc_was_enabled:
            gc.enable()

    query_times_ms.sort()
    stats = planner.stats
    return {
        "targets": targets,
        "shards": shards,
        "horizon_s": horizon_s,
        "window_s": window_s,
        "retained_points": db.total_points(),
        "identical": identical,
        "exprs": per_expr,
        "naive_ms": round(naive_total * 1e3, 3),
        "planned_ms": round(planned_total * 1e3, 3),
        "speedup": round(naive_total / planned_total, 2) if planned_total else 0.0,
        "query_p50_ms": round(_percentile(query_times_ms, 0.50), 4),
        "query_p95_ms": round(_percentile(query_times_ms, 0.95), 4),
        "planner_fastpath": stats.fastpath,
        "planner_fallback": stats.fallback,
        "series_cache_hits": stats.series_cache_hits,
        "series_resolves": stats.series_resolves,
        "plans_built": stats.plans_built,
        "decode_cache_hits": db.decode_cache_hits,
        "decode_cache_misses": db.decode_cache_misses,
    }


# ---- downsample_bench: rollup tiers against raw decode -----------------------


def _rollup_differential(
    rng, series: int = 12, horizon_s: float = 86400.0, windows: int = 50
) -> dict:
    """The randomized bit-exactness check the rollup tiers rest on: a small
    raw-retaining DB is populated for a virtual day, compacted, and then
    ``windows`` random tier-aligned reads are evaluated BOTH ways — the
    rollup fold and the raw bucketed twin (``range_avg_bucketed``, which
    regenerates identical bucket rows from the raw chunks and folds them in
    the same segment shape).  Every per-bucket (count, sum, min, max, last)
    row and every folded average must match bit-for-bit; any drift means
    the compactor and the fold no longer share one accumulation order."""
    policy = DownsamplePolicy()
    clock = VirtualClock()
    db = TimeSeriesDB(
        clock, retention=horizon_s + 7200.0, downsample=policy
    )
    labels = [
        tuple(sorted({"job": "diff", "instance": f"d-{i:03d}"}.items()))
        for i in range(series)
    ]
    interval = 45.0
    ts = 0.0
    for _tick in range(int(horizon_s / interval)):
        ts += interval
        clock.advance(interval)
        for i, lbl in enumerate(labels):
            # occasional gaps and NaN staleness markers keep the bucket
            # boundary logic honest, not just the happy path
            if rng.random() < 0.02:
                continue
            v = float("nan") if rng.random() < 0.01 else rng.uniform(0.0, 100.0)
            db.append("diff_gauge", lbl, v, ts)

    row_mismatches = fold_mismatches = checked = 0
    for _ in range(windows):
        step = rng.choice(policy.steps)
        upper = int(ts // step)
        # stay a couple of hours behind "now": bucket ends past the
        # compactor's aging point legitimately return None (raw fallback),
        # which would leave the differential checking nothing
        hi_max = upper - int(7200.0 // step) - 1
        if hi_max < 2:
            continue
        hi = rng.randrange(max(1, hi_max // 2), hi_max + 1)
        n = rng.randrange(1, max(2, hi))
        at = hi * step
        window_s = n * step
        roll_vec = db.rollup_range_avg(
            "diff_gauge", {"job": "diff"}, window_s=window_s, at=at, step=step
        )
        if roll_vec is None:
            continue  # window reaches past the compacted span: legal fallback
        checked += 1
        twin_vec = db.range_avg_bucketed(
            "diff_gauge", {"job": "diff"}, window_s=window_s, at=at, step=step
        )
        if not _vectors_identical(roll_vec, twin_vec):
            fold_mismatches += 1
    # per-bucket row identity across the whole compacted span, both tiers
    for step in policy.steps:
        stored = dict(db.rollup_rows("diff_gauge", step=step))
        for lbl_set, rows in stored.items():
            series_obj = db._data["diff_gauge"][lbl_set]
            raw_by_end = {
                r[0]: r
                for r in zip(
                    *raw_bucket_rows(series_obj, step, db._chunk_arrays)
                )
            }
            for row in rows:
                raw = raw_by_end.get(row[0])
                if raw is None or any(
                    a != b and not (a != a and b != b)
                    for a, b in zip(row, raw)
                ):
                    row_mismatches += 1
    return {
        "windows_checked": checked,
        "fold_mismatches": fold_mismatches,
        "row_mismatches": row_mismatches,
        "identical": checked > 0
        and fold_mismatches == 0
        and row_mismatches == 0,
    }


def run_downsample_bench(
    targets: int = 10000,
    shards: int = 8,
    horizon_s: float = 86400.0,
    scrape_interval: float = 30.0,
    window_s: float = 72000.0,
    at_s: float = 79200.0,
    iters: int = 3,
    seed: int = 1186,
) -> dict:
    """Rollup tiers vs raw decode over a day of fleet history: the
    ``downsample_bench`` rung's payload.

    ``targets`` fleet series spread across ``shards`` downsampling shard
    DBs behind a ``FederatedTSDB`` are scraped every ``scrape_interval``
    for ``horizon_s`` virtual seconds; the compactor ages sealed chunks
    past its horizon into 5m/1h rollups as the run goes.  Three claims are
    then measured:

    - **speedup**: the tier-aligned fleet query (``window_s`` ending at
      ``at_s``, both multiples of 1h) served from the 1h rollups vs the
      same window evaluated naively from raw chunk decodes (cold, one
      iteration — the flight-recorder-vs-full-rescan comparison).  Gated
      by ``perfgates.MIN_ROLLUP_SPEEDUP``.
    - **storage**: rollup bytes for the aged span vs the uncompressed
      16-byte cost of the raw samples they summarize, gated by
      ``perfgates.MAX_ROLLUP_BYTES_RATIO``.
    - **exactness**: the big-fleet rollup read must be bit-identical to
      the raw bucketed twin, and ``_rollup_differential`` fuzzes random
      aligned windows (plus every stored bucket row) on a raw-retaining
      DB.  A planner pass over the same window proves tier selection
      engages (``rollup_reads``)."""
    policy = DownsamplePolicy()
    clock = VirtualClock()
    retention = horizon_s + 60.0  # raw stays resident: the naive rescan needs it
    global_db = TimeSeriesDB(clock, retention=retention, downsample=policy)
    shard_dbs = [
        TimeSeriesDB(clock, retention=retention, downsample=policy)
        for _ in range(shards)
    ]
    db = FederatedTSDB(global_db, shard_dbs)

    labels = [
        tuple(sorted({"job": "fleet", "instance": f"synt-{i:05d}"}.items()))
        for i in range(targets)
    ]
    t0 = time.perf_counter()
    ts = 0.0
    day = 86400.0
    for tick in range(int(horizon_s / scrape_interval)):
        ts += scrape_interval
        clock.advance(scrape_interval)
        # diurnal base + per-series offset + short-period wobble: rollup
        # buckets carry real spread, not a constant the encoder flattens.
        # Quantized to 0.25 like the exporter's fixed-precision gauges —
        # full-mantissa noise would be a synthetic worst case no chip
        # utilization series exhibits, and the Gorilla columns' density
        # (the bytes gate) is a claim about realistic inputs
        base = 40.0 + 25.0 * (1.0 - abs((ts % day) / day - 0.5) * 2.0)
        base = round(base * 4.0) / 4.0
        for i, lbl in enumerate(labels):
            shard_dbs[i % shards].append(
                "fleet_duty_cycle",
                lbl,
                base + (i % 40) + 5.0 * (tick % _VARIANTS),
                ts,
            )
    populate_s = time.perf_counter() - t0
    appended = int(horizon_s / scrape_interval) * targets

    at = at_s
    matchers = {"job": "fleet"}
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        # the rollup read (warm once to build summaries, then timed)
        roll_vec = db.rollup_range_avg(
            "fleet_duty_cycle", matchers, window_s=window_s, at=at, step=3600.0
        )
        q0 = time.perf_counter()
        for _ in range(iters):
            db.rollup_range_avg(
                "fleet_duty_cycle",
                matchers,
                window_s=window_s,
                at=at,
                step=3600.0,
            )
        rollup_s = (time.perf_counter() - q0) / iters
        # the naive raw rescan: cold decode, one iteration
        q0 = time.perf_counter()
        naive_vec = db.range_avg(
            "fleet_duty_cycle", matchers, window_s=window_s, at=at
        )
        raw_s = time.perf_counter() - q0
        # exactness on the big fleet: rollup vs the raw bucketed twin
        twin_vec = db.range_avg_bucketed(
            "fleet_duty_cycle", matchers, window_s=window_s, at=at, step=3600.0
        )
    finally:
        if gc_was_enabled:
            gc.enable()

    identical = roll_vec is not None and _vectors_identical(roll_vec, twin_vec)

    # planner proof: the same logical expr planned over the federated view
    # must route through the rollup tier, not the raw decode path
    planner = QueryPlanner(db)
    plan = planner.plan(
        Avg(AvgOverTime("fleet_duty_cycle", window_s, matchers))
    )
    plan.evaluate(db, at)
    rollup_reads = dict(planner.stats.rollup_reads)

    storage = db.rollup_storage_stats()
    aged_points = storage["ingested_points"]
    rollup_bytes = storage["rollup_bytes"]
    aged_raw_bytes = aged_points * UNCOMPRESSED_BYTES_PER_SAMPLE
    differential = _rollup_differential(random.Random(seed))

    return {
        "targets": targets,
        "shards": shards,
        "horizon_s": horizon_s,
        "scrape_interval": scrape_interval,
        "window_s": window_s,
        "at_s": at_s,
        "appended_points": appended,
        "populate_s": round(populate_s, 3),
        "appends_per_sec": round(appended / populate_s, 1) if populate_s else 0.0,
        "retained_points": db.total_points(),
        "fleet_series": len(naive_vec),
        "rollup_ms": round(rollup_s * 1e3, 3),
        "raw_ms": round(raw_s * 1e3, 3),
        "speedup": round(raw_s / rollup_s, 2) if rollup_s else 0.0,
        "identical": identical,
        "rollup_reads": rollup_reads,
        "tier_selected": sum(rollup_reads.values()) > 0,
        "aged_points": aged_points,
        "rollup_bytes": rollup_bytes,
        "bytes_ratio": round(rollup_bytes / aged_raw_bytes, 4)
        if aged_raw_bytes
        else 1.0,
        "tiers": {
            label: dict(t) for label, t in storage.get("tiers", {}).items()
        },
        "differential": differential,
    }


# ---- the recovery drill -----------------------------------------------------


#: the restart fault of each component the drill can crash
DRILL_COMPONENTS = {
    "tsdb": "tsdb_restart",
    "hpa": "hpa_restart",
    "adapter": "adapter_restart",
    "wal": "wal_truncate",
}


def run_recovery_drill(
    components: tuple[str, ...] = ("tsdb", "hpa", "adapter", "wal"),
    pod_start_latency: float = 12.0,
    settle_s: float = 120.0,
    between_s: float = 180.0,
    surge_s: float = 90.0,
    stable_for: float = 10.0,
) -> dict:
    """Crash each requested component mid-run and measure its recovery.

    A durable pipeline (a WAL in a temporary directory, the HPA's
    checkpoint in a file there, traced) holds 3 replicas under a steady
    shared load; each component is crashed and rebuilt in turn, an impulse
    restart fault on a ``ChaosSchedule`` every ``between_s``; then the load
    surges, so a scale event after every restart shows that the trace
    still explains it.  ``ok``: every fault recovers, no scale event falls
    inside a fault's injected → recovered window (a restart must never
    flap), and every scale event's lineage reaches the exporter sweeps.
    """
    unknown = [c for c in components if c not in DRILL_COMPONENTS]
    if unknown:
        raise ValueError(
            f"unknown drill component(s) {unknown}; have: {', '.join(sorted(DRILL_COMPONENTS))}"
        )

    with tempfile.TemporaryDirectory(prefix="recovery-drill-") as tmp:
        clock = VirtualClock()
        cluster = SimCluster(
            clock, nodes=[(f"drill-node-{i}", 2) for i in range(3)],
            pod_start_latency=pod_start_latency,
        )
        state = {"load": 90.0}
        dep = SimDeployment(cluster, "tpu-test", "tpu-test", load_fn=lambda t: state["load"],
                            load_mode="shared")
        cluster.add_deployment(dep, replicas=1)
        clock.advance(15.0)

        tracer = Tracer(clock)
        wal = WriteAheadLog(Path(tmp) / "wal", segment_max_records=512)
        store = FileCheckpointStore(Path(tmp) / "hpa-checkpoint.json")
        behavior = HPABehavior(
            scale_down=ScalingRules(
                stabilization_window_seconds=60.0,
                policies=[ScalingPolicy("Percent", 100, 15.0)],
            )
        )
        pipe = AutoscalingPipeline(
            cluster, dep, target_value=40.0, max_replicas=4, behavior=behavior,
            tracer=tracer, wal=wal, checkpoint_store=store,
        )
        pipe.run_for(settle_s)
        settled = pipe.replicas()

        faults = [
            FaultSpec(kind=DRILL_COMPONENTS[c], at=30.0 + i * between_s)
            for i, c in enumerate(components)
        ]
        schedule = ChaosSchedule(pipe, faults, stable_for=stable_for)
        schedule.arm()
        clock.advance(30.0 + len(faults) * between_s)

        # the surge: a real scale event after every component was rebuilt
        state["load"] = 140.0
        clock.advance(surge_s)

        reports = [r.as_dict() for r in schedule.reports]
        windows = [
            (r.injected_at, r.recovered_at)
            for r in schedule.reports
            if r.injected_at is not None and r.recovered_at is not None
        ]
        spurious = sum(
            1 for ts, _a, _b in pipe.scale_history
            if any(start <= ts <= end for start, end in windows)
        )
        mttrs = [r.mttr for r in schedule.reports if r.mttr is not None]
        gaps = [r.replay_gap for r in schedule.reports if r.replay_gap is not None]
        syncs = [
            r.time_to_first_good_sync
            for r in schedule.reports
            if r.time_to_first_good_sync is not None
        ]
        by_id = index_spans(tracer.spans)
        lineages = [lineage_of(s, by_id) for s in tracer.spans_of("scale_event")]
        lineage_complete = bool(lineages) and all(w["complete"] for w in lineages)
        all_recovered = schedule.all_recovered()
        mttr_max = round(max(mttrs), 1) if mttrs else None
        return {
            "scenario": "recovery_drill",
            "mode": "virtual",
            "metric": "recovery_drill_mttr_max",
            "value": mttr_max,
            "unit": "s",
            "components": list(components),
            "settled_replicas": settled,
            "faults": reports,
            "all_recovered": all_recovered,
            "spurious_scale_events_during_replay": spurious,
            "mttr_max_s": mttr_max,
            "replay_gap_max_s": round(max(gaps), 1) if gaps else 0.0,
            "first_good_sync_max_s": round(max(syncs), 1) if syncs else None,
            "restarts": [dict(entry) for entry in pipe.restart_log],
            "final_replicas": pipe.replicas(),
            "final_running": pipe.running(),
            "scale_events": len(pipe.scale_history),
            "scale_event_lineages": len(lineages),
            "lineage_complete": lineage_complete,
            "trace_spans": len(tracer.spans),
            "ok": all_recovered and spurious == 0 and lineage_complete,
        }


def render_drill_report(result: dict) -> str:
    """The drill's summary, as the ``drill`` scenario prints it."""

    def fmt(x):
        return "-" if x is None else f"{x:g}"

    lines = [
        f"recovery drill: components={','.join(result['components'])} "
        f"settled={result['settled_replicas']} replicas",
        f"{'fault':<28} {'mttr':>6} {'replay_gap':>10} {'first_sync':>10} {'recovered':>9}",
    ]
    for f in result["faults"]:
        lines.append(
            f"{f['fault']:<28} {fmt(f['mttr']):>6} {fmt(f['replay_gap']):>10} "
            f"{fmt(f['time_to_first_good_sync']):>10} {str(f['recovered']):>9}"
        )
    lines.append(
        f"spurious scale events during replay: {result['spurious_scale_events_during_replay']}  "
        f"scale-event lineages complete: {result['lineage_complete']} "
        f"({result['scale_event_lineages']})  "
        f"final replicas: {result['final_replicas']}"
    )
    lines.append(f"verdict: {'PASS' if result['ok'] else 'FAIL'}")
    return "\n".join(lines)
