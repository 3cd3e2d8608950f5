"""Signal-propagation latency: workload change → first sync that saw it →
scale event.

Counterpart of ``k8s_gpu_hpa_tpu/obs/latency.py``.  The latency budget of
the loop (an intensity change reaches a scale event within 60 s) decomposes
on the trace: a ``workload_change`` span pins when the offered load moved,
and the following ``hpa_sync`` and ``scale_event`` spans pin when the
control plane noticed and when it acted.  ``propagation_report`` pairs them
and summarizes p50/p95; ``trial.run_signal_latency_trial`` reads it.

All timestamps are clock seconds; on a ``VirtualClock`` the report is
deterministic bit for bit.
"""

from __future__ import annotations

from typing import Callable

from k8s_gpu_hpa_tpu_torch.obs.trace import Span, Tracer


def percentile(values: list[float], q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 100]); None on an empty input.

    The extremes are pinned: q <= 0 returns the minimum, q >= 100 the
    maximum, and a single sample is returned at every q."""
    if not values:
        return None
    ordered = sorted(values)
    if q <= 0 or len(ordered) == 1:
        return ordered[0]
    if q >= 100:
        return ordered[-1]
    rank = max(1, round(q / 100.0 * len(ordered)))
    return ordered[min(rank, len(ordered)) - 1]


class TracedLoad:
    """A load function whose intensity steps emit ``workload_change`` spans.

    The span lands at the clock time the new intensity is first offered to
    the cluster (the exporter's next collection evaluates the load
    function): before that there is nothing for the pipeline to notice.
    ``min_delta`` suppresses smaller moves; the first call only records the
    baseline, since a run starting at intensity 20 is not a change."""

    def __init__(
        self,
        fn: Callable[[float], float],
        tracer: Tracer,
        min_delta: float = 5.0,
    ):
        self.fn = fn
        self.tracer = tracer
        self.min_delta = min_delta
        self._last: float | None = None

    def __call__(self, t: float) -> float:
        value = self.fn(t)
        if self._last is None:
            self._last = value
        elif abs(value - self._last) >= self.min_delta:
            self.tracer.emit(
                "workload_change",
                {"intensity": value, "previous": self._last},
            )
            self._last = value
        return value


def histogram_quantiles(
    hist,
    qs: tuple[float, ...] = (0.50, 0.95, 0.99),
    labels: tuple[tuple[str, str], ...] = (),
) -> dict[str, float | None]:
    """Quantile estimates off an in-process ``metrics.schema.Histogram``'s
    cumulative buckets, by Prometheus's bucket interpolation
    (``rules.bucket_quantile``).  Keys are ``p50``-style; a value is None
    while the histogram (or the label set asked for) is empty."""
    # imported here: the metrics modules import this package for their
    # coverage probes and stage brackets, so its eager imports stay free
    # of them
    from k8s_gpu_hpa_tpu_torch.metrics.rules import bucket_quantile

    buckets = hist.cumulative_buckets(labels)
    return {f"p{round(q * 100):g}": bucket_quantile(buckets, q) for q in qs}


def propagation_report(spans: list[Span], selfmetrics=None) -> dict:
    """Pair each workload change with the first following HPA sync and the
    first following scale event, both cut off at the next change (a scale
    caused by a later step is not credited to an earlier one).

    Returns the records of each change and the p50/p95 of the two
    latencies: ``sync`` (change → first sync, the noticing delay, bounded
    by the scrape, rule and sync intervals) and ``scale`` (change → scale
    event, the acting delay; a change that caused no scale is left out).

    With ``selfmetrics`` (a PipelineSelfMetrics) the report also carries
    ``hist_scale_latency_p50/p95/p99``, the same distribution read off the
    ``signal_propagation_seconds`` histogram the SLO reads."""
    hist_quantiles: dict[str, float | None] = {}
    if selfmetrics is not None:
        hist_quantiles = {
            f"hist_scale_latency_{k}": v
            for k, v in histogram_quantiles(selfmetrics.hist_propagation).items()
        }

    def of_kind(kind: str) -> list[Span]:
        return sorted((s for s in spans if s.kind == kind), key=lambda s: (s.start, s.span_id))

    changes = of_kind("workload_change")
    syncs = of_kind("hpa_sync")
    scales = of_kind("scale_event")
    records = []
    for i, change in enumerate(changes):
        cutoff = changes[i + 1].start if i + 1 < len(changes) else float("inf")
        first_sync = next((s for s in syncs if change.start < s.start <= cutoff), None)
        first_scale = next((s for s in scales if change.start < s.start <= cutoff), None)
        records.append(
            {
                "change_ts": change.start,
                "intensity": change.attrs.get("intensity"),
                "first_sync_ts": None if first_sync is None else first_sync.start,
                "scale_ts": None if first_scale is None else first_scale.start,
                "sync_latency": (
                    None if first_sync is None else first_sync.start - change.start
                ),
                "scale_latency": (
                    None if first_scale is None else first_scale.start - change.start
                ),
            }
        )
    sync_lat = [r["sync_latency"] for r in records if r["sync_latency"] is not None]
    scale_lat = [r["scale_latency"] for r in records if r["scale_latency"] is not None]
    return {
        "changes": records,
        "sync_latency_p50": percentile(sync_lat, 50),
        "sync_latency_p95": percentile(sync_lat, 95),
        "scale_latency_p50": percentile(scale_lat, 50),
        "scale_latency_p95": percentile(scale_lat, 95),
        "changes_total": len(records),
        "changes_scaled": len(scale_lat),
        **hist_quantiles,
    }
