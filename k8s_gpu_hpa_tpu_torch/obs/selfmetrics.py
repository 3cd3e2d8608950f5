"""Pipeline self-metrics: the control loop monitoring itself.

Counterpart of ``k8s_gpu_hpa_tpu/obs/selfmetrics.py``.  kube-controller-manager
and controller-runtime export metrics of their own reconcile loops;
:class:`PipelineSelfMetrics` is that layer for this pipeline: every stage
reports into it, and ``exposition()`` renders four families (the last sync's
duration, each target's last scrape duration, each rule's input staleness,
the sync decisions by outcome), the query engine's six counters once
``attach_query_engine`` wires them, and five latency histograms in the
Prometheus text format, served as one more scrape target
(``pipeline-self``), so the self-metrics land in the same TSDB and the same
doctor probe (``doctor.check_self_metrics``).
"""

from __future__ import annotations

import math
from collections import Counter

from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text
from k8s_gpu_hpa_tpu_torch.metrics.schema import (
    Exemplar,
    Histogram,
    MetricFamily,
)

#: wall-clock duration of the last HPA sync pass (gauge)
HPA_SYNC_DURATION = "hpa_sync_duration_seconds"
#: duration of the last scrape of each target (gauge; wall-clock)
SCRAPE_DURATION = "scrape_duration_seconds"
#: age of the newest input point each recording rule read at its last
#: evaluation (gauge): how stale the data behind the autoscale signal is
RULE_EVAL_STALENESS = "rule_eval_staleness_seconds"
#: HPA sync decisions by outcome (counter)
HPA_DECISION_TOTAL = "hpa_decision_total"

# The query engine's counters: how rule evaluation is served.  The planner's
# fastpath/fallback count chunks of planned range reads served from the
# seal-time summary vs decoded; its series counters split each evaluation's
# series-set check into revalidated from the cache vs re-resolved through
# the inverted index; the decode-cache pair counts sealed-chunk column reads
# served from the TSDB's decoded-window cache vs decoded afresh.

#: chunks served from seal-time summaries on planned range reads (counter)
PLANNER_FASTPATH_TOTAL = "query_planner_fastpath_chunks_total"
#: chunks a planned range read had to decode (counter)
PLANNER_FALLBACK_TOTAL = "query_planner_fallback_chunks_total"
#: series sets revalidated from the plan cache (counter)
PLANNER_SERIES_CACHE_HITS = "query_planner_series_cache_hits_total"
#: series sets re-resolved through the inverted index (counter)
PLANNER_SERIES_RESOLVES = "query_planner_series_resolves_total"
#: sealed-chunk column reads served from the decoded-window cache (counter)
DECODE_CACHE_HITS = "tsdb_decode_cache_hits_total"
#: sealed-chunk column reads that decoded Gorilla blobs (counter)
DECODE_CACHE_MISSES = "tsdb_decode_cache_misses_total"

SELF_METRIC_NAMES = (
    HPA_SYNC_DURATION,
    SCRAPE_DURATION,
    RULE_EVAL_STALENESS,
    HPA_DECISION_TOTAL,
    PLANNER_FASTPATH_TOTAL,
    PLANNER_FALLBACK_TOTAL,
    PLANNER_SERIES_CACHE_HITS,
    PLANNER_SERIES_RESOLVES,
    DECODE_CACHE_HITS,
    DECODE_CACHE_MISSES,
)

# ---- distributions (histograms with trace exemplars) -----------------------

#: HPA sync pass duration distribution
HPA_SYNC_LATENCY = "hpa_sync_latency_seconds"
#: scrape duration distribution (all targets pooled; the per-target gauge
#: keeps the breakdown)
SCRAPE_LATENCY = "scrape_latency_seconds"
#: full recording-rule evaluation duration distribution
RULE_EVAL_LATENCY = "rule_eval_latency_seconds"
#: custom-metrics adapter query duration distribution
ADAPTER_QUERY_LATENCY = "adapter_query_latency_seconds"
#: signal propagation, workload change -> scale event, in clock seconds
#: (the loop's latency budget is 60 s)
SIGNAL_PROPAGATION = "signal_propagation_seconds"

SELF_HISTOGRAM_NAMES = (
    HPA_SYNC_LATENCY,
    SCRAPE_LATENCY,
    RULE_EVAL_LATENCY,
    ADAPTER_QUERY_LATENCY,
    SIGNAL_PROPAGATION,
)

#: every TSDB series the self-histograms expand to
SELF_HISTOGRAM_SERIES = tuple(
    name + suffix
    for name in SELF_HISTOGRAM_NAMES
    for suffix in ("_bucket", "_sum", "_count")
)

#: propagation buckets in clock seconds; 30 is a bound on purpose: the
#: signal-propagation SLO (obs/slo.py) counts its good events off the
#: le="30" bucket series, so the budget must be a bucket boundary
SIGNAL_PROPAGATION_BUCKETS = (5.0, 10.0, 15.0, 20.0, 30.0, 45.0, 60.0, 90.0, 120.0)

#: the scrape-target name the pipeline serves its own metrics under
SELF_TARGET_NAME = "pipeline-self"

#: every value the ``reason`` label of HPA_DECISION_TOTAL can take
DECISION_REASONS = (
    "scale_up",
    "scale_down",
    "within_tolerance",
    "metrics_unavailable",
    "repair_partial_slice",
)


def decision_reason_label(last_reason: str) -> str:
    """An ``HPAStatus.last_reason`` collapsed to its counter label, by the
    fixed prefixes the sync writes (control/hpa.py)."""
    if last_reason.startswith("scale up"):
        return "scale_up"
    if last_reason.startswith("scale down"):
        return "scale_down"
    if last_reason.startswith("repair partial slice"):
        return "repair_partial_slice"
    if last_reason.startswith("metrics unavailable"):
        return "metrics_unavailable"
    return "within_tolerance"


class PipelineSelfMetrics:
    """Accumulates the stages' reports and renders them as exposition text.

    ``clock`` (optional) timestamps exemplars; the ``span_id`` a hook
    receives becomes the exemplar of the bucket the observation lands in,
    so a tail bucket links to a concrete span of the trace."""

    def __init__(self, clock=None):
        self.clock = clock
        self.sync_durations: list[float] = []  # every sync, for percentiles
        self._scrape_duration: dict[str, float] = {}
        self._rule_staleness: dict[str, float] = {}
        self.decisions: Counter = Counter()
        self.hist_sync = Histogram(HPA_SYNC_LATENCY, "HPA sync pass duration distribution")
        self.hist_scrape = Histogram(
            SCRAPE_LATENCY, "scrape duration distribution (all targets)"
        )
        self.hist_rule_eval = Histogram(
            RULE_EVAL_LATENCY, "full recording-rule evaluation duration"
        )
        self.hist_adapter = Histogram(
            ADAPTER_QUERY_LATENCY, "custom-metrics adapter query duration"
        )
        self.hist_propagation = Histogram(
            SIGNAL_PROPAGATION,
            "workload change to scale event, virtual seconds",
            bounds=SIGNAL_PROPAGATION_BUCKETS,
        )
        #: the query engine's counter sources (``attach_query_engine``), read
        #: at exposition time: the counts live on the planner and the TSDB
        self._planner_stats = None
        self._query_db = None

    def attach_query_engine(self, planner_stats, db) -> None:
        """Wire the query engine's counters: a ``PlannerStats`` and the DB
        whose decode cache counts.  The pipeline calls it when it builds its
        planner, and again after ``restart_tsdb`` swaps the DB."""
        self._planner_stats = planner_stats
        self._query_db = db

    def histograms(self) -> tuple[Histogram, ...]:
        return (
            self.hist_sync,
            self.hist_scrape,
            self.hist_rule_eval,
            self.hist_adapter,
            self.hist_propagation,
        )

    def _exemplar(self, value: float, span_id: int | None) -> Exemplar | None:
        if span_id is None:
            return None
        ts = None if self.clock is None else self.clock.now()
        return Exemplar(value, trace_id=span_id, span_id=span_id, ts=ts)

    # ---- the stages' hooks -------------------------------------------------

    def observe_sync(
        self, duration: float, last_reason: str, span_id: int | None = None
    ) -> None:
        self.sync_durations.append(duration)
        self.decisions[decision_reason_label(last_reason)] += 1
        self.hist_sync.observe(duration, self._exemplar(duration, span_id))

    def observe_scrape(
        self, target: str, duration: float, span_id: int | None = None
    ) -> None:
        self._scrape_duration[target] = duration
        self.hist_scrape.observe(duration, self._exemplar(duration, span_id))

    def observe_rule_eval(
        self,
        rule: str,
        staleness: float,
        duration: float | None = None,
        span_id: int | None = None,
    ) -> None:
        """``staleness`` comes with every evaluation, full or skipped;
        ``duration`` with full ones only (a skip costs a few integer
        compares, and observing it would drown the histogram in zeros)."""
        self._rule_staleness[rule] = staleness
        if duration is not None:
            self.hist_rule_eval.observe(duration, self._exemplar(duration, span_id))

    def observe_adapter_query(self, duration: float, span_id: int | None = None) -> None:
        self.hist_adapter.observe(duration, self._exemplar(duration, span_id))

    def observe_propagation(self, latency: float, span_id: int | None = None) -> None:
        self.hist_propagation.observe(latency, self._exemplar(latency, span_id))

    # ---- exposition --------------------------------------------------------

    def exposition(self) -> str:
        """The ``pipeline-self`` target's /metrics body."""
        sync = MetricFamily(
            HPA_SYNC_DURATION, "gauge", "wall-clock duration of the last HPA sync"
        )
        if self.sync_durations:
            sync.add(self.sync_durations[-1])
        scrape = MetricFamily(
            SCRAPE_DURATION, "gauge", "duration of the last scrape per target"
        )
        for target, duration in sorted(self._scrape_duration.items()):
            scrape.add(duration, target=target)
        staleness = MetricFamily(
            RULE_EVAL_STALENESS,
            "gauge",
            "age of the newest input point at each rule's last evaluation",
        )
        for rule, age in sorted(self._rule_staleness.items()):
            if not math.isnan(age):
                staleness.add(age, rule=rule)
        decisions = MetricFamily(
            HPA_DECISION_TOTAL, "counter", "HPA sync decisions by outcome"
        )
        for reason, count in sorted(self.decisions.items()):
            decisions.add(float(count), reason=reason)
        families = [sync, scrape, staleness, decisions]
        # literal tables, so the static producer table (analysis/symbols.py)
        # sees every family name
        if self._planner_stats is not None:
            s = self._planner_stats
            for name, help_text, value in (
                (PLANNER_FASTPATH_TOTAL,
                 "chunks served from seal-time summaries without decode", s.fastpath),
                (PLANNER_FALLBACK_TOTAL, "chunks a planned range read decoded", s.fallback),
                (PLANNER_SERIES_CACHE_HITS,
                 "series sets revalidated from the plan cache", s.series_cache_hits),
                (PLANNER_SERIES_RESOLVES,
                 "series sets re-resolved through the inverted index", s.series_resolves),
            ):
                fam = MetricFamily(name, "counter", help_text)
                fam.add(float(value))
                families.append(fam)
        if self._query_db is not None:
            db = self._query_db
            for name, help_text, value in (
                (DECODE_CACHE_HITS,
                 "sealed-chunk reads served from the decoded-window cache",
                 db.decode_cache_hits),
                (DECODE_CACHE_MISSES,
                 "sealed-chunk reads that decoded Gorilla blobs", db.decode_cache_misses),
            ):
                fam = MetricFamily(name, "counter", help_text)
                fam.add(float(value))
                families.append(fam)
        families.extend(h.family() for h in self.histograms())
        return encode_text(families)
