"""Decision tracing, metric lineage and the pipeline's self-instrumentation.

Counterpart of ``k8s_gpu_hpa_tpu/obs/``, its tracing plane: spans from every
pipeline stage (trace.py, validated against schema.py), lineage walks from
scale events back to raw device sweeps (lineage.py), signal-propagation
latency (latency.py), the pipeline's own Prometheus self-metrics, gauges and
latency histograms with trace exemplars (selfmetrics.py), and declared SLOs
with multi-window burn-rate alerts (slo.py).  ``control/loop.py`` wires them
in when a ``Tracer`` is passed to ``AutoscalingPipeline``; ``python -m
k8s_gpu_hpa_tpu_torch simulate --scenario trace`` and
``trial.run_signal_latency_trial`` surface them.

The JAX package's coverage probes, stage profiles, alert routing and
incident timelines are not ported.  The port's metrics modules import
nothing of this package, so every name here is imported eagerly.
"""

from k8s_gpu_hpa_tpu_torch.obs.latency import (
    TracedLoad,
    histogram_quantiles,
    percentile,
    propagation_report,
)
from k8s_gpu_hpa_tpu_torch.obs.lineage import format_lineage, index_spans, lineage_of
from k8s_gpu_hpa_tpu_torch.obs.schema import (
    LINEAGE_ORDER,
    SPAN_SCHEMA,
    validate_span_fields,
)
from k8s_gpu_hpa_tpu_torch.obs.selfmetrics import (
    ADAPTER_QUERY_LATENCY,
    DECISION_REASONS,
    HPA_DECISION_TOTAL,
    HPA_SYNC_DURATION,
    HPA_SYNC_LATENCY,
    RULE_EVAL_LATENCY,
    RULE_EVAL_STALENESS,
    SCRAPE_DURATION,
    SCRAPE_LATENCY,
    SELF_HISTOGRAM_NAMES,
    SELF_HISTOGRAM_SERIES,
    SELF_METRIC_NAMES,
    SELF_TARGET_NAME,
    SIGNAL_PROPAGATION,
    SIGNAL_PROPAGATION_BUCKETS,
    PipelineSelfMetrics,
    decision_reason_label,
)
from k8s_gpu_hpa_tpu_torch.obs.slo import (
    PROPAGATION_BUDGET_SECONDS,
    SLO_EVENTS_TOTAL,
    SLO_GOOD_TOTAL,
    SLODefinition,
    SLORecorder,
    burn_rate_alerts,
    shipped_slo_alerts,
    shipped_slo_recorders,
    shipped_slos,
)
from k8s_gpu_hpa_tpu_torch.obs.trace import Span, Tracer, read_jsonl

__all__ = [
    "ADAPTER_QUERY_LATENCY",
    "DECISION_REASONS",
    "HPA_DECISION_TOTAL",
    "HPA_SYNC_DURATION",
    "HPA_SYNC_LATENCY",
    "LINEAGE_ORDER",
    "PROPAGATION_BUDGET_SECONDS",
    "PipelineSelfMetrics",
    "RULE_EVAL_LATENCY",
    "RULE_EVAL_STALENESS",
    "SCRAPE_DURATION",
    "SCRAPE_LATENCY",
    "SELF_HISTOGRAM_NAMES",
    "SELF_HISTOGRAM_SERIES",
    "SELF_METRIC_NAMES",
    "SELF_TARGET_NAME",
    "SIGNAL_PROPAGATION",
    "SIGNAL_PROPAGATION_BUCKETS",
    "SLO_EVENTS_TOTAL",
    "SLO_GOOD_TOTAL",
    "SLODefinition",
    "SLORecorder",
    "SPAN_SCHEMA",
    "Span",
    "TracedLoad",
    "Tracer",
    "burn_rate_alerts",
    "decision_reason_label",
    "format_lineage",
    "histogram_quantiles",
    "index_spans",
    "lineage_of",
    "percentile",
    "propagation_report",
    "read_jsonl",
    "shipped_slo_alerts",
    "shipped_slo_recorders",
    "shipped_slos",
    "validate_span_fields",
]
