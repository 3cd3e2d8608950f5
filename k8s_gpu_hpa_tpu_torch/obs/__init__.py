"""Decision tracing, metric lineage, the pipeline's self-instrumentation,
decision-path coverage and per-stage cost attribution.

Counterpart of ``k8s_gpu_hpa_tpu/obs/``: spans from every pipeline stage
(trace.py, validated against schema.py), lineage walks from scale events
back to raw device sweeps (lineage.py), signal-propagation latency
(latency.py), the pipeline's own Prometheus self-metrics, gauges and latency
histograms with trace exemplars (selfmetrics.py), declared SLOs with
multi-window burn-rate alerts (slo.py), decision-path coverage probes
(coverage.py) and per-stage wall-clock cost attribution (profile.py).
``control/loop.py`` wires them in when a ``Tracer`` is passed to
``AutoscalingPipeline``; ``python -m k8s_gpu_hpa_tpu_torch simulate
--scenario trace|slo|coverage|profile|incident`` and the rungs of ``trial.py``
surface them.  Alert routing (alerting.py) and incident correlation
(incident.py) are imported by name, as the JAX package's are.

Import structure: ``selfmetrics`` and ``slo`` import from
``k8s_gpu_hpa_tpu_torch.metrics``, while the metrics modules import
``obs.coverage`` and ``obs.profile`` for their probes and stage brackets.
To keep that acyclic, this package eagerly imports only the metrics-free
submodules (coverage, profile, trace, schema, latency, lineage) and
resolves the selfmetrics and slo names on first attribute access (PEP 562),
by which time the metrics package is initialized.
"""

from k8s_gpu_hpa_tpu_torch.utils.lazy import lazy_exports
from k8s_gpu_hpa_tpu_torch.obs.coverage import (
    COVERAGE_HIT_RATIO,
    COVERAGE_METRIC_NAMES,
    COVERAGE_PROBES_HIT,
    COVERAGE_PROBES_REGISTERED,
    DOMAINS,
    PROBES,
    CoverageMap,
    Probe,
    coverage_families,
    diff_exports,
    probe_ids,
    probes_in_domain,
    render_scorecard,
)
from k8s_gpu_hpa_tpu_torch.obs.latency import (
    TracedLoad,
    histogram_quantiles,
    percentile,
    propagation_report,
)
from k8s_gpu_hpa_tpu_torch.obs.lineage import format_lineage, index_spans, lineage_of
from k8s_gpu_hpa_tpu_torch.obs.profile import (
    PROFILE_ATTRIBUTION_RATIO,
    PROFILE_METRIC_NAMES,
    PROFILE_STAGE_CALLS,
    PROFILE_STAGE_SECONDS,
    STAGES,
    ProfileMap,
    Stage,
    profile_families,
    render_scorecard as render_profile_scorecard,
    stage_ids,
    stages_in_domain,
)
from k8s_gpu_hpa_tpu_torch.obs.schema import (
    LINEAGE_ORDER,
    SPAN_SCHEMA,
    validate_span_fields,
)
from k8s_gpu_hpa_tpu_torch.obs.trace import Span, Tracer, read_jsonl

#: lazily-resolved names -> their metrics-importing submodule (see the
#: module docstring); ``from k8s_gpu_hpa_tpu_torch.obs import X`` works for
#: each of them through the module's ``__getattr__``
_LAZY_SUBMODULE = {
    "ADAPTER_QUERY_LATENCY": "selfmetrics",
    "DECISION_REASONS": "selfmetrics",
    "HPA_DECISION_TOTAL": "selfmetrics",
    "HPA_SYNC_DURATION": "selfmetrics",
    "HPA_SYNC_LATENCY": "selfmetrics",
    "RULE_EVAL_LATENCY": "selfmetrics",
    "RULE_EVAL_STALENESS": "selfmetrics",
    "SCRAPE_DURATION": "selfmetrics",
    "SCRAPE_LATENCY": "selfmetrics",
    "SELF_HISTOGRAM_NAMES": "selfmetrics",
    "SELF_HISTOGRAM_SERIES": "selfmetrics",
    "SELF_METRIC_NAMES": "selfmetrics",
    "SELF_TARGET_NAME": "selfmetrics",
    "SIGNAL_PROPAGATION": "selfmetrics",
    "SIGNAL_PROPAGATION_BUCKETS": "selfmetrics",
    "PipelineSelfMetrics": "selfmetrics",
    "decision_reason_label": "selfmetrics",
    "PROPAGATION_BUDGET_SECONDS": "slo",
    "SLO_EVENTS_TOTAL": "slo",
    "SLO_GOOD_TOTAL": "slo",
    "SLODefinition": "slo",
    "SLORecorder": "slo",
    "burn_rate_alerts": "slo",
    "shipped_slo_alerts": "slo",
    "shipped_slo_recorders": "slo",
    "shipped_slos": "slo",
}


__getattr__ = lazy_exports(__name__, _LAZY_SUBMODULE)


__all__ = [
    "ADAPTER_QUERY_LATENCY",
    "COVERAGE_HIT_RATIO",
    "COVERAGE_METRIC_NAMES",
    "COVERAGE_PROBES_HIT",
    "COVERAGE_PROBES_REGISTERED",
    "CoverageMap",
    "DECISION_REASONS",
    "DOMAINS",
    "HPA_DECISION_TOTAL",
    "HPA_SYNC_DURATION",
    "HPA_SYNC_LATENCY",
    "LINEAGE_ORDER",
    "PROBES",
    "PROFILE_ATTRIBUTION_RATIO",
    "PROFILE_METRIC_NAMES",
    "PROFILE_STAGE_CALLS",
    "PROFILE_STAGE_SECONDS",
    "PROPAGATION_BUDGET_SECONDS",
    "PipelineSelfMetrics",
    "Probe",
    "ProfileMap",
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
    "STAGES",
    "Span",
    "Stage",
    "TracedLoad",
    "Tracer",
    "burn_rate_alerts",
    "coverage_families",
    "decision_reason_label",
    "diff_exports",
    "format_lineage",
    "histogram_quantiles",
    "index_spans",
    "lineage_of",
    "percentile",
    "probe_ids",
    "probes_in_domain",
    "profile_families",
    "propagation_report",
    "read_jsonl",
    "render_profile_scorecard",
    "render_scorecard",
    "shipped_slo_alerts",
    "shipped_slo_recorders",
    "shipped_slos",
    "stage_ids",
    "stages_in_domain",
    "validate_span_fields",
]
