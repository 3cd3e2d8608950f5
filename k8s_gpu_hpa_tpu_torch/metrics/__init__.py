"""Metric schema, text exposition, TSDB and scraper, recording rules (L3)."""

from k8s_gpu_hpa_tpu_torch.utils.lazy import lazy_exports

#: the names the JAX package re-exports here, each from its submodule
_EXPORTS = {
    "CHIP_METRICS": "schema",
    "ChipSample": "schema",
    "MetricFamily": "schema",
    "Sample": "schema",
    "TPU_DUTY_CYCLE": "schema",
    "TPU_HBM_BW_UTIL": "schema",
    "TPU_HBM_TOTAL": "schema",
    "TPU_HBM_USAGE": "schema",
    "TPU_TENSORCORE_UTIL": "schema",
    "encode_text": "exposition",
    "parse_text": "exposition",
    "Scraper": "tsdb",
    "TimeSeriesDB": "tsdb",
    "RecordingRule": "rules",
    "RuleEvaluator": "rules",
    "tpu_test_avg_rule": "rules",
}
__getattr__ = lazy_exports(__name__, _EXPORTS)
__all__ = list(_EXPORTS)
