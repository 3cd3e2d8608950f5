"""Custom-metrics adapter (L4) and HPA controller (L5)."""

from k8s_gpu_hpa_tpu_torch.utils.lazy import lazy_exports

#: the names the JAX package re-exports here, each from its submodule
_EXPORTS = {
    "AdapterRule": "adapter",
    "CustomMetricsAdapter": "adapter",
    "ExternalRule": "adapter",
    "ObjectReference": "adapter",
    "behavior_from_manifest": "hpa",
    "ExternalMetricSpec": "hpa",
    "HPABehavior": "hpa",
    "HPAController": "hpa",
    "HPAStatus": "hpa",
    "metrics_from_manifest": "hpa",
    "ObjectMetricSpec": "hpa",
    "PodsMetricSpec": "hpa",
    "ResourceMetricSpec": "hpa",
    "ScalingPolicy": "hpa",
    "ScalingRules": "hpa",
    "SimCluster": "cluster",
    "SimDeployment": "cluster",
    "SimNode": "cluster",
    "SimPod": "cluster",
}
__getattr__ = lazy_exports(__name__, _EXPORTS)
__all__ = list(_EXPORTS)
