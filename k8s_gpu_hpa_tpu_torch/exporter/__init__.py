"""The metrics exporter (L2): device sources, the C++ core's binding, the daemon."""

from k8s_gpu_hpa_tpu_torch.utils.lazy import lazy_exports

#: the names the JAX package re-exports here, each from its submodule
_EXPORTS = {
    "ExporterDaemon": "daemon",
    "NativeExporter": "native",
    "build_native": "native",
    "PodResourcesClient": "podresources",
    "StaticAttributor": "podresources",
    "parse_device_index": "podresources",
    "parse_list_response": "podresources",
    "NvmlSource": "sources",
    "StubSource": "sources",
    "TorchDeviceSource": "sources",
}
__getattr__ = lazy_exports(__name__, _EXPORTS)
__all__ = list(_EXPORTS)
