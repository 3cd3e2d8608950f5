"""Host-side helpers: clocks, the native build, the chained-dwell timer and
the packages' lazy re-exports."""

from k8s_gpu_hpa_tpu_torch.utils.lazy import lazy_exports

#: the names the JAX package re-exports here, each from its submodule
_EXPORTS = {
    "Clock": "clock",
    "SystemClock": "clock",
    "VirtualClock": "clock",
}
__getattr__ = lazy_exports(__name__, _EXPORTS)
__all__ = list(_EXPORTS)
