"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from k8s_gpu_hpa_tpu_torch.utils.lazy import lazy_exports

#: the names the JAX package re-exports here, each from its submodule
_EXPORTS = {
    "flash_attention_supported": "flash_attention",
    "matmul_kernel": "matmul",
}
__getattr__ = lazy_exports(__name__, _EXPORTS)
__all__ = list(_EXPORTS)
