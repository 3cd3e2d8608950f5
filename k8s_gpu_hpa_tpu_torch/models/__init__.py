"""Models behind the load generators: the decoder transformer, the ResNet,
the tensor-parallel MLP, the mixture of experts and the pipeline stages."""

from k8s_gpu_hpa_tpu_torch.utils.lazy import lazy_exports

#: the names the JAX package re-exports here, each from its submodule
_EXPORTS = {
    "ResNet": "resnet",
    "resnet18ish": "resnet",
    "resnet50": "resnet",
    "init_tp_mlp": "tp_mlp",
    "tp_mlp_forward": "tp_mlp",
}
__getattr__ = lazy_exports(__name__, _EXPORTS)
__all__ = list(_EXPORTS)
