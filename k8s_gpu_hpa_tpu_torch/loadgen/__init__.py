"""Load generators (L1): the matmul busy-loop, the serving decode loop, the
training loads, the slice container's collective rung, their intensity knob
and telemetry."""

from k8s_gpu_hpa_tpu_torch.utils.lazy import lazy_exports

#: the names the JAX package re-exports here, each from its submodule
_EXPORTS = {
    "AllReduceLoadGen": "allreduce",
    "CollectiveStats": "allreduce",
    "LoadGenStats": "matmul",
    "MatmulLoadGen": "matmul",
    "TrainLoadGen": "train",
    "TrainStats": "train",
}
__getattr__ = lazy_exports(__name__, _EXPORTS)
__all__ = list(_EXPORTS)
