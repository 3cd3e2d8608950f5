"""Device meshes over ``torch.distributed`` process groups (parallel/mesh.py)."""

from k8s_gpu_hpa_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    data_sharding,
    make_mesh,
    mesh_shape,
    model_sharding,
    replicated,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "data_sharding",
    "make_mesh",
    "mesh_shape",
    "model_sharding",
    "replicated",
]
