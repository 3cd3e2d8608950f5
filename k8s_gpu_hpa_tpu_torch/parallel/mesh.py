"""Device-mesh and sharding helpers for the load-generator workloads.

Counterpart of ``k8s_gpu_hpa_tpu/parallel/mesh.py``.  In JAX one process
drives every chip of its host and a ``Mesh`` is a grid of those devices; in
PyTorch a mesh over several GPUs is a group of processes, one a GPU, so the
mesh here is a ``torch.distributed`` ``DeviceMesh`` over the process group
that ``loadgen/multihost.py`` brings up (``initialize``, ``launch``).  Its two
axes keep the JAX names: ``data`` and ``model``, contiguous ranks forming a
model group as JAX reshapes contiguous devices.

The sharding helpers return the DTensor placements of JAX's
``PartitionSpec``s, one placement per mesh axis (``torch.distributed.tensor``
is imported when they are called: it takes a second to import, and no
workload needs it).  The workloads themselves
(models/tp_mlp.py, loadgen/allreduce.py, loadgen/train.py) call explicit
collectives on ``mesh.get_group(DATA_AXIS)`` and ``mesh.get_group(MODEL_AXIS)``,
as the JAX workloads call explicit ``shard_map`` collectives.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: int | None = None, model_parallelism: int = 1) -> DeviceMesh:
    """A 2-D ``(data, model)`` mesh over every rank of the process group.

    ``model_parallelism`` ranks cooperate on one replica (the tensor-parallel
    axis, contiguous ranks); the rest is the data axis.  ``n_devices`` is the
    world size or None: a mesh over fewer ranks than the group holds is not
    built.  The mesh's device type is the group's: ``cuda`` over NCCL,
    ``cpu`` over gloo."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: bring one up with "
            "loadgen/multihost.py initialize() or launch()"
        )
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(
            f"a mesh of {n_devices} devices over a group of {n} ranks: "
            "the mesh spans the whole group"
        )
    if n % model_parallelism != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallelism={model_parallelism}"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(
        device_type, (n // model_parallelism, model_parallelism),
        mesh_dim_names=(DATA_AXIS, MODEL_AXIS),
    )


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{"data": n, "model": m}``, JAX's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_sharding(mesh: DeviceMesh) -> list:
    """Batch-sharded over the data axis (inputs, labels): ``P("data")``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0), Replicate()]


def replicated(mesh: DeviceMesh) -> list:
    """``P()``."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def model_sharding(mesh: DeviceMesh, axis: int = 1, ndim: int = 2) -> list:
    """A weight of ``ndim`` dimensions sharded over the model axis on its
    dimension ``axis`` and replicated over the data axis:
    ``P(None, "model")`` at the defaults."""
    from torch.distributed.tensor import Replicate, Shard

    if not 0 <= axis < ndim:
        raise ValueError(f"axis {axis} of a {ndim}-d weight")
    return [Replicate(), Shard(axis)]
