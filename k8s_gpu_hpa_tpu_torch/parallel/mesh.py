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
as the JAX workloads call explicit ``shard_map`` collectives.  Two of those
collectives have no differentiable counterpart in torch and are here:
``axis_index`` (``lax.axis_index``) and ``ppermute`` (``lax.ppermute``, with
its transpose as the backward), the ring's and the pipeline's
point-to-point step.
"""

from __future__ import annotations

import torch
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


def axis_index(group: dist.ProcessGroup) -> int:
    """This rank's index on the mesh axis whose group is ``group``:
    ``lax.axis_index``.  An axis name is refused: in torch a rank reaches
    its axis through the axis's group (``mesh.get_group(name)``)."""
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"an axis of several ranks is reached through its process group "
                        f"(mesh.get_group), not {group!r}")
    return dist.get_group_rank(group, dist.get_rank())


def ppermute(x: torch.Tensor, group: dist.ProcessGroup,
             perm: list[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over the ranks of ``group``: for each ``(src, dst)``
    of ``perm`` (indices on the axis) the rank at ``src`` sends its ``x`` to
    the rank at ``dst``; a rank that receives nothing gets zeros.  Every rank
    of the group calls it with the same ``perm``.

    Differentiable: the backward sends the gradient along the inverse
    permutation, as JAX transposes ``ppermute``.  The transport is one
    ``batch_isend_irecv`` of the rank's sends and receives, waited for
    under the group's timeout, so a ring whose ranks disagree raises.  A
    gloo group carries CUDA tensors only through all_reduce and broadcast,
    so on gloo (``dist.get_backend``) a CUDA tensor travels as a host copy
    and comes back to its device: the staging gloo does for the
    collectives it carries.  NCCL sends the device tensor."""
    return _PPermute.apply(x, group, tuple((int(s), int(d)) for s, d in perm))


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _send_recv(x, group, perm)

    @staticmethod
    def backward(ctx, grad):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _send_recv(grad, ctx.group, inverse), None, None


def host_staged(x: torch.Tensor, group: dist.ProcessGroup) -> bool:
    """Whether ``ppermute`` sends ``x`` over ``group`` as a host copy: a
    tensor off the CPU on a gloo group (chosen by the group's backend)."""
    return dist.get_backend(group) == "gloo" and x.device.type != "cpu"


def _send_recv(x: torch.Tensor, group: dist.ProcessGroup, perm: tuple) -> torch.Tensor:
    n, me = dist.get_world_size(group), axis_index(group)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or not all(
            0 <= i < n for i in srcs + dsts):
        raise ValueError(f"{list(perm)} is not a permutation of an axis of {n}")
    send_to = [d for s, d in perm if s == me and d != me]
    recv_from = [s for s, d in perm if d == me]
    if recv_from == [me]:  # an edge to itself
        return x.clone()
    staged = host_staged(x, group)
    send = x.detach().to("cpu" if staged else x.device).contiguous()
    recv = torch.empty_like(send)
    ranks = dist.get_process_group_ranks(group)
    ops = [dist.P2POp(dist.isend, send, ranks[d], group) for d in send_to]
    ops += [dist.P2POp(dist.irecv, recv, ranks[s], group) for s in recv_from]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not recv_from:
        return torch.zeros_like(x)
    return recv.to(x.device) if staged else recv
