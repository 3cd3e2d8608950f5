"""Tensor-parallel MLP block — the model-axis sharding exemplar.

Counterpart of ``k8s_gpu_hpa_tpu/models/tp_mlp.py``: a Megatron-style
column→row parallel pair.  The first weight is sharded over the ``model``
axis on its output dimension, the second on its input dimension, so the
forward needs exactly one collective at its end: an all_reduce (SUM) over
the model group, the JAX block's ``lax.psum``.  Each rank holds its shard of
the weights and its data shard of the batch.  The products are
``torch.matmul``, as the JAX block's are ``jnp.dot`` (no Pallas kernel).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.parallel.mesh import MODEL_AXIS, mesh_shape


def _shards(w1: torch.Tensor, w2: torch.Tensor, mesh: DeviceMesh,
            device: str | torch.device | None) -> dict[str, torch.Tensor]:
    """This rank's columns of ``w1`` and rows of ``w2``, on ``device``
    (default: the mesh's device type, CUDA's current device)."""
    n, m = mesh_shape(mesh)[MODEL_AXIS], mesh.get_local_rank(MODEL_AXIS)
    d_hidden = w1.shape[1]
    if d_hidden % n:
        raise ValueError(f"d_hidden={d_hidden} does not split over {n} model ranks")
    cols = slice(m * d_hidden // n, (m + 1) * d_hidden // n)
    dev = resolve(device if device is not None else mesh.device_type)
    return {"w1": w1[:, cols].contiguous().to(dev), "w2": w2[cols].contiguous().to(dev)}


def init_tp_mlp(generator: torch.Generator, d_model: int, d_hidden: int, mesh: DeviceMesh,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Weights drawn whole from ``generator`` on every rank (N(0, 1) in f32
    scaled by 1/sqrt(fan-in), then cast to ``dtype``), of which this rank
    keeps its model shard: ``w1`` [d_model, d_hidden/n] and ``w2``
    [d_hidden/n, d_model]."""
    w1 = torch.randn(d_model, d_hidden, generator=generator, device=generator.device)
    w2 = torch.randn(d_hidden, d_model, generator=generator, device=generator.device)
    w1 = (w1 * (1.0 / math.sqrt(d_model))).to(dtype)
    w2 = (w2 * (1.0 / math.sqrt(d_hidden))).to(dtype)
    return _shards(w1, w2, mesh, device)


def tp_params_from_numpy(w1: np.ndarray, w2: np.ndarray, mesh: DeviceMesh,
                         device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """This rank's shards of whole weights given as arrays (the JAX block's
    ``params``, gathered), in their dtype."""
    w1, w2 = (torch.from_numpy(np.ascontiguousarray(w)) for w in (w1, w2))
    return _shards(w1, w2, mesh, device)


def tp_mlp_forward(params: dict[str, torch.Tensor], x: torch.Tensor,
                   mesh: DeviceMesh) -> torch.Tensor:
    """``y = gelu(x @ w1) @ w2`` for this rank's data shard ``x``: the first
    product accumulates in f32 and rounds to ``x.dtype`` (the tanh gelu,
    ``jax.nn.gelu``'s default, in that dtype), the second stays in f32
    through the model group's sum, then rounds to ``x.dtype``."""
    h = F.gelu(torch.matmul(x, params["w1"]), approximate="tanh")
    y = torch.matmul(h.float(), params["w2"].float())
    dist.all_reduce(y, group=mesh.get_group(MODEL_AXIS))  # the one tp collective
    return y.to(x.dtype)
