"""Pipeline parallelism (PP): a layer-sharded residual-MLP stack with
GPipe-style microbatching over the device mesh.

Counterpart of ``k8s_gpu_hpa_tpu/models/pipeline.py``.  The layers are
sharded over the mesh's model axis (each rank holds ``n_layers / p``
consecutive layers, the layout for a model whose weights outgrow one
device), and microbatches stream through the stages, the activations
hopping one ``ppermute`` a step.  The schedule is the classic ``p + n_micro
- 1`` steps, every stage computing at every step, bubble steps included:
their results are never recorded, and every rank joins every hop, so the
ranks' collectives pair up without a condition on the data.

Differentiable: ``ppermute``'s backward sends the gradient along the
inverse permutation, and the stage-0 feed and the last stage's record are
each a ``torch.where`` on every stage, so every hop a rank receives and
the closing sum stay in its graph, and every rank runs the same backward
collectives in the same order.  The stack ends in ``psum`` over the
model group, so every stage returns the whole block; under JAX's gradient
of the global loss each rank scales its loss by ``1 / p`` and sums the
stage's weight gradients over the data axis (models/moe.py states the same
rule).  The products are ``torch.matmul``, as JAX leaves them to XLA.  Its
only user in the JAX package is its tests, and so it is here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.models.moe import _from_numpy
from k8s_gpu_hpa_tpu_torch.parallel.mesh import MODEL_AXIS, mesh_shape, ppermute, psum


@dataclass(frozen=True)
class PipelineConfig:
    d_model: int = 128
    d_ff: int = 256
    n_layers: int = 8
    dtype: torch.dtype = torch.bfloat16


def _stage_layers(mesh: DeviceMesh | None, n_layers: int) -> slice:
    """The layers this rank holds: all without a mesh, stage s's
    ``[s·L/p, (s+1)·L/p)`` with one."""
    if mesh is None:
        return slice(0, n_layers)
    p, s = mesh_shape(mesh)[MODEL_AXIS], mesh.get_local_rank(MODEL_AXIS)
    if n_layers % p:
        raise ValueError(f"n_layers {n_layers} must be divisible by the model axis size ({p})")
    return slice(s * n_layers // p, (s + 1) * n_layers // p)


def _place(params: dict, mesh: DeviceMesh | None,
           device: str | torch.device | None) -> dict[str, torch.Tensor]:
    layers = _stage_layers(mesh, params["w1"].shape[0])
    dev = resolve(device if device is not None or mesh is None else mesh.device_type)
    return {name: params[name][layers].contiguous().to(dev) for name in ("w1", "w2")}


def init_pp_params(generator: torch.Generator, cfg: PipelineConfig,
                   mesh: DeviceMesh | None = None,
                   device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Layer-stacked weights ([n_layers, ...]) drawn whole from ``generator``
    (N(0, 1) in f32 scaled by 1/sqrt(fan-in), cast to ``cfg.dtype``): all
    layers without a mesh, this stage's with one."""
    w1 = torch.randn(cfg.n_layers, cfg.d_model, cfg.d_ff, generator=generator) / cfg.d_model**0.5
    w2 = torch.randn(cfg.n_layers, cfg.d_ff, cfg.d_model, generator=generator) / cfg.d_ff**0.5
    return _place({"w1": w1.to(cfg.dtype), "w2": w2.to(cfg.dtype)}, mesh, device)


def pp_params_from_jax(params_np: dict, mesh: DeviceMesh | None = None,
                       device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """JAX's ``init_pp_params`` pytree, its leaves as numpy arrays, as the
    port's parameters in their dtype: every layer without a mesh, this
    stage's with one."""
    return _place({name: _from_numpy(params_np[name]) for name in ("w1", "w2")}, mesh, device)


def _stack(h: torch.Tensor, params: dict) -> torch.Tensor:
    """The residual layers ``h + gelu(h @ w1) @ w2`` of ``params``, in order
    (the tanh gelu, ``jax.nn.gelu``'s default)."""
    for w1, w2 in zip(params["w1"], params["w2"]):
        h = h + torch.matmul(F.gelu(torch.matmul(h, w1), approximate="tanh"), w2)
    return h


def pp_forward_reference(params: dict, cfg: PipelineConfig, x: torch.Tensor) -> torch.Tensor:
    """One device: the same stack, every layer in order."""
    return _stack(x, params)


def make_pp_forward(mesh: DeviceMesh, cfg: PipelineConfig, n_micro: int = 4):
    """``fwd(params, x)``: the stack on this rank's batch shard ``x`` [batch,
    d_model] with this stage's layers (``init_pp_params`` or
    ``pp_params_from_jax`` with the mesh), streamed in ``n_micro``
    microbatches; every rank of a model group returns the whole block."""
    p = mesh_shape(mesh)[MODEL_AXIS]
    if cfg.n_layers % p:
        raise ValueError(f"n_layers {cfg.n_layers} must be divisible by the model axis "
                         f"size ({p})")
    group = mesh.get_group(MODEL_AXIS)
    stage = mesh.get_local_rank(MODEL_AXIS)
    perm = [(i, (i + 1) % p) for i in range(p)]

    def fwd(params: dict, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"local batch {b} must be divisible by n_micro ({n_micro})")
        micro = x.reshape(n_micro, b // n_micro, cfg.d_model)
        first, last = (torch.tensor(stage == s, device=x.device) for s in (0, p - 1))
        cur = torch.zeros_like(micro[0])
        out = [torch.zeros_like(micro[0]) for _ in range(n_micro)]
        for t in range(p + n_micro - 1):
            # stage 0 takes microbatch t (bubble steps feed the last again;
            # nothing records their results)
            cur = torch.where(first, micro[min(t, n_micro - 1)], cur)
            y = _stack(cur, params)
            # the last stage's y at step t is microbatch t - (p - 1), done;
            # a where on every stage keeps the sum below in every graph
            if t >= p - 1:
                out[t - (p - 1)] = torch.where(last, y, out[t - (p - 1)])
            cur = ppermute(y, group, perm)
        # only the last stage holds the outputs (zeros elsewhere): the sum
        # gives every stage the whole block
        return psum(torch.stack(out), group).reshape(b, cfg.d_model)

    return fwd
