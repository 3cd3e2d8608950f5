"""Mixture-of-experts FFN with expert parallelism (EP) over the device mesh.

Counterpart of ``k8s_gpu_hpa_tpu/models/moe.py``.  The experts are sharded
over the mesh's model axis (each rank holds ``n_experts / m`` expert FFNs),
and tokens travel to their expert's rank and back by ``all_to_all``
(``parallel/mesh.py``), the all-pairs exchange no ring or tree collective
makes.  Switch-style top-1 routing with a fixed capacity an expert keeps
every shape static: tokens past an expert's capacity are dropped (their
output is zero, and the residual around the layer carries them), and
nothing is indexed by a boolean mask, so a burst can be captured as a CUDA
graph.  The products are ``torch.bmm`` and ``torch.einsum``, as JAX leaves
them to XLA (no Pallas kernel).

Differentiable end to end: the routing weight multiplies the expert
output, so the router learns from the loss, and ``all_to_all``'s backward
is the reverse exchange.

**Gradients over replicated outputs.**  Every model rank of a data row
routes the same tokens and returns the same output, as JAX's ``shard_map``
does (``out_specs P(DATA, None)``), and JAX's gradient is that of the
global loss, in which each data row's output counts once.  The rule here:
each rank scales its loss by ``1 / m`` (``replica_share``), and each
parameter's gradient is summed over the ranks that hold a copy of it
(``sum_replicated_grads``): the router's over every rank, the experts' over
the data axis.  Then each rank's gradients equal JAX's for its shard.

In bf16 the port's expert products round their result to bf16, where JAX
asks for an fp32 result and casts; in f32 both agree at JAX's bars.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, all_to_all, mesh_shape


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 128
    d_ff: int = 256  # an expert's hidden size
    n_experts: int = 4
    #: an expert's slots as a multiple of the even share (tokens/n_experts);
    #: 1.0 drops everything beyond a perfectly balanced assignment
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16


def _rank_experts(mesh: DeviceMesh | None, n_experts: int) -> slice:
    """The experts this rank holds: all without a mesh, model rank r's
    ``[r·local_e, (r+1)·local_e)`` with one."""
    if mesh is None:
        return slice(0, n_experts)
    m, r = mesh_shape(mesh)[MODEL_AXIS], mesh.get_local_rank(MODEL_AXIS)
    if n_experts % m:
        raise ValueError(f"n_experts {n_experts} must be divisible by the model "
                         f"axis size ({m})")
    local_e = n_experts // m
    return slice(r * local_e, (r + 1) * local_e)


def _place(params: dict, mesh: DeviceMesh | None,
           device: str | torch.device | None) -> dict[str, torch.Tensor]:
    experts = _rank_experts(mesh, params["w1"].shape[0])
    dev = resolve(device if device is not None or mesh is None else mesh.device_type)
    return {"router": params["router"].to(dev),
            "w1": params["w1"][experts].contiguous().to(dev),
            "w2": params["w2"][experts].contiguous().to(dev)}


def init_moe_params(generator: torch.Generator, cfg: MoEConfig, mesh: DeviceMesh | None = None,
                    device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Weights drawn whole from ``generator`` (N(0, 1) in f32, scaled by
    1/sqrt(fan-in); the router stays f32, the experts are cast to
    ``cfg.dtype``): all of them without a mesh, this rank's experts and the
    router with one.  ``device`` defaults to CUDA, or to the mesh's."""
    scale = 1.0 / cfg.d_model**0.5
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=generator) * scale
    w1 = torch.randn(cfg.n_experts, cfg.d_model, cfg.d_ff, generator=generator) * scale
    w2 = torch.randn(cfg.n_experts, cfg.d_ff, cfg.d_model, generator=generator) / cfg.d_ff**0.5
    return _place({"router": router, "w1": w1.to(cfg.dtype), "w2": w2.to(cfg.dtype)},
                  mesh, device)


def _from_numpy(a) -> torch.Tensor:
    """An array of JAX's (bf16 arrives as ml_dtypes' bfloat16) as a tensor
    of the same dtype; bf16 widens to f32 on the way, which is exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def moe_params_from_jax(params_np: dict, mesh: DeviceMesh | None = None,
                        device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """JAX's ``init_moe_params`` pytree, its leaves as numpy arrays, as the
    port's parameters in their dtypes: the whole set without a mesh, this
    rank's shard with one (the router replicated, model rank r's experts)."""
    return _place({name: _from_numpy(params_np[name]) for name in ("router", "w1", "w2")},
                  mesh, device)


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    """An expert's slots for a token block.  Floor of 1: a tiny block with
    many experts would otherwise compute capacity 0 and silently drop every
    token."""
    return max(1, int(cfg.capacity_factor * tokens / cfg.n_experts))


def _route(x: torch.Tensor, router: torch.Tensor, n_experts: int, capacity: int):
    """Top-1 routing with a fixed capacity: (expert, prob, slot, keep) a
    token.  The logits and softmax are f32; a tie takes the first expert;
    ``slot`` is the token's place among its expert's arrivals, in token
    order; a token past its expert's capacity is dropped (``keep`` false)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    expert = torch.argmax(probs, dim=-1)  # the first of equal maxima
    prob = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, n_experts)
    slot = (torch.cumsum(onehot, dim=0) - 1).gather(1, expert[:, None])[:, 0]
    return expert, prob, slot, slot < capacity


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def moe_ffn_reference(params: dict, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """One device, no communication: every token through its top-1 expert
    under the same capacity rule, each expert computed for every token as
    JAX's oracle computes it.  The EP parity oracle."""
    capacity = _capacity(x.shape[0], cfg)
    expert, prob, _, keep = _route(x, params["router"], cfg.n_experts, capacity)
    pick = expert[:, None, None]
    up = torch.einsum("td,edf->tef", x, params["w1"])
    up = up.gather(1, pick.expand(-1, 1, up.shape[-1]))[:, 0]
    down = torch.einsum("tf,efd->ted", _gelu(up), params["w2"])
    down = down.gather(1, pick.expand(-1, 1, down.shape[-1]))[:, 0]
    return (down.float() * (prob * keep)[:, None]).to(x.dtype)


def make_ep_moe_ffn(mesh: DeviceMesh, cfg: MoEConfig):
    """``ffn(params, x)``: the MoE FFN on this rank's token shard ``x``
    [tokens, d_model] with this rank's parameters (``init_moe_params`` or
    ``moe_params_from_jax`` with the mesh): experts sharded over the model
    axis, tokens over data.

    Dispatch: the rank buckets its tokens into a static [n_experts,
    capacity, d] buffer (a dropped token writes to a spare row that is cut
    off); ``all_to_all`` over the model group hands each rank its experts'
    buckets from every peer, ``[m, local_e, cap, d] → [local_e, m, cap,
    d]``; the local experts run as one batched product; the reverse
    exchange carries the results home, and each kept token takes its
    bucket's result times its routing weight."""
    m = mesh_shape(mesh)[MODEL_AXIS]
    if cfg.n_experts % m:
        raise ValueError(f"n_experts {cfg.n_experts} must be divisible by the model "
                         f"axis size ({m})")
    local_e, d = cfg.n_experts // m, cfg.d_model
    group = mesh.get_group(MODEL_AXIS)

    def ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
        capacity = _capacity(x.shape[0], cfg)
        expert, prob, slot, keep = _route(x, params["router"], cfg.n_experts, capacity)
        bucket = expert * capacity + slot
        spare = cfg.n_experts * capacity
        buf = x.new_zeros(spare + 1, d).index_copy(0, torch.where(keep, bucket, spare), x)
        recv = all_to_all(buf[:spare].view(m, local_e, capacity, d), group, 0, 1)
        up = torch.bmm(recv.reshape(local_e, m * capacity, d), params["w1"])
        down = torch.bmm(_gelu(up), params["w2"])
        back = all_to_all(down.view(local_e, m, capacity, d), group, 1, 0)
        out = back.reshape(spare, d).index_select(0, torch.where(keep, bucket, 0))
        return out * (prob * keep).to(out.dtype)[:, None]

    return ffn


def replica_share(mesh: DeviceMesh) -> float:
    """The factor of a rank's loss over its output: 1 / the model axis's
    size, every model rank of a data row holding the same output."""
    return 1.0 / mesh_shape(mesh)[MODEL_AXIS]


def sum_replicated_grads(params: dict[str, torch.Tensor], mesh: DeviceMesh) -> None:
    """Sum each parameter's ``.grad`` over the ranks that hold a copy of it,
    in place: the router's over every rank of the mesh, the experts' over
    the data axis."""
    dist.all_reduce(params["router"].grad)
    if mesh_shape(mesh)[DATA_AXIS] > 1:
        for name in ("w1", "w2"):
            dist.all_reduce(params[name].grad, group=mesh.get_group(DATA_AXIS))
