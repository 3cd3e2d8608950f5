"""Decoder transformer: the model behind the serving and the training load,
on one device or over a mesh.

Counterpart of ``k8s_gpu_hpa_tpu/models/transformer.py``: the config,
parameter init, the block shared by prefill and training, the static-shape
KV cache, ``prefill`` and ``decode_step``; the training path
(``_train_attn_fn``, ``forward_local``, ``make_forward``,
``make_train_step``), sequence-parallel over the mesh's ``data`` axis when
given a mesh (ring attention, ``ops/ring_attention.py``); and
tensor-parallel serving over the ``model`` axis (``tp_params``,
``init_tp_kv_cache``, ``make_tp_decode_step``, ``make_tp_decode_burst``,
``make_tp_prefill``).  JAX runs one SPMD program over global arrays; here
each rank of the ``torch.distributed`` group runs the per-device body on
its own shard, as ``shard_map``'s body sees it: a sequence shard of the
tokens for training, a batch shard of the requests and a head shard of
the weights and the cache for serving.

Parameters are a plain dict with the JAX pytree's keys (``embed``, ``pos``,
``out_norm``, ``blocks[i].{attn_norm, wqkv, wo, mlp_norm, w1, w2}``), one
tensor per leaf, so ``params_from_jax`` maps one to one.

Differences from the JAX module, each for the GPU:

- The KV cache is head-major, ``[layers, batch, heads, max_seq, head_dim]``
  (JAX: ``[layers, batch, max_seq, heads, head_dim]``), so that each
  (batch, head)'s K and V are contiguous [max_seq, head_dim] matrices and a
  decode step's two products over the cache read it once, with no copy.
  The bytes are the same.
- ``prefill`` and ``decode_step`` write the cache in place (the PyTorch
  counterpart of ``dynamic_update_slice`` with donation) and return it.
  ``decode_step`` writes at a position that may be a device tensor, so a
  whole decode chain can be captured in one CUDA graph.
- Products with the weights and over the cache run in the working dtype:
  a bf16 product accumulates in fp32 and rounds its result once, where the
  JAX module asks for an fp32 result and casts.  So in bf16 the decode's
  scores and the MLP's up-projection round to bf16 before the softmax and
  the GELU; in fp32 both modules compute the same thing.  The logits are
  fp32 products, as in JAX.
- Decode attention reads the whole static cache every step, masked at
  ``<= pos``, as the JAX module does: the decode load generator's bytes
  model counts a full cache read per step.
- The training step's SGD update is the JAX module's, leaf by leaf in fp32
  and cast back (``torch.optim.SGD`` would round a bf16 update elsewhere);
  the per-block remat is non-reentrant ``torch.utils.checkpoint``, so each
  layer's attention forward runs twice a step, as under ``jax.checkpoint``.
  Over a mesh the recomputation re-sends the ring's blocks; it runs in full
  (no early stop), so every rank sends the same hops in the same order.
- Tensor-parallel layers sum their partial products over the model axis in
  fp32 and round once, as JAX's psum of fp32 partials; each partial is a
  product in the working dtype, as above.  At a model axis of one the TP
  functions compute exactly what ``prefill`` and ``decode_step`` compute.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from k8s_gpu_hpa_tpu_torch.device import resolve
from k8s_gpu_hpa_tpu_torch.ops.flash_attention import flash_attention, flash_shape_supported
from k8s_gpu_hpa_tpu_torch.ops.ring_attention import NEG_INF, ring_attention_local
from k8s_gpu_hpa_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_index, mesh_shape, ppermute,
)

_LEAVES = ("attn_norm", "wqkv", "wo", "mlp_norm", "w1", "w2")


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256  # byte-level
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 4096
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def init_params(
    cfg: TransformerConfig,
    generator: torch.Generator,
    device: str | torch.device = "cpu",
) -> dict:
    """Random parameters from ``generator`` (a CPU generator: the same seed
    gives the same weights on any device), scaled as the JAX module scales
    them.  The numbers differ from JAX's for the same seed; tests carry JAX's
    parameters over with ``params_from_jax``."""

    def dense(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32) * scale
        return w.to(cfg.dtype).to(device)

    def ones():
        return torch.ones(cfg.d_model, dtype=cfg.dtype, device=device)

    params: dict = {
        "embed": dense((cfg.vocab, cfg.d_model), 0.02),
        "pos": dense((cfg.max_seq, cfg.d_model), 0.02),
        "out_norm": ones(),
        "blocks": [],
    }
    scale = 1.0 / (cfg.d_model**0.5)
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "attn_norm": ones(),
            "wqkv": dense((cfg.d_model, 3 * cfg.d_model), scale),
            "wo": dense((cfg.d_model, cfg.d_model), scale),
            "mlp_norm": ones(),
            "w1": dense((cfg.d_model, cfg.d_ff), scale),
            "w2": dense((cfg.d_ff, cfg.d_model), 1.0 / (cfg.d_ff**0.5)),
        })
    return params


def params_from_jax(
    params_np: dict, cfg: TransformerConfig, device: str | torch.device = "cpu"
) -> dict:
    """The JAX parameter pytree, its leaves as numpy arrays (bf16 leaves
    widened to float32 first, which is exact), as the port's parameters in
    ``cfg.dtype`` on ``device``."""

    def leaf(x):
        return torch.tensor(np.asarray(x, dtype=np.float32)).to(cfg.dtype).to(device)

    return {
        "embed": leaf(params_np["embed"]),
        "pos": leaf(params_np["pos"]),
        "out_norm": leaf(params_np["out_norm"]),
        "blocks": [{name: leaf(blk[name]) for name in _LEAVES} for blk in params_np["blocks"]],
    }


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Every parameter tensor, in the pytree's order."""
    leaves = [params["embed"], params["pos"], params["out_norm"]]
    for blk in params["blocks"]:
        leaves += [blk[name] for name in _LEAVES]
    return leaves


def params_from_leaves(leaves: list[torch.Tensor]) -> dict:
    """The inverse of ``param_leaves``."""
    it = iter(leaves)
    params: dict = {"embed": next(it), "pos": next(it), "out_norm": next(it), "blocks": []}
    for _ in range((len(leaves) - 3) // len(_LEAVES)):
        params["blocks"].append({name: next(it) for name in _LEAVES})
    return params


def params_to_numpy(params: dict) -> dict:
    """The port's parameters as the JAX pytree of float32 numpy arrays (bf16
    widens exactly), the inverse of ``params_from_jax``."""
    return params_from_leaves([t.detach().float().cpu().numpy() for t in param_leaves(params)])


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # cast back to x's dtype before the gain, as JAX does
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype) * g


def _mlp(x: torch.Tensor, blk: dict, cfg: TransformerConfig) -> torch.Tensor:
    """x + W2 gelu(W1 rmsnorm(x)), GELU in fp32 with the tanh approximation
    (``jax.nn.gelu``'s default)."""
    h = _rmsnorm(x, blk["mlp_norm"])
    up = torch.matmul(h, blk["w1"]).float()
    return x + torch.matmul(F.gelu(up, approximate="tanh").to(cfg.dtype), blk["w2"])


def _logits(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Tied LM head, fp32 logits, for [..., d_model] activations."""
    x = _rmsnorm(x, params["out_norm"])
    return torch.matmul(x.float(), params["embed"].float().t())


def _layer_tail(x: torch.Tensor, attn: torch.Tensor, blk: dict, cfg: TransformerConfig):
    """The layer after its attention, on one device: output projection,
    residual, MLP."""
    return _mlp(x + torch.matmul(attn, blk["wo"]), blk, cfg)


def _tp_block_tail(x: torch.Tensor, attn: torch.Tensor, blk: dict, cfg: TransformerConfig,
                   group: dist.ProcessGroup) -> torch.Tensor:
    """The TP layer after its attention, decode and prefill alike: the
    row-shard of ``wo``'s partial product summed over the model axis, then
    the MLP's column/row shards and their sum: the layer's exactly two
    all_reduces, each of fp32 partials rounded once after."""
    out = torch.matmul(attn, blk["wo"]).float()
    dist.all_reduce(out, group=group)
    x = x + out.to(cfg.dtype)
    h = _rmsnorm(x, blk["mlp_norm"])
    up = torch.matmul(h, blk["w1"]).float()
    down = torch.matmul(F.gelu(up, approximate="tanh").to(cfg.dtype), blk["w2"]).float()
    dist.all_reduce(down, group=group)
    return x + down.to(cfg.dtype)


def _qkv(h: torch.Tensor, blk: dict, cfg: TransformerConfig, heads: int):
    """q, k and v [..., heads·head_dim]: views of the fused product with
    ``wqkv`` ([d_model, 3·d_model], or a head shard [d_model, 3, heads,
    head_dim], whose columns are laid out alike)."""
    qkv = torch.matmul(h, blk["wqkv"].reshape(cfg.d_model, -1))
    return qkv.split(heads * cfg.head_dim, dim=-1)


def _block_forward(
    x: torch.Tensor,
    blk: dict,
    cfg: TransformerConfig,
    attn_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    heads: int | None = None,
    tail: Callable = _layer_tail,
):
    """One block over a full sequence: norm, QKV, attention, then ``tail``
    (output projection and MLP; tensor-parallel serving passes its own, of
    ``heads`` local heads).  ``attn_fn([b,s,h,d] q, k, v) -> [b,s,h,d]``;
    q, k and v are views of the fused QKV product.  Returns (x, k, v) so
    that cache-filling callers keep the projected K and V."""
    b, lq, _ = x.shape
    heads = cfg.n_heads if heads is None else heads
    h = _rmsnorm(x, blk["attn_norm"])
    shape = (b, lq, heads, cfg.head_dim)
    q, k, v = (t.view(shape) for t in _qkv(h, blk, cfg, heads))
    attn = attn_fn(q, k, v).reshape(b, lq, heads * cfg.head_dim)
    return tail(x, attn, blk, cfg), k, v


def _train_attn_fn(cfg: TransformerConfig, axis: str, n: int, lq: int, attn_impl: str):
    """The training attention op for a ring of ``n`` devices and local
    sequence ``lq``.

    ``auto``: on a ring of one device the local shard is the whole sequence,
    so the flash kernels serve the training forward and backward
    (``flash_attention``'s autograd Function) whenever the shape sits in
    their envelope; everything else (n > 1, off-envelope shapes) takes the
    ring's plain blocking.  ``ring`` forces the plain blocking: the
    with/without knob.  Any other value raises, as it arrives from the
    ``LLM_ATTN`` pod env and must not silently run the ring.

    The envelope is the Hopper kernels' (bf16, head_dim 64 or 128, seq a
    multiple of 64), not the TPU kernel's (head_dim a multiple of 128 and a
    12 MiB stripe), so for some shapes the two packages take different
    branches.  Both branches compute exact attention, so the results agree
    at the bars of the attention tests."""
    if attn_impl not in ("auto", "ring"):
        raise ValueError(f"attn_impl must be 'auto' or 'ring', got {attn_impl!r}")
    if attn_impl == "auto" and n == 1 and flash_shape_supported(lq, cfg.head_dim, cfg.dtype):
        return lambda q, k, v: flash_attention(q, k, v, causal=True)
    return lambda q, k, v: ring_attention_local(q, k, v, axis, n, causal=True)


def forward_local(
    params: dict,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    axis: str | dist.ProcessGroup,
    n: int,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """fp32 logits [batch, lq, vocab] for this rank's shard ``tokens``
    [batch, lq] of a sequence sharded in order over a ring of ``n`` ranks
    (``axis``: the ring's process group; on a ring of one, where the shard
    is the whole sequence, a name will do).  Positions are global:
    ``my·lq + arange(lq)``.

    Each block is recomputed in the backward pass (layer remat: the
    non-reentrant counterpart of ``jax.checkpoint``), trading its forward's
    FLOPs for the [batch, lq, d_ff] activations autograd would keep.  On a
    ring of several ranks the recomputation re-sends the ring's hops, so it
    runs in full on every rank: an early stop could end one rank's
    recomputation before a hop its peer waits for."""
    _, lq = tokens.shape
    my = axis_index(axis) if n > 1 else 0
    pos = my * lq + torch.arange(lq, device=tokens.device)
    x = params["embed"][tokens] + params["pos"][pos][None].to(cfg.dtype)
    attn_fn = _train_attn_fn(cfg, axis, n, lq, attn_impl)

    def block(x, blk):
        return _block_forward(x, blk, cfg, attn_fn)[0]

    with set_checkpoint_early_stop(False) if n > 1 else contextlib.nullcontext():
        for blk in params["blocks"]:
            x = checkpoint(block, x, blk, use_reentrant=False)
    return _logits(x, params)


def _ring(mesh: DeviceMesh | None) -> tuple[str | dist.ProcessGroup, int]:
    """The sequence ring of ``mesh``: its data axis's group and size; a ring
    of one without a mesh."""
    if mesh is None:
        return DATA_AXIS, 1
    return mesh.get_group(DATA_AXIS), mesh_shape(mesh)[DATA_AXIS]


def make_forward(cfg: TransformerConfig, mesh: DeviceMesh | None = None):
    """(params, tokens[batch, seq]) -> fp32 logits [batch, seq, vocab].
    With a mesh the sequence is sharded over its data axis: each rank passes
    its shard [batch, seq/n] (positions ``i·seq/n`` on, i its index on the
    axis) and gets that shard's logits; without one the whole sequence runs
    on one device."""
    axis, n = _ring(mesh)

    def forward(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return forward_local(params, tokens, cfg, axis, n)

    return forward


def make_loss_and_grad(cfg: TransformerConfig, attn_impl: str = "auto",
                       mesh: DeviceMesh | None = None):
    """(params, tokens[batch, seq]) -> (loss, grads): the training loss and
    its gradient, one tensor per leaf in ``param_leaves`` order.  With a
    mesh whose data axis has n > 1 ranks, sequence-parallel over that axis,
    after JAX's ``make_train_step``: each rank passes its token shard, its
    last position predicts the next shard's first token (one ``ppermute``
    hop), and one flat fp32 all_reduce sums the gradients and the loss,
    which come back in fp32.  On one rank (no mesh, or a data axis of one)
    neither happens and the gradients come back in the leaves' dtype.

    The loss is the next-token NLL over fp32 log-softmax: position i
    predicts token i + 1, and the global last position, whose target wraps
    to the first token, weighs 0; the mean is over the global weighted
    count, ``batch·(n·seq - 1)``.  Each rank differentiates its own NLL
    total over that count, the ring's backward hops carrying what its loss
    owes every rank's computation, so the sum over ranks is the gradient of
    the global mean: JAX's ``psum(g) / n``, whose psum transposes into
    n/count on each rank's cotangent.  The loss is a 0-d fp32 tensor on the
    device (reading it syncs)."""
    axis, n = _ring(mesh)
    wrap = [(j, (j - 1) % n) for j in range(n)]

    def loss_and_grad(params: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        b, lq = tokens.shape
        leaves = [p.detach().requires_grad_() for p in param_leaves(params)]
        with torch.enable_grad():
            logits = forward_local(params_from_leaves(leaves), tokens, cfg, axis, n, attn_impl)
            first = tokens[:, :1] if n == 1 else ppermute(tokens[:, :1], axis, wrap)
            targets = torch.cat([tokens[:, 1:], first], dim=1)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, targets[..., None])[..., 0]
            weights = torch.ones_like(nll)
            if n == 1 or axis_index(axis) == n - 1:
                weights[:, -1] = 0.0  # the global last position wraps to the first token
            loss = (nll * weights).sum() / (b * (n * lq - 1))
            grads = torch.autograd.grad(loss, leaves)
        if n == 1:
            return loss.detach(), list(grads)
        flat = torch.cat([g.float().reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=axis)
        grads = flat[:-1].split([g.numel() for g in grads])
        return flat[-1], [g.view(leaf.shape) for g, leaf in zip(grads, leaves)]

    return loss_and_grad


def make_train_step(cfg: TransformerConfig, lr: float = 1e-3, attn_impl: str = "auto",
                    mesh: DeviceMesh | None = None):
    """(params, tokens[batch, seq]) -> (params, loss): one SGD step on the
    loss and gradient of ``make_loss_and_grad``.  Without a mesh on one
    device (a ring of one); with one, sequence-parallel over its data axis:
    each rank passes its token shard
    [batch, seq/n] and the replicated parameters, and every rank gets the
    same updated parameters and the global loss.  Each leaf is updated as
    ``(p.float() - lr * g.float()).to(p.dtype)``, as in JAX.  The
    parameters passed in are not modified."""
    loss_and_grad = make_loss_and_grad(cfg, attn_impl, mesh)

    def train_step(params: dict, tokens: torch.Tensor) -> tuple[dict, torch.Tensor]:
        loss, grads = loss_and_grad(params, tokens)
        new = [
            (p.detach().float() - lr * g.float()).to(p.dtype)
            for p, g in zip(param_leaves(params), grads, strict=True)
        ]
        return params_from_leaves(new), loss

    return train_step


def init_kv_cache(
    cfg: TransformerConfig, batch: int, device: str | torch.device = "cpu"
) -> dict:
    """Static-shape, head-major KV cache of zeros:
    ``{"k", "v": [layers, batch, heads, max_seq, head_dim]}``."""
    shape = (cfg.n_layers, batch, cfg.n_heads, cfg.max_seq, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _prefill(params: dict, cfg: TransformerConfig, tokens: torch.Tensor, cache: dict,
             heads: int, tail: Callable) -> tuple[torch.Tensor, dict]:
    """``prefill`` over ``heads`` heads, each layer ended by ``tail``."""
    _, plen = tokens.shape
    x = params["embed"][tokens] + params["pos"][:plen][None].to(cfg.dtype)
    for i, blk in enumerate(params["blocks"]):
        x, k, v = _block_forward(
            x, blk, cfg, lambda q, k, v: flash_attention(q, k, v, causal=True), heads, tail
        )
        cache["k"][i, :, :, :plen] = k.transpose(1, 2)
        cache["v"][i, :, :, :plen] = v.transpose(1, 2)
    return _logits(x[:, -1], params), cache


def prefill(
    params: dict, cfg: TransformerConfig, tokens: torch.Tensor, cache: dict
) -> tuple[torch.Tensor, dict]:
    """Score the prompt ``tokens`` [batch, prompt_len] in one causal pass,
    writing its K and V into ``cache`` at positions 0..prompt_len-1 (in
    place), and return the fp32 logits at the last prompt position with the
    cache.  Attention is ``flash_attention``: the Hopper kernel inside its
    envelope, the exact reference outside it."""
    return _prefill(params, cfg, tokens, cache, cfg.n_heads, _layer_tail)


def _decode(params: dict, cfg: TransformerConfig, tokens: torch.Tensor, cache: dict,
            pos: int | torch.Tensor, heads: int, tail: Callable) -> tuple[torch.Tensor, dict]:
    """``decode_step`` over ``heads`` heads, each layer ended by ``tail``."""
    b = tokens.shape[0]
    dev = cache["k"].device
    pos_t = torch.as_tensor(pos, device=dev).reshape(1)
    x = params["embed"][tokens] + params["pos"].index_select(0, pos_t).to(cfg.dtype)
    x = x[:, None]  # [b, 1, d_model]
    hd = cfg.head_dim
    visible = torch.arange(cfg.max_seq, device=dev) <= pos_t  # [max_seq]
    for i, blk in enumerate(params["blocks"]):
        h = _rmsnorm(x, blk["attn_norm"])
        q, k, v = (t.reshape(b, heads, 1, hd) for t in _qkv(h, blk, cfg, heads))
        k_cache, v_cache = cache["k"][i], cache["v"][i]  # [b, heads, max_seq, hd]
        k_cache.index_copy_(2, pos_t, k)
        v_cache.index_copy_(2, pos_t, v)
        s = torch.matmul(q, k_cache.transpose(2, 3)).float() / math.sqrt(hd)
        s = torch.where(visible, s, NEG_INF)  # [b, heads, 1, max_seq]
        p = torch.softmax(s, dim=-1).to(cfg.dtype)
        attn = torch.matmul(p, v_cache).reshape(b, 1, heads * hd)
        x = tail(x, attn, blk, cfg)
    return _logits(x[:, 0], params), cache


def decode_step(
    params: dict,
    cfg: TransformerConfig,
    tokens: torch.Tensor,
    cache: dict,
    pos: int | torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """One autoregressive step: ``tokens`` [batch] sit at position ``pos``
    (an int or a 0-d integer tensor on the cache's device); their K and V
    are written into ``cache`` in place, attention reads the whole static
    cache masked at ``<= pos``, and the fp32 logits for the next position
    come back with the cache."""
    return _decode(params, cfg, tokens, cache, pos, cfg.n_heads, _layer_tail)


# ---- tensor-parallel serving (data x model over the mesh) -----------------
#
# Megatron's layout, as JAX shards it: attention heads and the MLP's d_ff are
# column-sharded over the model axis, the output projections row-sharded, so
# each layer needs exactly two all_reduces (after wo, after w2) and attention
# is local to the rank, which owns n_heads/m heads and their slice of the KV
# cache.  The batch is sharded over the data axis: independent replicas.


def tp_param_specs(cfg: TransformerConfig) -> dict:
    """The TP layout of ``init_params``' pytree as DTensor placements, one a
    mesh axis (data, model): JAX's PartitionSpecs.  ``wqkv`` is viewed as
    [d_model, 3, n_heads, head_dim] (``tp_params``), so the packed q/k/v
    columns shard by head, never inside one head's slice."""
    from torch.distributed.tensor import Replicate, Shard

    whole = [Replicate(), Replicate()]
    blk = {"attn_norm": whole, "wqkv": [Replicate(), Shard(2)], "wo": [Replicate(), Shard(0)],
           "mlp_norm": whole, "w1": [Replicate(), Shard(1)], "w2": [Replicate(), Shard(0)]}
    return {"embed": whole, "pos": whole, "out_norm": whole,
            "blocks": [dict(blk) for _ in range(cfg.n_layers)]}


def _tp_validate(cfg: TransformerConfig, mesh: DeviceMesh) -> None:
    m = mesh_shape(mesh)[MODEL_AXIS]
    if cfg.n_heads % m or cfg.d_ff % m:
        raise ValueError(
            f"n_heads {cfg.n_heads} and d_ff {cfg.d_ff} must be divisible "
            f"by the model axis size ({m})"
        )


def _tp_device(mesh: DeviceMesh, device: str | torch.device | None) -> torch.device:
    return resolve(device if device is not None else mesh.device_type)


def tp_params(params_np: dict, cfg: TransformerConfig, mesh: DeviceMesh,
              device: str | torch.device | None = None) -> dict:
    """This rank's shard of the full parameters ``params_np`` (the JAX
    pytree of numpy arrays: ``params_to_numpy``, or JAX's own), in
    ``cfg.dtype`` on ``device`` (default: the mesh's device type):
    ``wqkv`` viewed as [d_model, 3, n_heads, head_dim] and cut by head,
    ``wo`` and ``w2`` by rows, ``w1`` by columns, the rest whole."""
    _tp_validate(cfg, mesh)
    m, index = mesh_shape(mesh)[MODEL_AXIS], mesh.get_local_rank(MODEL_AXIS)
    dev = _tp_device(mesh, device)
    specs = tp_param_specs(cfg)

    def shard(x, placements):
        t = torch.tensor(np.asarray(x, dtype=np.float32))
        on_model = placements[1]
        if on_model.is_shard():
            t = t.chunk(m, dim=on_model.dim)[index]
        return t.contiguous().to(cfg.dtype).to(dev)

    blocks = [dict(blk, wqkv=np.asarray(blk["wqkv"]).reshape(
        cfg.d_model, 3, cfg.n_heads, cfg.head_dim)) for blk in params_np["blocks"]]
    return {
        "embed": shard(params_np["embed"], specs["embed"]),
        "pos": shard(params_np["pos"], specs["pos"]),
        "out_norm": shard(params_np["out_norm"], specs["out_norm"]),
        "blocks": [{name: shard(blk[name], spec[name]) for name in _LEAVES}
                   for blk, spec in zip(blocks, specs["blocks"], strict=True)],
    }


def init_tp_kv_cache(cfg: TransformerConfig, batch: int, mesh: DeviceMesh,
                     device: str | torch.device | None = None) -> dict:
    """This rank's slice of the TP KV cache, zeros: batch over the data
    axis, heads over the model axis, head-major as ``init_kv_cache``:
    ``{"k", "v": [layers, batch/data, n_heads/model, max_seq, head_dim]}``.
    Only the slice is allocated, never the whole cache: the layout exists
    for a cache larger than one device holds."""
    _tp_validate(cfg, mesh)
    shape = mesh_shape(mesh)
    if batch % shape[DATA_AXIS]:
        raise ValueError(f"batch {batch} must be divisible by the data axis ({shape[DATA_AXIS]})")
    local = (cfg.n_layers, batch // shape[DATA_AXIS], cfg.n_heads // shape[MODEL_AXIS],
             cfg.max_seq, cfg.head_dim)
    dev = _tp_device(mesh, device)
    return {"k": torch.zeros(local, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(local, dtype=cfg.dtype, device=dev)}


def _tp_layout(mesh: DeviceMesh, cfg: TransformerConfig) -> tuple[int, Callable]:
    """The rank's local head count and its layers' TP tail."""
    _tp_validate(cfg, mesh)
    heads = cfg.n_heads // mesh_shape(mesh)[MODEL_AXIS]
    return heads, partial(_tp_block_tail, group=mesh.get_group(MODEL_AXIS))


def make_tp_decode_step(mesh: DeviceMesh, cfg: TransformerConfig):
    """(tp_params, tokens[batch/data], tp_cache, pos) -> (logits[batch/data,
    vocab], tp_cache): one autoregressive step of this rank's batch shard
    over its heads (two all_reduces a layer); the cache is written in place.
    ``pos`` is an int or a 0-d integer tensor on the device.  Logits come
    out of the sums, so every rank of a model group holds the same."""
    heads, tail = _tp_layout(mesh, cfg)

    def step(params, tokens, cache, pos):
        return _decode(params, cfg, tokens, cache, pos, heads, tail)

    return step


def make_tp_decode_burst(mesh: DeviceMesh, cfg: TransformerConfig, tokens_per_burst: int):
    """(tp_params, tokens[batch/data], tp_cache, pos) -> (tokens, tp_cache,
    pos): ``tokens_per_burst`` greedy steps on the TP layout, as the
    single-device burst chains them: each step's argmax feeds the next and
    ``pos`` wraps before ``max_seq``.  ``tokens`` (long) and ``pos`` (a 0-d
    long tensor on the device) are updated in place with the cache and
    returned, so the burst can be captured in a CUDA graph."""
    step = make_tp_decode_step(mesh, cfg)

    def burst(params, tokens, cache, pos):
        for _ in range(tokens_per_burst):
            logits, cache = step(params, tokens, cache, pos)
            tokens.copy_(logits.argmax(dim=-1))
            pos.add_(1).remainder_(cfg.max_seq - 1)
        return tokens, cache, pos

    return burst


def make_tp_prefill(mesh: DeviceMesh, cfg: TransformerConfig):
    """(tp_params, tokens[batch/data, prompt_len], tp_cache) -> (last-position
    logits, tp_cache): the admission path of TP serving.  Each rank's
    attention is ``flash_attention`` over its local heads (the Hopper
    forward kernel inside its envelope: head sharding leaves head_dim as it
    is), then the same two all_reduces a layer as decode; the cache is
    written in place."""
    heads, tail = _tp_layout(mesh, cfg)

    def prefill_fn(params, tokens, cache):
        return _prefill(params, cfg, tokens, cache, heads, tail)

    return prefill_fn
