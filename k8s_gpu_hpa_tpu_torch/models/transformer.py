"""Decoder transformer, single device: the model behind the serving load.

Counterpart of the single-device part of
``k8s_gpu_hpa_tpu/models/transformer.py``: the config, parameter init, the
block shared by prefill and training, the static-shape KV cache, ``prefill``
and ``decode_step``.  The sequence-parallel training forward, tensor-parallel
serving and the training step are ported with their slices.

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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from k8s_gpu_hpa_tpu_torch.ops.flash_attention import flash_attention
from k8s_gpu_hpa_tpu_torch.ops.ring_attention import NEG_INF

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
    """Tied LM head, fp32 logits, for [batch, d_model] activations."""
    x = _rmsnorm(x, params["out_norm"])
    return torch.matmul(x.float(), params["embed"].float().t())


def _block_forward(
    x: torch.Tensor,
    blk: dict,
    cfg: TransformerConfig,
    attn_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
):
    """One block over a full sequence: norm, QKV, attention, output
    projection, MLP.  ``attn_fn([b,s,h,d] q, k, v) -> [b,s,h,d]``; q, k and
    v are views of the fused QKV product.  Returns (x, k, v) so that
    cache-filling callers keep the projected K and V."""
    b, lq, _ = x.shape
    h = _rmsnorm(x, blk["attn_norm"])
    qkv = torch.matmul(h, blk["wqkv"])
    shape = (b, lq, cfg.n_heads, cfg.head_dim)
    q, k, v = (t.view(shape) for t in qkv.split(cfg.d_model, dim=-1))
    attn = attn_fn(q, k, v).reshape(b, lq, cfg.d_model)
    x = x + torch.matmul(attn, blk["wo"])
    return _mlp(x, blk, cfg), k, v


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


def prefill(
    params: dict, cfg: TransformerConfig, tokens: torch.Tensor, cache: dict
) -> tuple[torch.Tensor, dict]:
    """Score the prompt ``tokens`` [batch, prompt_len] in one causal pass,
    writing its K and V into ``cache`` at positions 0..prompt_len-1 (in
    place), and return the fp32 logits at the last prompt position with the
    cache.  Attention is ``flash_attention``: the Hopper kernel inside its
    envelope, the exact reference outside it."""
    _, plen = tokens.shape
    x = params["embed"][tokens] + params["pos"][:plen][None].to(cfg.dtype)
    for i, blk in enumerate(params["blocks"]):
        x, k, v = _block_forward(
            x, blk, cfg, lambda q, k, v: flash_attention(q, k, v, causal=True)
        )
        cache["k"][i, :, :, :plen] = k.transpose(1, 2)
        cache["v"][i, :, :, :plen] = v.transpose(1, 2)
    return _logits(x[:, -1], params), cache


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
    b = tokens.shape[0]
    dev = cache["k"].device
    pos_t = torch.as_tensor(pos, device=dev).reshape(1)
    x = params["embed"][tokens] + params["pos"].index_select(0, pos_t).to(cfg.dtype)
    x = x[:, None]  # [b, 1, d_model]
    hd, heads = cfg.head_dim, cfg.n_heads
    visible = torch.arange(cfg.max_seq, device=dev) <= pos_t  # [max_seq]
    for i, blk in enumerate(params["blocks"]):
        h = _rmsnorm(x, blk["attn_norm"])
        qkv = torch.matmul(h, blk["wqkv"])
        q, k, v = (t.reshape(b, heads, 1, hd) for t in qkv.split(cfg.d_model, dim=-1))
        k_cache, v_cache = cache["k"][i], cache["v"][i]  # [b, heads, max_seq, hd]
        k_cache.index_copy_(2, pos_t, k)
        v_cache.index_copy_(2, pos_t, v)
        s = torch.matmul(q, k_cache.transpose(2, 3)).float() / math.sqrt(hd)
        s = torch.where(visible, s, NEG_INF)  # [b, heads, 1, max_seq]
        p = torch.softmax(s, dim=-1).to(cfg.dtype)
        attn = torch.matmul(p, v_cache).reshape(b, 1, cfg.d_model)
        x = x + torch.matmul(attn, blk["wo"])
        x = _mlp(x, blk, cfg)
    return _logits(x[:, 0], params), cache
