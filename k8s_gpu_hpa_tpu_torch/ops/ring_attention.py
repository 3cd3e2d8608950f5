"""Exact attention without a kernel: the oracle of the attention tests, the
path ``flash_attention`` takes off its kernels' envelope, and the ring
attention body of the training forward.

Counterpart of ``k8s_gpu_hpa_tpu/ops/ring_attention.py``: ``reference_attention``,
the online-softmax pieces ``_chunk_attn``, ``_merge`` and ``_block_attn``, and
``ring_attention_local`` for a ring of one device, where the local shard is
the whole sequence and no KV block moves.  The ring across devices (KV blocks
streamed with ``ppermute``) waits for the multi-device slice, ROADMAP item
10.  Like the JAX package, which leaves this path to XLA, it is plain
PyTorch: the with/without yardstick of the training step's flash kernels
(``attn_impl="ring"``).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30  # mask value; large-negative beats -inf for bf16/f32 exp math


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Attention over [batch, seq, heads, head_dim] operands, scores and
    softmax in fp32, the output cast back to the operands' dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(q.shape[-1])
    if causal:
        lq, lk = s.shape[2], s.shape[3]
        rows = torch.arange(lq, device=s.device)[:, None]
        cols = torch.arange(lk, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _chunk_attn(q, k, v, q_off: int, k_off: int, causal: bool):
    """Scores and weighted values for one (Q block, KV chunk) pair, q
    [b, lq, h, d] against k, v [b, lk, h, d].  Returns the online-softmax
    triple (m, l, o): per-row max [b, h, lq], sum of exp [b, h, lq] and the
    unnormalized output [b, h, lq, d], all fp32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if causal:
        q_pos = q_off + torch.arange(s.shape[2], device=s.device)[:, None]
        k_pos = k_off + torch.arange(s.shape[3], device=s.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m, p.sum(dim=-1), o


def _merge(m, l, o, bm, bl, bo):
    """Fold one online-softmax triple into the running accumulators."""
    m_new = torch.maximum(m, bm)
    scale_old = torch.exp(m - m_new)
    scale_new = torch.exp(bm - m_new)
    l = l * scale_old + bl * scale_new
    o = o * scale_old[..., None] + bo * scale_new[..., None]
    return m_new, l, o


def _block_attn(q, k, v, q_off: int, k_off: int, causal: bool, kv_chunk: int | None):
    """One (Q block, KV block) pair, the KV side scanned in chunks of
    ``kv_chunk`` so that the live score slab is [lq, kv_chunk], not
    [lq, lk]; a missing or non-dividing chunk scans it whole.  Each chunk's
    step is recomputed in the backward pass (non-reentrant checkpoint, the
    counterpart of ``jax.checkpoint`` on the scan body), so autograd never
    keeps a chunk's score slab.  Returns the block's combined triple."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if kv_chunk is None or kv_chunk >= lk or lk % kv_chunk != 0:
        return _chunk_attn(q, k, v, q_off, k_off, causal)

    def step(m, l, o, kc, vc, i):
        return _merge(m, l, o, *_chunk_attn(q, kc, vc, q_off, k_off + i * kv_chunk, causal))

    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    for i in range(lk // kv_chunk):
        kc = k[:, i * kv_chunk : (i + 1) * kv_chunk]
        vc = v[:, i * kv_chunk : (i + 1) * kv_chunk]
        m, l, o = checkpoint(step, m, l, o, kc, vc, i, use_reentrant=False)
    return m, l, o


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: str,
    n: int,
    causal: bool = False,
    kv_chunk: int | None = 512,
) -> torch.Tensor:
    """The per-device ring body on local [b, lq, h, d] shards, for a ring of
    ``n == 1`` device: the one resident KV block, chunked, with the exact
    online-softmax merge, in fp32, cast back to q's dtype.  ``axis`` names
    the mesh axis of the ring, as in the JAX signature.  ``n > 1`` raises:
    the KV ring across devices is ROADMAP item 10."""
    if n != 1:
        raise NotImplementedError(
            f"ring attention over {n} devices (axis {axis!r}) waits for the "
            "multi-device slice, ROADMAP item 10"
        )
    b, lq, h, d = q.shape
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    # the block resident at the ring's only step is this device's own
    bm, bl, bo = _block_attn(q.float(), k.float(), v, 0, 0, causal, kv_chunk)
    m, l, o = _merge(m, l, o, bm, bl, bo)
    # causal rows always attend to their own position, so l > 0; the floor
    # only guards the unreachable all-masked row
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
