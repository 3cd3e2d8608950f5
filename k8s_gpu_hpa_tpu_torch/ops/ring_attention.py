"""Exact attention without a kernel: the oracle of the attention tests, the
path ``flash_attention`` takes off its kernels' envelope, and ring attention,
the sequence-parallel attention of the training forward and the long-context
rung.

Counterpart of ``k8s_gpu_hpa_tpu/ops/ring_attention.py``: ``reference_attention``,
the online-softmax pieces ``_chunk_attn``, ``_merge`` and ``_block_attn``,
``ring_attention_local`` (the per-rank ring body) and ``ring_attention``.
The sequence is sharded over a mesh axis; each rank keeps its Q block and
the K/V blocks travel the ring (``parallel/mesh.py`` ``ppermute``, the
counterpart of ``lax.ppermute``), merged exactly by the online softmax.
Like the JAX package, which leaves this path to XLA, it is plain PyTorch:
no kernel is written for it.  On a ring of one it is the with/without
yardstick of the training step's flash kernels (``attn_impl="ring"``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from k8s_gpu_hpa_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, mesh_shape, ppermute

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
    axis: str | dist.ProcessGroup,
    n: int,
    causal: bool = False,
    kv_chunk: int | None = 512,
) -> torch.Tensor:
    """The per-rank ring body on local [b, lq, h, d] shards of a sequence
    sharded in order over a ring of ``n`` ranks: Q stays, and the K/V block
    resident at step s, which started on the rank at ``(my - s) mod n``,
    is attended (chunked, exact online-softmax merges, fp32), then passed
    one hop along the ring.  The result is cast back to q's dtype.

    ``axis`` is the ring's process group (``mesh.get_group(axis)``), the
    counterpart of JAX's axis name inside ``shard_map``; on a ring of one,
    where no block moves, a name will do.  JAX's loop makes ``n`` hops, the
    last of which only brings each block home; nothing reads it, so it is
    not sent here.  Every block is attended, fully masked ones too, as in
    JAX: each hop's gradient then flows back on every rank, so every rank
    sends the same backward hops in the same order, recomputation
    included."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    my = axis_index(axis) if n > 1 else 0
    qf = q.float()
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v)) if n > 1 else (k, v)  # one message a hop
    ring = [(j, (j + 1) % n) for j in range(n)]
    for s in range(n):
        k_off = ((my - s) % n) * lk
        bm, bl, bo = _block_attn(qf, kv[0].float(), kv[1], my * lq, k_off, causal, kv_chunk)
        m, l, o = _merge(m, l, o, bm, bl, bo)
        if s < n - 1:
            kv = ppermute(kv, axis, ring)
    # causal rows always attend to their own position, so l > 0 after all n
    # blocks; the floor only guards the unreachable all-masked row
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = DATA_AXIS,
    causal: bool = False,
    kv_chunk: int | None = 512,
) -> torch.Tensor:
    """Exact attention with the sequence sharded over the mesh axis
    ``axis``.  There is no global array in torch: each rank passes its own
    shard [batch, seq/n, heads, head_dim] of q, k and v (the shard of the
    rank at index i on the axis holds positions ``i·seq/n`` on) and gets its
    shard of the output back, as JAX's ``P(None, axis)`` places them.  Ranks
    of the other axis hold replicas and run rings of their own.
    ``kv_chunk`` blocks each K/V block so the score slab is
    [seq/n, kv_chunk] (None or a non-dividing chunk: unchunked)."""
    n = mesh_shape(mesh)[axis]
    return ring_attention_local(q, k, v, mesh.get_group(axis), n, causal=causal,
                                kv_chunk=kv_chunk)
