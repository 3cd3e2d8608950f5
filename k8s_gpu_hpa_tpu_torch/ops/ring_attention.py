"""Exact single-device attention: the oracle of the attention tests and the
path ``flash_attention`` takes off its kernel's envelope.

Counterpart of ``reference_attention`` in
``k8s_gpu_hpa_tpu/ops/ring_attention.py``.  The ring itself (KV blocks
streamed between devices) is ported with the multi-device slice; until then
this module holds only the reference and the mask value the ring shares
with the flash kernel.
"""

from __future__ import annotations

import math

import torch

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
