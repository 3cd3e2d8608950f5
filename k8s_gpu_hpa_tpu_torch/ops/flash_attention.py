"""Flash attention forward as a hand-written Hopper kernel — the prefill's hot op.

Counterpart of ``k8s_gpu_hpa_tpu/ops/flash_attention.py``.  Its Pallas
forward kernel ``_flash_kernel`` becomes ``csrc/flash_attention.cu``, CUDA
C++ for ``sm_90a``, built with ``nvcc`` at first use and bound with ctypes.
The source states what it replaces and what bounds it.  The two backward
kernels are ported with the training slice.

Entry points:

- ``flash_attention_kernel(q, k, v, causal, with_lse=False)``: launches the
  kernel for CUDA tensors and raises on anything it does not take.  For CPU
  tensors it computes ``flash_attention_reference`` instead — the only case
  in which the plain version stands in.  ``flash_attention_kernel.launches``
  counts launches.  Operands are [b*h, s, d], or [b, s, h, d] with any
  strides whose last is 1 (the transformer hands it views of its fused QKV
  projection, copied nowhere).
- ``flash_attention_reference(...)``: the plain PyTorch version of what the
  kernel computes.
- ``flash_attention(q, k, v, causal, block_q, block_k)``: the dispatcher of
  the JAX package's public contract.  Inside the envelope it takes the
  kernel; for mismatched q/k/v shapes or a shape or dtype outside the
  envelope it takes ``reference_attention``.

The envelope is the Hopper kernel's, not the TPU's: bf16, head_dim 64 or
128, and a sequence that is a positive multiple of the 64-row KV tile.
There is no stripe cap, because the kernel streams K/V through shared
memory instead of holding a batch-head's whole stripe.  The kernel's tiles
are fixed (128 Q rows by 64 KV rows); ``block_q`` and ``block_k`` are the
TPU kernel's tile sizes, accepted so that callers keep the JAX signature,
and change nothing here.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from k8s_gpu_hpa_tpu_torch.ops.ring_attention import NEG_INF, reference_attention
from k8s_gpu_hpa_tpu_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: K/V rows per tile of the kernel; the sequence must be a multiple
KV_TILE = 64
HEAD_DIMS = (64, 128)


def build() -> tuple[Path, str]:
    """Compile ``csrc/flash_attention.cu`` if needed; returns (library, nvcc output)."""
    return build_shared("libflash_attention.so", [SOURCE], [nvcc(), *NVCC_FLAGS])


_lib: ctypes.CDLL | None = None
_ready_devices: set[int] = set()


def _load(device: int) -> ctypes.CDLL:
    """The library, with the kernel's shared-memory opt-in made on ``device``.

    The opt-in is a device attribute call, which CUDA-graph capture does not
    allow, so it happens here, at the first launch on each device, and never
    inside a launch."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.flash_attention_init.restype = ctypes.c_int
        lib.flash_attention_init.argtypes = [ctypes.c_int]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
    if device not in _ready_devices:
        err = _lib.flash_attention_init(device)
        if err:
            raise RuntimeError(f"flash_attention_init failed with cudaError {err}")
        _ready_devices.add(device)
    return _lib


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """[b, s, h, d] -> [b*h, s, d]; a 3-D operand is already so."""
    if x.ndim == 3:
        return x
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    with_lse: bool = False,
):
    """Plain version of the kernel: fp32 scores times 1/sqrt(d), the causal
    mask with -1e30, fp32 softmax, P rounded to the operands' dtype before
    P V, fp32 accumulation, ``acc / max(l, 1e-30)`` cast to the operands'
    dtype; with ``with_lse`` also ``m + log(l_safe)`` as [b*h, s, 1] fp32.
    Same layouts in and out as ``flash_attention_kernel``."""
    qb, kb, vb = _bhsd(q), _bhsd(k), _bhsd(v)
    seq, d = qb.shape[1], qb.shape[2]
    s = torch.matmul(qb.float(), kb.float().transpose(1, 2)) * (1.0 / math.sqrt(d))
    if causal:
        pos = torch.arange(seq, device=s.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(q.dtype).float(), vb.float())
    out = (acc / l_safe).to(q.dtype)
    if q.ndim == 4:
        b, _, h, _ = q.shape
        out = out.reshape(b, h, seq, d).permute(0, 2, 1, 3).contiguous()
    if with_lse:
        return out, m + torch.log(l_safe)
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    tensors = (q, k, v)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(
            "flash_attention_kernel needs q, k and v on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(
            f"flash_attention_kernel takes bf16, got {[t.dtype for t in tensors]}"
        )
    if q.ndim not in (3, 4) or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash_attention_kernel takes q, k, v of one shape, [b*h, s, d] or "
            f"[b, s, h, d], got {[tuple(t.shape) for t in tensors]}"
        )
    seq, d = q.shape[1], q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if seq <= 0 or seq % KV_TILE:
        raise ValueError(
            f"flash_attention_kernel needs seq a positive multiple of {KV_TILE}, got {seq}"
        )
    for t in tensors:
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(
                "flash_attention_kernel needs head_dim contiguous and every other "
                f"stride a multiple of 8 elements, got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError("flash_attention_kernel needs 16-byte aligned operands")


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, seq, head) element strides; a 3-D tensor has one head."""
    if t.ndim == 3:
        return t.stride(0), t.stride(1), 0
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    with_lse: bool = False,
):
    """Attention on the Hopper kernel: bf16 in, fp32 softmax, bf16 out, and
    with ``with_lse`` the [b*h, s, 1] fp32 logsumexp beside it.

    CPU tensors take ``flash_attention_reference``; CUDA tensors launch the
    kernel or raise — there is no fallback.  The output is contiguous in the
    input's layout."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_reference(q, k, v, causal, with_lse)
    _check(q, k, v)
    if q.ndim == 3:
        bh, seq, d = q.shape
        batch, heads = bh, 1
    else:
        batch, seq, heads, d = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch * heads, seq, 1), dtype=torch.float32, device=q.device)
        if with_lse
        else None
    )
    strides = (ctypes.c_int64 * 12)(*_strides(q), *_strides(k), *_strides(v), *_strides(o))
    index = q.device.index
    lib = _load(index)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), strides,
        batch, heads, seq, d, int(causal), 1.0 / math.sqrt(d), index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed with cudaError {err}")
    flash_attention_kernel.launches += 1
    return (o, lse) if with_lse else o


flash_attention_kernel.launches = 0


def flash_shape_supported(
    seq: int, head_dim: int, dtype: torch.dtype, block_q: int = 512, block_k: int = 512
) -> bool:
    """The kernel's envelope: bf16, head_dim 64 or 128, seq a positive
    multiple of the KV tile.  ``block_q``/``block_k`` change nothing (see
    the module's note)."""
    return (
        dtype == torch.bfloat16
        and head_dim in HEAD_DIMS
        and seq > 0
        and seq % KV_TILE == 0
    )


def flash_attention_supported(q: torch.Tensor, block_q: int = 512, block_k: int = 512) -> bool:
    """Tensor form of the envelope check, for [b, s, h, d] operands."""
    if q.ndim != 4:
        return False
    _, seq, _, d = q.shape
    return flash_shape_supported(seq, d, q.dtype, block_q, block_k)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Exact attention over [batch, seq, heads, head_dim], in and out: the
    kernel inside its envelope, ``reference_attention`` outside it or when
    q, k and v differ in shape, so callers never branch."""
    if q.shape != k.shape or q.shape != v.shape or not flash_attention_supported(
        q, block_q, block_k
    ):
        return reference_attention(q, k, v, causal=causal)
    return flash_attention_kernel(q, k, v, causal)
