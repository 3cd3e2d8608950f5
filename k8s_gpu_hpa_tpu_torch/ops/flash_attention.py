"""Flash attention, forward and backward, as hand-written Hopper kernels — the
hot op of the prefill and of the training step.

Counterpart of ``k8s_gpu_hpa_tpu/ops/flash_attention.py``.  Its Pallas
forward kernel ``_flash_kernel`` becomes ``csrc/flash_attention.cu`` and its
two backward kernels ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``
become ``csrc/flash_attention_bwd.cu``: CUDA C++ for ``sm_90a``, each built
with ``nvcc`` at first use into a library of its own and bound with ctypes.
The sources state what they replace and what bounds them.

Entry points:

- ``flash_attention_kernel(q, k, v, causal, with_lse=False)``: launches the
  forward kernel for CUDA tensors, on the consumer warpgroups a CTA that
  ``fwd_split`` picks for the grid, and raises on anything it does not
  take.
  For CPU tensors it computes ``flash_attention_reference`` instead — the
  only case in which the plain version stands in.
  ``flash_attention_kernel.launches`` counts launches.  Operands are
  [b*h, s, d], or [b, s, h, d] with any strides whose last is 1 (the
  transformer hands it views of its fused QKV projection, copied nowhere).
- ``flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)``: dQ, dK and dV
  on the two backward kernels, the same way round: kernels for CUDA tensors,
  ``flash_attention_bwd_reference`` for CPU tensors.  It counts its launches
  in ``.dq_launches`` and ``.dkv_launches``.
- ``FlashAttention``: the ``torch.autograd.Function`` over both, the
  counterpart of the JAX ``custom_vjp`` ``_flash_bhsd_diff``.  It saves
  (q, k, v, o, lse) and asks the forward for the logsumexp only when a
  gradient is needed, so inference launches the forward as before.
- ``flash_attention(q, k, v, causal, block_q, block_k)``: the dispatcher of
  the JAX package's public contract.  Inside the envelope it takes
  ``FlashAttention``; for mismatched q/k/v shapes or a shape or dtype outside
  the envelope it takes ``reference_attention``, which autograd
  differentiates.

The envelope is the Hopper kernels', not the TPU's: bf16, head_dim 64 or
128, and a sequence that is a positive multiple of the 64-row KV tile.
There is no stripe cap, because the kernels stream tiles through shared
memory instead of holding a batch-head's whole stripe.  The kernels' tiles
are fixed; ``block_q`` and ``block_k`` are the TPU kernel's tile sizes,
accepted so that callers keep the JAX signature, and change nothing here.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from k8s_gpu_hpa_tpu_torch.ops.ring_attention import NEG_INF, reference_attention
from k8s_gpu_hpa_tpu_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"
#: the headers the sources include: the TMA, wgmma and descriptor layer and
#: the tensor maps
HEADERS = (CSRC / "hopper_ptx.cuh", CSRC / "smem_desc.cuh", CSRC / "tensor_map.cuh")
#: K/V rows per tile of the kernels; the sequence must be a multiple
KV_TILE = 64
HEAD_DIMS = (64, 128)
#: the forward's consumer warpgroups a CTA of 64 Q rows, which take turns
#: over its K/V tiles: one (two CTAs an SM) or two (one CTA an SM)
FWD_SPLITS = (1, 2)
#: the backward kernels, each on two consumer warpgroups a CTA of 64 rows
#: that take turns over the ring's tiles: K/V tiles for dQ, Q tiles for dK/dV
BWD_KERNELS = ("dq", "dkv")

_PTR, _INT, _I64P = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
#: the tail every launch entry takes: batch, heads, seq, head_dim, causal,
#: scale, device, stream
_TAIL = [_INT, _INT, _INT, _INT, _INT, ctypes.c_float, _INT, _PTR]


class _Library:
    """One kernel library: built at first use, loaded with ctypes, and its
    shared-memory opt-in made once per device.

    The opt-in is a device attribute call, which CUDA-graph capture does not
    allow, so it happens at the first launch on each device and never inside
    a launch."""

    def __init__(self, name: str, source: Path, init: str, entries: dict[str, list]):
        self.name, self.source, self.init, self.entries = name, source, init, entries
        self._lib: ctypes.CDLL | None = None
        self._ready: set[int] = set()

    def build(self) -> tuple[Path, str]:
        """Compile the source if needed; returns (library, nvcc output)."""
        return build_shared(self.name, [self.source], [nvcc(), *NVCC_FLAGS], HEADERS)

    def load(self, device: int) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()[0]))
            for entry, argtypes in {self.init: [_INT], **self.entries}.items():
                getattr(lib, entry).restype = ctypes.c_int
                getattr(lib, entry).argtypes = argtypes
            self._lib = lib
        if device not in self._ready:
            err = getattr(self._lib, self.init)(device)
            if err:
                raise RuntimeError(f"{self.init} failed with cudaError {err}")
            self._ready.add(device)
        return self._lib


_FWD = _Library(
    "libflash_attention.so", SOURCE, "flash_attention_init",
    {"flash_attention_fwd": [_PTR, _PTR, _PTR, _PTR, _PTR, _I64P, _INT, *_TAIL],
     "flash_attention_config": [_INT, _INT, ctypes.POINTER(ctypes.c_int), _INT]},
)
_BWD = _Library(
    "libflash_attention_bwd.so", BWD_SOURCE, "flash_attention_bwd_init",
    {
        "flash_attention_bwd_dq": [_PTR] * 7 + [_I64P, *_TAIL],
        "flash_attention_bwd_dkv": [_PTR] * 8 + [_I64P, *_TAIL],
        "flash_attention_bwd_config": [_INT, _INT, ctypes.POINTER(ctypes.c_int), _INT],
    },
)


def build() -> tuple[Path, str]:
    """Compile ``csrc/flash_attention.cu`` if needed; returns (library, nvcc output)."""
    return _FWD.build()


def fwd_split(batch_heads: int, seq: int, sms: int) -> int:
    """The forward's consumer warpgroups a CTA on a card of ``sms`` SMs,
    from ``FWD_SPLITS``: two, which split each CTA's K/V tiles, where the
    64-row CTAs do not outnumber the SMs (the training shape, 4
    batch-heads of 2048: 128 CTAs), so that each SM runs two warpgroups;
    else one (two CTAs an SM)."""
    return 2 if batch_heads * (seq // KV_TILE) <= sms else 1


def fwd_config(head_dim: int, kv_split: int, device: int = 0) -> dict[str, int]:
    """The forward instantiation's configuration, as the library reports
    it: threads, ring stages, CTAs an SM, dynamic shared memory in bytes."""
    out = (ctypes.c_int * 4)()
    n = _FWD.load(device).flash_attention_config(head_dim, kv_split, out, 4)
    if n != 4:
        raise ValueError(f"no forward instantiation for head_dim {head_dim}, kv_split {kv_split}")
    return dict(zip(("threads", "stages", "ctas_per_sm", "smem_bytes"), out))


def build_bwd() -> tuple[Path, str]:
    """Compile ``csrc/flash_attention_bwd.cu`` if needed; returns (library, nvcc output)."""
    return _BWD.build()


def bwd_config(kernel: str, head_dim: int, device: int = 0) -> dict[str, int]:
    """A backward instantiation's configuration (``kernel`` one of
    ``BWD_KERNELS``), as the library reports it: threads, ring stages,
    dynamic shared memory in bytes (one CTA an SM), and the producer's and
    the consumers' registers under ``setmaxnreg`` (0 without it)."""
    keys = ("threads", "stages", "smem_bytes", "producer_regs", "consumer_regs")
    out = (ctypes.c_int * len(keys))()
    n = _BWD.load(device).flash_attention_bwd_config(
        BWD_KERNELS.index(kernel), head_dim, out, len(keys))
    if n != len(keys):
        raise ValueError(f"no {kernel} instantiation for head_dim {head_dim}")
    return dict(zip(keys, out))


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """[b, s, h, d] -> [b*h, s, d]; a 3-D operand is already so."""
    if x.ndim == 3:
        return x
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _bshd_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[b*h, s, d] back to ``like``'s layout, contiguous."""
    if like.ndim == 3:
        return x
    b, s, h, d = like.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3).contiguous()


def _scores(qb: torch.Tensor, kb: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 Q K^T times 1/sqrt(d), masked with -1e30 when causal."""
    seq, d = qb.shape[1], qb.shape[2]
    s = torch.matmul(qb.float(), kb.float().transpose(1, 2)) * (1.0 / math.sqrt(d))
    if causal:
        pos = torch.arange(seq, device=s.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    return s


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
    s = _scores(_bhsd(q), _bhsd(k), causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(q.dtype).float(), _bhsd(v).float())
    out = _bshd_like((acc / l_safe).to(q.dtype), q)
    if with_lse:
        return out, m + torch.log(l_safe)
    return out


def flash_attention_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO O)`` in fp32 as [b*h, s, 1], contiguous: the
    work both backward kernels share, one reduction in PyTorch as the JAX
    package leaves it to XLA."""
    delta = (do.float() * o.float()).sum(dim=-1)  # [b, s, h] or [b*h, s]
    if o.ndim == 4:
        delta = delta.transpose(1, 2)
    return delta.reshape(-1, o.shape[1], 1).contiguous()


def _bwd_terms(q, k, v, do, lse, delta, causal):
    """The recomputed P = exp(S - lse) under the -1e30 mask and dS = P (dP -
    delta) / sqrt(d) rounded to the operands' dtype, both fp32 [b*h, s, s],
    with the fp32 [b*h, s, d] operands."""
    qb, kb, vb, dob = (_bhsd(t).float() for t in (q, k, v, do))
    p = torch.exp(_scores(qb, kb, causal) - lse)
    dp = torch.matmul(dob, vb.transpose(1, 2))
    ds = (p * (dp - delta) * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype).float()
    return p, ds, qb, kb, dob


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ = dS K, summed in fp32 and rounded
    once, in q's layout."""
    _, ds, _, kb, _ = _bwd_terms(q, k, v, do, lse, delta, causal)
    return _bshd_like(torch.matmul(ds, kb).to(q.dtype), q)


def flash_attention_bwd_dkv_reference(
    q, k, v, do, lse, delta, causal: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: dK = dS^T Q and dV = P^T dO with P
    rounded to the operands' dtype, each summed in fp32 and rounded once."""
    p, ds, qb, _, dob = _bwd_terms(q, k, v, do, lse, delta, causal)
    dk = torch.matmul(ds.transpose(1, 2), qb).to(q.dtype)
    dv = torch.matmul(p.to(q.dtype).float().transpose(1, 2), dob).to(q.dtype)
    return _bshd_like(dk, q), _bshd_like(dv, q)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels, as the JAX package's
    Pallas pair computes them: ``delta = rowsum(dO O)`` in fp32; P =
    exp(S - lse) recomputed from fp32 scores under the -1e30 mask; dP = dO
    V^T in fp32; dS = P (dP - delta) / sqrt(d) rounded to the operands'
    dtype; dQ = dS K, dK = dS^T Q and dV = P^T dO with P rounded to the
    operands' dtype, each summed in fp32 and rounded once.  ``lse`` is the
    forward's [b*h, s, 1] fp32 logsumexp; the gradients come back in q's
    layout, contiguous."""
    delta = flash_attention_bwd_delta(o, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    return (dq, *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal))


def _check(name: str, tensors: tuple[torch.Tensor, ...]) -> None:
    """Raises unless the bf16 operands suit the kernels: one CUDA device, one
    shape, [b*h, s, d] or [b, s, h, d], head_dim 64 or 128, seq a positive
    multiple of the KV tile, head_dim contiguous and every other stride a
    multiple of 8 elements, 16-byte aligned."""
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"{name} needs its operands on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{name} takes bf16, got {[t.dtype for t in tensors]}")
    q = tensors[0]
    if q.ndim not in (3, 4) or any(t.shape != q.shape for t in tensors):
        raise ValueError(
            f"{name} takes operands of one shape, [b*h, s, d] or [b, s, h, d], got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    seq, d = q.shape[1], q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got {d}")
    if seq <= 0 or seq % KV_TILE:
        raise ValueError(f"{name} needs seq a positive multiple of {KV_TILE}, got {seq}")
    for t in tensors:
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(
                f"{name} needs head_dim contiguous and every other stride a multiple "
                f"of 8 elements, got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned operands")


def _dims(q: torch.Tensor) -> tuple[int, int, int, int]:
    """(batch, seq, heads, head_dim); a 3-D tensor has one head."""
    if q.ndim == 3:
        bh, seq, d = q.shape
        return bh, seq, 1, d
    return tuple(q.shape)


def _strides(*tensors: torch.Tensor):
    """(batch, seq, head) element strides of each tensor, as a C array; a
    3-D tensor has one head."""
    flat = []
    for t in tensors:
        flat += [t.stride(0), t.stride(1), 0 if t.ndim == 3 else t.stride(2)]
    return (ctypes.c_int64 * len(flat))(*flat)


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
    _check("flash_attention_kernel", (q, k, v))
    batch, seq, heads, _ = _dims(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return _launch_fwd(q, k, v, causal, with_lse, fwd_split(batch * heads, seq, sms))


def _launch_fwd(q, k, v, causal: bool, with_lse: bool, kv_split: int):
    """The forward kernel on operands ``_check`` has passed, on ``kv_split``
    consumer warpgroups a CTA (one of ``FWD_SPLITS``; each computes the
    same), counted in ``flash_attention_kernel.launches``.
    ``flash_attention_kernel`` calls it with ``fwd_split``'s choice;
    ``chip_smoke.py`` calls it with each to hold both to the plain
    version."""
    if kv_split not in FWD_SPLITS:
        raise ValueError(f"the forward takes kv_split in {FWD_SPLITS}, got {kv_split}")
    batch, seq, heads, d = _dims(q)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch * heads, seq, 1), dtype=torch.float32, device=q.device)
        if with_lse
        else None
    )
    index = q.device.index
    err = _FWD.load(index).flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), _strides(q, k, v, o), kv_split,
        batch, heads, seq, d, int(causal), 1.0 / math.sqrt(d), index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed with cudaError {err}")
    flash_attention_kernel.launches += 1
    return (o, lse) if with_lse else o


flash_attention_kernel.launches = 0


def flash_attention_bwd_launch(
    kernel: str, q, k, v, do, lse, delta, causal: bool
) -> tuple[torch.Tensor, ...]:
    """One backward kernel, ``"dq"`` or ``"dkv"``, on operands that
    ``flash_attention_bwd_kernel`` has checked; ``delta`` is
    ``flash_attention_bwd_delta(o, do)``.  Returns (dq,) or (dk, dv), fresh
    and contiguous in q's layout, and counts the launch."""
    batch, seq, heads, d = _dims(q)
    n_out = {"dq": 1, "dkv": 2}[kernel]
    outs = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(n_out))
    index = q.device.index
    entry = getattr(_BWD.load(index), f"flash_attention_bwd_{kernel}")
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in outs),
        # the dq entry reads the first output's strides, the dkv entry both
        _strides(q, k, v, do, outs[0], outs[0], outs[-1]),
        batch, heads, seq, d, int(causal), 1.0 / math.sqrt(d), index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_bwd_{kernel} launch failed with cudaError {err}")
    counter = f"{kernel}_launches"
    setattr(flash_attention_bwd_kernel, counter, getattr(flash_attention_bwd_kernel, counter) + 1)
    return outs


def flash_attention_bwd_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of ``o = flash_attention_kernel(q, k, v, causal)`` for
    the output gradient ``do``, from the forward's logsumexp ``lse``
    ([b*h, s, 1] fp32): ``delta``, then the dQ kernel, then the dK/dV
    kernel.

    CPU tensors take ``flash_attention_bwd_reference``; CUDA tensors launch
    the kernels or raise — there is no fallback.  The gradients are
    contiguous in q's layout."""
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    name = "flash_attention_bwd_kernel"
    _check(name, (q, k, v, o, do))
    batch, seq, heads, _ = _dims(q)
    if (
        lse.dtype != torch.float32
        or lse.shape != (batch * heads, seq, 1)
        or not lse.is_contiguous()
        or lse.device != q.device
    ):
        raise ValueError(
            f"{name} needs lse as contiguous [{batch * heads}, {seq}, 1] fp32 on "
            f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )
    delta = flash_attention_bwd_delta(o, do)
    (dq,) = flash_attention_bwd_launch("dq", q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_launch("dkv", q, k, v, do, lse, delta, causal)
    return dq, dk, dv


flash_attention_bwd_kernel.dq_launches = 0
flash_attention_bwd_kernel.dkv_launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable attention on the kernels: the forward kernel, and the
    two backward kernels for the gradient, the counterpart of the JAX
    ``custom_vjp`` ``_flash_bhsd_diff``.  ``apply(q, k, v, causal)`` takes
    what ``flash_attention_kernel`` takes, and on CPU tensors runs the plain
    versions of both directions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if not any(ctx.needs_input_grad[:3]):
            # inference: the launch the serve path and its CUDA graph make
            return flash_attention_kernel(q, k, v, causal)
        o, lse = flash_attention_kernel(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over an expanded or strided gradient
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_shape_supported(
    seq: int, head_dim: int, dtype: torch.dtype, block_q: int = 512, block_k: int = 512
) -> bool:
    """The kernels' envelope: bf16, head_dim 64 or 128, seq a positive
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
    """Exact attention over [batch, seq, heads, head_dim], in and out, and
    differentiable: the kernels (``FlashAttention``) inside their envelope,
    ``reference_attention`` outside it or when q, k and v differ in shape,
    so callers never branch.  With grad mode off the forward kernel is
    called directly: a Function's forward cannot see that mode."""
    if q.shape != k.shape or q.shape != v.shape or not flash_attention_supported(
        q, block_q, block_k
    ):
        return reference_attention(q, k, v, causal=causal)
    if not torch.is_grad_enabled():
        return flash_attention_kernel(q, k, v, causal)
    return FlashAttention.apply(q, k, v, causal)
