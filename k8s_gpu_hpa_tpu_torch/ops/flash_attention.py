"""Flash attention, forward and backward, as hand-written Hopper kernels — the
hot op of the prefill and of the training step.

Counterpart of ``k8s_gpu_hpa_tpu/ops/flash_attention.py``.  Its Pallas
forward kernel ``_flash_kernel`` becomes ``csrc/flash_attention.cu`` and its
two backward kernels ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``
become ``csrc/flash_attention_bwd.cu`` for bf16 and f16 operands (wgmma on
the tensor cores; each source built once per type), and
``csrc/flash_attention_f32.cu`` and ``csrc/flash_attention_bwd_f32.cu`` for
f32 (FFMA on the CUDA cores): CUDA C++ for ``sm_90a``, each built with
``nvcc`` at first use into a library of its own, one per source and dtype,
with the same C entries, and bound with ctypes.  The sources state what
they replace and what bounds them.

Entry points:

- ``flash_attention_kernel(q, k, v, causal, with_lse=False)``: launches the
  forward kernel for CUDA tensors, on the consumer warpgroups a CTA that
  ``fwd_split`` picks for the grid, and raises on anything it does not
  take.
  For CPU tensors it computes ``flash_attention_reference`` instead — the
  only case in which the plain version stands in.
  ``flash_attention_kernel.launches`` counts launches, and
  ``.launches_by_dtype`` the same by dtype name.  Operands are
  [b*h, s, d], or [b, s, h, d] with any strides whose last is 1 (the
  transformer hands it views of its fused QKV projection, copied nowhere).
- ``flash_attention_bwd_kernel(q, k, v, o, lse, do, causal)``: dQ, dK and dV
  on the two backward kernels, the same way round: kernels for CUDA tensors,
  ``flash_attention_bwd_reference`` for CPU tensors.  It counts its launches
  in ``.dq_launches`` and ``.dkv_launches``, and by dtype name in
  ``.dq_launches_by_dtype`` and ``.dkv_launches_by_dtype``.
- ``FlashAttention``: the ``torch.autograd.Function`` over both, the
  counterpart of the JAX ``custom_vjp`` ``_flash_bhsd_diff``.  It saves
  (q, k, v, o, lse) and asks the forward for the logsumexp only when a
  gradient is needed, so inference launches the forward as before.
- ``flash_attention(q, k, v, causal, block_q, block_k)``: the dispatcher of
  the JAX package's public contract.  Inside the envelope it takes
  ``FlashAttention``; for mismatched q/k/v shapes or a shape or dtype outside
  the envelope it takes ``reference_attention``, which autograd
  differentiates.

The envelope is the Hopper kernels', not the TPU's, and it is per dtype
(``head_dim_supported``): the fixed-width instantiations' head_dims
(``HEAD_DIMS``: 64, 128, 256, 384 and 512 in bf16 and f16; 64, 128 and 256
in f32), and from ``STREAMED_FROM`` on (640 in bf16 and f16, 384 in f32)
every multiple of 128, with no upper width; and a sequence that is a
positive multiple of the 64-row tile.  There is no stripe cap, because the
kernels stream tiles through shared memory instead of holding a
batch-head's whole stripe.  So it contains the TPU kernel's envelope
(head_dim a multiple of 128, a sequence some 64-aligned block divides,
within a 12 MiB K/V stripe) in every dtype, and adds head_dim 64.  At
head_dim 384 and 512 in bf16 and f16 each kernel splits its output's
columns across CTAs (chunks: half of O's and dQ's, a 128 of dK's and
dV's).  From ``STREAMED_FROM`` on each kernel runs the streamed tiling: a
CTA owns 128 of its output's columns, sums the scores over the head_dim in
a runtime loop of 128-column chunks streamed through shared memory, and
then runs the owned-column product; head_dim is a kernel argument, so one
instantiation takes every width.  In both, every chunk recomputes the
scores over the whole head_dim, but for the f32 backward from 384 to 1024
(``CLUSTER_HEAD_DIMS``): there the head_dim / 128 CTAs of a (batch-head,
64-row tile) form a thread-block cluster, each computes the scores' part
over its own columns, and the cluster sums the parts through distributed
shared memory, so that each score tile is computed once.  A call is still
one launch.  The kernels' tiles are fixed; ``block_q`` and ``block_k`` are
the TPU kernel's tile sizes, accepted so that callers keep the JAX
signature, and change nothing here.
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
F32_SOURCE = CSRC / "flash_attention_f32.cu"
BWD_F32_SOURCE = CSRC / "flash_attention_bwd_f32.cu"
#: the headers the wgmma sources include: the TMA, wgmma and descriptor
#: layer, the element type and the tensor maps
HEADERS = (CSRC / "hopper_ptx.cuh", CSRC / "elem.cuh", CSRC / "smem_desc.cuh",
           CSRC / "tensor_map.cuh")
#: the headers the f32 sources include: the FFMA tile products, and the PTX
#: layer (the backward's cluster barrier and loads from a peer's shared
#: memory) with the element type it includes
F32_HEADERS = (CSRC / "ffma_tiles.cuh", CSRC / "hopper_ptx.cuh", CSRC / "elem.cuh")
#: the kernels' dtypes by name: the name of each library and count
DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
#: rows of a CTA's own tile; the sequence must be a multiple
KV_TILE = 64
#: the head_dims of each dtype's fixed-width instantiations: the wgmma
#: sources' five (at 384 and 512 the chunked tilings), the f32 FFMA sources'
#: three
HEAD_DIMS = {torch.bfloat16: (64, 128, 256, 384, 512), torch.float16: (64, 128, 256, 384, 512),
             torch.float32: (64, 128, 256)}
#: the streamed tilings' columns a CTA, and the chunk of the head_dim their
#: score products step over: they take every multiple of it
STREAMED_COLS = 128
#: from this head_dim on, each dtype's kernels run the streamed tiling
STREAMED_FROM = {torch.bfloat16: 640, torch.float16: 640, torch.float32: 384}
#: the head_dims at which the f32 backward's CTAs of a (batch-head, 64-row
#: tile) form a cluster (of head_dim / 128, at most the portable 8) and share
#: the score tiles (csrc/flash_attention_bwd_f32.cu); past them it streams
CLUSTER_HEAD_DIMS = range(384, 1025, STREAMED_COLS)
#: the forward's consumer warpgroups a CTA of 64 Q rows, which take turns
#: over its K/V tiles: one (two CTAs an SM) or two (one CTA an SM)
FWD_SPLITS = (1, 2)
#: the backward kernels, each on two consumer warpgroups a CTA of 64 rows
#: that take turns over the ring's tiles: K/V tiles for dQ, Q tiles for
#: dK/dV (at head_dim 256 dK/dV's split dV and dK instead; at 384 and 512
#: one warpgroup a CTA)
BWD_KERNELS = ("dq", "dkv")

_PTR, _INT, _I64P = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
#: the tail every launch entry takes: batch, heads, seq, head_dim, causal,
#: scale, device, stream
_TAIL = [_INT, _INT, _INT, _INT, _INT, ctypes.c_float, _INT, _PTR]


class _Library:
    """One kernel source's libraries, one per dtype: each built at first
    use, loaded with ctypes, and its shared-memory opt-in made once per
    device.  Every library of a source has the same C entries.

    The opt-in is a device attribute call, which CUDA-graph capture does not
    allow, so it happens at the first launch on each device and never inside
    a launch."""

    def __init__(self, stem: str, wgmma: Path, f32: Path, init: str, entries: dict[str, list]):
        self.stem, self.init, self.entries = stem, init, entries
        self.sources = {torch.bfloat16: wgmma, torch.float16: wgmma, torch.float32: f32}
        self._libs: dict[torch.dtype, ctypes.CDLL] = {}
        self._ready: set[tuple[torch.dtype, int]] = set()

    def build(self, dtype: torch.dtype = torch.bfloat16) -> tuple[Path, str]:
        """Compile the source of ``dtype`` if needed (f16 is the bf16 source
        built with ``ELEM_F16``); returns (library, nvcc output)."""
        f32 = dtype == torch.float32
        flags = ["-DELEM_F16"] if dtype == torch.float16 else []
        return build_shared(f"{self.stem}_{DTYPES[dtype]}.so", [self.sources[dtype]],
                            [nvcc(), *NVCC_FLAGS, *flags], F32_HEADERS if f32 else HEADERS)

    def load(self, dtype: torch.dtype, device: int) -> ctypes.CDLL:
        if dtype not in self._libs:
            lib = ctypes.CDLL(str(self.build(dtype)[0]))
            for entry, argtypes in {self.init: [_INT], **self.entries}.items():
                getattr(lib, entry).restype = ctypes.c_int
                getattr(lib, entry).argtypes = argtypes
            self._libs[dtype] = lib
        if (dtype, device) not in self._ready:
            err = getattr(self._libs[dtype], self.init)(device)
            if err:
                raise RuntimeError(f"{self.init} ({DTYPES[dtype]}) failed with cudaError {err}")
            self._ready.add((dtype, device))
        return self._libs[dtype]


_FWD = _Library(
    "libflash_attention", SOURCE, F32_SOURCE, "flash_attention_init",
    {"flash_attention_fwd": [_PTR, _PTR, _PTR, _PTR, _PTR, _I64P, _INT, *_TAIL],
     "flash_attention_config": [_INT, _INT, ctypes.POINTER(ctypes.c_int), _INT]},
)
_BWD = _Library(
    "libflash_attention_bwd", BWD_SOURCE, BWD_F32_SOURCE, "flash_attention_bwd_init",
    {
        "flash_attention_bwd_dq": [_PTR] * 7 + [_I64P, *_TAIL],
        "flash_attention_bwd_dkv": [_PTR] * 8 + [_I64P, *_TAIL],
        "flash_attention_bwd_config": [_INT, _INT, ctypes.POINTER(ctypes.c_int), _INT],
    },
)


def build(dtype: torch.dtype = torch.bfloat16) -> tuple[Path, str]:
    """Compile the forward of ``dtype`` if needed; returns (library, nvcc output)."""
    return _FWD.build(dtype)


def streamed(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether ``dtype``'s kernels run the streamed tiling at ``head_dim``."""
    return head_dim >= STREAMED_FROM[dtype]


def head_dim_supported(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether ``dtype``'s kernels take ``head_dim``: a fixed-width
    instantiation's (``HEAD_DIMS``), or from ``STREAMED_FROM`` on any
    multiple of ``STREAMED_COLS``."""
    return dtype in DTYPES and (
        head_dim in HEAD_DIMS[dtype]
        or (streamed(head_dim, dtype) and head_dim % STREAMED_COLS == 0)
    )


def fwd_splits(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> tuple[int, ...]:
    """The forward's instantiations at ``head_dim`` and ``dtype``, by
    consumer warpgroups a CTA: ``FWD_SPLITS``, or one alone from 256 on,
    where a 64-row tile is 32 KB or more and two warpgroups' ring and
    hand-over do not fit an SM's shared memory (csrc/flash_attention.cu),
    and in f32, whose kernel has one tiling (csrc/flash_attention_f32.cu);
    the streamed tilings have one too."""
    return (1,) if head_dim >= 256 or dtype == torch.float32 else FWD_SPLITS


def fwd_split(batch_heads: int, seq: int, sms: int, head_dim: int,
              dtype: torch.dtype = torch.bfloat16) -> int:
    """The forward's consumer warpgroups a CTA on a card of ``sms`` SMs,
    from ``fwd_splits(head_dim, dtype)``: two, which split each CTA's K/V
    tiles, where the kernel has that tiling and the 64-row CTAs do not
    outnumber the SMs (the training shape, 4 batch-heads of 2048: 128 CTAs),
    so that each SM runs two warpgroups; else one."""
    two = 2 in fwd_splits(head_dim, dtype) and batch_heads * (seq // KV_TILE) <= sms
    return 2 if two else 1


def fwd_config(head_dim: int, kv_split: int, device: int = 0,
               dtype: torch.dtype = torch.bfloat16) -> dict[str, int]:
    """The forward instantiation's configuration, as the library of
    ``dtype`` reports it: threads, ring stages, CTAs an SM, dynamic shared
    memory in bytes, CTAs a (batch-head, Q tile) (``chunks`` of O's
    columns: 2 at head_dim 384 and 512 in bf16 and f16, head_dim / 128 on
    the streamed tiling, else 1) and K/V rows a tile."""
    keys = ("threads", "stages", "ctas_per_sm", "smem_bytes", "chunks", "kv_rows")
    out = (ctypes.c_int * len(keys))()
    n = _FWD.load(dtype, device).flash_attention_config(head_dim, kv_split, out, len(keys))
    if n != len(keys):
        raise ValueError(f"no {DTYPES[dtype]} forward instantiation for head_dim {head_dim}, "
                         f"kv_split {kv_split}")
    return dict(zip(keys, out))


def build_bwd(dtype: torch.dtype = torch.bfloat16) -> tuple[Path, str]:
    """Compile the backward of ``dtype`` if needed; returns (library, nvcc output)."""
    return _BWD.build(dtype)


def bwd_config(kernel: str, head_dim: int, device: int = 0,
               dtype: torch.dtype = torch.bfloat16) -> dict[str, int]:
    """A backward instantiation's configuration (``kernel`` one of
    ``BWD_KERNELS``), as the library of ``dtype`` reports it: threads, ring
    stages, dynamic shared memory in bytes (one CTA an SM), the producer's
    and the consumers' registers under ``setmaxnreg`` (0 without it), CTAs
    a (batch-head, 64-row tile) (``chunks`` of the output's columns: at
    head_dim 384 and 512 in bf16 and f16 dQ's 2, dK/dV's 3 and 4, on the
    streamed tiling head_dim / 128, in f32 from 384 to 1024 the CTAs of a
    cluster, head_dim / 128, else 1) and rows a streamed tile."""
    keys = ("threads", "stages", "smem_bytes", "producer_regs", "consumer_regs", "chunks",
            "stream_rows")
    out = (ctypes.c_int * len(keys))()
    n = _BWD.load(dtype, device).flash_attention_bwd_config(
        BWD_KERNELS.index(kernel), head_dim, out, len(keys))
    if n != len(keys):
        raise ValueError(f"no {DTYPES[dtype]} {kernel} instantiation for head_dim {head_dim}")
    return dict(zip(keys, out))


def bwd_max_clusters(kernel: str, head_dim: int, device: int = 0) -> int:
    """The most clusters of the f32 backward ``kernel`` (one of
    ``BWD_KERNELS``) at ``head_dim`` (in ``CLUSTER_HEAD_DIMS``) that the
    card holds at once, as ``cudaOccupancyMaxActiveClusters`` reports it."""
    lib = _BWD.load(torch.float32, device)
    entry = lib.flash_attention_bwd_max_clusters
    entry.argtypes, entry.restype = [_INT, _INT, _INT, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    clusters = ctypes.c_int(0)
    err = entry(BWD_KERNELS.index(kernel), head_dim, device, ctypes.byref(clusters))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters ({kernel}, head_dim {head_dim}) "
                           f"failed with cudaError {err}")
    return clusters.value


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
    """Raises unless the operands suit the kernels: one CUDA device, one
    dtype of ``DTYPES``, one shape, [b*h, s, d] or [b, s, h, d], a head_dim
    the dtype's kernels take (``head_dim_supported``), seq a positive
    multiple of the tile, head_dim contiguous and every other stride a
    multiple of 8 elements, 16-byte aligned."""
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"{name} needs its operands on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if tensors[0].dtype not in DTYPES or any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError(f"{name} takes operands of one of {[str(d) for d in DTYPES]}, got "
                        f"{[t.dtype for t in tensors]}")
    q = tensors[0]
    if q.ndim not in (3, 4) or any(t.shape != q.shape for t in tensors):
        raise ValueError(
            f"{name} takes operands of one shape, [b*h, s, d] or [b, s, h, d], got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    seq, d = q.shape[1], q.shape[-1]
    if not head_dim_supported(d, q.dtype):
        raise ValueError(f"{name} takes {DTYPES[q.dtype]} operands of head_dim in "
                         f"{HEAD_DIMS[q.dtype]} or a multiple of {STREAMED_COLS} from "
                         f"{STREAMED_FROM[q.dtype]} on, got {d}")
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
    """Attention on the Hopper kernel of the operands' dtype (bf16, f16 or
    f32 in, fp32 softmax, the same dtype out), and with ``with_lse`` the
    [b*h, s, 1] fp32 logsumexp beside it.

    CPU tensors take ``flash_attention_reference``; CUDA tensors launch the
    kernel or raise — there is no fallback.  The output is contiguous in the
    input's layout."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_reference(q, k, v, causal, with_lse)
    _check("flash_attention_kernel", (q, k, v))
    batch, seq, heads, d = _dims(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return _launch_fwd(q, k, v, causal, with_lse,
                       fwd_split(batch * heads, seq, sms, d, q.dtype))


def _launch_fwd(q, k, v, causal: bool, with_lse: bool, kv_split: int):
    """The forward kernel on operands ``_check`` has passed, on ``kv_split``
    consumer warpgroups a CTA (one of ``fwd_splits(head_dim, dtype)``;
    each computes the same), counted in ``flash_attention_kernel.launches``
    and ``.launches_by_dtype``.
    ``flash_attention_kernel`` calls it with ``fwd_split``'s choice;
    ``chip_smoke.py`` calls it with each to hold each to the plain
    version."""
    batch, seq, heads, d = _dims(q)
    splits = fwd_splits(d, q.dtype)
    if kv_split not in splits:
        raise ValueError(f"the {DTYPES[q.dtype]} forward takes kv_split in {splits} at "
                         f"head_dim {d}, got {kv_split}")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch * heads, seq, 1), dtype=torch.float32, device=q.device)
        if with_lse
        else None
    )
    index = q.device.index
    err = _FWD.load(q.dtype, index).flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), _strides(q, k, v, o), kv_split,
        batch, heads, seq, d, int(causal), 1.0 / math.sqrt(d), index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed with cudaError {err}")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by_dtype[DTYPES[q.dtype]] += 1
    return (o, lse) if with_lse else o


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by_dtype = dict.fromkeys(DTYPES.values(), 0)


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
    entry = getattr(_BWD.load(q.dtype, index), f"flash_attention_bwd_{kernel}")
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
    getattr(flash_attention_bwd_kernel, f"{counter}_by_dtype")[DTYPES[q.dtype]] += 1
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
flash_attention_bwd_kernel.dq_launches_by_dtype = dict.fromkeys(DTYPES.values(), 0)
flash_attention_bwd_kernel.dkv_launches_by_dtype = dict.fromkeys(DTYPES.values(), 0)


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
    """The kernels' envelope: a head_dim the dtype's kernels take
    (``head_dim_supported``: bf16 or f16 at 64-512 and every multiple of
    128 from 640 on, f32 at 64, 128, 256 and every multiple of 128 from 384
    on), seq a positive multiple of the tile.  ``block_q``/``block_k``
    change nothing (see the module's note)."""
    return head_dim_supported(head_dim, dtype) and seq > 0 and seq % KV_TILE == 0


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
