"""Tiled matmul as hand-written Hopper kernels — the loadgen's hot op.

Counterpart of ``k8s_gpu_hpa_tpu/ops/pallas_matmul.py``.  The reference's
load generator is a CUDA binary (vectorAdd, cuda-test-deployment.yaml:18-19);
its analog must keep the card busy, and this module owns that hot loop with
kernels of its own, CUDA C++ for ``sm_90a``, each built with ``nvcc`` at
first use into a library of its own and bound with ctypes: bf16 and f16 from
``csrc/matmul.cu`` (wgmma on the tensor cores; one build per type), f32 from
``csrc/matmul_f32.cu`` (FFMA on the CUDA cores).  Every library has the
same C entries.  The sources state which Pallas kernels they replace and
what bounds them.

Four entry points:

- ``matmul_kernel(a, b)``: launches the CUDA kernel of the operands' dtype
  (bf16, f16 or f32) for CUDA tensors and raises on anything it does not
  take.  For CPU tensors it computes ``matmul_reference`` instead — the
  only case in which the plain version stands in.
  ``matmul_kernel.launches`` counts launches, and
  ``matmul_kernel.launches_by_dtype`` the same by dtype name.
- ``matmul_reference(a, b)``: the plain PyTorch version, fp32 accumulation
  cast to the input dtype.
- ``matmul(a, b, use_kernel=True)``: the dispatcher.  The kernel runs only
  for 2-D operands whose dims are all multiples of 128; anything else goes
  to ``torch.matmul``.
- ``kernel_config(dtype)``: a kernel's tile, pipeline, register and
  shared-memory configuration, as its library reports it, for reports.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from k8s_gpu_hpa_tpu_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "matmul.cu"
F32_SOURCE = CSRC / "matmul_f32.cu"
#: the PTX layer, the element type and the descriptor helpers the wgmma
#: source includes
HEADERS = (CSRC / "hopper_ptx.cuh", CSRC / "elem.cuh", CSRC / "smem_desc.cuh")
#: every dim must be a multiple of this: the kernels' tile rows, and half the
#: wgmma kernel's tile columns (a 128-column remainder is read through TMA's
#: zero fill)
ALIGN = 128
#: the kernels' dtypes by name: the name of each library and count
DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
#: names of the values ``matmul_config`` reports, in its order: the wgmma
#: kernel's, and the f32 kernel's
CONFIG_KEYS = ("tile_m", "tile_n", "tile_k", "stages", "consumer_warpgroups",
               "producer_regs", "consumer_regs", "smem_bytes", "group_m")
F32_CONFIG_KEYS = ("tile_m", "tile_n", "tile_k", "stages", "threads", "smem_bytes")
_INT, _PTR = ctypes.c_int, ctypes.c_void_p
#: every library's C entries and their argument types
ENTRIES = {
    "matmul_init": [_INT],
    "matmul_config": [ctypes.POINTER(_INT), _INT],
    # a, b, c, m, n, k, device, stream
    "matmul_launch": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR],
}


def sources(dtype: torch.dtype = torch.bfloat16) -> tuple[Path, tuple[Path, ...], list[str]]:
    """(source, the headers it includes, extra nvcc flags) of the kernel of
    ``dtype``: f16 is the bf16 source built with ``ELEM_F16``."""
    if dtype == torch.float32:
        return F32_SOURCE, (), []
    return SOURCE, HEADERS, ["-DELEM_F16"] if dtype == torch.float16 else []


def build(dtype: torch.dtype = torch.bfloat16) -> tuple[Path, str]:
    """Compile the kernel of ``dtype`` if needed; returns (library, nvcc
    output)."""
    source, headers, flags = sources(dtype)
    return build_shared(f"libmatmul_{DTYPES[dtype]}.so", [source],
                        [nvcc(), *NVCC_FLAGS, *flags], headers)


_libs: dict[torch.dtype, ctypes.CDLL] = {}
_ready: set[tuple[torch.dtype, int]] = set()


def _load(dtype: torch.dtype, device: int | None = None) -> ctypes.CDLL:
    """The library of ``dtype``, and its ``matmul_init`` run once for
    ``device``: the shared-memory opt-in and (wgmma) the SM count, device
    attribute calls that a launch must not make (it may sit inside
    CUDA-graph capture)."""
    if dtype not in _libs:
        lib = ctypes.CDLL(str(build(dtype)[0]))
        for entry, argtypes in ENTRIES.items():
            getattr(lib, entry).restype = _INT
            getattr(lib, entry).argtypes = argtypes
        _libs[dtype] = lib
    lib = _libs[dtype]
    if device is not None and (dtype, device) not in _ready:
        err = lib.matmul_init(device)
        if err:
            raise RuntimeError(f"matmul_init ({DTYPES[dtype]}) failed with cudaError {err}")
        _ready.add((dtype, device))
    return lib


def kernel_config(dtype: torch.dtype = torch.bfloat16) -> dict[str, int]:
    """The kernel's tile, pipeline and register configuration for
    ``dtype``, as its library reports it (builds the library if needed)."""
    keys = F32_CONFIG_KEYS if dtype == torch.float32 else CONFIG_KEYS
    out = (_INT * len(keys))()
    _load(dtype).matmul_config(out, len(keys))
    return dict(zip(keys, out))


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 accumulation, cast to the input dtype."""
    if a.is_cuda:
        # the reference is full fp32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(
            f"matmul_kernel needs both operands on one CUDA device, got "
            f"{a.device} and {b.device}"
        )
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"matmul_kernel takes two operands of one of {[str(d) for d in DTYPES]}, got "
            f"{a.dtype} and {b.dtype}"
        )
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul_kernel takes [M,K] @ [K,N], got {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    if any(d % ALIGN for d in (*a.shape, b.shape[1])):
        raise ValueError(
            f"matmul_kernel needs every dim a multiple of {ALIGN}, got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_kernel takes contiguous row-major operands")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("matmul_kernel needs 16-byte aligned operands")


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B on the Hopper kernel of the operands' dtype (bf16 and f16
    on the tensor cores, f32 on the CUDA cores; fp32 accumulation, C in the
    operands' dtype).

    CPU tensors take ``matmul_reference``; CUDA tensors launch the kernel or
    raise — there is no fallback."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_reference(a, b)
    _check(a, b)
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _load(a.dtype, a.device.index).matmul_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.device.index, stream
    )
    if err:
        raise RuntimeError(f"matmul_launch ({DTYPES[a.dtype]}) failed with cudaError {err}")
    matmul_kernel.launches += 1
    matmul_kernel.launches_by_dtype[DTYPES[a.dtype]] += 1
    return c


matmul_kernel.launches = 0
matmul_kernel.launches_by_dtype = dict.fromkeys(DTYPES.values(), 0)


def matmul(a: torch.Tensor, b: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """The kernel when asked for and aligned, else ``torch.matmul``."""
    if (
        use_kernel
        and a.ndim == 2
        and b.ndim == 2
        and a.shape[0] % ALIGN == 0
        and a.shape[1] % ALIGN == 0
        and b.shape[1] % ALIGN == 0
    ):
        return matmul_kernel(a, b)
    return torch.matmul(a, b)
