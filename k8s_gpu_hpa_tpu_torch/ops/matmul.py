"""Tiled bf16 matmul as a hand-written Hopper kernel — the loadgen's hot op.

Counterpart of ``k8s_gpu_hpa_tpu/ops/pallas_matmul.py``.  The reference's
load generator is a CUDA binary (vectorAdd, cuda-test-deployment.yaml:18-19);
its analog must keep the tensor cores busy, and this module owns that hot
loop with a kernel of its own: ``csrc/matmul.cu``, CUDA C++ for ``sm_90a``,
built with ``nvcc`` at first use and bound with ctypes.  The source states
which Pallas kernels it replaces and what bounds it.

Four entry points:

- ``matmul_kernel(a, b)``: launches the CUDA kernel for CUDA tensors and
  raises on anything it does not take.  For CPU tensors it computes
  ``matmul_reference`` instead — the only case in which the plain version
  stands in.  ``matmul_kernel.launches`` counts launches.
- ``matmul_reference(a, b)``: the plain PyTorch version, fp32 accumulation
  cast to the input dtype.
- ``matmul(a, b, use_kernel=True)``: the dispatcher.  The kernel runs only
  for 2-D operands whose dims are all multiples of 128; anything else goes
  to ``torch.matmul``.
- ``kernel_config()``: the kernel's tile, pipeline, register and
  shared-memory configuration, as its library reports it, for reports.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from k8s_gpu_hpa_tpu_torch.utils.build import NVCC_FLAGS, build_shared, nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "matmul.cu"
#: the PTX layer and the descriptor helpers the source includes
HEADERS = (CSRC / "hopper_ptx.cuh", CSRC / "smem_desc.cuh")
#: every dim must be a multiple of this: the kernel's tile rows, and half its
#: tile columns (a 128-column remainder is read through TMA's zero fill)
ALIGN = 128
#: names of the values ``matmul_bf16_config`` reports, in its order
CONFIG_KEYS = ("tile_m", "tile_n", "tile_k", "stages", "consumer_warpgroups",
               "producer_regs", "consumer_regs", "smem_bytes", "group_m")
_INT, _PTR = ctypes.c_int, ctypes.c_void_p
#: the library's C entries and their argument types
ENTRIES = {
    "matmul_bf16_init": [_INT],
    "matmul_bf16_config": [ctypes.POINTER(_INT), _INT],
    # a, b, c, m, n, k, device, stream
    "matmul_bf16": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR],
}


def build() -> tuple[Path, str]:
    """Compile ``csrc/matmul.cu`` if needed; returns (library, nvcc output)."""
    return build_shared("libmatmul_bf16.so", [SOURCE], [nvcc(), *NVCC_FLAGS], HEADERS)


_lib: ctypes.CDLL | None = None
_ready: set[int] = set()


def _load(device: int | None = None) -> ctypes.CDLL:
    """The library, and ``matmul_bf16_init`` run once for ``device``: the
    shared-memory opt-in and the SM count, device attribute calls that a
    launch must not make (it may sit inside CUDA-graph capture)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for entry, argtypes in ENTRIES.items():
            getattr(lib, entry).restype = _INT
            getattr(lib, entry).argtypes = argtypes
        _lib = lib
    if device is not None and device not in _ready:
        err = _lib.matmul_bf16_init(device)
        if err:
            raise RuntimeError(f"matmul_bf16_init failed with cudaError {err}")
        _ready.add(device)
    return _lib


def kernel_config() -> dict[str, int]:
    """The kernel's tile, pipeline and register configuration, as the
    library reports it (builds the library if needed)."""
    out = (_INT * len(CONFIG_KEYS))()
    _load().matmul_bf16_config(out, len(CONFIG_KEYS))
    return dict(zip(CONFIG_KEYS, out))


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
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul_kernel takes bf16, got {a.dtype} and {b.dtype}")
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
    """C = A @ B on the Hopper kernel (bf16 in, fp32 accumulate, bf16 out).

    CPU tensors take ``matmul_reference``; CUDA tensors launch the kernel or
    raise — there is no fallback."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_reference(a, b)
    _check(a, b)
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _load(a.device.index).matmul_bf16(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.device.index, stream
    )
    if err:
        raise RuntimeError(f"matmul_bf16 launch failed with cudaError {err}")
    matmul_kernel.launches += 1
    return c


matmul_kernel.launches = 0


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
