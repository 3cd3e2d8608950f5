"""The CUDA sources of the flash-attention kernels (forward and backward) and
of the GEMM, run on the CPU.

The sources compile as C++ against a lockstep simulator of the CUDA features
they use (tools/warpsim: one host thread per CUDA thread; ldmatrix, mma.sync
and shuffles exchanged at a barrier of the warp, wgmma at a barrier of the
warpgroup, in the layouts of the PTX ISA; cp.async as a copy; mbarriers as
shared state under a lock; a TMA load as a swizzled, zero-filled copy that
completes its barrier's bytes; shared-memory accesses checked for alignment
and bounds).  The simulator replaces only the PTX layers (csrc/mma_ptx.cuh,
csrc/hopper_ptx.cuh); the kernels and csrc/mma_bf16.cuh compile as they are.
So their tiling, fragment and descriptor layouts, causal bounds, strided
addressing, barrier phases and the GEMM's persistent tile order are held
against the plain versions here, at small shapes, with chip_smoke.py's bars:
outputs within 0.02 absolute (the forward's bar), the logsumexp within 1e-4,
gradients within 2e-3 + 2^-6 of their value, the GEMM within 1e-2 + 2^-6 of
its value.  What it cannot show: speed; a cp.async or wgmma read before its
wait (copies and products land at once); what nvcc refuses; and a hardware
layout (a descriptor's offsets, the swizzle, the accumulator fragment) that
the simulator and the kernel misread the same way.  chip_smoke.py's parity
on the card shows those.  Each simulation runs this file as a script in a
subprocess with a time limit, so that a warp-collective fault or a barrier
deadlock fails the test instead of hanging it."""

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from k8s_gpu_hpa_tpu_torch.ops import flash_attention as fa
from k8s_gpu_hpa_tpu_torch.ops import matmul as mm
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "k8s_gpu_hpa_tpu_torch" / "ops" / "csrc"
SIM = REPO / "tools" / "warpsim"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "matmul.cu")
# chip_smoke.py's bar for the gradients: BWD_ATOL + BWD_RTOL * |value|
GRAD_ATOL, GRAD_RTOL = 2e-3, 2.0**-6
# and for the GEMM: ATOL + RTOL * |value|
GEMM_ATOL, GEMM_RTOL = 1e-2, 2.0**-6

# (batch, seq, heads, head_dim, causal): head_dim 64 causal; head_dim 128
# not causal; and seq 192 with three heads, whose forward cuts a ragged
# second Q tile of 128 and whose backward starts its dK/dV loops at the
# diagonal
SHAPES = [(1, 128, 2, 64, 1), (1, 128, 1, 128, 0), (2, 192, 3, 128, 1)]
# (M, K, N) for the GEMM, whose simulated device has two SMs: one tile with
# N = 128 under the 256-wide tile and K = 128 (two steps); 2x2 tiles with N =
# 384 and K = 640 (ten steps: the four-stage ring wraps inside a tile and runs
# on into the block's next tile); and 17x1 tiles, past one group of 16 tile
# rows, eight or nine tiles a block
GEMM_SHAPES = [(128, 128, 128), (256, 640, 384), (2176, 128, 256)]


def _simulated(text: str) -> str:
    """A kernel source as the simulator compiles it: each launch
    ``kernel<<<grid, threads, smem, stream>>>(p)`` becomes a call, and the
    shared-memory declaration goes (the simulator's buffer stands in)."""
    text = re.sub(r"(\w+(?:<\d+>)?)<<<(.*)>>>\(p\)", r"launch_kernel(\1, \2, p)", text)
    return "\n".join(ln for ln in text.splitlines() if "extern __shared__" not in ln)


def _build(out: Path, edit=lambda name, text: text) -> Path:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    # the simulator's PTX layer beside the kernels' own mma_bf16.cuh
    for f in (*SIM.iterdir(), CSRC / "mma_bf16.cuh"):
        shutil.copy(f, out / f.name)
    units = [out / "sim.cc"]
    for name in SOURCES:
        unit = out / name.replace(".cu", ".cc")
        unit.write_text(_simulated(edit(name, (CSRC / name).read_text())))
        units.append(unit)
    lib = out / "libsim.so"
    subprocess.run(
        # pack_bf16 reads a bf16 pair through a uint32_t pointer, as nvcc allows
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         "-fno-strict-aliasing",
         f"-I{out}", "-o", str(lib), *map(str, units)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return lib


def _two_cores() -> None:
    """Run the simulation on two of the cores it may use.  Its hundreds of
    threads meet at barriers thousands of times: on two cores it takes some
    quarter longer than on eight, and leaves the others to the test workers."""
    os.sched_setaffinity(0, set(sorted(os.sched_getaffinity(0))[-2:]))


def _run(lib: Path, shape, kernel: str = "flash") -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, str(lib), kernel, *map(str, shape)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=300,
        preexec_fn=_two_cores if hasattr(os, "sched_setaffinity") else None,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _simulate(lib_path: str, b: int, s: int, h: int, d: int, causal: int) -> dict:
    """The simulated kernels on CPU tensors at one shape: their largest
    differences from the plain versions.  Inputs are views of one fused QKV
    product, as the transformer hands them over, made from a numpy seed; the
    backward kernels take the simulated forward's output and logsumexp, as
    chip_smoke.py feeds them the card's."""
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in {**fa._FWD.entries, **fa._BWD.entries}.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    rng = np.random.default_rng(s * 7 + h + causal)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d), dtype=np.float32)).bfloat16()
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).bfloat16()
    tail = (b, h, s, d, causal, 1.0 / math.sqrt(d), 0, None)

    def unwritten():
        return torch.full(q.shape, float("nan"), dtype=torch.bfloat16)

    o, lse = unwritten(), torch.full((b * h, s, 1), float("nan"))
    assert lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        fa._strides(q, k, v, o), *tail) == 0
    want_o, want_lse = fa.flash_attention_reference(q, k, v, bool(causal), with_lse=True)
    delta = fa.flash_attention_bwd_delta(o, do)
    dq, dk, dv = unwritten(), unwritten(), unwritten()
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    strides = fa._strides(q, k, v, do, dq, dk, dv)
    assert lib.flash_attention_bwd_dq(*inputs, dq.data_ptr(), strides, *tail) == 0
    assert lib.flash_attention_bwd_dkv(*inputs, dk.data_ptr(), dv.data_ptr(), strides, *tail) == 0
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, bool(causal))
    out = {"o": float((o.float() - want_o.float()).abs().max()),
           "lse": float((lse - want_lse).abs().max())}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        # an element never written (NaN) lies outside every bar
        diff = (got.float() - ref.float()).abs().nan_to_num(math.inf)
        out[name] = float(diff.max())
        out[name + "_bar"] = float((diff / (GRAD_ATOL + GRAD_RTOL * ref.float().abs())).max())
    return out


def _simulate_gemm(lib_path: str, m: int, k: int, n: int) -> dict:
    """The simulated GEMM on CPU tensors at one shape: its largest
    difference from the plain version, and in units of the bar."""
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in mm.ENTRIES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    rng = np.random.default_rng(m + 3 * k + 7 * n)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).bfloat16()
    c = torch.full((m, n), float("nan"), dtype=torch.bfloat16)
    assert lib.matmul_bf16_init(0) == 0
    assert lib.matmul_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, 0, None) == 0
    want = mm.matmul_reference(a, b).float()
    diff = (c.float() - want).abs().nan_to_num(math.inf)
    return {"max_abs_err": float(diff.max()),
            "bar": float((diff / (GEMM_ATOL + GEMM_RTOL * want.abs())).max())}


@pytest.fixture(scope="module")
def sim_lib(tmp_path_factory) -> Path:
    return _build(tmp_path_factory.mktemp("warpsim"))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}s{}h{}d{}c{}".format(*s))
def test_kernel_sources_match_the_plain_versions(sim_lib, shape):
    err = _run(sim_lib, shape)
    assert err["o"] <= 0.02 and err["lse"] <= 1e-4, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] <= 1.0, (name, err)


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "m{}k{}n{}".format(*s))
def test_gemm_source_matches_the_plain_version(sim_lib, shape):
    err = _run(sim_lib, shape, "gemm")
    assert err["bar"] <= 1.0, err


def test_the_simulation_catches_swapped_descriptor_offsets(tmp_path):
    """A planted fault: B's descriptor with its leading and stride byte
    offsets swapped, which reads B's 64-column boxes as K rows.  The
    product leaves its bar by far."""

    def plant(name, text):
        if name != "matmul.cu":
            return text
        right = "kk * kWgK * kSwizzleRow, kBBoxBytes, kSwizzleAtom)"
        assert right in text
        return text.replace(right, "kk * kWgK * kSwizzleRow, kSwizzleAtom, kBBoxBytes)")

    err = _run(_build(tmp_path, plant), (128, 128, 256), "gemm")
    assert err["bar"] > 10.0, err


def test_the_simulation_catches_a_wrong_causal_mask(tmp_path):
    """A planted fault: the dK/dV kernel masking the diagonal too.  dQ
    stays right; dK and dV leave their bars."""

    def plant(name, text):
        if name != "flash_attention_bwd.cu":
            return text
        right = "if (p.causal && i * kBlk + col < row0 + (e / 2) * 8) x = kNegInf;"
        assert right in text
        return text.replace(right, right.replace(" < ", " <= "))

    err = _run(_build(tmp_path, plant), (1, 128, 1, 64, 1))
    assert err["dq_bar"] <= 1.0
    assert err["dk_bar"] > 1.0 and err["dv_bar"] > 1.0, err


if __name__ == "__main__":
    # python tests/test_torch_kernel_sim.py LIBSIM flash BATCH SEQ HEADS HEAD_DIM CAUSAL
    # python tests/test_torch_kernel_sim.py LIBSIM gemm M K N
    simulate = {"flash": _simulate, "gemm": _simulate_gemm}[sys.argv[2]]
    print(json.dumps(simulate(sys.argv[1], *(int(x) for x in sys.argv[3:]))))
