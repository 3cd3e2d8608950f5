"""The CUDA sources of the flash-attention kernels (forward and backward) and
of the GEMM, run on the CPU: the wgmma sources built as bf16 and as f16
(``ELEM_F16``), and the f32 sources (FFMA), each into a library of its own.

The sources compile as C++ against a lockstep simulator of the CUDA features
they use (tools/warpsim: one host thread per CUDA thread; shuffles exchanged
at a barrier of the warp, wgmma at a barrier of the warpgroup, in the
layouts of the PTX ISA, reading bf16 or f16 operands; mbarriers as shared
state under a lock; a TMA load of bf16, f16 or fp32 as a swizzled or plain,
zero-filled copy that completes its barrier's bytes; shared-memory
addresses checked for alignment and bounds; a thread-block cluster's CTAs
run at once, each with its own shared memory, a cluster barrier, and
bounds-checked loads from a peer's shared memory as it stood at the last
barrier).  The simulator replaces only
the PTX layer (csrc/hopper_ptx.cuh); the kernels, csrc/elem.cuh,
csrc/smem_desc.cuh, csrc/tensor_map.cuh and csrc/ffma_tiles.cuh compile as
they are.  So their tiling, fragment and descriptor layouts, causal bounds,
strided addressing, barrier phases and the GEMM's persistent tile order are
held against the plain versions here, at small shapes, with chip_smoke.py's
bars: in bf16 and f16 outputs within 0.02 absolute (the forward's bar), the
logsumexp within 1e-4, gradients within 2e-3 + 2^-6 of their value, the
GEMM within 1e-2 + 2^-6 of its value; in f32 the JAX package's f32 bars,
2e-3 (forward), 2e-4 (gradients) and 1e-3 (GEMM), each absolute plus that
much of the value.  What it cannot show: speed; a wgmma read before its wait
(copies and products land at once); what nvcc refuses; and a hardware
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
from tests.test_torch_cores import PORT_NICE
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "k8s_gpu_hpa_tpu_torch" / "ops" / "csrc"
SIM = REPO / "tools" / "warpsim"
#: the sources of each library: the wgmma ones build as bf16 and as f16
SOURCES = {
    "bf16": ("flash_attention.cu", "flash_attention_bwd.cu", "matmul.cu"),
    "f16": ("flash_attention.cu", "flash_attention_bwd.cu", "matmul.cu"),
    "f32": ("flash_attention_f32.cu", "flash_attention_bwd_f32.cu", "matmul_f32.cu"),
}
#: the headers the kernels include that compile as they are
HEADERS = ("elem.cuh", "smem_desc.cuh", "tensor_map.cuh", "ffma_tiles.cuh")
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
# chip_smoke.py's bar for the gradients: BWD_ATOL + BWD_RTOL * |value|, in
# bf16 and f16; in f32 the JAX package's 2e-4 + 2e-4 |value|
GRAD_BARS = {"bf16": (2e-3, 2.0**-6), "f16": (2e-3, 2.0**-6), "f32": (2e-4, 2e-4)}
# and for the GEMM: ATOL + RTOL * |value|; in f32 JAX's 1e-3 + 1e-3 |value|
GEMM_BARS = {"bf16": (1e-2, 2.0**-6), "f16": (1e-2, 2.0**-6), "f32": (1e-3, 1e-3)}
# and for the forward's output: 0.02 absolute; in f32 JAX's 2e-3 + 2e-3 |value|
OUT_BARS = {"bf16": (0.02, 0.0), "f16": (0.02, 0.0), "f32": (2e-3, 2e-3)}

# (batch, seq, heads, head_dim, causal, the forward's consumer warpgroups a
# CTA): head_dim 64 causal on one warpgroup; head_dim 128 not causal split
# over two; seq 192 with three heads, whose backward starts its dK/dV loops
# at the diagonal; seq 192 not causal with b = 2, whose 4-D tensor maps
# must address each batch's rows and no other's; seq 192 causal split over
# two warpgroups, whose first Q tile leaves the second warpgroup no tile and
# whose diagonal tiles fall to either (as the backward's first Q tile and
# last K/V tile always do); and nine tiles a side, more than twice every
# ring's stages (two on one warpgroup of the forward, four elsewhere), so
# that every stage is released and refilled and every barrier's phase
# flips, at head_dim 64 on each forward split and at 128, where dQ too has
# its producer warpgroup under setmaxnreg; and head_dim 256 (one forward
# split, a three-stage forward ring, two-stage backward rings, dQ without
# the overlap and dK/dV split by role) at seq 192 with three heads causal,
# with b = 2 not causal, and over nine tiles; and head_dim 384 and 512, the
# chunked tilings (each CTA a half of O's and dQ's columns and a 128 of dK's
# and dV's, 32-row streamed tiles whose scores are m64n32k16 products, one
# consumer warpgroup; rings of four and two stages at 384, three and one at
# 512) at seq 192 with three heads causal, with b = 2 not causal, and over
# 12 and 10 streamed tiles a side, more than twice every ring's stages
SHAPES = [(1, 128, 2, 64, 1, 1), (1, 128, 1, 128, 0, 2), (2, 192, 3, 128, 1, 1),
          (2, 192, 1, 128, 0, 1), (1, 192, 2, 128, 1, 2), (1, 576, 1, 64, 1, 1),
          (1, 576, 1, 64, 1, 2), (1, 576, 1, 128, 1, 2), (2, 192, 3, 256, 1, 1),
          (2, 192, 1, 256, 0, 1), (1, 576, 1, 256, 1, 1), (2, 192, 3, 384, 1, 1),
          (2, 192, 1, 384, 0, 1), (1, 384, 1, 384, 1, 1), (2, 192, 3, 512, 1, 1),
          (2, 192, 1, 512, 0, 1), (1, 320, 1, 512, 1, 1)]
# (M, K, N) for the GEMM, whose simulated device has two SMs: one tile with
# N = 128 under the 256-wide tile and K = 128 (two steps); 2x2 tiles with N =
# 384 and K = 640 (ten steps: the four-stage ring wraps inside a tile and runs
# on into the block's next tile); and 17x1 tiles, past one group of 16 tile
# rows, eight or nine tiles a block
GEMM_SHAPES = [(128, 128, 128), (256, 640, 384), (2176, 128, 256)]
# f16, the wgmma sources built with ELEM_F16: every instantiation once (the
# forward at head_dim 64 and 128 on one and on two warpgroups, 256, 384 and
# 512 on one; both backward kernels at each head_dim), causal and not,
# several heads and batches, seq 192 whose dK/dV loops start at the diagonal
F16_SHAPES = [(1, 128, 2, 64, 1, 1), (1, 128, 1, 64, 0, 2), (2, 192, 3, 128, 1, 1),
              (1, 192, 2, 128, 1, 2), (2, 192, 3, 256, 1, 1), (2, 192, 3, 384, 1, 1),
              (2, 192, 1, 512, 0, 1)]
F16_GEMM_SHAPES = [(128, 128, 128), (256, 640, 384)]
# f32, the FFMA sources, one tiling (kv_split 1): each head_dim causal and
# not; at 256 the streamed tiles are 32 rows, so two cross the diagonal
F32_SHAPES = [(1, 128, 2, 64, 1, 1), (2, 192, 1, 64, 0, 1), (2, 192, 3, 128, 1, 1),
              (1, 128, 2, 128, 0, 1), (1, 192, 2, 256, 1, 1), (2, 128, 1, 256, 0, 1)]
# one tile; 2x3 tiles over 80 K steps of 8, the two stages alternating
F32_GEMM_SHAPES = [(128, 128, 128), (256, 640, 384)]


def _simulated(text: str) -> str:
    """A kernel source as the simulator compiles it: each launch
    ``kernel<<<grid, threads, smem, stream>>>(p)`` becomes a call, and the
    shared-memory declaration goes (the simulator's buffer stands in)."""
    text = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*)>>>\(p\)", r"launch_kernel(\1, \2, p)", text)
    return "\n".join(ln for ln in text.splitlines() if "extern __shared__" not in ln)


def _build(out: Path, edit=lambda name, text: text, dtype: str = "bf16") -> Path:
    """The library of ``dtype``'s sources (``SOURCES``) in ``out``; f16
    builds the wgmma sources with ``ELEM_F16``, as ops/*.py do for nvcc."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    # the simulator's PTX layer beside the kernels' own headers over it
    for f in (*SIM.iterdir(), *(CSRC / name for name in HEADERS)):
        shutil.copy(f, out / f.name)
    units = [out / "sim.cc"]
    for name in SOURCES[dtype]:
        unit = out / name.replace(".cu", ".cc")
        unit.write_text(_simulated(edit(name, (CSRC / name).read_text())))
        units.append(unit)
    lib = out / f"libsim_{dtype}.so"
    subprocess.run(
        # pack_pair reads an element pair through a uint32_t pointer, as nvcc allows
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         "-fno-strict-aliasing", *(["-DELEM_F16"] if dtype == "f16" else []),
         f"-I{out}", "-o", str(lib), *map(str, units)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return lib


def _two_cores() -> None:
    """Run the simulation on two of the cores it may use, at the lowest
    priority (which a process may always take, even where its worker could
    not raise its own again).  Its hundreds of threads meet at barriers
    thousands of times: on two cores it takes some quarter longer than on
    eight, and leaves the others to the test workers."""
    os.sched_setaffinity(0, set(sorted(os.sched_getaffinity(0))[-2:]))
    os.setpriority(os.PRIO_PROCESS, 0, PORT_NICE)


def _run(lib: Path, shape, kernel: str = "flash", dtype: str = "bf16") -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, str(lib), kernel, dtype, *map(str, shape)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=300,
        preexec_fn=_two_cores if hasattr(os, "sched_setaffinity") else None,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _simulate(
    lib_path: str, dtype: str, b: int, s: int, h: int, d: int, causal: int, kv_split: int
) -> dict:
    """The simulated kernels of ``dtype`` on CPU tensors at one shape: their
    largest differences from the plain versions.  Inputs are views of one
    fused QKV product, as the transformer hands them over, made from a numpy
    seed; the backward kernels take the simulated forward's output and
    logsumexp, as chip_smoke.py feeds them the card's."""
    dt = DTYPES[dtype]
    out_atol, out_rtol = OUT_BARS[dtype]
    grad_atol, grad_rtol = GRAD_BARS[dtype]
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in {**fa._FWD.entries, **fa._BWD.entries}.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    rng = np.random.default_rng(s * 7 + h + causal)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d), dtype=np.float32)).to(dt)
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).to(dt)
    tail = (b, h, s, d, causal, 1.0 / math.sqrt(d), 0, None)

    def unwritten():
        return torch.full(q.shape, float("nan"), dtype=dt)

    o, lse = unwritten(), torch.full((b * h, s, 1), float("nan"))
    assert lib.flash_attention_init(0) == 0
    assert lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        fa._strides(q, k, v, o), kv_split, *tail) == 0
    want_o, want_lse = fa.flash_attention_reference(q, k, v, bool(causal), with_lse=True)
    delta = fa.flash_attention_bwd_delta(o, do)
    dq, dk, dv = unwritten(), unwritten(), unwritten()
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    strides = fa._strides(q, k, v, do, dq, dk, dv)
    assert lib.flash_attention_bwd_init(0) == 0
    # each entry's cudaError: the simulated cluster kernels' launch fails
    # where their exchange faulted (tools/warpsim/hopper_ptx.cuh), after
    # running to the end
    rc = {"dq_rc": lib.flash_attention_bwd_dq(*inputs, dq.data_ptr(), strides, *tail),
          "dkv_rc": lib.flash_attention_bwd_dkv(*inputs, dk.data_ptr(), dv.data_ptr(), strides,
                                                *tail)}
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, bool(causal))
    # an element never written (NaN) lies outside every bar
    o_diff = (o.float() - want_o.float()).abs().nan_to_num(math.inf)
    out = {"o": float(o_diff.max()),
           "o_bar": float((o_diff / (out_atol + out_rtol * want_o.float().abs())).max()),
           "lse": float((lse - want_lse).abs().nan_to_num(math.inf).max()), **rc}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        diff = (got.float() - ref.float()).abs().nan_to_num(math.inf)
        out[name] = float(diff.max())
        out[name + "_bar"] = float((diff / (grad_atol + grad_rtol * ref.float().abs())).max())
    return out


def _simulate_gemm(lib_path: str, dtype: str, m: int, k: int, n: int) -> dict:
    """The simulated GEMM of ``dtype`` on CPU tensors at one shape: its
    largest difference from the plain version, and in units of the bar."""
    dt = DTYPES[dtype]
    gemm_atol, gemm_rtol = GEMM_BARS[dtype]
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in mm.ENTRIES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    rng = np.random.default_rng(m + 3 * k + 7 * n)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dt)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(dt)
    c = torch.full((m, n), float("nan"), dtype=dt)
    assert lib.matmul_init(0) == 0
    assert lib.matmul_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, 0, None) == 0
    want = mm.matmul_reference(a, b).float()
    diff = (c.float() - want).abs().nan_to_num(math.inf)
    return {"max_abs_err": float(diff.max()),
            "bar": float((diff / (gemm_atol + gemm_rtol * want.abs())).max())}


@pytest.fixture(scope="module")
def sim_lib(tmp_path_factory) -> Path:
    return _build(tmp_path_factory.mktemp("warpsim"))


@pytest.fixture(scope="module")
def sim_libs(tmp_path_factory):
    """The f16 and f32 libraries, each built at its first use."""
    built = {}

    def lib(dtype: str) -> Path:
        if dtype not in built:
            built[dtype] = _build(tmp_path_factory.mktemp(f"warpsim_{dtype}"), dtype=dtype)
        return built[dtype]

    return lib


def _assert_within(err: dict, dtype: str) -> None:
    assert err["dq_rc"] == 0 and err["dkv_rc"] == 0, (dtype, err)
    assert err["o_bar"] <= 1.0 and err["lse"] <= 1e-4, (dtype, err)
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] <= 1.0, (dtype, name, err)


# 64 Q rows a CTA ("q64"), on one or two warpgroups
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}s{}h{}d{}c{}q64x{}".format(*s))
def test_kernel_sources_match_the_plain_versions(sim_lib, shape):
    err = _run(sim_lib, shape)
    assert err["dq_rc"] == 0 and err["dkv_rc"] == 0, err
    assert err["o"] <= 0.02 and err["lse"] <= 1e-4, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] <= 1.0, (name, err)


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "m{}k{}n{}".format(*s))
def test_gemm_source_matches_the_plain_version(sim_lib, shape):
    err = _run(sim_lib, shape, "gemm")
    assert err["bar"] <= 1.0, err


@pytest.mark.parametrize("shape", F16_SHAPES, ids=lambda s: "b{}s{}h{}d{}c{}q64x{}".format(*s))
def test_f16_kernel_sources_match_the_plain_versions(sim_libs, shape):
    """The wgmma sources built as f16: f16 wgmma operands, f16 TMA boxes, and
    P, dS and the outputs rounded to f16, held to the bf16 bars."""
    _assert_within(_run(sim_libs("f16"), shape, dtype="f16"), "f16")


@pytest.mark.parametrize("shape", F16_GEMM_SHAPES, ids=lambda s: "m{}k{}n{}".format(*s))
def test_f16_gemm_source_matches_the_plain_version(sim_libs, shape):
    err = _run(sim_libs("f16"), shape, "gemm", "f16")
    assert err["bar"] <= 1.0, err


@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: "b{}s{}h{}d{}c{}".format(*s[:5]))
def test_f32_kernel_sources_match_the_plain_versions(sim_libs, shape):
    """The FFMA sources of the f32 forward, dQ and dK/dV, held to the JAX
    package's f32 bars."""
    _assert_within(_run(sim_libs("f32"), shape, dtype="f32"), "f32")


@pytest.mark.parametrize("shape", F32_GEMM_SHAPES, ids=lambda s: "m{}k{}n{}".format(*s))
def test_f32_gemm_source_matches_the_plain_version(sim_libs, shape):
    err = _run(sim_libs("f32"), shape, "gemm", "f32")
    assert err["bar"] <= 1.0, err


def _planted(name: str, right: str, wrong: str):
    """An edit of ``name``'s source that replaces the line ``right``, which
    must be there, with ``wrong``."""

    def plant(source, text):
        if source != name:
            return text
        assert right in text
        return text.replace(right, wrong)

    return plant


def test_the_simulation_catches_swapped_descriptor_offsets(tmp_path):
    """A planted fault: B's descriptor with its leading and stride byte
    offsets swapped, which reads B's 64-column boxes as K rows.  The
    product leaves its bar by far."""

    plant = _planted("matmul.cu", "desc_mn_major(b_tile + kk * kWgK * kSwizzleRow, kBBoxBytes)",
                     "smem_desc(b_tile + kk * kWgK * kSwizzleRow, kSwizzleAtom, kBBoxBytes)")
    err = _run(_build(tmp_path, plant), (128, 128, 256), "gemm")
    assert err["bar"] > 10.0, err


def test_the_simulation_catches_a_wrong_causal_mask(tmp_path):
    """A planted fault: the dK/dV kernel masking the diagonal too.  dQ
    stays right; dK and dV leave their bars."""
    right = "if (diagonal && q0 + 8 * j + col0 + e % 2 < row0 + (e / 2) * 8) s[x] = kNegInf;"
    plant = _planted("flash_attention_bwd.cu", right, right.replace(" < ", " <= "))
    err = _run(_build(tmp_path, plant), (1, 128, 1, 64, 1, 1))
    assert err["dq_bar"] <= 1.0
    assert err["dk_bar"] > 1.0 and err["dv_bar"] > 1.0, err


def test_the_simulation_catches_ds_packed_in_swapped_order(tmp_path):
    """A planted fault: the dK/dV kernel packing each bf16 pair of dS^T with
    its two Q rows swapped, so dS^T Q weighs each Q row by its neighbour's
    dS.  dK leaves its bar; dV, whose P^T is packed apart, and dQ stay
    right."""
    plant = _planted("flash_attention_bwd.cu", "    pack<N>(pds, dp);\n    // dK += dS^T Q",
                     "    pack<N>(pds, dp);\n    for (auto& a : pds) for (auto& r : a) "
                     "r = r >> 16 | r << 16;\n    // dK += dS^T Q")
    err = _run(_build(tmp_path, plant), (1, 128, 1, 64, 1, 1))
    assert err["dq_bar"] <= 1.0 and err["dv_bar"] <= 1.0, err
    assert err["dk_bar"] > 1.0, err


def test_the_simulation_catches_k_read_k_major_in_dq(tmp_path):
    """A planted fault: the dQ kernel's dS K reading the K tile with a
    K-major descriptor where the product reads B N-major, at head_dim 64
    (the shape run here; the other widths keep the right product).  dQ
    leaves its bar; dK and dV, the other kernel's, stay right."""
    plant = _planted(
        "flash_attention_bwd.cu",
        "product_rs<C::kDc, N>(dq, pds, k_cols, C::kStreamBoxBytes);",
        "if constexpr (D == 64) {"
        "  for (int kc = 0; kc < N / kWgK; ++kc) {"
        "    wgmma_m64n64k16_rs(dq, pds[kc], desc_k_major(k_cols + kc * kWgK * 2), 1);"
        "  }"
        "} else {"
        "  product_rs<C::kDc, N>(dq, pds, k_cols, C::kStreamBoxBytes);"
        "}")
    err = _run(_build(tmp_path, plant), (1, 128, 1, 64, 1, 1))
    assert err["dk_bar"] <= 1.0 and err["dv_bar"] <= 1.0, err
    assert err["dq_bar"] > 1.0, err


def test_the_simulation_catches_an_f32_mask_that_misses_the_diagonal(tmp_path):
    """A planted fault: the f32 forward masking only tiles that start past
    the CTA's first row, so at head_dim 64 the diagonal tile goes unmasked.
    The output leaves its bar."""
    right = "const bool crossing = p.causal && kv0 + T::kOther - 1 > q0;"
    plant = _planted("flash_attention_f32.cu", right,
                     right.replace("kv0 + T::kOther - 1 > q0", "kv0 > q0"))
    err = _run(_build(tmp_path, plant, "f32"), (1, 128, 1, 64, 1, 1), dtype="f32")
    assert err["o_bar"] > 1.0, err


def test_the_simulation_catches_a_chunk_storing_the_wrong_columns(tmp_path):
    """A planted fault: at head_dim 512 every CTA of the dK/dV kernel stores
    its chunk of dK at columns 0-127, whatever its chunk, so dK's other
    columns are never written.  dK leaves its bar; dV, stored apart, and dQ
    stay right."""
    right = "store_rows<C::kDc>(p, 0, b, h, row0, col0, dk, chunk * C::kDc);"
    plant = _planted("flash_attention_bwd.cu", right, right.replace("chunk * C::kDc", "0"))
    err = _run(_build(tmp_path, plant), (1, 128, 1, 512, 1, 1))
    assert err["dq_bar"] <= 1.0 and err["dv_bar"] <= 1.0, err
    assert err["dk_bar"] > 1.0, err


def test_the_logsumexp_does_not_depend_on_the_chunk_that_writes_it(sim_lib, tmp_path):
    """At head_dim 512 every chunk of the forward computes the same (m, l)
    by the same instructions in the same order, and the first writes the
    logsumexp.  The source with the last chunk writing it instead gives the
    same outputs, to the last bit of every difference from the plain
    versions."""
    right = "if (p.lse != nullptr && chunk == 0 && lane % 4 == 0) {"
    plant = _planted("flash_attention.cu", right,
                     right.replace("chunk == 0", "chunk == C::kChunks - 1"))
    shape = (1, 128, 1, 512, 1, 1)
    assert _run(_build(tmp_path, plant), shape) == _run(sim_lib, shape)


def test_the_simulation_catches_p_packed_in_swapped_order(tmp_path):
    """A planted fault: the forward packing each bf16 pair of P with its two
    keys swapped, so P V weighs each value row by its neighbour's
    probability.  The output leaves its bar; the logsumexp, which P's
    packing never reaches, stays right."""

    plant = _planted("flash_attention.cu", "pack<C::kKv>(pk, s);",
                     "pack<C::kKv>(pk, s); for (auto& a : pk) a[0] = a[0] >> 16 | a[0] << 16;")
    err = _run(_build(tmp_path, plant), (1, 128, 1, 64, 1, 1))
    assert err["lse"] <= 1e-4
    assert err["o"] > 0.02, err


if __name__ == "__main__":
    # python tests/test_torch_kernel_sim.py LIBSIM flash DTYPE BATCH SEQ HEADS HEAD_DIM CAUSAL KV_SPLIT
    # python tests/test_torch_kernel_sim.py LIBSIM gemm DTYPE M K N
    simulate = {"flash": _simulate, "gemm": _simulate_gemm}[sys.argv[2]]
    print(json.dumps(simulate(sys.argv[1], sys.argv[3], *(int(x) for x in sys.argv[4:]))))
