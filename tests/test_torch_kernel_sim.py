"""The CUDA sources of the flash-attention kernels (forward and backward),
run on the CPU.

The sources compile as C++ against a lockstep simulator of the CUDA features
they use (tools/warpsim: one host thread per CUDA thread; ldmatrix, mma.sync
and shuffles exchanged at a barrier of the warp, in the fragment layouts of
the PTX ISA; cp.async as a copy; shared-memory accesses checked for
alignment and bounds).  The simulator replaces only the PTX layer
(csrc/mma_ptx.cuh); the kernels and csrc/mma_bf16.cuh compile as they are.
So their tiling, fragment layouts, causal bounds and strided addressing are
held against the plain versions here, at small shapes, with chip_smoke.py's
bars: outputs within 0.02 absolute (the forward's bar), the logsumexp within
1e-4, gradients within 2e-3 + 2^-6 of their value.  What it cannot show: speed, a cp.async
read before its wait (copies land at once), and what nvcc refuses;
chip_smoke.py shows those on the card.  Each simulation runs this file as a
script in a subprocess with a time limit, so that a warp-collective fault
fails the test instead of hanging it."""

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

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "k8s_gpu_hpa_tpu_torch" / "ops" / "csrc"
SIM = REPO / "tools" / "warpsim"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")
# chip_smoke.py's bar for the gradients: BWD_ATOL + BWD_RTOL * |value|
GRAD_ATOL, GRAD_RTOL = 2e-3, 2.0**-6

# (batch, seq, heads, head_dim, causal): head_dim 64 causal; head_dim 128
# not causal; and seq 192 with three heads, whose forward cuts a ragged
# second Q tile of 128 and whose backward starts its dK/dV loops at the
# diagonal
SHAPES = [(1, 128, 2, 64, 1), (1, 128, 1, 128, 0), (2, 192, 3, 128, 1)]


def _simulated(text: str) -> str:
    """A kernel source as the simulator compiles it: each launch
    ``kernel<<<grid, threads, smem, stream>>>(p)`` becomes a call, and the
    shared-memory declaration goes (the simulator's buffer stands in)."""
    text = re.sub(r"(\w+<\d+>)<<<(.*)>>>\(p\)", r"launch_kernel(\1, \2, p)", text)
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


def _run(lib: Path, shape) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, str(lib), *map(str, shape)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=300,
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


@pytest.fixture(scope="module")
def sim_lib(tmp_path_factory) -> Path:
    return _build(tmp_path_factory.mktemp("warpsim"))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}s{}h{}d{}c{}".format(*s))
def test_kernel_sources_match_the_plain_versions(sim_lib, shape):
    err = _run(sim_lib, shape)
    assert err["o"] <= 0.02 and err["lse"] <= 1e-4, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] <= 1.0, (name, err)


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
    # python tests/test_torch_kernel_sim.py LIBSIM BATCH SEQ HEADS HEAD_DIM CAUSAL
    print(json.dumps(_simulate(sys.argv[1], *(int(x) for x in sys.argv[2:7]))))
