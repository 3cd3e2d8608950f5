"""The streamed instantiations of the flash kernels (forward, dQ and dK/dV;
head_dim 640 and up in the wgmma sources, built as bf16 and as f16, and 384
and up in the f32 FFMA sources), and the f32 backward's cluster tiling (384
to 1024), run on the CPU in the lockstep simulator of
tests/test_torch_kernel_sim.py, whose helpers build and drive them, and held
against their plain versions at that file's bars.

The streamed tilings hold no whole row of a tile: each CTA owns 128 of its
output's columns and sums the score products over the head_dim in a runtime
loop of 128-column chunks, which the wgmma kernels stream in pairs through a
ring of four stages beside a two-stage ring of the owned columns.  The f32
backward's CTAs of a (batch-head, 64-row tile) form a cluster from 384 to
1024 instead: each computes the scores' part over its own 128 columns, and
each sums the cluster's parts from their shared memory after a cluster
barrier; past 1024 the streamed tiling stays.  The shapes: head_dim 640
(five chunks) and 1024 (eight) in bf16 and f16, 384, 640 and 1024 (clusters
of three, five and eight) and 1152 (streamed) in f32; causal and not; one
head, and two batches of two heads (the 4-D tensor maps and strides of
fused QKV views); and seq 320 causal, five 64-row tiles a side, which wraps
the two-stage rings, and the cluster's two partial buffers, twice.
Planted faults: a score product that drops its last head_dim chunk fails
the simulation, in the wgmma forward, the wgmma backward and the f32
streamed backward, as does a cluster sum that skips the last rank's part;
a cluster that sums the parts before its barrier reads stale shared memory,
and a CTA that leaves before its peers are done with its shared memory,
fail the launch.  The simulator's cluster launch itself is held to what
cudaLaunchKernelEx refuses and to each CTA's rank and shared memory.  Run
it alone with ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_kernel_sim_streamed.py -n 3``."""

import ctypes
import math
import shutil
import subprocess

import pytest

from k8s_gpu_hpa_tpu_torch.ops import flash_attention as fa
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)
from tests.test_torch_kernel_sim import CSRC, SIM, _assert_within, _build, _planted, _run

# (batch, seq, heads, head_dim, causal, the forward's consumer warpgroups a
# CTA: one, the streamed tiling's only)
WGMMA_SHAPES = [(1, 128, 1, 640, 1, 1), (1, 192, 1, 640, 0, 1), (2, 128, 2, 640, 0, 1),
                (1, 320, 1, 640, 1, 1), (1, 128, 1, 1024, 1, 1), (1, 192, 1, 1024, 0, 1)]
F16_SHAPES = [(1, 192, 1, 640, 1, 1), (1, 128, 1, 1024, 0, 1), (1, 192, 1, 1024, 1, 1)]
F32_SHAPES = [(1, 128, 1, 384, 1, 1), (1, 192, 1, 384, 0, 1), (2, 128, 2, 384, 1, 1),
              (1, 128, 1, 640, 0, 1), (1, 192, 1, 640, 1, 1), (1, 320, 1, 384, 1, 1),
              (1, 128, 1, 1024, 1, 1), (1, 192, 1, 1024, 0, 1), (1, 128, 1, 1152, 1, 1)]
#: the launch failure (cudaErrorLaunchFailure) the simulated cluster
#: kernels' entries return where their exchange faulted
LAUNCH_FAILURE = 719


def _ids(shape) -> str:
    return "b{}s{}h{}d{}c{}".format(*shape[:5])


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Each dtype's library, built at its first use."""
    built = {}

    def lib(dtype: str):
        if dtype not in built:
            built[dtype] = _build(tmp_path_factory.mktemp(f"streamed_{dtype}"), dtype=dtype)
        return built[dtype]

    return lib


@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=_ids)
def test_bf16_streamed_kernels_match_the_plain_versions(libs, shape):
    _assert_within(_run(libs("bf16"), shape), "bf16")


@pytest.mark.parametrize("shape", F16_SHAPES, ids=_ids)
def test_f16_streamed_kernels_match_the_plain_versions(libs, shape):
    """The wgmma sources built as f16, at the bf16 bars."""
    _assert_within(_run(libs("f16"), shape, dtype="f16"), "f16")


@pytest.mark.parametrize("shape", F32_SHAPES, ids=_ids)
def test_f32_streamed_kernels_match_the_plain_versions(libs, shape):
    """The FFMA sources' streamed tiling, at the JAX package's f32 bars."""
    _assert_within(_run(libs("f32"), shape, dtype="f32"), "f32")


def test_the_simulation_catches_a_forward_dropping_its_last_chunk(tmp_path):
    """A planted fault: the streamed forward's producer loading Q's last
    128-column chunk from past the head_dim, where the tensor map reads
    zeros, so the score product drops that chunk (its pair still loaded and
    consumed, so the rings stay in step).  The output and the logsumexp
    leave their bars."""
    right = "tma_load_4d(pair + x * kBoxBytes, &p.q, &full[st], c * C::kDc + x * kBox, h, q0, b);"
    plant = _planted("flash_attention.cu", right, right.replace(
        "c * C::kDc + x * kBox", "(c == chunks - 1 ? p.head_dim : c * C::kDc) + x * kBox"))
    err = _run(_build(tmp_path, plant), (1, 128, 1, 640, 1, 1))
    assert err["o_bar"] > 1.0 and err["lse"] > 1e-4, err


def test_the_simulation_catches_a_backward_dropping_its_last_chunk(tmp_path):
    """The same fault in the streamed backward's producer: the A operand of
    each score product (dQ: Q and dO; dK/dV: K and V) read from past the
    head_dim in its last chunk.  dQ, dK and dV leave their bars; the
    forward stays right."""
    right = "load_chunk(pair, a[g], &sm.full[st], c * C::kDc, h, own_row, b);"
    plant = _planted("flash_attention_bwd.cu", right, right.replace(
        "c * C::kDc", "c == chunks - 1 ? p.head_dim : c * C::kDc"))
    err = _run(_build(tmp_path, plant), (1, 128, 1, 640, 1, 1))
    assert err["o_bar"] <= 1.0 and err["lse"] <= 1e-4, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] > 1.0, (name, err)


def test_the_simulation_catches_an_f32_backward_dropping_its_last_chunk(tmp_path):
    """A planted fault: the f32 backward's cluster sum adding every rank's
    part of the scores but the last's, so S and dP (S^T and dP^T) lose the
    head_dim's last chunk.  dQ, dK and dV leave their bars; the forward
    stays right."""
    right = "for (int r = 0; r < ranks; ++r) {"
    plant = _planted("flash_attention_bwd_f32.cu", right,
                     right.replace("r < ranks", "r < ranks - 1"))
    err = _run(_build(tmp_path, plant, "f32"), (1, 128, 1, 384, 1, 1), dtype="f32")
    assert err["o_bar"] <= 1.0 and err["lse"] <= 1e-4, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] > 1.0, (name, err)


def test_the_simulation_catches_a_streamed_f32_backward_dropping_its_last_chunk(tmp_path):
    """The same fault in the f32 streamed backward, past the cluster's 1024:
    its score products summing every chunk but the head_dim's last.  dQ, dK
    and dV leave their bars; the forward stays right."""
    right = "for (int k = 0; k < cta.chunks; ++k) {"
    plant = _planted("flash_attention_bwd_f32.cu", right,
                     right.replace("k < cta.chunks", "k < cta.chunks - 1"))
    err = _run(_build(tmp_path, plant, "f32"), (1, 128, 1, 1152, 1, 1), dtype="f32")
    assert err["o_bar"] <= 1.0 and err["lse"] <= 1e-4, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] > 1.0, (name, err)


def test_the_simulation_catches_a_cluster_summing_before_its_barrier(tmp_path):
    """A planted fault: both cluster kernels summing the cluster's parts of
    the scores before the barrier that should order the loads after every
    CTA's writes.  The loads read each peer's shared memory as the barrier
    before left it: fresh shared memory's 0xff bytes (NaN) in the first two
    tiles, an older tile's parts later.  dQ, dK and dV leave their bars, and
    both launches fail, each CTA having rewritten parts its peers loaded."""
    sum = "    sum_partials(s, dp, part, part + kSlotFloats, cta.chunks);\n"
    dq_barrier = ("    cluster_arrive();  // this CTA's partials of the tile are in\n"
                  "    __syncthreads();   // every thread's dP is done with V: the next V "
                  "comes in\n"
                  "    if (j + 1 < n_kv) load_v(kv0 + kF32Rows);\n"
                  "    cluster_wait();  // and every peer's\n")
    dkv_barrier = "    cluster_sync();  // every CTA's partials of this tile are in\n"
    plant_dq = _planted("flash_attention_bwd_f32.cu", dq_barrier + sum, sum + dq_barrier)
    plant_dkv = _planted("flash_attention_bwd_f32.cu", dkv_barrier + sum, sum + dkv_barrier)
    err = _run(_build(tmp_path, lambda name, text: plant_dkv(name, plant_dq(name, text)), "f32"),
               (1, 128, 1, 384, 1, 1), dtype="f32")
    assert err["o_bar"] <= 1.0 and err["lse"] <= 1e-4, err
    assert err["dq_rc"] == err["dkv_rc"] == LAUNCH_FAILURE, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] > 1.0, (name, err)


def test_the_simulation_catches_a_cta_leaving_its_cluster_early(tmp_path):
    """A planted fault: both cluster kernels without their last barrier, so
    a CTA may exit while a peer still loads the last tile's parts from its
    shared memory.  The simulator keeps that memory, so the gradients come
    out right, but both launches fail."""
    right = "  cluster_sync();  // no CTA leaves while a peer may still load its partials\n"
    plant = _planted("flash_attention_bwd_f32.cu", right, "")
    err = _run(_build(tmp_path, plant, "f32"), (1, 192, 1, 384, 1, 1), dtype="f32")
    assert err["dq_rc"] == err["dkv_rc"] == LAUNCH_FAILURE, err
    for name in ("dq", "dk", "dv"):
        assert err[name + "_bar"] <= 1.0, (name, err)


@pytest.mark.parametrize("head_dim", [384, 512, 640, 768, 896, 1024, 1152, 2048])
@pytest.mark.parametrize("kernel", fa.BWD_KERNELS)
def test_the_f32_backward_config_counts_the_cluster_s_ctas(libs, kernel, head_dim):
    """``flash_attention_bwd_config`` of the f32 library: from 384 to 1024
    the cluster tiling, its CTAs a (batch-head, 64-row tile) ``chunks`` =
    head_dim / 128 (3 to 8) in 204,800 bytes of shared memory (four 64 x
    128 chunks and four 64 x 68 slots); past it the streamed tiling's 135
    KB, as many CTAs; 256 threads and 64-row tiles in both."""
    lib = ctypes.CDLL(str(libs("f32")))
    entry = lib.flash_attention_bwd_config
    entry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    out = (ctypes.c_int * 7)()
    assert entry(fa.BWD_KERNELS.index(kernel), head_dim, out, 7) == 7
    clustered = head_dim in fa.CLUSTER_HEAD_DIMS
    assert clustered == (head_dim <= 1024)
    smem = (4 * 64 * 132 + 4 * 64 * 68) * 4 if clustered else 4 * 64 * 132 * 4
    assert list(out) == [256, 1, smem, 0, 0, head_dim // 128, 64]
    clusters = ctypes.c_int(0)
    got = lib.flash_attention_bwd_max_clusters(fa.BWD_KERNELS.index(kernel), head_dim, 0,
                                               ctypes.byref(clusters))
    # the simulator holds one cluster at a time; off the cluster tiling the
    # entry refuses (cudaErrorInvalidValue)
    assert (got, clusters.value) == ((0, 1) if clustered else (1, 0))


#: a kernel of the simulator's cluster primitives alone: each CTA writes its
#: rank and block index into its shared memory, then thread t < the cluster
#: loads CTA t's (before the barrier with `early`, else after it)
CLUSTER_PROBE = r"""
#include "cuda_runtime.h"
#include "hopper_ptx.cuh"

struct Probe {
  float* out;
  int early;
};

void probe(const Probe p) {
  float* s = reinterpret_cast<float*>(smem_raw);
  const uint32_t rank = cluster_ctarank();
  const unsigned size = sim.cluster.size;
  if (threadIdx.x == 0) {
    s[0] = static_cast<float>(rank);
    s[1] = static_cast<float>(blockIdx.x);
  }
  float4 v{};
  if (p.early && threadIdx.x < size) v = ld_cluster_f4(mapa(smem_u32(s), threadIdx.x));
  cluster_sync();
  if (!p.early && threadIdx.x < size) v = ld_cluster_f4(mapa(smem_u32(s), threadIdx.x));
  cluster_sync();
  if (threadIdx.x < size) {
    p.out[2 * (blockIdx.x * size + threadIdx.x)] = v.x;
    p.out[2 * (blockIdx.x * size + threadIdx.x) + 1] = v.y;
  }
}

extern "C" int launch(int grid, int cluster, int early, float* out) {
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(64);
  cfg.dynamicSmemBytes = 1024;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, probe, Probe{out, early});
  return err != cudaSuccess ? static_cast<int>(err) : static_cast<int>(cudaGetLastError());
}
"""


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    out = tmp_path_factory.mktemp("cluster_probe")
    for f in (*SIM.iterdir(), CSRC / "elem.cuh"):
        shutil.copy(f, out / f.name)
    (out / "probe.cc").write_text(CLUSTER_PROBE)
    lib = out / "libprobe.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{out}",
                    "-o", str(lib), str(out / "sim.cc"), str(out / "probe.cc")],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(lib))
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("grid,cluster", [(8, 4), (16, 8), (3, 1), (9, 3)])
def test_the_simulated_cluster_loads_each_rank_s_shared_memory(probe_lib, grid, cluster):
    """Each CTA's rank is its block index modulo the cluster, and a load at
    a peer's address (mapa) reads that peer's shared memory."""
    out = (ctypes.c_float * (2 * grid * cluster))()
    assert probe_lib.launch(grid, cluster, 0, out) == 0
    for block in range(grid):
        first = block - block % cluster
        for t in range(cluster):
            at = 2 * (block * cluster + t)
            assert (out[at], out[at + 1]) == (t, first + t), (block, t)


@pytest.mark.parametrize("grid,cluster", [(6, 4), (18, 9), (16, 16), (4, 0)])
def test_the_simulated_cluster_launch_refuses_what_cuda_refuses(probe_lib, grid, cluster):
    """A cluster of more than eight CTAs (the portable limit), or one that
    does not divide the grid, is refused (cudaErrorInvalidClusterSize) and
    never runs."""
    out = (ctypes.c_float * max(2 * grid * cluster, 1))()
    assert probe_lib.launch(grid, cluster, 0, out) == 912
    assert all(x == 0.0 for x in out)


def test_the_simulated_cluster_load_before_the_barrier_reads_stale_memory(probe_lib):
    """Loads before the barrier read fresh shared memory (0xff bytes: NaN),
    and the launch fails: every CTA rewrote bytes its peers had loaded."""
    out = (ctypes.c_float * 32)()
    assert probe_lib.launch(8, 2, 1, out) == LAUNCH_FAILURE
    assert all(math.isnan(x) for x in out)
