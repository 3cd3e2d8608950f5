// bf16 GEMM for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], fp32 accumulation,
// bf16 output.  All three matrices are row-major and contiguous.
//
// Replaces the two Pallas TPU kernels of k8s_gpu_hpa_tpu/ops/pallas_matmul.py:
// `_matmul_kernel_fullk` (full-K stripes, one contraction per output tile) and
// `_matmul_kernel_kgrid` (K as a sequential grid axis into an fp32 VMEM
// accumulator).  On the TPU the grid runs in order on one core, so the k-grid
// kernel carried its sum from one grid step to the next.  Here blocks run in
// parallel in no order, so the K loop lives inside the block and one kernel
// covers both branches: the accumulator stays in registers for the whole loop.
//
// Bound.  The work is 2*M*N*K operations on (M*K + K*N + M*N) * 2 bytes.  At
// the load generator's 4096^3 that is 137.4 GFLOP, or 0.139 ms at the H100
// SXM's 989 TFLOP/s dense bf16, against 100.7 MB, or 0.030 ms at 3.35 TB/s: the
// tensor cores bound it, not the memory (NVIDIA H100 SXM data sheet).
//
// Design, kept simple on purpose (wgmma, TMA and a deeper pipeline are later
// work):
//   - one CTA of 256 threads (8 warps) per 128x128 output tile; the warps
//     form a 2x4 grid, each owning a 64x32 sub-tile of 4x2 wmma fragments;
//   - a K loop in steps of 32: A (128x32) and B (32x128) tiles are staged in
//     shared memory with cp.async, double-buffered so the next tile's copy
//     overlaps this tile's products; rows are padded by 8 elements so the
//     fragment loads do not all land in one bank;
//   - tensor cores through nvcuda::wmma 16x16x16 bf16 fragments with fp32
//     accumulators;
//   - the epilogue passes each fragment through a per-warp shared scratch and
//     writes 16-byte rows of bf16 converted with __float2bfloat16.
// The kernel allocates nothing and launches on the caller's stream.  Shapes
// must be multiples of 128 and pointers 16-byte aligned; the Python wrapper
// (ops/matmul.py) checks both before it calls in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kWarpsN = 4;
constexpr int kWM = 64;  // rows of C per warp
constexpr int kWN = 32;  // columns of C per warp
constexpr int kFM = kWM / 16;
constexpr int kFN = kWN / 16;
constexpr int kALd = kBK + 8;  // padded row stride of the A tile, elements
constexpr int kBLd = kBN + 8;  // padded row stride of the B tile, elements
constexpr int kStages = 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__global__ void __launch_bounds__(kThreads)
    matmul_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ b,
                       __nv_bfloat16* __restrict__ c, int n, int k) {
  __shared__ __align__(128) __nv_bfloat16 a_s[kStages][kBM * kALd];
  __shared__ __align__(128) __nv_bfloat16 b_s[kStages][kBK * kBLd];
  __shared__ __align__(128) float c_s[kThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // Each tile is 512 chunks of 16 bytes (8 bf16): two per thread.
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      const int ar = id / (kBK / 8);
      const int ac = (id % (kBK / 8)) * 8;
      cp_async16(&a_s[stage][ar * kALd + ac],
                 a + static_cast<size_t>(m0 + ar) * k + k0 + ac);
      const int br = id / (kBN / 8);
      const int bc = (id % (kBN / 8)) * 8;
      cp_async16(&b_s[stage][br * kBLd + bc],
                 b + static_cast<size_t>(k0 + br) * n + n0 + bc);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int k_tiles = k / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < k_tiles) load_tile(cur ^ 1, kt + 1);
    // an empty group on the last step keeps "all but the newest" meaning
    // "tile kt has landed"
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          a_frag[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          b_frag[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(a_frag[i], &a_s[cur][(wm * kWM + i * 16) * kALd + kk],
                               kALd);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(b_frag[j], &b_s[cur][kk * kBLd + wn * kWN + j * 16],
                               kBLd);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], a_frag[i], b_frag[j], acc[i][j]);
    }
    // every warp is done reading `cur` before the next step refills it
    __syncthreads();
  }

  float* scratch = c_s[warp];
  const int r = lane / 2;
  const int c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(scratch[r * 16 + c8 + e]);
      const int row = m0 + wm * kWM + i * 16 + r;
      const int col = n0 + wn * kWN + j * 16 + c8;
      *reinterpret_cast<uint4*>(c + static_cast<size_t>(row) * n + col) =
          *reinterpret_cast<const uint4*>(out);
      __syncwarp();
    }
  }
}

}  // namespace

// C entry, bound with ctypes.  `device` is the CUDA ordinal the pointers live
// on and `stream` the caller's cudaStream_t.  Returns cudaGetLastError() after
// the launch: nonzero means the launch was refused and nothing ran.
extern "C" int matmul_bf16(const void* a, const void* b, void* c, int m, int n,
                           int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kBN, m / kBM);
  matmul_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(c), n, k);
  return static_cast<int>(cudaGetLastError());
}
