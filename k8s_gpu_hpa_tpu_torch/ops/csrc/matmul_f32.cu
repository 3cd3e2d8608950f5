// f32 GEMM for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], every product and
// sum in fp32 on the CUDA cores.  All three matrices are row-major and
// contiguous; every dim a multiple of 128 (the wrapper checks).
//
// Replaces the two Pallas TPU kernels of k8s_gpu_hpa_tpu/ops/pallas_matmul.py,
// `_matmul_kernel_fullk` and `_matmul_kernel_kgrid`, at f32: the dtype the
// JAX package's own test runs them in (tests/test_jax_workloads.py, rtol and
// atol 1e-3).  As in matmul.cu, the K loop lives inside the block, so one
// kernel covers both Pallas branches.  The bf16 and f16 kernels are
// matmul.cu.
//
// Why not the tensor cores: wgmma's tf32 takes both shared-memory operands
// K-major only, where B ([K,N] row-major) is N-major, so B would have to be
// transposed first; and one tf32 pass rounds each operand to 10 mantissa
// bits, which at JAX's test shape (256 x 384 x 128) leaves some 1e-2 near
// zero-valued outputs against the bar of 1e-3.  FFMA keeps f32.
//
// Bound.  2*M*N*K operations on (M*K + K*N + M*N) * 4 bytes.  At the load
// generator's 4096^3 that is 137.4 GFLOP, or 2.05 ms at the H100 SXM's 67
// TFLOP/s f32 peak (CUDA cores), against 201 MB, or 0.060 ms at 3.35 TB/s:
// the FFMA rate bounds it (NVIDIA H100 SXM data sheet).  So the design keeps
// every FFMA's operands in registers and shared memory:
//   - a CTA of 256 threads computes a 128 x 128 tile of C in K steps of 8;
//     each thread holds an 8 x 8 block of accumulators (rows 4 ty + i and 64
//     + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j, t = 16 ty + tx), so a
//     k step is 4 float4 reads of shared memory for 64 FFMA;
//   - A's 128 x 8 slab is stored transposed (K rows of M, each padded by 4
//     floats so that the transposing stores of two K halves of one row fall
//     in different banks), B's 8 x 128 slab as it lies, both as float4
//     reads along M or N;
//   - two stages: each thread loads its float4 of the next slab of A and of
//     B into registers while the CTA multiplies the current one, and stores
//     them into the other stage before the one barrier a K step.
// A simple tiling that is right; making it fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;
constexpr int kLdA = kBM + 4;  // A's slab, transposed: K rows of M, padded
constexpr int kStageFloats = kBK * kLdA + kBK * kBN;
constexpr size_t kSmemBytes = 2 * kStageFloats * sizeof(float);

struct Params {
  const float* a;
  const float* b;
  float* c;
  int m, n, k;
};

__global__ void __launch_bounds__(kThreads, 2) matmul_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // this thread's float4 of each slab: A row t / 2, K half t % 2; B row t /
  // 32, columns 4 (t % 32)
  const int a_row = t / 2, a_k = (t % 2) * 4;
  const int b_row = t / 32, b_col = (t % 32) * 4;
  const float* a_src = p.a + static_cast<int64_t>(m0 + a_row) * p.k + a_k;
  const float* b_src = p.b + static_cast<int64_t>(b_row) * p.n + n0 + b_col;
  const int steps = p.k / kBK;

  auto put = [&](int stage, const float4& av, const float4& bv) {
    float* as = stages + stage * kStageFloats;
    float* bs = as + kBK * kLdA;
    as[(a_k + 0) * kLdA + a_row] = av.x;
    as[(a_k + 1) * kLdA + a_row] = av.y;
    as[(a_k + 2) * kLdA + a_row] = av.z;
    as[(a_k + 3) * kLdA + a_row] = av.w;
    *reinterpret_cast<float4*>(bs + b_row * kBN + b_col) = bv;
  };

  float4 av = *reinterpret_cast<const float4*>(a_src);
  float4 bv = *reinterpret_cast<const float4*>(b_src);
  put(0, av, bv);
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int ks = 0; ks < steps; ++ks) {
    const int cur = ks & 1;
    const bool more = ks + 1 < steps;
    if (more) {  // the next slab, in flight behind this one's products
      av = *reinterpret_cast<const float4*>(a_src + (ks + 1) * kBK);
      bv = *reinterpret_cast<const float4*>(b_src + static_cast<int64_t>(ks + 1) * kBK * p.n);
    }
    const float* as = stages + cur * kStageFloats;
    const float* bs = as + kBK * kLdA;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kLdA + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kLdA + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kBN + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kBN + 64 + 4 * tx);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // the other stage was last read before the previous step's barrier
    if (more) put(cur ^ 1, av, bv);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    float* c = p.c + static_cast<int64_t>(row) * p.n + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v;
      v.x = acc[i][4 * h + 0];
      v.y = acc[i][4 * h + 1];
      v.z = acc[i][4 * h + 2];
      v.w = acc[i][4 * h + 3];
      *reinterpret_cast<float4*>(c + 64 * h + 4 * tx) = v;
    }
  }
}

}  // namespace

// C entries, bound with ctypes, as matmul.cu's: the same names and
// arguments, so ops/matmul.py drives either library alike.
//
// matmul_init opts the kernel in to its dynamic shared memory (under the
// default 48 KB: a no-op kept for the common interface), once per device
// before the first launch.  Returns a cudaError_t.
extern "C" int matmul_init(int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(matmul_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The kernel's configuration, for reports: tile rows, columns and K step,
// stages, threads, dynamic shared memory in bytes.  Writes at most `n`
// values; returns how many there are.
extern "C" int matmul_config(int* out, int n) {
  const int values[] = {kBM, kBN, kBK, 2, kThreads, static_cast<int>(kSmemBytes)};
  const int count = static_cast<int>(sizeof(values) / sizeof(values[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = values[i];
  return count;
}

// `device` is the CUDA ordinal the pointers live on, initialised with
// matmul_init, and `stream` the caller's cudaStream_t.  Returns
// cudaGetLastError() after the launch: nonzero means the launch was refused
// and nothing ran.
extern "C" int matmul_launch(const void* a, const void* b, void* c, int m, int n, int k,
                             int device, void* stream) {
  if (m % kBM || n % kBN || k % kBK) return static_cast<int>(cudaErrorInvalidValue);
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  p.m = m;
  p.n = n;
  p.k = k;
  const dim3 grid(n / kBN, m / kBM);
  matmul_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}
