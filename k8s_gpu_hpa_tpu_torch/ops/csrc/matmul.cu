// bf16 GEMM for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], fp32 accumulation,
// C rounded once to bf16.  All three matrices are row-major and contiguous.
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
// tensor cores bound it, not the memory (NVIDIA H100 SXM data sheet).  So the
// design keeps the tensor cores fed and hides every copy behind them:
//   - tensor cores through wgmma.mma_async m64n256k16 (bf16 in, fp32
//     accumulators), the only instruction that reaches their full rate on
//     Hopper; both operands come from shared memory through matrix
//     descriptors with the 128-byte swizzle.  A's tile is K-major, as A is;
//     B's is N-major, as B is ([K,N] row-major), read with wgmma's transpose
//     bit, so nothing is transposed in memory.
//   - a CTA tile of 128x256 in K steps of 64 (one 128-byte swizzle row of
//     bf16): each operand byte brought into shared memory feeds 128 or 256
//     products, against 64 or 32 in the wmma kernel this replaced.
//   - copies by TMA into a ring of four stages (16 KB of A and 32 KB of B
//     each, 192 KB in all, which needs the dynamic shared-memory opt-in).  A
//     full and an empty mbarrier per stage: the producer arms the full one
//     with the stage's bytes, TMA completes it, and the consumers release
//     the stage through the empty one.  The swizzle caps a TMA box's inner
//     dimension at 64 bf16, so B's 64x256 tile arrives as four 64x64 boxes.
//   - warp specialisation: one producer warpgroup, one thread of which issues
//     the loads (setmaxnreg drops it to 40 registers), and two consumer
//     warpgroups of 64x256 each, 128 fp32 accumulators a thread
//     (setmaxnreg raises them to 232; 232*256 + 40*128 = 64,512 of the SM's
//     65,536).  A consumer issues a stage's four k16 wgmma as one group and
//     releases the stage before only once wgmma.wait_group shows that
//     stage's group done, so one group is always in flight.
//   - a persistent grid, one CTA per SM, over the output tiles in groups of
//     16 tile rows, so the ~132 tiles in flight share their A and B stripes
//     in the 50 MB L2; the ring runs on across tiles, so the producer loads
//     the next tile while the consumers store this one.
//   - the epilogue casts to bf16 in registers and stores straight to C, two
//     values a store: no shared-memory staging, so the ring keeps all four
//     stages.
// Edges: every dim a multiple of 128 (the wrapper checks).  N = 128 mod 256
// leaves the last tile column half outside C: TMA fills B's missing columns
// with zeros and the epilogue skips them.  K = 128 is two steps.
//
// The kernel allocates nothing and launches on the caller's stream.  The TMA
// descriptors are encoded on the host at each call, since the operands
// change from one product to the next (cuTensorMapEncodeTiled of the CUDA driver API,
// reached through the runtime's cudaGetDriverEntryPointByVersion, so nothing
// new is linked), and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "smem_desc.cuh"

namespace {

constexpr int kBM = 128;  // tile rows: two consumer warpgroups of 64
constexpr int kBN = 256;  // tile columns: one wgmma's N
constexpr int kBK = 64;   // K step: 128 bytes of bf16, one swizzle row
constexpr int kWgK = 16;  // one wgmma's K
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBoxN = 64;  // B's box width: the 128-byte swizzle's limit
constexpr int kGroupM = 16;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kConsumerRegs * 128 * kConsumers + kProducerRegs * 128 <= 65536,
              "register file");

constexpr uint32_t kABytes = kBM * kBK * 2;      // 16 KB
constexpr uint32_t kBBoxBytes = kBK * kBoxN * 2;  // 8 KB
constexpr uint32_t kBBytes = kBK * kBN * 2;      // 32 KB
constexpr uint32_t kStageBytes = kABytes + kBBytes;
// the ring, its barriers, and room to align the ring to the swizzle atom
constexpr size_t kSmemBytes =
    kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) + kSwizzleAtom;

struct Params {
  CUtensorMap a;  // [M, K], box 64 (K) x 128 (M)
  CUtensorMap b;  // [K, N], box 64 (N) x 64 (K)
  __nv_bfloat16* c;
  int m, n, k;
};

// A's 64x16 slice for wgmma, K-major: step kk of a stage starts 32 bytes
// further along the row.
__device__ __forceinline__ uint64_t desc_a(const unsigned char* a_tile, int kk) {
  return desc_k_major(a_tile + kk * kWgK * 2);
}

// B's 16x256 slice for wgmma, N-major: the 64-column boxes lie kBBoxBytes
// apart; step kk starts 16 rows further down.
__device__ __forceinline__ uint64_t desc_b(const unsigned char* b_tile, int kk) {
  return desc_mn_major(b_tile + kk * kWgK * kSwizzleRow, kBBoxBytes);
}

// output tile t in grouped order: down kGroupM tile rows, then across
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  tm = first + (t % per_group) % rows;
  tn = (t % per_group) / rows;
}

__global__ void __launch_bounds__(kThreads, 1)
    matmul_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of the shared address: align the ring to it
  unsigned char* ring =
      smem_raw + (kSwizzleAtom - smem_u32(smem_raw) % kSwizzleAtom) % kSwizzleAtom;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tiles_m = p.m / kBM;
  const int tiles_n = (p.n + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int k_steps = p.k / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread walks the same tiles and K steps as the consumers
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, tiles_m, tiles_n, tm, tn);
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);  // a fresh ring starts empty
          unsigned char* a_tile = ring + stage * kStageBytes;
          unsigned char* b_tile = a_tile + kABytes;
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(a_tile, &p.a, &full[stage], ks * kBK, tm * kBM);
#pragma unroll
          for (int j = 0; j < kBN / kBoxN; ++j) {
            tma_load_2d(b_tile + j * kBBoxBytes, &p.b, &full[stage], tn * kBN + j * kBoxN,
                        ks * kBK);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int half = wg - 1;  // this warpgroup's 64 rows of the tile
    const int lt = threadIdx.x % 128;
    const int warp = lt / 32, lane = lt % 32;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
      int prev = 0;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a_tile = ring + stage * kStageBytes + half * 64 * kSwizzleRow;
        const unsigned char* b_tile = ring + stage * kStageBytes + kABytes;
        wgmma_fence();
        wgmma_fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < kBK / kWgK; ++kk) {
          wgmma_m64n256k16_bf16(acc, desc_a(a_tile, kk), desc_b(b_tile, kk), ks > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_fence_operands(acc);
        // the previous step's group is done: its stage may be refilled
        wgmma_wait<1>();
        if (ks > 0 && lt == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      wgmma_fence_operands(acc);
      if (lt == 0) mbar_arrive(&empty[prev]);

      // epilogue: rows r and r + 8, columns 8j + 2(lane % 4) and +1
      const int row = tm * kBM + half * 64 + warp * 16 + lane / 4;
      const int col0 = tn * kBN + 2 * (lane % 4);
      __nv_bfloat16* c0 = p.c + static_cast<size_t>(row) * p.n;
      __nv_bfloat16* c8 = c0 + static_cast<size_t>(8) * p.n;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col < p.n) {
          *reinterpret_cast<__nv_bfloat162*>(c0 + col) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(c8 + col) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

PFN_cuTensorMapEncodeTiled g_encode = nullptr;
int g_sms[64] = {};

// a row-major [rows, cols] bf16 tensor, read in boxes of box_cols x box_rows
// under the 128-byte swizzle; out-of-bounds elements read as zero
CUresult encode(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
                int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return g_encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                  strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// C entries, bound with ctypes.
//
// matmul_bf16_init opts the kernel in to its dynamic shared memory, reads the
// device's SM count (the persistent grid's size) and looks up the CUDA
// driver API's cuTensorMapEncodeTiled.  It is called once per device before
// the first launch, never at launch.  Returns a cudaError_t.
extern "C" int matmul_bf16_init(int device) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(matmul_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess && g_encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    // the entry point's CUDA 12.0 signature, which <cudaTypedefs.h> names
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                           cudaEnableDefault, &found);
    if (err == cudaSuccess && found != cudaDriverEntryPointSuccess) {
      err = cudaErrorSymbolNotFound;
    }
    if (err == cudaSuccess) g_encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The kernel's configuration, for reports: tile rows, columns and K step,
// stages, consumer warpgroups, the producer's and the consumers' registers a
// thread under setmaxnreg, dynamic shared memory in bytes, tile rows per
// group.  Writes at most `n` values; returns how many there are.
extern "C" int matmul_bf16_config(int* out, int n) {
  const int values[] = {kBM, kBN, kBK, kStages, kConsumers, kProducerRegs,
                        kConsumerRegs, static_cast<int>(kSmemBytes), kGroupM};
  const int count = static_cast<int>(sizeof(values) / sizeof(values[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = values[i];
  return count;
}

// `device` is the CUDA ordinal the pointers live on, initialised with
// matmul_bf16_init, and `stream` the caller's cudaStream_t.  Returns
// cudaGetLastError() after the launch: nonzero means the launch was refused
// and nothing ran.  A refused descriptor returns the CUDA driver API's
// CUresult, whose codes are the runtime's (201: no current context).
extern "C" int matmul_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                           int device, void* stream) {
  if (device < 0 || device >= 64 || g_sms[device] == 0 || g_encode == nullptr) {
    return static_cast<int>(cudaErrorInitializationError);
  }
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cudaSetDevice makes the device's context current in this thread, which
  // cuTensorMapEncodeTiled needs; a thread's first cudaGetDevice does not
  if ((err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  Params p;
  CUresult refused = encode(&p.a, a, m, k, kBK, kBM);
  if (refused == CUDA_SUCCESS) refused = encode(&p.b, b, k, n, kBoxN, kBK);
  if (refused != CUDA_SUCCESS) {
    if (cur != device) cudaSetDevice(cur);
    return static_cast<int>(refused);
  }
  p.c = static_cast<__nv_bfloat16*>(c);
  p.m = m;
  p.n = n;
  p.k = k;
  const int tiles = (m / kBM) * ((n + kBN - 1) / kBN);
  const dim3 grid(tiles < g_sms[device] ? tiles : g_sms[device]);
  matmul_bf16_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}
