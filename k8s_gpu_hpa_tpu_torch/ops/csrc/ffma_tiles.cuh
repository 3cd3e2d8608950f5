// The tile products of the f32 flash-attention kernels
// (flash_attention_f32.cu, the forward; flash_attention_bwd_f32.cu, dQ and
// dK/dV): plain fp32 FFMA on the CUDA cores, operands staged in shared
// memory, accumulators in registers.  No wgmma, TMA or mbarrier, so the CPU
// simulator (tools/warpsim) compiles it as it is.
//
// Why not the tensor cores: wgmma's tf32 takes both shared-memory operands
// K-major only, with no transpose bit, where these products read V, K and Q
// N-major; and one tf32 pass rounds each operand to 10 mantissa bits, some
// 1e-2 near zero-valued results at K = 384, against the f32 bars of 2e-3
// (forward) and 2e-4 (gradients).  FFMA keeps every product in f32.
//
// Layout.  A CTA is 256 threads on a 16 x 16 grid, t = 16 ty + tx.  Every
// tile in shared memory is row-major, its rows kLd = D + 4 floats apart: the
// pad puts eight consecutive rows' 16-byte chunks in eight different bank
// groups, so a float4 read of one column chunk across rows is conflict-free,
// and a float4 read along a row stays aligned.  A score tile is 64 rows of
// the CTA's own tile by the streamed tile's kOther rows (64, or 32 at D 256,
// where shared memory would not hold 64); thread (ty, tx) holds rows 4 ty +
// ii (ii < 4) and columns tx + 16 jj (jj < kOther / 16) of it.  An output
// tile is 64 x D; the thread holds rows 4 ty + ii and columns 64 m + 4 tx +
// e (m < D / 64, e < 4), as acc[ii][4 m + e].
//
// The wide tilings (head_dim 384 and up, any multiple of 128) use the D =
// 128 tiles on 128-column chunks of wider rows, an output tile a CTA's 128
// columns.  The forward's streamed tiling, and the backward's past 1024,
// sum a score tile chunk by chunk in one CTA (add_scores); the backward's
// cluster tiling (384 to 1024) computes one chunk's part of it in each CTA
// of a cluster and sums the parts across the cluster
// (flash_attention_bwd_f32.cu).

#pragma once

#include <stdint.h>

namespace {

constexpr int kF32Threads = 256;
constexpr int kF32Rows = 64;  // rows of the CTA's own tile
constexpr float kF32NegInf = -1e30f;
constexpr float kF32Log2e = 1.4426950408889634f;
constexpr float kF32Ln2 = 0.6931471805599453f;

template <int D>
struct F32Tiles {
  static_assert(D == 64 || D == 128 || D == 256, "head_dim 64, 128 or 256");
  static constexpr int kLd = D + 4;                      // a tile's row stride, floats
  static constexpr int kOther = D == 256 ? 32 : 64;      // rows of a streamed tile
  static constexpr int kCols = kOther / 16;              // score columns a thread
  static constexpr int kPLd = kOther + 4;                // a score tile's row stride
  static constexpr int kOut = D / 16;                    // output columns a thread
  static constexpr uint32_t kTileFloats = kF32Rows * kLd;     // an own tile
  static constexpr uint32_t kOtherFloats = kOther * kLd;      // a streamed tile
  static constexpr uint32_t kScoreFloats = kF32Rows * kPLd;   // P, dS or their transposes
};

// the streamed tilings' chunk of a row: 128 columns, the D = 128 tiles
constexpr int kF32ChunkCols = 128;
using F32Chunk = F32Tiles<kF32ChunkCols>;

// `rows` rows of D floats from `src` (row r at src + r * row_stride, 16-byte
// aligned) into `dst`, rows kLd apart; the whole CTA takes part
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int rows,
                                          int64_t row_stride) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < rows * kVec; i += kF32Threads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    *reinterpret_cast<float4*>(dst + r * F32Tiles<D>::kLd + c) =
        *reinterpret_cast<const float4*>(src + r * row_stride + c);
  }
}

// s[ii][jj] += sum_k a[4 ty + ii][k] b[tx + 16 jj][k]: a score tile of the
// own tile `a` against the streamed tile `b`, both D wide, added to `s`
// (the streamed tilings sum one over the head_dim's 128-column chunks)
template <int D>
__device__ __forceinline__ void add_scores(float (&s)[4][F32Tiles<D>::kCols], const float* a,
                                           const float* b, int ty, int tx) {
  using T = F32Tiles<D>;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 av[4], bv[T::kCols];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      av[ii] = *reinterpret_cast<const float4*>(a + (4 * ty + ii) * T::kLd + k);
    }
#pragma unroll
    for (int jj = 0; jj < T::kCols; ++jj) {
      bv[jj] = *reinterpret_cast<const float4*>(b + (tx + 16 * jj) * T::kLd + k);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int jj = 0; jj < T::kCols; ++jj) {
        float x = s[ii][jj];
        x = fmaf(av[ii].x, bv[jj].x, x);
        x = fmaf(av[ii].y, bv[jj].y, x);
        x = fmaf(av[ii].z, bv[jj].z, x);
        s[ii][jj] = fmaf(av[ii].w, bv[jj].w, x);
      }
    }
  }
}

// s[ii][jj] = sum_k a[4 ty + ii][k] b[tx + 16 jj][k]
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][F32Tiles<D>::kCols], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < F32Tiles<D>::kCols; ++jj) s[ii][jj] = 0.0f;
  }
  add_scores<D>(s, a, b, ty, tx);
}

// writes a score tile held as `s` into `dst` (64 rows kPLd apart)
template <int D>
__device__ __forceinline__ void put_scores(float* dst, const float (&s)[4][F32Tiles<D>::kCols],
                                           int ty, int tx) {
  using T = F32Tiles<D>;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < T::kCols; ++jj) dst[(4 * ty + ii) * T::kPLd + tx + 16 * jj] = s[ii][jj];
  }
}

// acc[ii][4 m + e] += sum_j p[4 ty + ii][j] b[j][64 m + 4 tx + e]: a score
// tile `p` (64 x kOther, rows kPLd apart) times the streamed tile `b`
// (kOther x D), j in order
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][F32Tiles<D>::kOut], const float* p,
                                           const float* b, int ty, int tx) {
  using T = F32Tiles<D>;
#pragma unroll 2
  for (int j = 0; j < T::kOther; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      pv[ii] = *reinterpret_cast<const float4*>(p + (4 * ty + ii) * T::kPLd + j);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int m = 0; m < D / 64; ++m) {
        const float4 bv = *reinterpret_cast<const float4*>(b + (j + jj) * T::kLd + 64 * m + 4 * tx);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float w = jj == 0 ? pv[ii].x : jj == 1 ? pv[ii].y : jj == 2 ? pv[ii].z : pv[ii].w;
          acc[ii][4 * m + 0] = fmaf(w, bv.x, acc[ii][4 * m + 0]);
          acc[ii][4 * m + 1] = fmaf(w, bv.y, acc[ii][4 * m + 1]);
          acc[ii][4 * m + 2] = fmaf(w, bv.z, acc[ii][4 * m + 2]);
          acc[ii][4 * m + 3] = fmaf(w, bv.w, acc[ii][4 * m + 3]);
        }
      }
    }
  }
}

// stores an output tile's rows, each times its `scale[ii]`, at `dst` (row r
// at dst + r * row_stride)
template <int D>
__device__ __forceinline__ void store_out(float* dst, int64_t row_stride,
                                          const float (&acc)[4][F32Tiles<D>::kOut],
                                          const float (&scale)[4], int ty, int tx) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    float* row = dst + (4 * ty + ii) * row_stride;
#pragma unroll
    for (int m = 0; m < D / 64; ++m) {
      float4 v;
      v.x = acc[ii][4 * m + 0] * scale[ii];
      v.y = acc[ii][4 * m + 1] * scale[ii];
      v.z = acc[ii][4 * m + 2] * scale[ii];
      v.w = acc[ii][4 * m + 3] * scale[ii];
      *reinterpret_cast<float4*>(row + 64 * m + 4 * tx) = v;
    }
  }
}

// the sum (or max) of a value over the 16 threads of a score row: tx is the
// lane's low four bits
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int mask = 1; mask < 16; mask <<= 1) x += __shfl_xor_sync(0xffffffffu, x, mask);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int mask = 1; mask < 16; mask <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, mask));
  return x;
}

}  // namespace
