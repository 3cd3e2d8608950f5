// Flash attention backward for f32 operands on Hopper (sm_90a): dQ, dK and
// dV of O = softmax(Q K^T / sqrt(d)) V, fp32 throughout, the probabilities
// recomputed from the forward's logsumexp, never stored; head_dim 64, 128 or
// 256, and on the streamed tiling (below) any multiple of 128 from 384 on.
//
// Replaces the two Pallas TPU kernels of k8s_gpu_hpa_tpu/ops/flash_attention.py
// called by `_flash_bhsd_bwd`, `_flash_bwd_dq_kernel` (pallas_call at :273)
// and `_flash_bwd_dkv_kernel` (pallas_call at :289), at f32, the dtype the
// JAX package's own gradient tests run them in.  Each computes what its
// Pallas kernel computes: S = (Q K^T) * scale in fp32, the causal mask
// q_pos >= k_pos with -1e30 before the exponential, P = exp(S - lse), dP =
// dO V^T, dS = P (dP - delta) scale, dQ = sum dS K, dV = sum P^T dO, dK =
// sum dS^T Q, all in fp32 (the operand dtype: no rounding between the
// products).  The exponentials are exp2 of log2(e)-prescaled scores.  delta
// = rowsum(dO O) in fp32 comes from the caller, as on the TPU.  Two
// kernels, as the bf16 and f16 pair (flash_attention_bwd.cu): dQ over Q
// tiles, dK and dV over K/V tiles, no atomics.
//
// Bound.  6 d operations a (batch-head, query, key) pair at or below the
// diagonal for dQ (S, dP, dS K) and 8 d for dK/dV (S^T, dP^T, P^T dO, dS^T
// Q), on the CUDA cores at the H100 SXM's f32 peak of 67 TFLOP/s (NVIDIA
// H100 SXM data sheet): at the llm training shape (b1, s2048, h4, d128,
// causal) 6.45 GFLOP, 96 us, and 8.59 GFLOP, 128 us, against 21.0 MB (6.3
// us) and 25.2 MB (7.5 us) at 3.35 TB/s.  The FFMA rate bounds both.
// ffma_tiles.cuh says why not the tensor cores.
//
// Design, the simplest that is right (making it fast is later work): one
// CTA of 256 threads per (batch-head, 64-row tile), heaviest causal tiles
// first; the CTA's own two tiles stay in shared memory and the other side's
// tiles stream through one stage (64 rows, 32 at head_dim 256, where two own
// tiles and two 64-row streamed tiles would pass the 227 KB a CTA may have),
// loaded with float4 loads behind a barrier; every product is one of
// ffma_tiles.cuh's register tiles, the score tiles (dS, P^T, dS^T) going
// through shared memory between the products.
//   - dQ: Q and dO stay; K and V tiles stream up to the diagonal.  S = Q
//     K^T, dP = dO V^T, then dS over V's tile (which dP no longer needs),
//     and dQ += dS K.  Each thread reads lse and delta for its four rows
//     once.
//   - dK/dV: K and V stay; Q and dO tiles stream from the diagonal on (or
//     from 0), each thread reading lse and delta for its score columns.
//     S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T into shared memory,
//     and dV += P^T dO, dK += dS^T Q.
//
// Head_dim 384 to 1024: the cluster tiling, one instantiation of each
// kernel, head_dim a kernel argument.  No tile holds a whole row.  Each CTA
// of 256 threads owns 64 rows and one 128-column chunk of its outputs'
// columns, and the n = head_dim / 128 CTAs of one (batch-head, 64-row tile)
// form a thread-block cluster (n = 3 to 8, 8 the portable limit; the grid's
// fast axis the batch-head's chunks, a CTA's rank in the cluster its chunk).
// Each CTA computes the part of every score tile over its own 128 columns,
// and the cluster sums the parts through distributed shared memory (DSMEM):
//   - dQ: Q's and dO's chunks stay; for each K/V tile up to the diagonal a
//     CTA loads K's and V's chunks alone, writes its partials S_c = Q_c K_c^T
//     and dP_c = dO_c V_c^T to its shared memory, and after a cluster
//     barrier sums the n partials of S and of dP from the cluster's shared
//     memory in rank order 0 .. n-1, so that every CTA sums the same values
//     in the same order and holds the same bits; then dS, and dQ_c += dS K_c
//     on the K chunk it holds.  V's chunk is done with once the partials
//     are in, so the next tile's comes in between the CTA's arrival at the
//     barrier and its wait;
//   - dK/dV: K's and V's chunks stay; for each Q tile from the diagonal on,
//     Q's and dO's chunks, the partials S^T_c = K_c Q_c^T and dP^T_c = V_c
//     dO_c^T, summed the same way; then P^T and dS^T, and dV_c += P^T dO_c,
//     dK_c += dS^T Q_c on the chunks it holds.
// So a pair costs the minimum across the cluster, 6 d and 8 d operations,
// and a tile two chunk loads a CTA; the exchange adds 2 n DSMEM loads of a
// 16 KB partial a CTA a tile.  Shared memory: four 64 x 128 chunks (135 KB)
// and four slots of a padded 64 x 64 score tile (70 KB), 204,800 bytes, one
// CTA an SM.  A tile's partials (S and dP) take the two slots of its
// parity; the score tiles of its products (dQ's dS; dK/dV's P^T and dS^T)
// take the other parity's, which no peer loads during the tile.  So one
// cluster barrier a tile orders the exchange: a CTA writes a parity's
// partials again two tiles on, after a barrier that every peer reached once
// done loading them; and a last barrier keeps each CTA, and its shared
// memory, until its peers are done with it.  At the training shape of four
// heads of 512 in f32 (b1, s2048, h4, causal) the minima are 25.8 and 34.4
// GFLOP, 385 and 513 us at 67 TFLOP/s, against 84 and 101 MB, 25 and 30 us
// at 3.35 TB/s: the FFMA rate bounds both.
//
// Past 1024 (n > 8, beyond the portable cluster) the streamed tiling runs:
// the same CTAs, no cluster, each summing S and dP (or S^T and dP^T) over
// the whole head_dim itself in a runtime loop of 128-column chunks of Q, K,
// dO and V (135 KB); then its own columns' products as above.  A pair costs
// 4 d n + 2 d operations in dQ and 4 d n + 4 d in dK/dV.  (A CTA of a
// cluster that owned two chunks would hold eight 64 x 128 chunks, 270 KB.)
//
// Layout.  Q, K, V, dO, dQ, dK and dV are [B, S, H, D] with D contiguous and
// any other strides (element counts, multiples of 8); a [B*H, S, D] tensor
// is the case H = 1.  lse and delta are [B*H, S] fp32, contiguous.  S must
// be a multiple of 64.  The Python wrapper (ops/flash_attention.py) checks
// all of this before it calls in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ffma_tiles.cuh"
#include "hopper_ptx.cuh"

namespace {

template <int D, bool DKV>
struct Cfg {
  using T = F32Tiles<D>;
  // the own two tiles, the streamed two, and dK/dV's P^T and dS^T (dQ's dS
  // lies over V's tile)
  static constexpr size_t kSmem =
      (2 * T::kTileFloats + 2 * T::kOtherFloats + (DKV ? 2 * T::kScoreFloats : 0)) *
      sizeof(float);
  static_assert(T::kScoreFloats <= T::kOtherFloats, "dS fits over the V tile");
  static_assert(kSmem <= 232448, "shared memory of a CTA");
};

struct Params {
  const float* in[4];  // q, k, v, dout
  const float* lse;    // [b*h, s]
  const float* delta;
  float* out[2];       // dQ; or dK and dV
  int64_t st[4][3];    // (batch, seq, head) element strides of q, k, v, dout
  int64_t out_st[2][3];
  int heads, seq;
  float scale;       // 1/sqrt(d)
  float scale_log2;  // 1/sqrt(d) * log2(e)
  int causal;
  int head_dim;
};

__device__ __forceinline__ int64_t at(const int64_t (&st)[3], int b, int row, int h) {
  return b * st[0] + static_cast<int64_t>(row) * st[1] + h * st[2];
}

// dQ's step between its products: P = exp(S scale - lse) under the mask
// where the K/V tile from kv0 reaches past the CTA's first row q0
// (`crossing`), then dS = P (dP - delta) scale, in dP's registers
template <class T>
__device__ __forceinline__ void probs_ds(float (&s)[4][T::kCols], float (&dp)[4][T::kCols],
                                         const float (&lse_l2)[4], const float (&delta)[4],
                                         const Params& p, bool crossing, int q0, int kv0,
                                         int ty, int tx) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < T::kCols; ++jj) {
      if (crossing && q0 + 4 * ty + ii < kv0 + tx + 16 * jj) s[ii][jj] = kF32NegInf;
      const float pe = exp2f(fmaf(s[ii][jj], p.scale_log2, -lse_l2[ii]));
      dp[ii][jj] = pe * (dp[ii][jj] - delta[ii]) * p.scale;
    }
  }
}

// dK/dV's step between its products: P^T = exp(S^T scale - lse[col]) under
// the mask where the Q tile from q0 reaches above the CTA's last key
// (`crossing`; its first key k0), then dS^T = P^T (dP^T - delta[col])
// scale, each thread reading lse and delta for its score columns
template <class T>
__device__ __forceinline__ void transposed_probs_ds(float (&s)[4][T::kCols],
                                                    float (&dp)[4][T::kCols], const Params& p,
                                                    int bh, bool crossing, int q0, int k0,
                                                    int ty, int tx) {
#pragma unroll
  for (int jj = 0; jj < T::kCols; ++jj) {
    const int q = q0 + tx + 16 * jj;
    const int64_t row = static_cast<int64_t>(bh) * p.seq + q;
    const float lse_l2 = p.lse[row] * kF32Log2e;
    const float dl = p.delta[row];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      if (crossing && q < k0 + 4 * ty + ii) s[ii][jj] = kF32NegInf;
      s[ii][jj] = exp2f(fmaf(s[ii][jj], p.scale_log2, -lse_l2));
      dp[ii][jj] = s[ii][jj] * (dp[ii][jj] - dl) * p.scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ Params p) {
  using T = F32Tiles<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = q_s + T::kTileFloats;
  float* k_s = do_s + T::kTileFloats;
  float* v_s = k_s + T::kOtherFloats;
  float* ds_s = v_s;  // dS over V, once dP is done with it

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;  // the longest causal loops first
  const int n_kv = (p.causal ? q0 + kF32Rows : p.seq) / T::kOther;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<D>(q_s, p.in[0] + at(p.st[0], b, q0, h), kF32Rows, p.st[0][1]);
  load_rows<D>(do_s, p.in[3] + at(p.st[3], b, q0, h), kF32Rows, p.st[3][1]);
  float lse_l2[4], delta[4];  // lse in log2 units
  float dq[4][T::kOut];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t row = static_cast<int64_t>(bh) * p.seq + q0 + 4 * ty + ii;
    lse_l2[ii] = p.lse[row] * kF32Log2e;
    delta[ii] = p.delta[row];
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) dq[ii][c] = 0.0f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * T::kOther;
    __syncthreads();  // the previous tile's dS K is done with dS and K
    load_rows<D>(k_s, p.in[1] + at(p.st[1], b, kv0, h), T::kOther, p.st[1][1]);
    load_rows<D>(v_s, p.in[2] + at(p.st[2], b, kv0, h), T::kOther, p.st[2][1]);
    __syncthreads();
    float s[4][T::kCols], dp[4][T::kCols];
    scores<D>(s, q_s, k_s, ty, tx);
    scores<D>(dp, do_s, v_s, ty, tx);
    probs_ds<T>(s, dp, lse_l2, delta, p, p.causal && kv0 + T::kOther - 1 > q0, q0, kv0, ty, tx);
    __syncthreads();  // every thread's dP is done with V
    put_scores<D>(ds_s, dp, ty, tx);
    __syncthreads();
    accumulate<D>(dq, ds_s, k_s, ty, tx);
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_out<D>(p.out[0] + at(p.out_st[0], b, q0, h), p.out_st[0][1], dq, one, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dkv_f32_kernel(const __grid_constant__ Params p) {
  using T = F32Tiles<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + T::kTileFloats;
  float* q_s = v_s + T::kTileFloats;
  float* do_s = q_s + T::kOtherFloats;
  float* pt_s = do_s + T::kOtherFloats;  // P^T
  float* dst_s = pt_s + T::kScoreFloats;  // dS^T

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * kF32Rows;  // the longest causal loops first
  // causal: Q tiles before the CTA's first key see none of its keys
  const int lo = p.causal ? k0 / T::kOther : 0;
  const int count = p.seq / T::kOther - lo;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<D>(k_s, p.in[1] + at(p.st[1], b, k0, h), kF32Rows, p.st[1][1]);
  load_rows<D>(v_s, p.in[2] + at(p.st[2], b, k0, h), kF32Rows, p.st[2][1]);
  float dk[4][T::kOut], dv[4][T::kOut];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) dk[ii][c] = dv[ii][c] = 0.0f;
  }

  for (int n = 0; n < count; ++n) {
    const int q0 = (lo + n) * T::kOther;
    __syncthreads();  // the previous tile's products are done with its tiles
    load_rows<D>(q_s, p.in[0] + at(p.st[0], b, q0, h), T::kOther, p.st[0][1]);
    load_rows<D>(do_s, p.in[3] + at(p.st[3], b, q0, h), T::kOther, p.st[3][1]);
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: rows are the CTA's keys, columns the
    // tile's queries
    float s[4][T::kCols], dp[4][T::kCols];
    scores<D>(s, k_s, q_s, ty, tx);
    scores<D>(dp, v_s, do_s, ty, tx);
    transposed_probs_ds<T>(s, dp, p, bh, p.causal && q0 < k0 + kF32Rows - 1, q0, k0, ty, tx);
    put_scores<D>(pt_s, s, ty, tx);
    put_scores<D>(dst_s, dp, ty, tx);
    __syncthreads();
    accumulate<D>(dv, pt_s, do_s, ty, tx);
    accumulate<D>(dk, dst_s, q_s, ty, tx);
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_out<D>(p.out[0] + at(p.out_st[0], b, k0, h), p.out_st[0][1], dk, one, ty, tx);
  store_out<D>(p.out[1] + at(p.out_st[1], b, k0, h), p.out_st[1][1], dv, one, ty, tx);
}

// the streamed tiling (the file's note): four 64 x 128 chunks
constexpr size_t kStreamedSmem = 4 * F32Chunk::kTileFloats * sizeof(float);
static_assert(F32Chunk::kOther == kF32Rows, "streamed tiles of 64 rows");
static_assert(kStreamedSmem <= 232448, "shared memory of a CTA");

// the cluster tiling (the file's note): four 64 x 128 chunks and four slots
// of a padded score tile; a partial lies in a slot thread-major, the
// thread's float4 ii at float (ii * kF32Threads + t) * 4, so that a warp's
// loads of it, in its own CTA or a peer's, are 512 contiguous bytes
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr uint32_t kSlotFloats = F32Chunk::kScoreFloats;
constexpr size_t kClusterSmem = (4 * F32Chunk::kTileFloats + 4 * kSlotFloats) * sizeof(float);
static_assert(4 * 4 * kF32Threads <= kSlotFloats, "a partial fits a slot");
static_assert(kClusterSmem <= 232448, "shared memory of a CTA");

// The CTA's (batch-head, chunk, own 64 rows) on the streamed and cluster
// tilings; the chunk is given (the cluster's: the CTA's rank), the own rows
// counted down from the last (dQ's longest causal loops first) or up from 0
// (dK/dV's)
struct StreamedCta {
  int bh, b, h, chunk, chunks, row0;
  __device__ StreamedCta(const Params& p, bool down, int chunk_) : chunk(chunk_) {
    chunks = p.head_dim / kF32ChunkCols;
    bh = blockIdx.x / chunks;
    b = bh / p.heads;
    h = bh % p.heads;
    row0 = (down ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kF32Rows;
  }
};

// a += x y^T and c += z w^T over the head_dim: the score tiles of the own
// rows of x and z (from row `own`) against the streamed rows of y and w
// (from row `other`), a 128-column chunk of each of the four at a time
// through bufs[0..3]
__device__ __forceinline__ void streamed_scores(
    float (&a)[4][F32Chunk::kCols], float (&c)[4][F32Chunk::kCols], float* const (&bufs)[4],
    const Params& p, const StreamedCta& cta, int x, int y, int z, int w, int own, int other,
    int ty, int tx) {
  const int which[4] = {x, y, z, w};
  const int rows[4] = {own, other, own, other};
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < F32Chunk::kCols; ++jj) a[ii][jj] = c[ii][jj] = 0.0f;
  }
  for (int k = 0; k < cta.chunks; ++k) {
    __syncthreads();  // the previous chunk's (or tile's) products are done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load_rows<kF32ChunkCols>(
          bufs[i], p.in[which[i]] + at(p.st[which[i]], cta.b, rows[i], cta.h) + k * kF32ChunkCols,
          kF32Rows, p.st[which[i]][1]);
    }
    __syncthreads();
    add_scores<kF32ChunkCols>(a, bufs[0], bufs[1], ty, tx);
    add_scores<kF32ChunkCols>(c, bufs[2], bufs[3], ty, tx);
  }
}

// the streamed dQ (the file's note)
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dq_f32_streamed_kernel(const __grid_constant__ Params p) {
  using T = F32Chunk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* const bufs[4] = {
      reinterpret_cast<float*>(smem_raw), reinterpret_cast<float*>(smem_raw) + T::kTileFloats,
      reinterpret_cast<float*>(smem_raw) + 2 * T::kTileFloats,
      reinterpret_cast<float*>(smem_raw) + 3 * T::kTileFloats};
  const StreamedCta cta(p, true, blockIdx.x % (p.head_dim / kF32ChunkCols));
  const int q0 = cta.row0;
  const int n_kv = (p.causal ? q0 + kF32Rows : p.seq) / kF32Rows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float lse_l2[4], delta[4];  // lse in log2 units
  float dq[4][T::kOut];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t row = static_cast<int64_t>(cta.bh) * p.seq + q0 + 4 * ty + ii;
    lse_l2[ii] = p.lse[row] * kF32Log2e;
    delta[ii] = p.delta[row];
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) dq[ii][c] = 0.0f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * kF32Rows;
    float s[4][T::kCols], dp[4][T::kCols];
    // S = Q K^T and dP = dO V^T over the head_dim
    streamed_scores(s, dp, bufs, p, cta, 0, 1, 3, 2, q0, kv0, ty, tx);
    probs_ds<T>(s, dp, lse_l2, delta, p, p.causal && kv0 + kF32Rows - 1 > q0, q0, kv0, ty, tx);
    __syncthreads();  // every thread's scores are done with the chunks
    // K's chunk of the CTA's columns, and dS
    load_rows<kF32ChunkCols>(
        bufs[0], p.in[1] + at(p.st[1], cta.b, kv0, cta.h) + cta.chunk * kF32ChunkCols, kF32Rows,
        p.st[1][1]);
    put_scores<kF32ChunkCols>(bufs[1], dp, ty, tx);
    __syncthreads();
    accumulate<kF32ChunkCols>(dq, bufs[1], bufs[0], ty, tx);
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_out<kF32ChunkCols>(
      p.out[0] + at(p.out_st[0], cta.b, q0, cta.h) + cta.chunk * kF32ChunkCols, p.out_st[0][1],
      dq, one, ty, tx);
}

// the streamed dK/dV (the file's note)
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dkv_f32_streamed_kernel(const __grid_constant__ Params p) {
  using T = F32Chunk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* const bufs[4] = {
      reinterpret_cast<float*>(smem_raw), reinterpret_cast<float*>(smem_raw) + T::kTileFloats,
      reinterpret_cast<float*>(smem_raw) + 2 * T::kTileFloats,
      reinterpret_cast<float*>(smem_raw) + 3 * T::kTileFloats};
  const StreamedCta cta(p, false, blockIdx.x % (p.head_dim / kF32ChunkCols));
  const int k0 = cta.row0;
  // causal: Q tiles before the CTA's first key see none of its keys
  const int lo = p.causal ? k0 / kF32Rows : 0;
  const int count = p.seq / kF32Rows - lo;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int cols = cta.chunk * kF32ChunkCols;

  float dk[4][T::kOut], dv[4][T::kOut];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) dk[ii][c] = dv[ii][c] = 0.0f;
  }

  for (int n = 0; n < count; ++n) {
    const int q0 = (lo + n) * kF32Rows;
    // S^T = K Q^T and dP^T = V dO^T over the head_dim: rows are the CTA's
    // keys, columns the tile's queries
    float s[4][T::kCols], dp[4][T::kCols];
    streamed_scores(s, dp, bufs, p, cta, 1, 0, 2, 3, k0, q0, ty, tx);
    transposed_probs_ds<T>(s, dp, p, cta.bh, p.causal && q0 < k0 + kF32Rows - 1, q0, k0, ty, tx);
    __syncthreads();  // every thread's scores are done with the chunks
    // Q's and dO's chunks of the CTA's columns, P^T and dS^T
    load_rows<kF32ChunkCols>(bufs[0], p.in[0] + at(p.st[0], cta.b, q0, cta.h) + cols, kF32Rows,
                             p.st[0][1]);
    load_rows<kF32ChunkCols>(bufs[2], p.in[3] + at(p.st[3], cta.b, q0, cta.h) + cols, kF32Rows,
                             p.st[3][1]);
    put_scores<kF32ChunkCols>(bufs[1], s, ty, tx);
    put_scores<kF32ChunkCols>(bufs[3], dp, ty, tx);
    __syncthreads();
    accumulate<kF32ChunkCols>(dv, bufs[1], bufs[2], ty, tx);
    accumulate<kF32ChunkCols>(dk, bufs[3], bufs[0], ty, tx);
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_out<kF32ChunkCols>(p.out[0] + at(p.out_st[0], cta.b, k0, cta.h) + cols, p.out_st[0][1],
                           dk, one, ty, tx);
  store_out<kF32ChunkCols>(p.out[1] + at(p.out_st[1], cta.b, k0, cta.h) + cols, p.out_st[1][1],
                           dv, one, ty, tx);
}

// writes the thread's score tile `s` to `slot`, thread-major (kClusterSmem)
__device__ __forceinline__ void put_partial(float* slot, const float (&s)[4][F32Chunk::kCols]) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    *reinterpret_cast<float4*>(slot + (ii * kF32Threads + threadIdx.x) * 4) = {
        s[ii][0], s[ii][1], s[ii][2], s[ii][3]};
  }
}

// a = the sum of the cluster's partials at `x`, and c of those at `z` (the
// same slots in every CTA), rank 0 first: every CTA adds the same values in
// the same order
__device__ __forceinline__ void sum_partials(float (&a)[4][F32Chunk::kCols],
                                             float (&c)[4][F32Chunk::kCols], const float* x,
                                             const float* z, int ranks) {
  const uint32_t ax = smem_u32(x) + threadIdx.x * 16, az = smem_u32(z) + threadIdx.x * 16;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < F32Chunk::kCols; ++jj) a[ii][jj] = c[ii][jj] = 0.0f;
  }
  for (int r = 0; r < ranks; ++r) {
    const uint32_t px = mapa(ax, r), pz = mapa(az, r);
    float4 vx[4], vz[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      vx[ii] = ld_cluster_f4(px + ii * kF32Threads * 16);
      vz[ii] = ld_cluster_f4(pz + ii * kF32Threads * 16);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      a[ii][0] += vx[ii].x, a[ii][1] += vx[ii].y, a[ii][2] += vx[ii].z, a[ii][3] += vx[ii].w;
      c[ii][0] += vz[ii].x, c[ii][1] += vz[ii].y, c[ii][2] += vz[ii].z, c[ii][3] += vz[ii].w;
    }
  }
}

// The cluster tiling's shared memory: Q's and dO's chunks (dQ) or K's and
// V's (dK/dV), which stay, the other two, which stream, and the slots, two
// a tile parity: its partials of S and dP (or S^T and dP^T)
struct ClusterSmem {
  float* own[2];
  float* streamed[2];
  float* slots;
  __device__ explicit ClusterSmem(unsigned char* raw) {
    float* f = reinterpret_cast<float*>(raw);
    own[0] = f, own[1] = f + F32Chunk::kTileFloats;
    streamed[0] = f + 2 * F32Chunk::kTileFloats, streamed[1] = f + 3 * F32Chunk::kTileFloats;
    slots = f + 4 * F32Chunk::kTileFloats;
  }
  // the two slots of a tile's parity
  __device__ float* parity(int tile) const { return slots + (tile % 2) * 2 * kSlotFloats; }
};

// the cluster dQ (the file's note)
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dq_f32_cluster_kernel(const __grid_constant__ Params p) {
  using T = F32Chunk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const ClusterSmem sm(smem_raw);
  float *const q_s = sm.own[0], *const do_s = sm.own[1];
  float *const k_s = sm.streamed[0], *const v_s = sm.streamed[1];
  const StreamedCta cta(p, true, static_cast<int>(cluster_ctarank()));
  const int q0 = cta.row0;
  const int n_kv = (p.causal ? q0 + kF32Rows : p.seq) / kF32Rows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int cols = cta.chunk * kF32ChunkCols;

  load_rows<kF32ChunkCols>(q_s, p.in[0] + at(p.st[0], cta.b, q0, cta.h) + cols, kF32Rows,
                           p.st[0][1]);
  load_rows<kF32ChunkCols>(do_s, p.in[3] + at(p.st[3], cta.b, q0, cta.h) + cols, kF32Rows,
                           p.st[3][1]);
  float lse_l2[4], delta[4];  // lse in log2 units
  float dq[4][T::kOut];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t row = static_cast<int64_t>(cta.bh) * p.seq + q0 + 4 * ty + ii;
    lse_l2[ii] = p.lse[row] * kF32Log2e;
    delta[ii] = p.delta[row];
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) dq[ii][c] = 0.0f;
  }

  // V's chunk of the K/V tile from row kv0
  const auto load_v = [&](int kv0) {
    load_rows<kF32ChunkCols>(v_s, p.in[2] + at(p.st[2], cta.b, kv0, cta.h) + cols, kF32Rows,
                             p.st[2][1]);
  };
  load_v(0);
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * kF32Rows;
    float* const part = sm.parity(j);
    float* const ds_s = sm.parity(j + 1);  // no peer loads it during this tile
    __syncthreads();  // the previous tile's dS K is done with K and dS
    load_rows<kF32ChunkCols>(k_s, p.in[1] + at(p.st[1], cta.b, kv0, cta.h) + cols, kF32Rows,
                             p.st[1][1]);
    __syncthreads();
    float s[4][T::kCols], dp[4][T::kCols];
    scores<kF32ChunkCols>(s, q_s, k_s, ty, tx);
    scores<kF32ChunkCols>(dp, do_s, v_s, ty, tx);
    put_partial(part, s);
    put_partial(part + kSlotFloats, dp);
    cluster_arrive();  // this CTA's partials of the tile are in
    __syncthreads();   // every thread's dP is done with V: the next V comes in
    if (j + 1 < n_kv) load_v(kv0 + kF32Rows);
    cluster_wait();  // and every peer's
    sum_partials(s, dp, part, part + kSlotFloats, cta.chunks);
    probs_ds<T>(s, dp, lse_l2, delta, p, p.causal && kv0 + kF32Rows - 1 > q0, q0, kv0, ty, tx);
    put_scores<kF32ChunkCols>(ds_s, dp, ty, tx);
    __syncthreads();
    accumulate<kF32ChunkCols>(dq, ds_s, k_s, ty, tx);
  }
  cluster_sync();  // no CTA leaves while a peer may still load its partials

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_out<kF32ChunkCols>(p.out[0] + at(p.out_st[0], cta.b, q0, cta.h) + cols, p.out_st[0][1],
                           dq, one, ty, tx);
}

// the cluster dK/dV (the file's note)
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dkv_f32_cluster_kernel(const __grid_constant__ Params p) {
  using T = F32Chunk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const ClusterSmem sm(smem_raw);
  float *const k_s = sm.own[0], *const v_s = sm.own[1];
  float *const q_s = sm.streamed[0], *const do_s = sm.streamed[1];
  const StreamedCta cta(p, false, static_cast<int>(cluster_ctarank()));
  const int k0 = cta.row0;
  // causal: Q tiles before the CTA's first key see none of its keys
  const int lo = p.causal ? k0 / kF32Rows : 0;
  const int count = p.seq / kF32Rows - lo;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int cols = cta.chunk * kF32ChunkCols;

  load_rows<kF32ChunkCols>(k_s, p.in[1] + at(p.st[1], cta.b, k0, cta.h) + cols, kF32Rows,
                           p.st[1][1]);
  load_rows<kF32ChunkCols>(v_s, p.in[2] + at(p.st[2], cta.b, k0, cta.h) + cols, kF32Rows,
                           p.st[2][1]);
  float dk[4][T::kOut], dv[4][T::kOut];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) dk[ii][c] = dv[ii][c] = 0.0f;
  }

  for (int n = 0; n < count; ++n) {
    const int q0 = (lo + n) * kF32Rows;
    float* const part = sm.parity(n);
    float* const pt_s = sm.parity(n + 1);  // P^T, then dS^T: no peer loads them now
    float* const dst_s = pt_s + kSlotFloats;
    __syncthreads();  // the previous tile's products are done with its tiles
    load_rows<kF32ChunkCols>(q_s, p.in[0] + at(p.st[0], cta.b, q0, cta.h) + cols, kF32Rows,
                             p.st[0][1]);
    load_rows<kF32ChunkCols>(do_s, p.in[3] + at(p.st[3], cta.b, q0, cta.h) + cols, kF32Rows,
                             p.st[3][1]);
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: rows are the CTA's keys, columns the
    // tile's queries
    float s[4][T::kCols], dp[4][T::kCols];
    scores<kF32ChunkCols>(s, k_s, q_s, ty, tx);
    scores<kF32ChunkCols>(dp, v_s, do_s, ty, tx);
    put_partial(part, s);
    put_partial(part + kSlotFloats, dp);
    cluster_sync();  // every CTA's partials of this tile are in
    sum_partials(s, dp, part, part + kSlotFloats, cta.chunks);
    transposed_probs_ds<T>(s, dp, p, cta.bh, p.causal && q0 < k0 + kF32Rows - 1, q0, k0, ty, tx);
    put_scores<kF32ChunkCols>(pt_s, s, ty, tx);
    put_scores<kF32ChunkCols>(dst_s, dp, ty, tx);
    __syncthreads();
    accumulate<kF32ChunkCols>(dv, pt_s, do_s, ty, tx);
    accumulate<kF32ChunkCols>(dk, dst_s, q_s, ty, tx);
  }
  cluster_sync();  // no CTA leaves while a peer may still load its partials

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_out<kF32ChunkCols>(p.out[0] + at(p.out_st[0], cta.b, k0, cta.h) + cols, p.out_st[0][1],
                           dk, one, ty, tx);
  store_out<kF32ChunkCols>(p.out[1] + at(p.out_st[1], cta.b, k0, cta.h) + cols, p.out_st[1][1],
                           dv, one, ty, tx);
}

// head_dims of the fixed tilings, of the cluster one and of the streamed one
bool fixed_width(int head_dim) { return head_dim == 64 || head_dim == 128 || head_dim == 256; }
bool chunked(int head_dim) { return head_dim >= 384 && head_dim % kF32ChunkCols == 0; }
bool clustered(int head_dim) {
  return chunked(head_dim) && head_dim <= kMaxCluster * kF32ChunkCols;
}
bool streamed(int head_dim) { return chunked(head_dim) && !clustered(head_dim); }

// a launch of the cluster tiling: the grid, and a cluster of the
// batch-head's chunks along its fast axis
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(dim3 grid, int chunks, cudaStream_t stream) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = chunks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kF32Threads);
    cfg.dynamicSmemBytes = kClusterSmem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

template <int D>
cudaError_t opt_in_both() {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cfg<D, false>::kSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Cfg<D, true>::kSmem));
  }
  return err;
}

template <int D, bool DKV>
void launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const dim3 grid(batch_heads, p.seq / kF32Rows);
  if constexpr (DKV) {
    flash_bwd_dkv_f32_kernel<D><<<grid, kF32Threads, Cfg<D, true>::kSmem, stream>>>(p);
  } else {
    flash_bwd_dq_f32_kernel<D><<<grid, kF32Threads, Cfg<D, false>::kSmem, stream>>>(p);
  }
}

int put_config(const int (&values)[7], int* out, int n) {
  for (int i = 0; i < n && i < 7; ++i) out[i] = values[i];
  return 7;
}

template <class C>
int config_of(int* out, int n) {
  // one CTA a (batch-head, 64-row tile): its chunks, 1
  return put_config({kF32Threads, 1, static_cast<int>(C::kSmem), 0, 0, 1, C::T::kOther}, out, n);
}

int launch_bwd(bool dkv, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* out0, void* out1,
               const int64_t* strides, int batch, int heads, int seq, int head_dim, int causal,
               float scale, int device, void* stream) {
  if (!fixed_width(head_dim) && !chunked(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  Params p;
  const void* in[4] = {q, k, v, dout};
  for (int t = 0; t < 4; ++t) {
    p.in[t] = static_cast<const float*>(in[t]);
    for (int a = 0; a < 3; ++a) p.st[t][a] = strides[3 * t + a];
  }
  p.lse = lse;
  p.delta = delta;
  p.out[0] = static_cast<float*>(out0);
  p.out[1] = static_cast<float*>(out1);
  // dq's strides, or dk's and dv's
  for (int o = 0; o < 2; ++o) {
    for (int a = 0; a < 3; ++a) p.out_st[o][a] = strides[(dkv ? 15 + 3 * o : 12) + a];
  }
  p.heads = heads;
  p.seq = seq;
  p.scale = scale;
  p.scale_log2 = scale * kF32Log2e;
  p.causal = causal;
  p.head_dim = head_dim;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  const int chunks = head_dim / kF32ChunkCols;
  const dim3 chunk_grid(bh * chunks, seq / kF32Rows);
  if (clustered(head_dim)) {
    const ClusterLaunch cl(chunk_grid, chunks, s);
    err = dkv ? cudaLaunchKernelEx(&cl.cfg, flash_bwd_dkv_f32_cluster_kernel, p)
              : cudaLaunchKernelEx(&cl.cfg, flash_bwd_dq_f32_cluster_kernel, p);
    if (err != cudaSuccess) {
      if (cur != device) cudaSetDevice(cur);
      return static_cast<int>(err);
    }
  } else if (streamed(head_dim)) {
    if (dkv) {
      flash_bwd_dkv_f32_streamed_kernel<<<chunk_grid, kF32Threads, kStreamedSmem, s>>>(p);
    } else {
      flash_bwd_dq_f32_streamed_kernel<<<chunk_grid, kF32Threads, kStreamedSmem, s>>>(p);
    }
  } else if (head_dim == 256) {
    dkv ? launch<256, true>(p, bh, s) : launch<256, false>(p, bh, s);
  } else if (head_dim == 128) {
    dkv ? launch<128, true>(p, bh, s) : launch<128, false>(p, bh, s);
  } else {
    dkv ? launch<64, true>(p, bh, s) : launch<64, false>(p, bh, s);
  }
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}

}  // namespace

// C entries, bound with ctypes, as flash_attention_bwd.cu's: the same names
// and arguments, so ops/flash_attention.py drives either library alike.
//
// flash_attention_bwd_init opts the ten instantiations (each kernel at
// head_dim 64, 128 and 256, on clusters and streamed) in to the dynamic
// shared memory they need above the default 48 KB, once per device before
// the first launch.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_init(int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = opt_in_both<64>();
  if (err == cudaSuccess) err = opt_in_both<128>();
  if (err == cudaSuccess) err = opt_in_both<256>();
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_streamed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStreamedSmem));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32_streamed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStreamedSmem));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kClusterSmem));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kClusterSmem));
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The configuration of (dkv: the dK/dV kernel, else dQ; head_dim): threads,
// stages (one), dynamic shared memory in bytes, 0, 0 (no setmaxnreg), CTAs
// a (batch-head, 64-row tile) (chunks of the outputs' columns: on the
// cluster tiling the cluster's CTAs) and rows a streamed tile.  Returns how
// many values there are, or 0 where there is no such instantiation.
extern "C" int flash_attention_bwd_config(int dkv, int head_dim, int* out, int n) {
  if (chunked(head_dim)) {
    const size_t smem = clustered(head_dim) ? kClusterSmem : kStreamedSmem;
    return put_config({kF32Threads, 1, static_cast<int>(smem), 0, 0, head_dim / kF32ChunkCols,
                       F32Chunk::kOther}, out, n);
  }
  if (head_dim == 64) {
    return dkv ? config_of<Cfg<64, true>>(out, n) : config_of<Cfg<64, false>>(out, n);
  }
  if (head_dim == 128) {
    return dkv ? config_of<Cfg<128, true>>(out, n) : config_of<Cfg<128, false>>(out, n);
  }
  if (head_dim == 256) {
    return dkv ? config_of<Cfg<256, true>>(out, n) : config_of<Cfg<256, false>>(out, n);
  }
  return 0;
}

// The most clusters of (dkv: the dK/dV kernel, else dQ) at `head_dim` on
// the cluster tiling that `device`, initialised with
// flash_attention_bwd_init, holds at once
// (cudaOccupancyMaxActiveClusters), into `clusters`.  Returns a
// cudaError_t, cudaErrorInvalidValue for a head_dim off the cluster tiling.
extern "C" int flash_attention_bwd_max_clusters(int dkv, int head_dim, int device,
                                                int* clusters) {
  if (!clustered(head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int chunks = head_dim / kF32ChunkCols;
  const ClusterLaunch cl(dim3(chunks), chunks, nullptr);
  err = dkv ? cudaOccupancyMaxActiveClusters(clusters, flash_bwd_dkv_f32_cluster_kernel, &cl.cfg)
            : cudaOccupancyMaxActiveClusters(clusters, flash_bwd_dq_f32_cluster_kernel, &cl.cfg);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// `strides` holds 21 element strides: (batch, seq, head) for q, k, v, dout,
// dq, dk and dv; the dq entry reads those of dq and ignores dk and dv, the
// dkv entry the other way round.  lse and delta are [batch * heads, seq]
// fp32, contiguous.  `device` is the CUDA ordinal the pointers live on,
// initialised with flash_attention_bwd_init, and `stream` the caller's
// cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, const int64_t* strides, int batch, int heads,
                                      int seq, int head_dim, int causal, float scale, int device,
                                      void* stream) {
  return launch_bwd(false, q, k, v, dout, lse, delta, dq, dq, strides, batch, heads, seq,
                    head_dim, causal, scale, device, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, const int64_t* strides, int batch,
                                       int heads, int seq, int head_dim, int causal, float scale,
                                       int device, void* stream) {
  return launch_bwd(true, q, k, v, dout, lse, delta, dk, dv, strides, batch, heads, seq,
                    head_dim, causal, scale, device, stream);
}
