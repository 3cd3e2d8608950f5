// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T / sqrt(d)) V over bf16 operands, the probabilities
// recomputed from the forward's logsumexp, never stored.
//
// Replaces the two Pallas TPU kernels of k8s_gpu_hpa_tpu/ops/flash_attention.py
// called by `_flash_bhsd_bwd`: `_flash_bwd_dq_kernel` (pallas_call at :273)
// and `_flash_bwd_dkv_kernel` (pallas_call at :289).  Each computes what its
// Pallas kernel computes, in the same order and with the same roundings:
// S = (Q K^T) * scale in fp32, the causal mask q_pos >= k_pos with -1e30
// before the exponential, P = exp(S - lse), dP = dO V^T in fp32,
// dS = P * (dP - delta) * scale rounded to bf16, dQ = sum dS K, dV = sum
// P^T dO with P rounded to bf16, dK = sum dS^T Q, every sum in fp32 and
// rounded to bf16 once.  delta = rowsum(dO * O) in fp32 comes from the
// caller, as on the TPU.  Two kernels because the gradients parallelise
// over different axes without races: dQ over Q tiles (each CTA owns its
// rows), dK and dV over K/V tiles.  No atomics: results are deterministic.
//
// dQ kernel: one CTA per (batch-head, 64 Q rows), four warps of 16 rows.  Q
// and dO stay in registers as mma fragments; K/V tiles of 64 rows stream
// through two cp.async buffers and the loop stops at the forward's causal
// bound (the diagonal tile).  For each 16-key slice of a tile the warp
// computes S and dP (16x16 each) on the tensor cores, turns them into dS in
// registers, and adds dS K into its fp32 dQ accumulators, reusing the dS
// accumulators as the A operand.
//
// dK/dV kernel: one CTA per (batch-head, 64 K/V rows), four warps of 16
// rows.  K and V stay in shared memory; Q, dO, lse and delta tiles of 64 Q
// rows stream through two cp.async buffers from the diagonal on (causal) or
// from 0.  The warp computes the transposed scores S^T = K Q^T, so that its
// accumulators hold its own K/V rows: P^T = exp(S^T scale - lse[col]),
// dP^T = V dO^T and dS^T = P^T (dP^T - delta[col]) scale are then, packed to
// bf16, the A operands of dV += P^T dO and dK += dS^T Q, and nothing is
// transposed through shared memory.  Both products take their B operand
// from the same Q and dO tiles through ldmatrix.trans.  Working 16 Q rows at
// a time keeps the live registers at the two [16, D] fp32 accumulators
// (dK and dV) plus four 16x8 blocks: ptxas (CUDA 12.8, sm_90a) gives the
// dK/dV kernel 254 registers a thread at D = 128 and the dQ kernel 242, no
// spills, so a wider tile needs another split, not more registers.
//
// Tiles.  64-row tiles on both sides give 128 CTAs at the llm training
// shape (b1, s2048, h4, d128), one per SM of the 132, where 128-row Q tiles
// would give 64.  The causal work of a CTA grows with its distance from the
// diagonal end, so the dQ grid starts with the last Q tiles and the dK/dV
// grid with the first K/V tiles: the long CTAs start first.
//
// Bound.  Each (batch-head, query, key) pair at or below the diagonal costs
// 6 d operations in the dQ kernel (three products) and 8 d in the dK/dV
// kernel (four).  At the llm shape that is 4 * 2048 * 2049 / 2 pairs: 6.45
// GFLOP, 6.5 us, and 8.59 GFLOP, 8.7 us, at the H100 SXM's 989 TFLOP/s dense
// bf16, against 10.5 MB (3.2 us) and 12.6 MB (3.8 us) at 3.35 TB/s: the
// tensor cores bound both (NVIDIA H100 SXM data sheet).  mma.sync with
// operands re-read from shared memory is far from either; wgmma, TMA and
// warp specialisation are later work.
//
// Layout.  Q, K, V, dO, dQ, dK and dV are [B, S, H, D] with D contiguous and
// any other strides (element counts, multiples of 8); a [B*H, S, D] tensor is
// the case H = 1.  lse and delta are [B*H, S] fp32, contiguous.  S must be a
// multiple of 64 and D 64 or 128.  The Python wrapper (ops/flash_attention.py)
// checks all of this before it calls in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlk = 64;  // rows of every tile, Q and K/V alike
constexpr int kWarps = kBlk / 16;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  // (batch, seq, head) element strides of q, k, v, dout, dq, dk, dv
  int64_t st[7][3];
  int heads, seq;
  float scale;
  int causal;
};

enum { kQ, kK, kV, kDo, kDq, kDk, kDv };

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;  // padded row stride, elements
  static constexpr int kTile = kBlk * kLd;
  // dQ: Q, dO, two K and two V tiles; dK/dV: K, V, two Q and two dO tiles,
  // and two lse and two delta tiles
  static constexpr size_t kDqBytes = 6 * kTile * sizeof(bf16);
  static constexpr size_t kDkvBytes = kDqBytes + 4 * kBlk * sizeof(float);
};

__device__ __forceinline__ int64_t offset(const Params& p, int which, int b, int row, int h) {
  return b * p.st[which][0] + static_cast<int64_t>(row) * p.st[which][1] + h * p.st[which][2];
}

// one 64-row tile from device memory into a padded shared-memory tile
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t row_stride,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks in one row
  for (int id = tid; id < kBlk * kChunks; id += kThreads) {
    const int r = id / kChunks;
    const int c = (id % kChunks) * 8;
    cp_async16(dst + r * Smem<D>::kLd + c, src + r * row_stride + c);
  }
}

// Stores a warp's 16 x D fp32 accumulator rows `row0` and `row0 + 8` (this
// thread's two rows) as bf16.
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, int which, bf16* out, int b, int h,
                                           int row0, int lane, const float (&acc)[D / 8][4]) {
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* dst = out + offset(p, which, b, row0 + r * 8, h);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8 + c0) =
          __floats2bfloat162_rn(acc[i][2 * r], acc[i][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  using S = Smem<D>;
  constexpr int kLd = S::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + S::kTile;
  bf16* k_s = do_s + S::kTile;      // [2][kBlk][kLd]
  bf16* v_s = k_s + 2 * S::kTile;   // [2][kBlk][kLd]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal loops first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = iq * kBlk;

  const bf16* k_base = p.k + offset(p, kK, b, 0, h);
  const bf16* v_base = p.v + offset(p, kV, b, 0, h);
  load_tile<D>(q_s, p.q + offset(p, kQ, b, q0, h), p.st[kQ][1], tid);
  load_tile<D>(do_s, p.dout + offset(p, kDo, b, q0, h), p.st[kDo][1], tid);
  cp_async_commit();

  auto load_kv = [&](int stage, int tile) {
    const int64_t k0 = static_cast<int64_t>(tile) * kBlk;
    load_tile<D>(k_s + stage * S::kTile, k_base + k0 * p.st[kK][1], p.st[kK][1], tid);
    load_tile<D>(v_s + stage * S::kTile, v_base + k0 * p.st[kV][1], p.st[kV][1], tid);
  };

  // the forward's causal bound: Q tile iq sees K/V tiles 0 .. iq
  const int hi = p.causal ? iq + 1 : p.seq / kBlk;
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_one();  // Q and dO have landed
  __syncthreads();

  // Q and dO fragments of this warp's 16 rows, one per 16-wide slice of D
  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  {
    const int row = warp * 16 + (lane % 16);
    const int col = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(qf[kk], q_s + row * kLd + kk * 16 + col);
      ldmatrix_x4(dof[kk], do_s + row * kLd + kk * 16 + col);
    }
  }

  // this thread's rows g and g + 8 of the warp's 16
  const int g = lane / 4;
  const int row0 = q0 + warp * 16 + g;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = static_cast<int64_t>(bh) * p.seq + row0 + r * 8;
    lse[r] = p.lse[at];
    delta[r] = p.delta[at];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int j = 0; j < hi; ++j) {
    const int cur = j & 1;
    if (j + 1 < hi) load_kv(cur ^ 1, j + 1);
    // an empty group on the last tile keeps "all but the newest" meaning
    // "tile j has landed"
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* ks = k_s + cur * S::kTile;
    const bf16* vs = v_s + cur * S::kTile;

#pragma unroll
    for (int kc = 0; kc < kBlk / 16; ++kc) {
      // S = Q K^T and dP = dO V^T for the warp's 16 rows and keys
      // kc*16 .. kc*16 + 15 of the tile
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // matrices: keys kc*16 + {0..7, 8..15} x d kk*16 + {0..7, 8..15}
        const int m = lane / 8;
        const int key = kc * 16 + (lane % 8) + (m / 2) * 8;
        const int col = kk * 16 + (m % 2) * 8;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, ks + key * kLd + col);
        ldmatrix_x4(vf, vs + key * kLd + col);
        mma_bf16(s[0], qf[kk], kf[0], kf[1]);
        mma_bf16(s[1], qf[kk], kf[2], kf[3]);
        mma_bf16(dp[0], dof[kk], vf[0], vf[1]);
        mma_bf16(dp[1], dof[kk], vf[2], vf[3]);
      }
      // dS = P (dP - delta) scale, P = exp(S scale - lse) under the mask
      const int key0 = j * kBlk + kc * 16 + 2 * (lane % 4);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          float x = s[nb][e] * p.scale;
          if (p.causal && row0 + r * 8 < key0 + nb * 8 + (e % 2)) x = kNegInf;
          const float pe = expf(x - lse[r]);
          s[nb][e] = pe * (dp[nb][e] - delta[r]) * p.scale;
        }
      }
      uint32_t ds[4];
      pack_a(ds, s[0], s[1]);
      // dQ += dS K: K rows kc*16 .. are the k dimension, read transposed
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        const int key = kc * 16 + (lane % 16);
        const int col = nd * 16 + (lane / 16) * 8;
        uint32_t kt[4];
        ldmatrix_x4_trans(kt, ks + key * kLd + col);
        mma_bf16(acc[2 * nd], ds, kt[0], kt[1]);
        mma_bf16(acc[2 * nd + 1], ds, kt[2], kt[3]);
      }
    }
    // every warp is done reading `cur` before the next tile refills it
    __syncthreads();
  }
  store_rows<D>(p, kDq, p.dq, b, h, row0, lane, acc);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  using S = Smem<D>;
  constexpr int kLd = S::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + S::kTile;
  bf16* q_s = v_s + S::kTile;        // [2][kBlk][kLd]
  bf16* do_s = q_s + 2 * S::kTile;   // [2][kBlk][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * S::kTile);  // [2][kBlk]
  float* delta_s = lse_s + 2 * kBlk;                               // [2][kBlk]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int jk = blockIdx.x;  // the longest causal loops first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = jk * kBlk;

  load_tile<D>(k_s, p.k + offset(p, kK, b, k0, h), p.st[kK][1], tid);
  load_tile<D>(v_s, p.v + offset(p, kV, b, k0, h), p.st[kV][1], tid);
  cp_async_commit();

  const bf16* q_base = p.q + offset(p, kQ, b, 0, h);
  const bf16* do_base = p.dout + offset(p, kDo, b, 0, h);
  const float* lse_base = p.lse + static_cast<int64_t>(bh) * p.seq;
  const float* delta_base = p.delta + static_cast<int64_t>(bh) * p.seq;
  auto load_q = [&](int stage, int tile) {
    const int64_t q0 = static_cast<int64_t>(tile) * kBlk;
    load_tile<D>(q_s + stage * S::kTile, q_base + q0 * p.st[kQ][1], p.st[kQ][1], tid);
    load_tile<D>(do_s + stage * S::kTile, do_base + q0 * p.st[kDo][1], p.st[kDo][1], tid);
    // lse and delta: kBlk / 4 chunks of four floats each
    for (int id = tid; id < kBlk / 2; id += kThreads) {
      const int which = id / (kBlk / 4);
      const int c = (id % (kBlk / 4)) * 4;
      cp_async16((which ? delta_s : lse_s) + stage * kBlk + c,
                 (which ? delta_base : lse_base) + q0 + c);
    }
  };

  // causal: Q tiles before the diagonal see none of these keys
  const int lo = p.causal ? jk : 0;
  const int n_q = p.seq / kBlk;
  load_q(0, lo);
  cp_async_commit();

  // this thread's K/V rows g and g + 8 of the warp's 16
  const int g = lane / 4;
  const int row0 = k0 + warp * 16 + g;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.0f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.0f;
  }

  for (int i = lo; i < n_q; ++i) {
    const int cur = (i - lo) & 1;
    if (i + 1 < n_q) load_q(cur ^ 1, i + 1);
    cp_async_commit();
    cp_async_wait_one();  // K, V and Q tile i have landed
    __syncthreads();
    const bf16* qs = q_s + cur * S::kTile;
    const bf16* dos = do_s + cur * S::kTile;
    const float* lses = lse_s + cur * kBlk;
    const float* deltas = delta_s + cur * kBlk;

#pragma unroll
    for (int kc = 0; kc < kBlk / 16; ++kc) {
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 K/V rows and Q rows
      // kc*16 .. kc*16 + 15 of the tile
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_row = warp * 16 + (lane % 16);
        const int a_col = kk * 16 + (lane / 16) * 8;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, k_s + a_row * kLd + a_col);
        ldmatrix_x4(vf, v_s + a_row * kLd + a_col);
        // matrices: Q rows kc*16 + {0..7, 8..15} x d kk*16 + {0..7, 8..15}
        const int m = lane / 8;
        const int qrow = kc * 16 + (lane % 8) + (m / 2) * 8;
        const int col = kk * 16 + (m % 2) * 8;
        uint32_t qf[4], of[4];
        ldmatrix_x4(qf, qs + qrow * kLd + col);
        ldmatrix_x4(of, dos + qrow * kLd + col);
        mma_bf16(s[0], kf, qf[0], qf[1]);
        mma_bf16(s[1], kf, qf[2], qf[3]);
        mma_bf16(dp[0], vf, of[0], of[1]);
        mma_bf16(dp[1], vf, of[2], of[3]);
      }
      // P^T = exp(S^T scale - lse[col]) under the mask,
      // dS^T = P^T (dP^T - delta[col]) scale
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kc * 16 + nb * 8 + 2 * (lane % 4) + (e % 2);
          float x = s[nb][e] * p.scale;
          if (p.causal && i * kBlk + col < row0 + (e / 2) * 8) x = kNegInf;
          const float pe = expf(x - lses[col]);
          s[nb][e] = pe;
          dp[nb][e] = pe * (dp[nb][e] - deltas[col]) * p.scale;
        }
      }
      uint32_t pa[4], ds[4];
      pack_a(pa, s[0], s[1]);
      pack_a(ds, dp[0], dp[1]);
      // dV += P^T dO and dK += dS^T Q: Q rows kc*16 .. are the k dimension,
      // read transposed
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        const int qrow = kc * 16 + (lane % 16);
        const int col = nd * 16 + (lane / 16) * 8;
        uint32_t ot[4], qt[4];
        ldmatrix_x4_trans(ot, dos + qrow * kLd + col);
        ldmatrix_x4_trans(qt, qs + qrow * kLd + col);
        mma_bf16(dv[2 * nd], pa, ot[0], ot[1]);
        mma_bf16(dv[2 * nd + 1], pa, ot[2], ot[3]);
        mma_bf16(dk[2 * nd], ds, qt[0], qt[1]);
        mma_bf16(dk[2 * nd + 1], ds, qt[2], qt[3]);
      }
    }
    // every warp is done reading `cur` before the next tile refills it
    __syncthreads();
  }
  store_rows<D>(p, kDk, p.dk, b, h, row0, lane, dk);
  store_rows<D>(p, kDv, p.dv, b, h, row0, lane, dv);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Runs `launch` with `device` current, then puts the caller's device back.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = launch();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int64_t* strides, int heads,
                   int seq, int causal, float scale) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  for (int t = 0; t < 7; ++t) {
    for (int a = 0; a < 3; ++a) p.st[t][a] = strides[3 * t + a];
  }
  p.heads = heads;
  p.seq = seq;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// C entries, bound with ctypes.  Each returns a cudaError_t: nonzero means
// the call was refused and nothing ran.
//
// flash_attention_bwd_init opts the four instantiations in to the dynamic
// shared memory they need above the default 48 KB.  It is called once per
// device at the first launch, never inside a launch: a launch may sit inside
// CUDA-graph capture.
extern "C" int flash_attention_bwd_init(int device) {
  return on_device(device, [] {
    cudaError_t err = opt_in(flash_bwd_dq_kernel<64>, Smem<64>::kDqBytes);
    if (err == cudaSuccess) err = opt_in(flash_bwd_dq_kernel<128>, Smem<128>::kDqBytes);
    if (err == cudaSuccess) err = opt_in(flash_bwd_dkv_kernel<64>, Smem<64>::kDkvBytes);
    if (err == cudaSuccess) err = opt_in(flash_bwd_dkv_kernel<128>, Smem<128>::kDkvBytes);
    return err;
  });
}

// `strides` holds 21 element strides: (batch, seq, head) for q, k, v, dout,
// dq, dk and dv; flash_attention_bwd_dq reads those of dq and ignores dk and
// dv, flash_attention_bwd_dkv the other way round.  lse and delta are
// [batch * heads, seq] fp32.  `device` is the CUDA ordinal the pointers live
// on and `stream` the caller's cudaStream_t.  Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, const int64_t* strides, int batch, int heads,
                                      int seq, int head_dim, int causal, float scale,
                                      int device, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, strides, heads, seq, causal, scale);
  p.dq = static_cast<bf16*>(dq);
  const dim3 grid(seq / kBlk, batch * heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (head_dim == 128) {
      flash_bwd_dq_kernel<128><<<grid, kThreads, Smem<128>::kDqBytes, s>>>(p);
    } else if (head_dim == 64) {
      flash_bwd_dq_kernel<64><<<grid, kThreads, Smem<64>::kDqBytes, s>>>(p);
    } else {
      return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  });
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, const int64_t* strides, int batch,
                                       int heads, int seq, int head_dim, int causal,
                                       float scale, int device, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, strides, heads, seq, causal, scale);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const dim3 grid(seq / kBlk, batch * heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (head_dim == 128) {
      flash_bwd_dkv_kernel<128><<<grid, kThreads, Smem<128>::kDkvBytes, s>>>(p);
    } else if (head_dim == 64) {
      flash_bwd_dkv_kernel<64><<<grid, kThreads, Smem<64>::kDkvBytes, s>>>(p);
    } else {
      return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  });
}
