// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T / sqrt(d)) V over bf16 operands, the probabilities
// recomputed from the forward's logsumexp, never stored.
//
// Replaces the two Pallas TPU kernels of k8s_gpu_hpa_tpu/ops/flash_attention.py
// called by `_flash_bhsd_bwd`: `_flash_bwd_dq_kernel` (pallas_call at :273)
// and `_flash_bwd_dkv_kernel` (pallas_call at :289).  Each computes what its
// Pallas kernel computes, with the same roundings: S = (Q K^T) * scale in
// fp32, the causal mask q_pos >= k_pos with -1e30 before the exponential
// (on the diagonal tile only: tiles past it are skipped, dQ's `hi` and dK/dV's
// `lo`), P = exp(S - lse), dP = dO V^T in fp32, dS = P * (dP - delta) *
// scale rounded to bf16, dQ = sum dS K, dV = sum P^T dO with P rounded to
// bf16, dK = sum dS^T Q, every sum in fp32 and rounded to bf16 once.  The
// exponentials are exp2 of log2(e)-prescaled scores.  delta = rowsum(dO * O)
// in fp32 comes from the caller, as on the TPU.  Two kernels, because the
// gradients parallelise over different axes without races: dQ over Q tiles
// (each CTA owns its rows), dK and dV over K/V tiles.  No atomics: results
// are deterministic.
//
// Bound.  Each (batch-head, query, key) pair at or below the diagonal costs
// 6 d operations in the dQ kernel (three products) and 8 d in the dK/dV
// kernel (four).  At the llm training shape (b1, s2048, h4, d128, causal)
// that is 4 * 2048 * 2049 / 2 pairs: 6.45 GFLOP, 6.5 us, and 8.59 GFLOP,
// 8.7 us, at the H100 SXM's 989 TFLOP/s dense bf16, against 10.5 MB (3.1
// us) and 12.6 MB (3.8 us) at 3.35 TB/s: the tensor cores bound both, and
// the products re-read every operand tile from shared memory many times
// (NVIDIA H100 SXM data sheet).  So the design is the forward's
// (flash_attention.cu): wgmma for every product, operands brought once by
// TMA into a ring, and no shared-memory round trip for the intermediates.
// Recomputing S and dP in both kernels costs 14 d operations a pair where a
// fused backward accumulating dQ with atomics does 10 d.
//
// Both kernels:
//   - one CTA per (batch-head, 64-row tile), heaviest causal tiles first:
//     the grid's fast axis is the batch-head, its slow axis the tile;
//   - one producer thread loads the CTA's own two tiles once and then
//     streams the other side's tiles by TMA into a ring of stages, each
//     with a full and an empty mbarrier, as the forward does.  bf16 tensors
//     reach the TMA unit through 4-D tensor maps over (d, h, s, b) with the
//     caller's strides (64 x 64 boxes under the 128-byte swizzle), lse and
//     delta, [b*h, s] fp32, through 2-D maps (boxes of 64, unswizzled);
//   - two consumer warpgroups on the CTA's 64 rows, which take turns over
//     the ring's tiles, each with its own accumulators; the second hands
//     its sums to the first through shared memory at the end, over the ring
//     once both are done with it.  So an SM runs two warpgroups, one's
//     exponentials beside the other's products, and at the training shape,
//     whose 128 CTAs fill 128 of the 132 SMs once, the heaviest CTA's 32
//     tiles run 16 on each.  One warpgroup a CTA was slower at both timed
//     shapes and is gone: ptxas allows a thread 168 registers where two
//     CTAs of 160 threads share an SM, fewer than either kernel holds at
//     d 128, so it ran one warpgroup an SM.
//
// dK/dV kernel: a CTA's K and V rows stay in shared memory; the ring holds
// Q and dO tiles with their 64 lse and delta values, from the diagonal on
// (causal) or from 0.  A warpgroup computes the transposed scores, so that
// its accumulators hold its own K/V rows:
//   - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands in
//     shared memory, K or V the K-major A, the Q or dO tile a K-major B;
//   - P^T = exp2(S^T scale log2e - lse[col] log2e) and dS^T = P^T (dP^T -
//     delta[col]) scale in registers, col being the accumulator's column
//     (a Q row of the tile, whose lse and delta come from the stage);
//   - dV += P^T dO and dK += dS^T Q: wgmma m64n{d}k16 with A from
//     registers, the S^T and dP^T accumulators packed to bf16 pairs, and B
//     the same dO or Q tile read N-major (the transpose bit): one swizzled
//     tile feeds a K-major descriptor for S^T and an N-major one for dK.
//   dV's product is issued as soon as P^T is packed, so dS^T is computed
//   while it runs.  A thread holds 64 + 64 fp32 of dK and dV at d 128, 32 +
//   32 of S^T and dP^T and 16 + 16 packed.  ptxas allows a thread 168
//   registers where a CTA has more than two warpgroups' threads, so the
//   producer is a whole warpgroup that gives registers up (setmaxnreg) and
//   each consumer thread may hold 240 (24 * 128 + 240 * 256 = 64,512 of the
//   SM's 65,536).
// dQ kernel: the forward's loop with dO, lse and delta added.  Q and dO stay
// in shared memory, K and V tiles stream through the ring up to the
// diagonal; each thread reads lse and delta for its two rows once:
//   - S = Q K^T and dP = dO V^T: wgmma m64n64k16, K and V K-major B;
//   - dS = P (dP - delta) scale packed to bf16 A fragments, and dQ += dS K:
//     wgmma m64n{d}k16 with K read N-major;
//   - the next tile's S and dP are issued before this tile's dS K, and the
//     next dS is computed while dS K runs.  Registers: dQ 64, S 32, dP 32,
//     packed dS 16 at d 128, all held by products in flight, more than 168:
//     at d 128 dQ too has a producer warpgroup under setmaxnreg; at d 64 a
//     producer warp.
//
// Layout.  Q, K, V, dO, dQ, dK and dV are [B, S, H, D] with D contiguous and
// any other strides (element counts, multiples of 8); a [B*H, S, D] tensor is
// the case H = 1.  lse and delta are [B*H, S] fp32, contiguous.  S must be a
// multiple of 64 and D 64 or 128.  The Python wrapper (ops/flash_attention.py)
// checks all of this before it calls in.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "smem_desc.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kBlk = kBoxRows;  // rows of every tile, Q and K/V alike
constexpr int kWgK = 16;        // one wgmma's K
constexpr uint32_t kBoxBytes = kBlk * kBox * 2;       // 8 KB
constexpr uint32_t kRowBytes = kBlk * sizeof(float);  // a tile's lse or delta
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

using bf16 = __nv_bfloat16;

// two floats rounded to a bf16 pair, the first in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows a CTA on two consumer warpgroups that take turns over the ring's
// tiles; DKV: the dK/dV kernel, else dQ
template <int D, bool DKV>
struct Cfg {
  static constexpr int kBoxes = D / kBox;  // boxes across a row of a tile
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;  // 64 rows of Q, K, V or dO
  // ptxas caps a thread at 168 registers in a CTA of more than 256 threads:
  // the producer is a warpgroup that gives registers up (setmaxnreg), except
  // for dQ at d 64, which fits in 168 beside a producer warp
  static constexpr bool kRegSplit = DKV || D == 128;
  static constexpr int kThreads = 256 + (kRegSplit ? 128 : 32);
  static constexpr int kStages = 4;
  // a stage: two tiles (dK/dV: Q and dO; dQ: K and V), and dK/dV's lse and
  // delta rows, which lie apart so that the tiles keep the swizzle's alignment
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr uint32_t kRowsBytes = DKV ? kStages * 2 * kRowBytes : 0;
  // the CTA's own two tiles, the ring, the rows, the barriers (full and
  // empty a stage, the own tiles', done, handed), and room to align to the
  // swizzle atom
  static constexpr size_t kSmem = 2 * kTileBytes + kStages * kStageBytes + kRowsBytes +
                                  (2 * kStages + 3) * sizeof(uint64_t) + kSwizzleAtom;
  // the second warpgroup's accumulators (dK and dV: d a thread; dQ: d / 2),
  // handed over through the ring
  static_assert((DKV ? D : D / 2) * 128 * sizeof(float) <= kStages * kStageBytes,
                "the hand-over fits in the ring");
  static_assert(!kRegSplit || kConsumerRegs * 256 + kProducerRegs * 128 <= 65536,
                "register file");
};

struct Params {
  CUtensorMap q, k, v, dout;  // [b, s, h, d], box 64 (d) x 1 x 64 (s) x 1
  CUtensorMap lse, delta;     // [b*h, s] fp32, box 64 (s) x 1: dK/dV only
  const float* lse_rows;      // the same tensors, for dQ's plain loads
  const float* delta_rows;
  bf16* out[2];       // dQ; or dK and dV
  int64_t st[2][3];   // their (batch, seq, head) element strides
  int heads, seq;
  float scale;        // 1/sqrt(d)
  float scale_log2;   // 1/sqrt(d) * log2(e)
  int causal;
};

// CTA layout in shared memory, aligned to the swizzle atom
template <class C>
struct Smem {
  unsigned char* own;   // the CTA's two tiles: dK/dV: K, V; dQ: Q, dO
  unsigned char* ring;  // stage s: two tiles at s * kStageBytes
  float* rows;          // dK/dV: stage s's lse at 2 s * 64, its delta after
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_full;
  uint64_t* done;    // both consumer warpgroups are done with the ring
  uint64_t* handed;  // the second has handed its sums over

  __device__ explicit Smem(unsigned char* raw) {
    own = raw + (kSwizzleAtom - smem_u32(raw) % kSwizzleAtom) % kSwizzleAtom;
    ring = own + 2 * C::kTileBytes;
    rows = reinterpret_cast<float*>(ring + C::kStages * C::kStageBytes);
    full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(rows) + C::kRowsBytes);
    empty = full + C::kStages;
    own_full = empty + C::kStages;
    done = own_full + 1;
    handed = done + 1;
  }
};

template <class C>
__device__ __forceinline__ void init_barriers(const Smem<C>& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 1);  // one warpgroup reads each tile
    }
    mbar_init(sm.own_full, 1);
    mbar_init(sm.done, 256);
    mbar_init(sm.handed, 128);
    mbar_fence_init();
  }
  __syncthreads();
}

// a 64-row tile of a [b, s, h, d] tensor: its 64-column boxes, kBoxBytes apart
template <class C>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int row, int b) {
#pragma unroll
  for (int c = 0; c < C::kBoxes; ++c) {
    tma_load_4d(dst + c * kBoxBytes, map, bar, c * kBox, h, row, b);
  }
}

// d = A B for a 64 x 64 x D product, both operands K-major 64-row tiles in
// shared memory (32-byte steps along a row, the next box every four)
template <int D>
__device__ __forceinline__ void product_ss(float (&d)[32], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / kWgK; ++kk) {
    const uint32_t at = (kk / 4) * kBoxBytes + (kk % 4) * kWgK * 2;
    wgmma_m64n64k16_ss_bf16(d, desc_k_major(a + at), desc_k_major(b + at), kk > 0);
  }
}

// d += A B for a 64 x D x 64 product: A from registers, 16 columns each; B a
// 64-row tile read N-major (step kc starts 16 rows further down)
template <int D>
__device__ __forceinline__ void product_rs(float (&d)[D / 2], const uint32_t (&a)[kBlk / kWgK][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kc = 0; kc < kBlk / kWgK; ++kc) {
    const uint64_t desc = desc_mn_major(b + kc * kWgK * kSwizzleRow, kBoxBytes);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs_bf16(d, a[kc], desc, 1);
    } else {
      wgmma_m64n64k16_rs_bf16(d, a[kc], desc, 1);
    }
  }
}

// fp32 accumulators to bf16 pairs, the A fragments of the next product:
// columns 16 kc .. 16 kc + 15 are accumulator blocks 2 kc and 2 kc + 1
__device__ __forceinline__ void pack(uint32_t (&a)[kBlk / kWgK][4], const float (&x)[32]) {
#pragma unroll
  for (int kc = 0; kc < kBlk / kWgK; ++kc) {
    a[kc][0] = pack_bf16(x[8 * kc + 0], x[8 * kc + 1]);
    a[kc][1] = pack_bf16(x[8 * kc + 2], x[8 * kc + 3]);
    a[kc][2] = pack_bf16(x[8 * kc + 4], x[8 * kc + 5]);
    a[kc][3] = pack_bf16(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

template <int N>
__device__ __forceinline__ void hand_over(float* xchg, int t, const float (&a)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) xchg[k * 128 + t] = a[k];
}

template <int N>
__device__ __forceinline__ void take_over(const float* xchg, int t, float (&a)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] += xchg[k * 128 + t];
}

// The second consumer warpgroup hands its accumulators to the first through
// shared memory, thread by thread in the same layout, once both are done
// with the ring, which the hand-over overwrites.  Returns whether this
// warpgroup stores the sums.
template <class C, class... Acc>
__device__ __forceinline__ bool merge(const Smem<C>& sm, int wg, int t, Acc&... acc) {
  float* xchg = reinterpret_cast<float*>(sm.ring);
  mbar_arrive(sm.done);
  if (wg == 1) {
    mbar_wait(sm.done, 0);
    float* at = xchg;
    ((hand_over(at, t, acc), at += sizeof(acc) / sizeof(float) * 128), ...);
    mbar_arrive(sm.handed);
    return false;
  }
  mbar_wait(sm.handed, 0);
  const float* at = xchg;
  ((take_over(at, t, acc), at += sizeof(acc) / sizeof(float) * 128), ...);
  return true;
}

// Stores a warpgroup's 64 x D fp32 accumulator rows as bf16: thread t holds
// rows `row0` and `row0 + 8`, columns 8 i + col0 and + 1
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, int which, int b, int h, int row0,
                                           int col0, const float (&acc)[D / 2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* dst = p.out[which] + b * p.st[which][0] +
                static_cast<int64_t>(row0 + r * 8) * p.st[which][1] + h * p.st[which][2];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8 + col0) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D, true>::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D, true>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  unsigned char* k_s = sm.own;
  unsigned char* v_s = sm.own + C::kTileBytes;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * kBlk;  // the longest causal loops first
  // causal: Q tiles before the diagonal see none of these keys
  const int lo = p.causal ? blockIdx.y : 0;
  const int count = p.seq / kBlk - lo;  // the CTA's Q tiles, lo on
  // the CTA's n-th Q tile lies in stage n % kStages, in the ring's round
  // n / kStages
  auto stage_of = [](int n) { return n % C::kStages; };
  auto phase_of = [](int n) { return static_cast<uint32_t>(n / C::kStages) & 1u; };
  init_barriers(sm);

  // the warpgroup, taken from lane 0 so the compiler sees it uniform across
  // the warp: branches on it are then not divergent, and it does not
  // serialize the wgmma under them
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    if constexpr (C::kRegSplit) setmaxnreg_dec<kProducerRegs>();
    // producer: one thread loads K and V once, then Q, dO, lse and delta
    // tile by tile
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(sm.own_full, 2 * C::kTileBytes);
      load_tile<C>(k_s, &p.k, sm.own_full, h, k0, b);
      load_tile<C>(v_s, &p.v, sm.own_full, h, k0, b);
      for (int n = 0; n < count; ++n) {
        const int st = stage_of(n);
        const int q0 = (lo + n) * kBlk;
        mbar_wait(&sm.empty[st], phase_of(n) ^ 1);  // a fresh ring starts empty
        unsigned char* q_tile = sm.ring + st * C::kStageBytes;
        float* rows = sm.rows + st * 2 * kBlk;
        mbar_arrive_expect_tx(&sm.full[st], C::kStageBytes + 2 * kRowBytes);
        load_tile<C>(q_tile, &p.q, &sm.full[st], h, q0, b);
        load_tile<C>(q_tile + C::kTileBytes, &p.dout, &sm.full[st], h, q0, b);
        tma_load_2d(rows, &p.lse, &sm.full[st], q0, bh);
        tma_load_2d(rows + kBlk, &p.delta, &sm.full[st], q0, bh);
      }
    }
    return;
  }
  if constexpr (C::kRegSplit) setmaxnreg_inc<kConsumerRegs>();

  // consumer warpgroup `wg`: of the CTA's Q tiles the n-th for n = wg (mod
  // 2).  Thread t holds K/V rows 16 warp + lane/4 (r = 0) and + 8 (r =
  // 1) of the 64, and in each 8-column block of an accumulator the columns
  // col0 + {0, 1}: element 4 j + e is block j, row e / 2, column e % 2.
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int mine = count > wg ? (count - wg + 1) / 2 : 0;
  const int row0 = k0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  float s[32], dp[32];
  uint32_t pp[kBlk / kWgK][4], pds[kBlk / kWgK][4];  // P^T and dS^T in bf16 pairs

  if (mine > 0) mbar_wait(sm.own_full, 0);
  for (int i = 0; i < mine; ++i) {
    const int n = wg + 2 * i;
    const int st = stage_of(n);
    const int q0 = (lo + n) * kBlk;
    const unsigned char* q_tile = sm.ring + st * C::kStageBytes;
    const unsigned char* do_tile = q_tile + C::kTileBytes;
    const float* lse = sm.rows + st * 2 * kBlk;
    const float* delta = lse + kBlk;
    mbar_wait(&sm.full[st], phase_of(n));
    // S^T = K Q^T, then dP^T = V dO^T, one group each
    wgmma_fence();
    product_ss<D>(s, k_s, q_tile);
    wgmma_commit();
    product_ss<D>(dp, v_s, do_tile);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_operands(s);
    // P^T = exp(S^T scale - lse[col]), masked on the diagonal tile
    const bool diagonal = p.causal && q0 == k0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        if (diagonal && q0 + 8 * j + col0 + e % 2 < row0 + (e / 2) * 8) s[x] = kNegInf;
        s[x] = exp2_approx(fmaf(s[x], p.scale_log2, -(e % 2 ? l.y : l.x) * kLog2e));
      }
    }
    pack(pp, s);
    // dV += P^T dO, while dS^T is computed
    wgmma_fence();
    wgmma_fence_operands(dv);
    wgmma_fence_operands(pp);
    product_rs<D>(dv, pp, do_tile);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_operands(dp);
    // dS^T = P^T (dP^T - delta[col]) scale
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        dp[x] = s[x] * (dp[x] - (e % 2 ? dl.y : dl.x)) * p.scale;
      }
    }
    pack(pds, dp);
    // dK += dS^T Q
    wgmma_fence();
    wgmma_fence_operands(dk);
    wgmma_fence_operands(pds);
    product_rs<D>(dk, pds, q_tile);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(dk);
    wgmma_fence_operands(dv);
    wgmma_fence_operands(pp);
    wgmma_fence_operands(pds);
    if (t == 0) mbar_arrive(&sm.empty[st]);  // both products are done with the stage
  }

  if (!merge(sm, wg, t, dk, dv)) return;
  store_rows<D>(p, 0, b, h, row0, col0, dk);
  store_rows<D>(p, 1, b, h, row0, col0, dv);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D, false>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D, false>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  unsigned char* q_s = sm.own;
  unsigned char* do_s = sm.own + C::kTileBytes;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlk;  // the longest causal loops first
  // the forward's causal bound: the CTA's K/V tiles run through its diagonal
  const int n_kv = p.causal ? q0 / kBlk + 1 : p.seq / kBlk;
  auto stage_of = [](int j) { return j % C::kStages; };
  auto phase_of = [](int j) { return static_cast<uint32_t>(j / C::kStages) & 1u; };
  init_barriers(sm);

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    if constexpr (C::kRegSplit) setmaxnreg_dec<kProducerRegs>();
    // producer: one thread loads Q and dO once, then K and V tile by tile
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(sm.own_full, 2 * C::kTileBytes);
      load_tile<C>(q_s, &p.q, sm.own_full, h, q0, b);
      load_tile<C>(do_s, &p.dout, sm.own_full, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = stage_of(j);
        mbar_wait(&sm.empty[st], phase_of(j) ^ 1);  // a fresh ring starts empty
        unsigned char* k_tile = sm.ring + st * C::kStageBytes;
        mbar_arrive_expect_tx(&sm.full[st], C::kStageBytes);
        load_tile<C>(k_tile, &p.k, &sm.full[st], h, j * kBlk, b);
        load_tile<C>(k_tile + C::kTileBytes, &p.v, &sm.full[st], h, j * kBlk, b);
      }
    }
    return;
  }
  if constexpr (C::kRegSplit) setmaxnreg_inc<kConsumerRegs>();

  // consumer warpgroup `wg`: of the CTA's K/V tiles the ones j = wg (mod
  // 2); thread t holds Q rows row0 and row0 + 8, in the accumulator
  // layout of the dK/dV kernel
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int mine = n_kv > wg ? (n_kv - wg + 1) / 2 : 0;
  const int row0 = q0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float lse_l2[2], delta[2];  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = static_cast<int64_t>(bh) * p.seq + row0 + r * 8;
    lse_l2[r] = p.lse_rows[at] * kLog2e;
    delta[r] = p.delta_rows[at];
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  if (mine > 0) {
    float s[32], dp[32];
    uint32_t pds[kBlk / kWgK][4];  // dS in bf16 pairs: A of dS K

    // S = Q K^T and dP = dO V^T for tile j, one group
    auto issue_scores = [&](int j) {
      const unsigned char* k_tile = sm.ring + stage_of(j) * C::kStageBytes;
      product_ss<D>(s, q_s, k_tile);
      product_ss<D>(dp, do_s, k_tile + C::kTileBytes);
      wgmma_commit();
    };
    // P = exp(S scale - lse) under the diagonal tile's mask, then dS = P
    // (dP - delta) scale, in dP's registers
    auto grad = [&](int j) {
      const bool diagonal = p.causal && j * kBlk == q0;
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = x % 4 / 2;
        if (diagonal && row0 + r * 8 < j * kBlk + (x / 4) * 8 + col0 + x % 2) s[x] = kNegInf;
        const float pe = exp2_approx(fmaf(s[x], p.scale_log2, -lse_l2[r]));
        dp[x] = pe * (dp[x] - delta[r]) * p.scale;
      }
    };
    // dQ += dS K for tile j, K read N-major
    auto issue_dq = [&](int j) {
      product_rs<D>(dq, pds, sm.ring + stage_of(j) * C::kStageBytes);
      wgmma_commit();
    };

    int cur = wg;  // the tile whose dS is packed
    mbar_wait(sm.own_full, 0);
    mbar_wait(&sm.full[stage_of(cur)], phase_of(cur));
    wgmma_fence();
    issue_scores(cur);
    wgmma_wait<0>();
    wgmma_fence_operands(s);
    wgmma_fence_operands(dp);
    grad(cur);
    pack(pds, dp);
    // each step issues tile j's S and dP, then the previous tile's dS K,
    // and computes tile j's dS while dS K is in flight; no wgmma sits under
    // a condition
    for (int i = 1; i < mine; ++i) {
      const int j = wg + 2 * i;
      mbar_wait(&sm.full[stage_of(j)], phase_of(j));
      wgmma_fence();  // this thread's writes of dq and pds precede the products
      wgmma_fence_operands(dq);
      wgmma_fence_operands(pds);
      issue_scores(j);
      issue_dq(cur);
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
      grad(j);
      wgmma_wait<0>();
      wgmma_fence_operands(dq);
      wgmma_fence_operands(pds);
      if (t == 0) mbar_arrive(&sm.empty[stage_of(cur)]);  // dS K is done with its stage
      pack(pds, dp);
      cur = j;
    }
    wgmma_fence();
    wgmma_fence_operands(dq);
    wgmma_fence_operands(pds);
    issue_dq(cur);
    wgmma_wait<0>();
    wgmma_fence_operands(dq);
    if (t == 0) mbar_arrive(&sm.empty[stage_of(cur)]);
  }

  if (!merge(sm, wg, t, dq)) return;
  store_rows<D>(p, 0, b, h, row0, col0, dq);
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t opt_in_both() {
  cudaError_t err = opt_in(flash_bwd_dq_kernel<D>, Cfg<D, false>::kSmem);
  if (err == cudaSuccess) err = opt_in(flash_bwd_dkv_kernel<D>, Cfg<D, true>::kSmem);
  return err;
}

template <int D, bool DKV>
void launch(const Params& p, int batch_heads, cudaStream_t stream) {
  using C = Cfg<D, DKV>;
  const dim3 grid(batch_heads, p.seq / kBlk);
  if constexpr (DKV) {
    flash_bwd_dkv_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  } else {
    flash_bwd_dq_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  }
}

template <class C>
int config_of(int* out, int n) {
  const int values[] = {C::kThreads, C::kStages, static_cast<int>(C::kSmem),
                        C::kRegSplit ? kProducerRegs : 0, C::kRegSplit ? kConsumerRegs : 0};
  const int count = static_cast<int>(sizeof(values) / sizeof(values[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = values[i];
  return count;
}

// Encodes the maps a kernel reads (dkv: the dK/dV kernel, else dQ) on
// `device`, fills the rest of its parameters and launches it.  Returns
// cudaGetLastError() after the launch, or a refused encoding's CUresult.
int launch_bwd(bool dkv, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* out0, void* out1,
               const int64_t* strides, int batch, int heads, int seq, int head_dim, int causal,
               float scale, int device, void* stream) {
  if (g_encode == nullptr) return static_cast<int>(cudaErrorInitializationError);
  if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cudaSetDevice makes the device's context current in this thread, which
  // cuTensorMapEncodeTiled needs; a thread's first cudaGetDevice does not
  if ((err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  Params p;
  CUresult refused = encode_bshd(&p.q, q, batch, seq, heads, head_dim, strides);
  if (refused == CUDA_SUCCESS) {
    refused = encode_bshd(&p.k, k, batch, seq, heads, head_dim, strides + 3);
  }
  if (refused == CUDA_SUCCESS) {
    refused = encode_bshd(&p.v, v, batch, seq, heads, head_dim, strides + 6);
  }
  if (refused == CUDA_SUCCESS) {
    refused = encode_bshd(&p.dout, dout, batch, seq, heads, head_dim, strides + 9);
  }
  if (dkv && refused == CUDA_SUCCESS) {
    refused = encode_rows_f32(&p.lse, lse, batch * heads, seq);
  }
  if (dkv && refused == CUDA_SUCCESS) {
    refused = encode_rows_f32(&p.delta, delta, batch * heads, seq);
  }
  if (refused != CUDA_SUCCESS) {
    if (cur != device) cudaSetDevice(cur);
    return static_cast<int>(refused);
  }
  p.lse_rows = lse;
  p.delta_rows = delta;
  p.out[0] = static_cast<bf16*>(out0);
  p.out[1] = static_cast<bf16*>(out1);
  // dq's strides, or dk's and dv's
  for (int o = 0; o < 2; ++o) {
    for (int a = 0; a < 3; ++a) p.st[o][a] = strides[(dkv ? 15 + 3 * o : 12) + a];
  }
  p.heads = heads;
  p.seq = seq;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) {
    dkv ? launch<128, true>(p, batch * heads, s) : launch<128, false>(p, batch * heads, s);
  } else {
    dkv ? launch<64, true>(p, batch * heads, s) : launch<64, false>(p, batch * heads, s);
  }
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}

}  // namespace

// C entries, bound with ctypes.
//
// flash_attention_bwd_init opts the four instantiations (each kernel at
// head_dim 64 and 128) in to the dynamic shared memory they need above the
// default 48 KB and looks up the CUDA driver API's cuTensorMapEncodeTiled.
// It is called once per device before the first launch, never at launch: a
// launch may sit inside CUDA-graph capture.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_init(int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = opt_in_both<64>();
  if (err == cudaSuccess) err = opt_in_both<128>();
  if (err == cudaSuccess) err = find_encode();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The configuration of the instantiation for (dkv: the dK/dV kernel, else
// dQ; head_dim), for reports: threads, ring stages, dynamic shared memory in
// bytes (one CTA an SM), and the producer's and the consumers' registers
// under setmaxnreg (0, 0 without it).  Writes at most `n` values; returns
// how many there are, or 0 where there is no such instantiation.
extern "C" int flash_attention_bwd_config(int dkv, int head_dim, int* out, int n) {
  if (head_dim == 64) {
    return dkv ? config_of<Cfg<64, true>>(out, n) : config_of<Cfg<64, false>>(out, n);
  }
  if (head_dim == 128) {
    return dkv ? config_of<Cfg<128, true>>(out, n) : config_of<Cfg<128, false>>(out, n);
  }
  return 0;
}

// `strides` holds 21 element strides: (batch, seq, head) for q, k, v, dout,
// dq, dk and dv; flash_attention_bwd_dq reads those of dq and ignores dk and
// dv, flash_attention_bwd_dkv the other way round.  lse and delta are
// [batch * heads, seq] fp32, contiguous.  `device` is the CUDA ordinal the
// pointers live on, initialised with flash_attention_bwd_init, and `stream`
// the caller's cudaStream_t.  Returns cudaGetLastError() after the launch:
// nonzero means the launch was refused and nothing ran.  A refused tensor
// map returns the CUDA driver API's CUresult.
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
