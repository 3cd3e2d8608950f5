// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T / sqrt(d)) V over bf16 or f16 operands, the probabilities
// recomputed from the forward's logsumexp, never stored.  The operands' type
// is elem.cuh's Elem: this source builds once as bf16 and once with ELEM_F16
// as f16, each into a library of its own with the same C entries; the two
// types have one size, so everything below holds for both ("bf16" reads
// Elem).  f32 operands take flash_attention_bwd_f32.cu.
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
// fused backward accumulating dQ with atomics does 10 d.  At head_dim 256
// (b1, s2048, h8: a 2048-wide model of 8 heads) the pairs are 8 * 2048 *
// 2049 / 2: 25.8 GFLOP, 26.1 us, and 34.4 GFLOP, 34.8 us, against 42.0 MB
// and 50.4 MB (12.5 and 15.0 us): the tensor cores bound both.  At head_dim
// 384 and 512 in 4 heads (b1, s2048, h4) dQ is 19.3 and 25.8 GFLOP, 19.5 and
// 26.1 us, dK/dV 25.8 and 34.4 GFLOP, 26.1 and 34.8 us: the tensor cores
// again.
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
// Head_dim 256.  A 64-row tile is 32 KB, so the CTA's own two tiles and a
// ring of two stages take 192 KB; a third stage would pass the SM's 227 KB.
//   - dQ keeps its two warpgroups taking turns, but not the overlap: a
//     warpgroup that issued its next tile's S and dP before its current
//     tile's dS K would hold two stages two tiles apart, which a ring of two
//     gives the same stage.  So each tile is released before the next is
//     awaited, and the two warpgroups' products overlap each other's
//     exponentials instead.  Registers: dQ 128, S 32, dP 32 at most.
//   - dK/dV cannot hold dK and dV (64 x 256 fp32 each, 256 registers a
//     thread) in one warpgroup, so the two warpgroups split the roles
//     instead of the tiles: both read every Q tile of the ring (its empty
//     barrier takes two arrivals); the first computes S^T and dV += P^T dO
//     (dV 128, S^T 32, P^T 16 registers), the second S^T, dP^T and dK +=
//     dS^T Q (dK 128, S^T 32, dP^T 32); each stores its own gradient, with
//     no hand-over.  S^T is computed twice, 10 d operations a pair where
//     the other head_dims do 8 d, and the second warpgroup, at 6 d, paces
//     the CTA.
//   - the m64n{d}k16 products with A from registers are two m64n128k16 at
//     d 256, one on each half of the accumulator's columns.
// A simple tiling that is right; making it fast is later work.
//
// Head_dim 384 and 512: the chunked tilings.  A 64-row tile is 48 or 64 KB:
// the CTA's own two tiles and a 64-row stage of the other two would take
// 192 or 256 KB, and dK and dV 64 x 512 fp32 each 256 registers a thread.
// So each CTA computes a chunk of its output's columns, the grid's fast
// axis the batch-head's chunks, and streams tiles of 32 rows:
//   - dQ: half of dQ's columns (192 or 256: two chunks); S = Q K^T and dP =
//     dO V^T contract over the whole head_dim in every chunk (m64n32k16),
//     dQ += dS K on the chunk's columns of the same K tile: 10 d operations
//     a pair, 1.67 times the minimum 6 d.  Own Q and dO (96 or 128 KB) and
//     a ring of two stages of 32-row K and V tiles (48 KB each) at 384, of
//     one (64 KB) at 512, which releases each tile before the next is
//     loaded;
//   - dK/dV: 128 of dK's and of dV's columns (three or four chunks: 64 +
//     64 registers a thread, as at d 128, where 192 + 192 would not fit);
//     S^T and dP^T over the whole head_dim in every chunk, dV += P^T dO and
//     dK += dS^T Q on the chunk's columns of the streamed Q and dO tiles:
//     20 d operations a pair at 512 and 16 d at 384, 2.5 and 2 times the
//     minimum 8 d.  Two stages at 384, one at 512; lse and delta in boxes
//     of 32;
//   - one consumer warpgroup and a producer warp, 160 threads (up to 255
//     registers, no setmaxnreg, no hand-over); causal tiles that reach past
//     the CTA's first row (dQ) or last key (dK/dV) are masked, two a CTA.
// This chunks dK/dV narrower than the 256-column chunks dQ and the forward
// take, since two accumulators share a thread's registers.  The recomputed
// score products are the next thing to speed up.
//
// Head_dim 640 and up: the streamed tilings, one instantiation of each
// kernel for every multiple of 128, head_dim a kernel argument.  At 640 the
// chunked tiling's own two tiles (160 KB) and one 32-row stage (80 KB) pass
// a CTA's 227 KB, so no tile holds a whole row:
//   - each CTA owns 64 rows and one 128-column chunk of its outputs'
//     columns (head_dim / 128 chunks, the grid's fast axis the batch-head's
//     chunks), one consumer warpgroup and a producer warp, 160 threads;
//   - for each 64-row tile of the other side, the two score products (dQ: S
//     = Q K^T and dP = dO V^T; dK/dV: S^T = K Q^T and dP^T = V dO^T) are each
//     summed over the head_dim in a runtime loop of 128-column chunks: a
//     stage of the ring holds one pair of 64 x 128 chunks (32 KB), and the
//     own rows' chunks are re-read from L2 for every tile like the others';
//   - then the tile's chunks of the CTA's columns come through a second
//     ring of two stages (dQ: K's, 16 KB; dK/dV: Q's and dO's with the
//     tile's lse and delta, 32.5 KB), and dQ += dS K, or dV += P^T dO and
//     dK += dS^T Q, run on those columns alone, A from registers;
//   - four pair stages: 160 KB for dQ, 194 KB for dK/dV; registers: dQ 64,
//     S 32, dP 32, dS 16; dK 64, dV 64, S^T 32, dP^T 32, P^T and dS^T 16
//     each;
//   - causal tiles are 64 rows, so one a CTA crosses the diagonal.
// Every chunk recomputes the scores over the whole row: with n = d / 128
// chunks a pair costs 4 d n + 2 d operations in dQ against the minimum 6 d,
// and 4 d n + 4 d in dK/dV against 8 d (at 1024: 34 d and 36 d, 5.7 and 4.5
// times).  At the training shape of a 2048-wide model of two heads of 1024
// (b1, s2048, h2, causal) the minima are 25.8 and 34.4 GFLOP, 26.1 and 34.8
// us at 989 TFLOP/s, against 41.9 and 50.4 MB, 12.5 and 15.0 us at 3.35
// TB/s: the tensor cores bound both.  Sharing the scores across chunks is
// later work.
//
// Layout.  Q, K, V, dO, dQ, dK and dV are [B, S, H, D] with D contiguous and
// any other strides (element counts, multiples of 8); a [B*H, S, D] tensor is
// the case H = 1.  lse and delta are [B*H, S] fp32, contiguous.  S must be a
// multiple of 64 and D 64, 128, 256, 384, 512 or a multiple of 128 from 640
// on.  The Python wrapper
// (ops/flash_attention.py) checks all of this before it calls in.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "smem_desc.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kBlk = kBoxRows;  // a CTA's own rows (a warpgroup's wgmma M)
constexpr int kWgK = 16;        // one wgmma's K
constexpr uint32_t kBoxBytes = kBlk * kBox * 2;       // 8 KB
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// 64 rows a CTA on two consumer warpgroups that take turns over the ring's
// tiles (at d 256 the dK/dV kernel's split their roles instead), or at d 384
// and 512 on one, with kDc of the output's columns (the file's note); DKV:
// the dK/dV kernel, else dQ
template <int D, bool DKV>
struct Cfg {
  static_assert(D == 64 || D == 128 || D == 256 || D == 384 || D == 512,
                "head_dim 64, 128, 256, 384 or 512");
  static constexpr bool kWide = D > 256;
  static constexpr int kConsumers = kWide ? 1 : 2;
  // the output's columns a CTA: all, or at d 384 and 512 a chunk: dQ's
  // half, dK's and dV's 128 each (two accumulators of 64 registers a thread)
  static constexpr int kDc = !kWide ? D : DKV ? 128 : D / 2;
  static constexpr int kChunks = D / kDc;
  static constexpr int kStream = stream_rows(D);  // rows of a streamed tile
  static constexpr int kBoxes = D / kBox;  // boxes across a row of a tile
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;  // 64 rows of Q, K, V or dO
  static constexpr uint32_t kStreamBoxBytes = kStream * kBox * 2;
  static constexpr uint32_t kStreamTileBytes = kBoxes * kStreamBoxBytes;
  static constexpr uint32_t kRowBytes = kStream * sizeof(float);  // a tile's lse or delta
  // ptxas caps a thread at 168 registers in a CTA of more than 256 threads:
  // the producer is a warpgroup that gives registers up (setmaxnreg), except
  // for dQ at d 64, which fits in 168 beside a producer warp, and at d 384
  // and 512, whose one consumer warpgroup may hold 255 beside a producer warp
  static constexpr bool kRegSplit = !kWide && (DKV || D >= 128);
  static constexpr int kThreads = 128 * kConsumers + (kRegSplit ? 128 : 32);
  // four stages; two at d 256 and 384, one at 512, where more would not fit
  static constexpr int kStages = D == 512 ? 1 : D >= 256 ? 2 : 4;
  // a warpgroup issues its next tile's products before it releases its
  // current tile, whose stage must then differ from the next's: two stages
  // a consumer warpgroup taking turns
  static constexpr bool kOverlap = kStages >= 2 * kConsumers;
  // d 256's dK/dV: the warpgroups split dV and dK, each reads every tile
  static constexpr bool kRoles = DKV && D == 256;
  // a stage: two tiles (dK/dV: Q and dO; dQ: K and V), and dK/dV's lse and
  // delta rows, which lie apart so that the tiles keep the swizzle's alignment
  static constexpr uint32_t kStageBytes = 2 * kStreamTileBytes;
  static constexpr uint32_t kRowsBytes = DKV ? kStages * 2 * kRowBytes : 0;
  // the CTA's own two tiles, the ring, the rows, the barriers (full and
  // empty a stage, the own tiles', done, handed), and room to align to the
  // swizzle atom
  static constexpr size_t kSmem = 2 * kTileBytes + kStages * kStageBytes + kRowsBytes +
                                  (2 * kStages + 3) * sizeof(uint64_t) + kSwizzleAtom;
  // the second warpgroup's accumulators (dK and dV: d a thread; dQ: d / 2),
  // handed over through the ring
  static_assert(kRoles || kConsumers == 1 ||
                    (DKV ? D : D / 2) * 128 * sizeof(float) <= kStages * kStageBytes,
                "the hand-over fits in the ring");
  static_assert(kSmem <= 232448, "shared memory of a CTA");
  static_assert(!kRegSplit || kConsumerRegs * 256 + kProducerRegs * 128 <= 65536,
                "register file");
};

struct Params {
  CUtensorMap q, k, v, dout;  // [b, s, h, d], box 64 (d) x 1 x 64 (s) x 1
  CUtensorMap lse, delta;     // [b*h, s] fp32, box 64 (s) x 1: dK/dV only
  const float* lse_rows;      // the same tensors, for dQ's plain loads
  const float* delta_rows;
  Elem* out[2];       // dQ; or dK and dV
  int64_t st[2][3];   // their (batch, seq, head) element strides
  int heads, seq;
  float scale;        // 1/sqrt(d)
  float scale_log2;   // 1/sqrt(d) * log2(e)
  int causal;
  int head_dim;
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
      // one warpgroup reads each tile, or both where they split the roles
      mbar_init(&sm.empty[s], C::kRoles ? 2 : 1);
    }
    mbar_init(sm.own_full, 1);
    mbar_init(sm.done, 128 * C::kConsumers);
    mbar_init(sm.handed, 128);
    mbar_fence_init();
  }
  __syncthreads();
}

// a tile of a [b, s, h, d] tensor, as many rows as the map's box: its
// BOXES 64-column boxes, BOX_BYTES apart
template <uint32_t BOX_BYTES, int BOXES>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int row, int b) {
#pragma unroll
  for (int c = 0; c < BOXES; ++c) {
    tma_load_4d(dst + c * BOX_BYTES, map, bar, c * kBox, h, row, b);
  }
}

// d = A B for a 64 x N x D product, both operands K-major in shared memory
// (32-byte steps along a row, the next box every four): A a 64-row tile
// (own), B an N-row tile (streamed, N 64 or 32)
template <int D, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / kWgK; ++kk) {
    const uint32_t along = (kk % 4) * kWgK * 2;
    const uint64_t ad = desc_k_major(a + (kk / 4) * kBoxBytes + along);
    const uint64_t bd = desc_k_major(b + (kk / 4) * (N * kSwizzleRow) + along);
    if constexpr (N == 64) {
      wgmma_m64n64k16_ss(d, ad, bd, kk > 0);
    } else {
      wgmma_m64n32k16_ss(d, ad, bd, kk > 0);
    }
  }
}

// d += A B for a 64 x N x K product: A from registers, 16 columns each; B a
// K-row tile's N columns read N-major (step kc starts 16 rows further down,
// its 64-column boxes `box` bytes apart).  Each step is an m64n128k16
// product on each 128 of d's columns, then an m64n64k16 on the last 64
// where N is an odd multiple of 64 (the accumulator layout of m64n256k16:
// d's first 64 values are columns 0-127)
template <int N, int K>
__device__ __forceinline__ void product_rs(float (&d)[N / 2], const uint32_t (&a)[K / kWgK][4],
                                           const unsigned char* b, uint32_t box) {
#pragma unroll
  for (int kc = 0; kc < K / kWgK; ++kc) {
    const unsigned char* rows = b + kc * kWgK * kSwizzleRow;
#pragma unroll
    for (int n = 0; n < N / 128; ++n) {
      wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(d + 64 * n), a[kc],
                               desc_mn_major(rows + 2 * n * box, box), 1);
    }
    if constexpr (N % 128) {
      wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(d + 64 * (N / 128)), a[kc],
                              desc_mn_major(rows + 2 * (N / 128) * box, box), 1);
    }
  }
}

// P = exp(S scale - lse) under the causal mask where `diagonal` (keys from
// `key0`; thread t holds Q rows row0 and row0 + 8), then dS = P (dP - delta)
// scale, in dP's registers: dQ's step between its two products
template <int N>
__device__ __forceinline__ void probs_ds(float (&s)[N / 2], float (&dp)[N / 2],
                                         const float (&lse_l2)[2], const float (&delta)[2],
                                         const Params& p, bool diagonal, int key0, int row0,
                                         int col0) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const int r = x % 4 / 2;
    if (diagonal && row0 + r * 8 < key0 + (x / 4) * 8 + col0 + x % 2) s[x] = kNegInf;
    const float pe = exp2_approx(fmaf(s[x], p.scale_log2, -lse_l2[r]));
    dp[x] = pe * (dp[x] - delta[r]) * p.scale;
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

// Stores a warpgroup's 64 x D fp32 accumulator rows as Elem, from column
// `first` on: thread t holds rows `row0` and `row0 + 8`, columns 8 i + col0
// and + 1 of the D
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, int which, int b, int h, int row0,
                                           int col0, const float (&acc)[D / 2], int first = 0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    Elem* dst = p.out[which] + b * p.st[which][0] +
                static_cast<int64_t>(row0 + r * 8) * p.st[which][1] + h * p.st[which][2] + first;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      store_pair(dst + i * 8 + col0, acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

// The dK/dV kernel's producer: a warpgroup that gives its registers up (a
// warp at d 384 and 512), one thread of which loads the CTA's K and V tiles
// once, then from the CTA's first Q tile `lo` on each Q and dO tile with its
// lse and delta into the ring
template <class C>
__device__ __forceinline__ void dkv_producer(const Params& p, const Smem<C>& sm, int bh, int b,
                                             int h, int k0, int lo, int count) {
  if constexpr (C::kRegSplit) setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x != 128 * C::kConsumers) return;
  mbar_arrive_expect_tx(sm.own_full, 2 * C::kTileBytes);
  load_tile<kBoxBytes, C::kBoxes>(sm.own, &p.k, sm.own_full, h, k0, b);
  load_tile<kBoxBytes, C::kBoxes>(sm.own + C::kTileBytes, &p.v, sm.own_full, h, k0, b);
  for (int n = 0; n < count; ++n) {
    // the CTA's n-th Q tile lies in stage n % kStages, in the ring's round
    // n / kStages
    const int st = n % C::kStages;
    const int q0 = (lo + n) * C::kStream;
    // a fresh ring starts empty
    mbar_wait(&sm.empty[st], (static_cast<uint32_t>(n / C::kStages) & 1u) ^ 1);
    unsigned char* q_tile = sm.ring + st * C::kStageBytes;
    float* rows = sm.rows + st * 2 * C::kStream;
    mbar_arrive_expect_tx(&sm.full[st], C::kStageBytes + 2 * C::kRowBytes);
    load_tile<C::kStreamBoxBytes, C::kBoxes>(q_tile, &p.q, &sm.full[st], h, q0, b);
    load_tile<C::kStreamBoxBytes, C::kBoxes>(q_tile + C::kStreamTileBytes, &p.dout, &sm.full[st],
                                             h, q0, b);
    tma_load_2d(rows, &p.lse, &sm.full[st], q0, bh);
    tma_load_2d(rows + C::kStream, &p.delta, &sm.full[st], q0, bh);
  }
}

// P^T = exp(S^T scale - lse[col]) in place for an N-row Q tile from q0,
// masked where the tile reaches above the CTA's last key row (the diagonal
// tile, or at 32 rows a tile the two that cover the CTA's own rows); thread
// t holds K rows row0 and row0 + 8
template <int N>
__device__ __forceinline__ void transposed_probs(float (&s)[N / 2], const float* lse,
                                                 const Params& p, int q0, int k0, int row0,
                                                 int col0) {
  const bool diagonal = p.causal && q0 < k0 + kBlk;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + col0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      if (diagonal && q0 + 8 * j + col0 + e % 2 < row0 + (e / 2) * 8) s[x] = kNegInf;
      s[x] = exp2_approx(fmaf(s[x], p.scale_log2, -(e % 2 ? l.y : l.x) * kLog2e));
    }
  }
}

// dS^T = P^T (dP^T - delta[col]) scale, in dP^T's registers
template <int N>
__device__ __forceinline__ void transposed_ds(float (&dp)[N / 2], const float (&s)[N / 2],
                                              const float* delta, float scale, int col0) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + col0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      dp[x] = s[x] * (dp[x] - (e % 2 ? dl.y : dl.x)) * scale;
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

  // the grid's fast axis: the batch-head's chunks of dK's and dV's
  // columns, each chunk a CTA
  const int bh = blockIdx.x / C::kChunks;
  const int chunk = blockIdx.x % C::kChunks;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * kBlk;  // the longest causal loops first
  // causal: Q tiles before the diagonal see none of these keys
  const int lo = p.causal ? k0 / C::kStream : 0;
  const int count = p.seq / C::kStream - lo;  // the CTA's Q tiles, lo on
  auto stage_of = [](int n) { return n % C::kStages; };
  auto phase_of = [](int n) { return static_cast<uint32_t>(n / C::kStages) & 1u; };
  init_barriers(sm);

  // the warpgroup, taken from lane 0 so the compiler sees it uniform across
  // the warp: branches on it are then not divergent, and it does not
  // serialize the wgmma under them
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == C::kConsumers) {
    dkv_producer(p, sm, bh, b, h, k0, lo, count);
    return;
  }
  if constexpr (C::kRegSplit) setmaxnreg_inc<kConsumerRegs>();

  // consumer warpgroup `wg`: of the CTA's Q tiles the n-th for n = wg (mod
  // kConsumers).  Thread t holds K/V rows 16 warp + lane/4 (r = 0) and + 8
  // (r = 1) of the 64, and in each 8-column block of an accumulator the
  // columns col0 + {0, 1}: element 4 j + e is block j, row e / 2, column e % 2.
  constexpr int N = C::kStream;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int mine = count > wg ? (count - wg + C::kConsumers - 1) / C::kConsumers : 0;
  const int row0 = k0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  // where the CTA's columns of a Q or dO tile start
  const uint32_t cols = chunk * (C::kDc / kBox) * C::kStreamBoxBytes;
  float dk[C::kDc / 2], dv[C::kDc / 2];
#pragma unroll
  for (int i = 0; i < C::kDc / 2; ++i) dk[i] = dv[i] = 0.0f;
  float s[N / 2], dp[N / 2];
  uint32_t pp[N / kWgK][4], pds[N / kWgK][4];  // P^T and dS^T in bf16 pairs

  if (mine > 0) mbar_wait(sm.own_full, 0);
  for (int i = 0; i < mine; ++i) {
    const int n = wg + C::kConsumers * i;
    const int st = stage_of(n);
    const int q0 = (lo + n) * N;
    const unsigned char* q_tile = sm.ring + st * C::kStageBytes;
    const unsigned char* do_tile = q_tile + C::kStreamTileBytes;
    const float* lse = sm.rows + st * 2 * N;
    const float* delta = lse + N;
    mbar_wait(&sm.full[st], phase_of(n));
    // S^T = K Q^T, then dP^T = V dO^T, one group each, over every column
    wgmma_fence();
    product_ss<D, N>(s, k_s, q_tile);
    wgmma_commit();
    product_ss<D, N>(dp, v_s, do_tile);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_operands(s);
    transposed_probs<N>(s, lse, p, q0, k0, row0, col0);
    pack<N>(pp, s);
    // dV += P^T dO on the CTA's columns, while dS^T is computed
    wgmma_fence();
    wgmma_fence_operands(dv);
    wgmma_fence_operands(pp);
    product_rs<C::kDc, N>(dv, pp, do_tile + cols, C::kStreamBoxBytes);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_operands(dp);
    transposed_ds<N>(dp, s, delta, p.scale, col0);
    pack<N>(pds, dp);
    // dK += dS^T Q
    wgmma_fence();
    wgmma_fence_operands(dk);
    wgmma_fence_operands(pds);
    product_rs<C::kDc, N>(dk, pds, q_tile + cols, C::kStreamBoxBytes);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(dk);
    wgmma_fence_operands(dv);
    wgmma_fence_operands(pp);
    wgmma_fence_operands(pds);
    if (t == 0) mbar_arrive(&sm.empty[st]);  // both products are done with the stage
  }

  if constexpr (C::kConsumers == 2) {
    if (!merge(sm, wg, t, dk, dv)) return;
  }
  store_rows<C::kDc>(p, 0, b, h, row0, col0, dk, chunk * C::kDc);
  store_rows<C::kDc>(p, 1, b, h, row0, col0, dv, chunk * C::kDc);
}

// d 256 (the file's note): the two consumer warpgroups split the roles, both
// reading every Q tile of the ring; the first accumulates dV, the second dK,
// and each stores its own
template <>
__global__ void __launch_bounds__(Cfg<256, true>::kThreads, 1)
    flash_bwd_dkv_kernel<256>(const __grid_constant__ Params p) {
  constexpr int D = 256;
  using C = Cfg<D, true>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  unsigned char* k_s = sm.own;
  unsigned char* v_s = sm.own + C::kTileBytes;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * kBlk;
  const int lo = p.causal ? blockIdx.y : 0;
  const int count = p.seq / kBlk - lo;
  init_barriers(sm);

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    dkv_producer(p, sm, bh, b, h, k0, lo, count);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // thread t holds K/V rows row0 and row0 + 8 in the accumulator layout of
  // the other tiling
  const bool dk_role = wg == 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row0 = k0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float acc[D / 2];  // dV, or dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float s[kBlk / 2], dp[kBlk / 2];
  uint32_t pa[kBlk / kWgK][4];  // P^T, or dS^T, in bf16 pairs

  if (count > 0) mbar_wait(sm.own_full, 0);
  for (int n = 0; n < count; ++n) {
    const int st = n % C::kStages;
    const int q0 = (lo + n) * kBlk;
    const unsigned char* q_tile = sm.ring + st * C::kStageBytes;
    const unsigned char* do_tile = q_tile + C::kTileBytes;
    const float* lse = sm.rows + st * 2 * kBlk;
    mbar_wait(&sm.full[st], static_cast<uint32_t>(n / C::kStages) & 1u);
    // S^T = K Q^T, and for dK dP^T = V dO^T, one group
    wgmma_fence();
    product_ss<D, kBlk>(s, k_s, q_tile);
    if (dk_role) product_ss<D, kBlk>(dp, v_s, do_tile);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(s);
    wgmma_fence_operands(dp);
    transposed_probs<kBlk>(s, lse, p, q0, k0, row0, col0);
    if (dk_role) {
      transposed_ds<kBlk>(dp, s, lse + kBlk, p.scale, col0);
      pack<kBlk>(pa, dp);
    } else {
      pack<kBlk>(pa, s);
    }
    // dV += P^T dO, or dK += dS^T Q
    wgmma_fence();
    wgmma_fence_operands(acc);
    wgmma_fence_operands(pa);
    product_rs<D, kBlk>(acc, pa, dk_role ? q_tile : do_tile, kBoxBytes);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    wgmma_fence_operands(pa);
    if (t == 0) mbar_arrive(&sm.empty[st]);  // this warpgroup is done with the stage
  }
  store_rows<D>(p, dk_role ? 0 : 1, b, h, row0, col0, acc);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D, false>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D, false>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  unsigned char* q_s = sm.own;
  unsigned char* do_s = sm.own + C::kTileBytes;

  // the grid's fast axis: the batch-head's chunks of dQ's columns, each
  // chunk a CTA
  const int bh = blockIdx.x / C::kChunks;
  const int chunk = blockIdx.x % C::kChunks;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlk;  // the longest causal loops first
  // the forward's causal bound: the CTA's K/V tiles run through its diagonal
  constexpr int N = C::kStream;
  const int n_kv = p.causal ? (q0 + kBlk) / N : p.seq / N;
  auto stage_of = [](int j) { return j % C::kStages; };
  auto phase_of = [](int j) { return static_cast<uint32_t>(j / C::kStages) & 1u; };
  init_barriers(sm);

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == C::kConsumers) {
    if constexpr (C::kRegSplit) setmaxnreg_dec<kProducerRegs>();
    // producer: one thread loads Q and dO once, then K and V tile by tile
    if (threadIdx.x == 128 * C::kConsumers) {
      mbar_arrive_expect_tx(sm.own_full, 2 * C::kTileBytes);
      load_tile<kBoxBytes, C::kBoxes>(q_s, &p.q, sm.own_full, h, q0, b);
      load_tile<kBoxBytes, C::kBoxes>(do_s, &p.dout, sm.own_full, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = stage_of(j);
        mbar_wait(&sm.empty[st], phase_of(j) ^ 1);  // a fresh ring starts empty
        unsigned char* k_tile = sm.ring + st * C::kStageBytes;
        mbar_arrive_expect_tx(&sm.full[st], C::kStageBytes);
        load_tile<C::kStreamBoxBytes, C::kBoxes>(k_tile, &p.k, &sm.full[st], h, j * N, b);
        load_tile<C::kStreamBoxBytes, C::kBoxes>(k_tile + C::kStreamTileBytes, &p.v,
                                                 &sm.full[st], h, j * N, b);
      }
    }
    return;
  }
  if constexpr (C::kRegSplit) setmaxnreg_inc<kConsumerRegs>();

  // consumer warpgroup `wg`: of the CTA's K/V tiles the ones j = wg (mod
  // kConsumers); thread t holds Q rows row0 and row0 + 8, in the
  // accumulator layout of the dK/dV kernel
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int mine = n_kv > wg ? (n_kv - wg + C::kConsumers - 1) / C::kConsumers : 0;
  const int row0 = q0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float lse_l2[2], delta[2];  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = static_cast<int64_t>(bh) * p.seq + row0 + r * 8;
    lse_l2[r] = p.lse_rows[at] * kLog2e;
    delta[r] = p.delta_rows[at];
  }
  float dq[C::kDc / 2];
#pragma unroll
  for (int i = 0; i < C::kDc / 2; ++i) dq[i] = 0.0f;

  if (mine > 0) {
    float s[N / 2], dp[N / 2];
    uint32_t pds[N / kWgK][4];  // dS in bf16 pairs: A of dS K

    // S = Q K^T and dP = dO V^T for tile j, one group, over every column
    auto issue_scores = [&](int j) {
      const unsigned char* k_tile = sm.ring + stage_of(j) * C::kStageBytes;
      product_ss<D, N>(s, q_s, k_tile);
      product_ss<D, N>(dp, do_s, k_tile + C::kStreamTileBytes);
      wgmma_commit();
    };
    // P and dS for tile j, masked where the tile reaches past the CTA's first
    // row (the diagonal one, or at 32 rows a tile the two that cover the
    // CTA's own keys)
    auto grad = [&](int j) {
      probs_ds<N>(s, dp, lse_l2, delta, p, p.causal && (j + 1) * N > q0, j * N, row0, col0);
    };
    // dQ += dS K on the CTA's columns for tile j, K read N-major
    auto issue_dq = [&](int j) {
      const unsigned char* k_cols =
          sm.ring + stage_of(j) * C::kStageBytes + chunk * (C::kDc / kBox) * C::kStreamBoxBytes;
      product_rs<C::kDc, N>(dq, pds, k_cols, C::kStreamBoxBytes);
      wgmma_commit();
    };

    mbar_wait(sm.own_full, 0);
    if constexpr (C::kOverlap) {
      int cur = wg;  // the tile whose dS is packed
      mbar_wait(&sm.full[stage_of(cur)], phase_of(cur));
      wgmma_fence();
      issue_scores(cur);
      wgmma_wait<0>();
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
      grad(cur);
      pack<N>(pds, dp);
      // each step issues tile j's S and dP, then the previous tile's dS K,
      // and computes tile j's dS while dS K is in flight; no wgmma sits under
      // a condition
      for (int i = 1; i < mine; ++i) {
        const int j = wg + C::kConsumers * i;
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
        pack<N>(pds, dp);
        cur = j;
      }
      wgmma_fence();
      wgmma_fence_operands(dq);
      wgmma_fence_operands(pds);
      issue_dq(cur);
      wgmma_wait<0>();
      wgmma_fence_operands(dq);
      if (t == 0) mbar_arrive(&sm.empty[stage_of(cur)]);
    } else {
      // d 256 and 512: each tile's products in turn, its stage released
      // before the next tile is awaited
      for (int i = 0; i < mine; ++i) {
        const int j = wg + C::kConsumers * i;
        mbar_wait(&sm.full[stage_of(j)], phase_of(j));
        wgmma_fence();  // this thread's writes of dq and pds precede the products
        wgmma_fence_operands(dq);
        wgmma_fence_operands(pds);
        issue_scores(j);
        wgmma_wait<0>();
        wgmma_fence_operands(s);
        wgmma_fence_operands(dp);
        grad(j);
        pack<N>(pds, dp);
        wgmma_fence();
        wgmma_fence_operands(pds);
        issue_dq(j);
        wgmma_wait<0>();
        wgmma_fence_operands(dq);
        wgmma_fence_operands(pds);
        if (t == 0) mbar_arrive(&sm.empty[stage_of(j)]);  // dS K is done with its stage
      }
    }
  }

  if constexpr (C::kConsumers == 2) {
    if (!merge(sm, wg, t, dq)) return;
  }
  store_rows<C::kDc>(p, 0, b, h, row0, col0, dq, chunk * C::kDc);
}

// The streamed tilings (the file's note); DKV: the dK/dV kernel, else dQ
template <bool DKV>
struct Streamed {
  static constexpr int kDc = 128;        // the outputs' columns a CTA
  static constexpr int kStages = 4;      // pair stages
  static constexpr int kOwnStages = 2;   // stages of the CTA's columns
  static constexpr uint32_t kChunkBytes = 2 * kBoxBytes;  // 64 x 128: two boxes
  static constexpr uint32_t kPairBytes = 2 * kChunkBytes;
  // dQ: K's chunk; dK/dV: Q's and dO's, and the tile's lse and delta apart
  static constexpr uint32_t kOwnBytes = (DKV ? 2 : 1) * kChunkBytes;
  static constexpr uint32_t kRowBytes = kBlk * sizeof(float);
  static constexpr uint32_t kRowsBytes = DKV ? kOwnStages * 2 * kRowBytes : 0;
  static constexpr int kThreads = 160;
  static constexpr size_t kSmem = kStages * kPairBytes + kOwnStages * kOwnBytes + kRowsBytes +
                                  2 * (kStages + kOwnStages) * sizeof(uint64_t) + kSwizzleAtom;
  static_assert(kSmem <= 232448, "shared memory of a CTA");
};

template <bool DKV>
struct StreamedSmem {
  using C = Streamed<DKV>;
  unsigned char* ring;  // pair stage s at s * kPairBytes
  unsigned char* own;   // own stage s at s * kOwnBytes
  float* rows;          // dK/dV: own stage s's lse at 2 s * 64, its delta after
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_full;
  uint64_t* own_empty;

  __device__ explicit StreamedSmem(unsigned char* raw) {
    ring = raw + (kSwizzleAtom - smem_u32(raw) % kSwizzleAtom) % kSwizzleAtom;
    own = ring + C::kStages * C::kPairBytes;
    rows = reinterpret_cast<float*>(own + C::kOwnStages * C::kOwnBytes);
    full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(rows) + C::kRowsBytes);
    empty = full + C::kStages;
    own_full = empty + C::kStages;
    own_empty = own_full + C::kOwnStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < C::kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 1);
      }
      for (int s = 0; s < C::kOwnStages; ++s) {
        mbar_init(&own_full[s], 1);
        mbar_init(&own_empty[s], 1);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// the 64 x 128 chunk of a [b, s, h, d] tensor from column `col`, row `row`
__device__ __forceinline__ void load_chunk(unsigned char* dst, const CUtensorMap* map,
                                           uint64_t* bar, int col, int h, int row, int b) {
  tma_load_4d(dst, map, bar, col, h, row, b);
  tma_load_4d(dst + kBoxBytes, map, bar, col + kBox, h, row, b);
}

// The streamed producer: one thread streams, for each of the CTA's `count`
// tiles of the other side from tile `first`, the pairs of the first score
// product's chunks (A of the CTA's rows `own_row`, B of the tile's), then
// the second's, then the tile's chunks of the CTA's columns.  Pair n of
// the CTA lies in stage n % kStages, in the ring's round n / kStages
template <bool DKV>
__device__ __forceinline__ void streamed_producer(const Params& p, const StreamedSmem<DKV>& sm,
                                                  int bh, int b, int h, int chunk, int chunks,
                                                  int own_row, int first, int count) {
  using C = Streamed<DKV>;
  if (threadIdx.x != 128) return;
  // dK/dV: S^T = K Q^T, dP^T = V dO^T; dQ: S = Q K^T, dP = dO V^T
  const CUtensorMap* a[2] = {DKV ? &p.k : &p.q, DKV ? &p.v : &p.dout};
  const CUtensorMap* bm[2] = {DKV ? &p.q : &p.k, DKV ? &p.dout : &p.v};
  int n = 0;
  for (int i = 0; i < count; ++i) {
    const int row = (first + i) * kBlk;
    for (int g = 0; g < 2; ++g) {
      for (int c = 0; c < chunks; ++c, ++n) {
        const int st = n % C::kStages;
        mbar_wait(&sm.empty[st], (static_cast<uint32_t>(n / C::kStages) & 1u) ^ 1);
        unsigned char* pair = sm.ring + st * C::kPairBytes;
        mbar_arrive_expect_tx(&sm.full[st], C::kPairBytes);
        load_chunk(pair, a[g], &sm.full[st], c * C::kDc, h, own_row, b);
        load_chunk(pair + C::kChunkBytes, bm[g], &sm.full[st], c * C::kDc, h, row, b);
      }
    }
    const int os = i % C::kOwnStages;
    mbar_wait(&sm.own_empty[os], (static_cast<uint32_t>(i / C::kOwnStages) & 1u) ^ 1);
    unsigned char* own = sm.own + os * C::kOwnBytes;
    const int col = chunk * C::kDc;
    if constexpr (DKV) {
      float* rows = sm.rows + os * 2 * kBlk;
      mbar_arrive_expect_tx(&sm.own_full[os], C::kOwnBytes + 2 * C::kRowBytes);
      load_chunk(own, &p.q, &sm.own_full[os], col, h, row, b);
      load_chunk(own + C::kChunkBytes, &p.dout, &sm.own_full[os], col, h, row, b);
      tma_load_2d(rows, &p.lse, &sm.own_full[os], row, bh);
      tma_load_2d(rows + kBlk, &p.delta, &sm.own_full[os], row, bh);
    } else {
      mbar_arrive_expect_tx(&sm.own_full[os], C::kOwnBytes);
      load_chunk(own, &p.k, &sm.own_full[os], col, h, row, b);
    }
  }
}

// d = A B^T over the head_dim for one tile: `chunks` pairs of the ring from
// pair n on, each two 64 x 128 chunks, K-major both; returns the next pair
template <bool DKV>
__device__ __forceinline__ int streamed_scores(float (&d)[kBlk / 2], const StreamedSmem<DKV>& sm,
                                               int n, int chunks) {
  using C = Streamed<DKV>;
  for (int c = 0; c < chunks; ++c, ++n) {
    const int st = n % C::kStages;
    mbar_wait(&sm.full[st], static_cast<uint32_t>(n / C::kStages) & 1u);
    const unsigned char* pair = sm.ring + st * C::kPairBytes;
    wgmma_fence();
    wgmma_fence_operands(d);
#pragma unroll
    for (int kk = 0; kk < C::kDc / kWgK; ++kk) {
      const uint32_t at = (kk / 4) * kBoxBytes + (kk % 4) * kWgK * 2;
      wgmma_m64n64k16_ss(d, desc_k_major(pair + at), desc_k_major(pair + C::kChunkBytes + at),
                         c > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(d);
    if (threadIdx.x == 0) mbar_arrive(&sm.empty[st]);  // the products are done with the pair
  }
  return n;
}

// the streamed dQ (the file's note)
__global__ void __launch_bounds__(Streamed<false>::kThreads, 1)
    flash_bwd_dq_streamed_kernel(const __grid_constant__ Params p) {
  using C = Streamed<false>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int chunks = p.head_dim / C::kDc;
  const int bh = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlk;  // the longest causal loops first
  const int n_kv = p.causal ? (q0 + kBlk) / kBlk : p.seq / kBlk;
  const StreamedSmem<false> sm(smem_raw);

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 1) {
    streamed_producer(p, sm, bh, b, h, chunk, chunks, q0, 0, n_kv);
    return;
  }

  // thread t holds Q rows row0 and row0 + 8, in the accumulator layout of
  // the fixed tilings
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int row0 = q0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float lse_l2[2], delta[2];  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = static_cast<int64_t>(bh) * p.seq + row0 + r * 8;
    lse_l2[r] = p.lse_rows[at] * kLog2e;
    delta[r] = p.delta_rows[at];
  }
  float dq[C::kDc / 2];
#pragma unroll
  for (int i = 0; i < C::kDc / 2; ++i) dq[i] = 0.0f;
  float s[kBlk / 2] = {}, dp[kBlk / 2] = {};
  uint32_t pds[kBlk / kWgK][4];  // dS in Elem pairs: A of dS K

  int n = 0;  // the pairs consumed
  for (int j = 0; j < n_kv; ++j) {
    n = streamed_scores(s, sm, n, chunks);   // S = Q K^T
    n = streamed_scores(dp, sm, n, chunks);  // dP = dO V^T
    // P and dS, masked on the diagonal tile
    probs_ds<kBlk>(s, dp, lse_l2, delta, p, p.causal && (j + 1) * kBlk > q0, j * kBlk, row0,
                   col0);
    pack<kBlk>(pds, dp);
    // dQ += dS K on the CTA's columns, K read N-major
    const int os = j % C::kOwnStages;
    mbar_wait(&sm.own_full[os], static_cast<uint32_t>(j / C::kOwnStages) & 1u);
    wgmma_fence();
    wgmma_fence_operands(dq);
    wgmma_fence_operands(pds);
    product_rs<C::kDc, kBlk>(dq, pds, sm.own + os * C::kOwnBytes, kBoxBytes);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(dq);
    wgmma_fence_operands(pds);
    if (t == 0) mbar_arrive(&sm.own_empty[os]);  // dS K is done with its stage
  }
  store_rows<C::kDc>(p, 0, b, h, row0, col0, dq, chunk * C::kDc);
}

// the streamed dK/dV (the file's note)
__global__ void __launch_bounds__(Streamed<true>::kThreads, 1)
    flash_bwd_dkv_streamed_kernel(const __grid_constant__ Params p) {
  using C = Streamed<true>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int chunks = p.head_dim / C::kDc;
  const int bh = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * kBlk;  // the longest causal loops first
  // causal: Q tiles before the diagonal see none of these keys
  const int lo = p.causal ? blockIdx.y : 0;
  const int count = p.seq / kBlk - lo;
  const StreamedSmem<true> sm(smem_raw);

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 1) {
    streamed_producer(p, sm, bh, b, h, chunk, chunks, k0, lo, count);
    return;
  }

  // thread t holds K/V rows row0 and row0 + 8, in the accumulator layout of
  // the fixed tilings
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int row0 = k0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float dk[C::kDc / 2], dv[C::kDc / 2];
#pragma unroll
  for (int i = 0; i < C::kDc / 2; ++i) dk[i] = dv[i] = 0.0f;
  float s[kBlk / 2] = {}, dp[kBlk / 2] = {};
  uint32_t pp[kBlk / kWgK][4], pds[kBlk / kWgK][4];  // P^T and dS^T in Elem pairs

  int n = 0;  // the pairs consumed
  for (int i = 0; i < count; ++i) {
    const int q0 = (lo + i) * kBlk;
    n = streamed_scores(s, sm, n, chunks);   // S^T = K Q^T
    n = streamed_scores(dp, sm, n, chunks);  // dP^T = V dO^T
    const int os = i % C::kOwnStages;
    mbar_wait(&sm.own_full[os], static_cast<uint32_t>(i / C::kOwnStages) & 1u);
    const unsigned char* q_cols = sm.own + os * C::kOwnBytes;
    const float* lse = sm.rows + os * 2 * kBlk;
    transposed_probs<kBlk>(s, lse, p, q0, k0, row0, col0);
    transposed_ds<kBlk>(dp, s, lse + kBlk, p.scale, col0);
    pack<kBlk>(pp, s);
    pack<kBlk>(pds, dp);
    // dV += P^T dO and dK += dS^T Q on the CTA's columns
    wgmma_fence();
    wgmma_fence_operands(dv);
    wgmma_fence_operands(dk);
    wgmma_fence_operands(pp);
    wgmma_fence_operands(pds);
    product_rs<C::kDc, kBlk>(dv, pp, q_cols + C::kChunkBytes, kBoxBytes);
    product_rs<C::kDc, kBlk>(dk, pds, q_cols, kBoxBytes);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(dv);
    wgmma_fence_operands(dk);
    wgmma_fence_operands(pp);
    wgmma_fence_operands(pds);
    if (t == 0) mbar_arrive(&sm.own_empty[os]);  // both products are done with the stage
  }
  store_rows<C::kDc>(p, 0, b, h, row0, col0, dk, chunk * C::kDc);
  store_rows<C::kDc>(p, 1, b, h, row0, col0, dv, chunk * C::kDc);
}

// the head_dims of the fixed tilings (64-512), and of the streamed one
bool fixed_width(int head_dim) {
  return head_dim == 64 || head_dim == 128 || head_dim == 256 || head_dim == 384 ||
         head_dim == 512;
}
bool streamed(int head_dim) { return head_dim >= 640 && head_dim % Streamed<false>::kDc == 0; }

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
  const dim3 grid(batch_heads * C::kChunks, p.seq / kBlk);
  if constexpr (DKV) {
    flash_bwd_dkv_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  } else {
    flash_bwd_dq_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  }
}

int put_config(const int (&values)[7], int* out, int n) {
  for (int i = 0; i < n && i < 7; ++i) out[i] = values[i];
  return 7;
}

template <class C>
int config_of(int* out, int n) {
  return put_config({C::kThreads, C::kStages, static_cast<int>(C::kSmem),
                     C::kRegSplit ? kProducerRegs : 0, C::kRegSplit ? kConsumerRegs : 0,
                     C::kChunks, C::kStream}, out, n);
}

template <bool DKV>
int streamed_config(int head_dim, int* out, int n) {
  using C = Streamed<DKV>;
  return put_config({C::kThreads, C::kStages, static_cast<int>(C::kSmem), 0, 0,
                     head_dim / C::kDc, kBlk}, out, n);
}

// Encodes the maps a kernel reads (dkv: the dK/dV kernel, else dQ) on
// `device`, fills the rest of its parameters and launches it.  Returns
// cudaGetLastError() after the launch, or a refused encoding's CUresult.
int launch_bwd(bool dkv, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* out0, void* out1,
               const int64_t* strides, int batch, int heads, int seq, int head_dim, int causal,
               float scale, int device, void* stream) {
  if (g_encode == nullptr) return static_cast<int>(cudaErrorInitializationError);
  if (!fixed_width(head_dim) && !streamed(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cudaSetDevice makes the device's context current in this thread, which
  // cuTensorMapEncodeTiled needs; a thread's first cudaGetDevice does not
  if ((err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  Params p;
  // the CTA's own tiles in 64-row boxes, the streamed ones (dQ: K and V;
  // dK/dV: Q, dO, lse and delta) in the tiles' rows
  const int rows = stream_rows(head_dim);
  const int q_rows = dkv ? rows : kBlk, kv_rows = dkv ? kBlk : rows;
  CUresult refused = encode_bshd(&p.q, q, batch, seq, heads, head_dim, strides, q_rows);
  if (refused == CUDA_SUCCESS) {
    refused = encode_bshd(&p.k, k, batch, seq, heads, head_dim, strides + 3, kv_rows);
  }
  if (refused == CUDA_SUCCESS) {
    refused = encode_bshd(&p.v, v, batch, seq, heads, head_dim, strides + 6, kv_rows);
  }
  if (refused == CUDA_SUCCESS) {
    refused = encode_bshd(&p.dout, dout, batch, seq, heads, head_dim, strides + 9, q_rows);
  }
  if (dkv && refused == CUDA_SUCCESS) {
    refused = encode_rows_f32(&p.lse, lse, batch * heads, seq, rows);
  }
  if (dkv && refused == CUDA_SUCCESS) {
    refused = encode_rows_f32(&p.delta, delta, batch * heads, seq, rows);
  }
  if (refused != CUDA_SUCCESS) {
    if (cur != device) cudaSetDevice(cur);
    return static_cast<int>(refused);
  }
  p.lse_rows = lse;
  p.delta_rows = delta;
  p.out[0] = static_cast<Elem*>(out0);
  p.out[1] = static_cast<Elem*>(out1);
  // dq's strides, or dk's and dv's
  for (int o = 0; o < 2; ++o) {
    for (int a = 0; a < 3; ++a) p.st[o][a] = strides[(dkv ? 15 + 3 * o : 12) + a];
  }
  p.heads = heads;
  p.seq = seq;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.head_dim = head_dim;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (streamed(head_dim)) {
    using Dq = Streamed<false>;
    using Dkv = Streamed<true>;
    const dim3 grid(batch * heads * (head_dim / Dq::kDc), seq / kBlk);
    if (dkv) {
      flash_bwd_dkv_streamed_kernel<<<grid, Dkv::kThreads, Dkv::kSmem, s>>>(p);
    } else {
      flash_bwd_dq_streamed_kernel<<<grid, Dq::kThreads, Dq::kSmem, s>>>(p);
    }
  } else if (head_dim == 512) {
    dkv ? launch<512, true>(p, batch * heads, s) : launch<512, false>(p, batch * heads, s);
  } else if (head_dim == 384) {
    dkv ? launch<384, true>(p, batch * heads, s) : launch<384, false>(p, batch * heads, s);
  } else if (head_dim == 256) {
    dkv ? launch<256, true>(p, batch * heads, s) : launch<256, false>(p, batch * heads, s);
  } else if (head_dim == 128) {
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
// flash_attention_bwd_init opts the twelve instantiations (each kernel at
// head_dim 64, 128, 256, 384 and 512, and streamed) in to the dynamic shared
// memory they need above the default 48 KB and looks up the CUDA driver
// API's cuTensorMapEncodeTiled.  It is called once per device before the
// first launch, never at launch: a launch may sit inside CUDA-graph
// capture.  Returns a cudaError_t.
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
  if (err == cudaSuccess) err = opt_in_both<384>();
  if (err == cudaSuccess) err = opt_in_both<512>();
  if (err == cudaSuccess) err = opt_in(flash_bwd_dq_streamed_kernel, Streamed<false>::kSmem);
  if (err == cudaSuccess) err = opt_in(flash_bwd_dkv_streamed_kernel, Streamed<true>::kSmem);
  if (err == cudaSuccess) err = find_encode();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The configuration of the instantiation for (dkv: the dK/dV kernel, else
// dQ; head_dim), for reports: threads, ring stages, dynamic shared memory in
// bytes (one CTA an SM), the producer's and the consumers' registers under
// setmaxnreg (0, 0 without it), CTAs a (batch-head, 64-row tile) (chunks of
// the output's columns), and rows a streamed tile.  Writes at most `n` values; returns
// how many there are, or 0 where there is no such instantiation.
extern "C" int flash_attention_bwd_config(int dkv, int head_dim, int* out, int n) {
  if (head_dim == 64) {
    return dkv ? config_of<Cfg<64, true>>(out, n) : config_of<Cfg<64, false>>(out, n);
  }
  if (head_dim == 128) {
    return dkv ? config_of<Cfg<128, true>>(out, n) : config_of<Cfg<128, false>>(out, n);
  }
  if (head_dim == 256) {
    return dkv ? config_of<Cfg<256, true>>(out, n) : config_of<Cfg<256, false>>(out, n);
  }
  if (head_dim == 384) {
    return dkv ? config_of<Cfg<384, true>>(out, n) : config_of<Cfg<384, false>>(out, n);
  }
  if (head_dim == 512) {
    return dkv ? config_of<Cfg<512, true>>(out, n) : config_of<Cfg<512, false>>(out, n);
  }
  if (streamed(head_dim)) {
    return dkv ? streamed_config<true>(head_dim, out, n) : streamed_config<false>(head_dim, out, n);
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
