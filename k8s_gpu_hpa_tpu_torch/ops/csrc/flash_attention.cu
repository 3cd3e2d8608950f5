// Flash attention forward for Hopper (sm_90a): O = softmax(Q K^T / sqrt(d)) V
// over bf16 or f16 operands, fp32 online softmax, optional causal mask and
// per-row logsumexp.  The operands' type is elem.cuh's Elem: this source
// builds once as bf16 and once with ELEM_F16 as f16, each into a library of
// its own with the same C entries; the two types have one size, so the
// tilings, rings and budgets below hold for both.  f32 operands take
// flash_attention_f32.cu.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// k8s_gpu_hpa_tpu/ops/flash_attention.py (pallas_call in `_flash_bhsd`).  It
// computes what that kernel computes: scores in fp32 times 1/sqrt(d), the
// causal mask q_pos >= k_pos with -1e30 (not -inf), the online softmax
// (m, l, acc) in fp32, P rounded to Elem before P V, fp32 accumulation,
// out = acc / max(l, 1e-30), and with an lse pointer lse = m + log(l_safe).
// Causal tiles past the diagonal are skipped, not masked: the 64 Q rows from
// q0 stop their KV loop at tile q0 / 64, the diagonal, the only one masked.
// The exponentials are exp2 of log2(e)-prescaled scores, and the logsumexp
// is brought back to natural log at the end.
//
// The TPU kernel keeps a whole K/V stripe of one batch-head in VMEM and loops
// over it.  A Hopper CTA has at most 227 KB of shared memory, so this kernel
// streams K/V tiles of 64 rows instead (FlashAttention-3 style), at head_dim
// 64, 128 or 256 (384 and 512: the chunked tiling below; 640 and up: the
// streamed tiling after it):
//   - one CTA per (batch-head, Q tile of 64 rows), heaviest causal tiles
//     first: the grid's fast axis is the batch-head, its slow axis the Q
//     tile counted down from the last;
//   - one producer warp, one thread of which loads Q once and then K and V
//     tiles by TMA into a ring of stages, each with a full and an empty
//     mbarrier (the producer arms the full one with the stage's bytes, TMA
//     completes it, the consumer warpgroup that read the stage releases it
//     through the empty one);
//   - one or two consumer warpgroups on the CTA's 64 Q rows.  S = Q K^T is
//     wgmma m64n64k16 with both operands in shared memory, K-major (K's
//     rows are the product's N); O += P V is wgmma m64n{D}k16 with P from
//     registers: the fp32 S accumulators, packed to Elem pairs, are its A
//     fragments, so scores never leave the registers; V is read N-major
//     with the transpose bit.  At D = 256 P V is two m64n128k16 products a
//     16-key step, one on each half of O's columns (wgmma's N stops at 256,
//     and the PTX layer's register-A products stop at 128), and Q K^T 16
//     steps.  Within a warpgroup the next tile's Q K^T is issued before
//     this tile's P V, and its softmax runs while P V is in flight;
//   - tensors reach the TMA unit through 4-D tensor maps over (d, h, s, b)
//     with the caller's strides, so the transformer's views of its fused QKV
//     product are read where they lie; the map's s extent is the sequence,
//     so a box past it reads zeros and never the next batch's rows.  Boxes
//     are 64 x 64 (128-byte rows, the swizzle's width): d = 128 is two boxes,
//     d = 256 four.
//
// The consumer warpgroups a CTA are the host's choice (flash_attention_fwd's
// kv_split; ops/flash_attention.py::fwd_split picks it from the grid):
//   - one (160 threads, two stages, two CTAs an SM, so one CTA's softmax
//     overlaps the other's products) where the CTAs outnumber the SMs, as
//     at the serve prefill (b8 s512 h4: 256 CTAs);
//   - two that take turns over the K/V tiles, each with its own (m, l, O),
//     the second handing its state over through shared memory at the end
//     (288 threads, four stages, one CTA an SM), where they do not, as at
//     the training shape (b1 s2048 h4: 128 CTAs on 132 SMs): the heaviest
//     CTA's 32 tiles run on two warpgroups of one SM instead of one.
// At head_dim 256 only the first fits: a 64-row tile is 32 KB, so Q and a
// three-stage ring of K and V take 224 KB, one CTA an SM (two stages would
// leave each tile's load exposed behind the previous tile's P V; two
// warpgroups would need a ring of four stages, their turns two tiles apart,
// and 66 KB of hand-over, past the SM's 227 KB).  A consumer thread then
// holds O at 128 fp32 registers beside S (32) and P (16): launch bounds of
// 160 threads, one CTA an SM, let it have up to 255, so the producer stays
// one warp and no setmaxnreg is needed.
//
// Head_dim 384 and 512: the chunked tiling.  O in one warpgroup would be 192
// or 256 fp32 registers a thread (past 255 at 512), and Q with one 64-row K/V
// stage 144 or 192 KB.  So each CTA computes half of O's columns (192 or
// 256: two chunks, the grid's fast axis the batch-head's chunks), the d256
// tiling on its own columns:
//   - S = Q K^T contracts over the whole head_dim in every chunk (the scores
//     are computed once a chunk: 6 d operations a pair, 1.5 times the
//     minimum 4 d), so each chunk loads all of K but only its columns of V;
//   - K/V tiles are 32 rows, their scores m64n32k16 products: a stage is 36
//     or 48 KB, and Q (48 or 64 KB) and four or three stages fit;
//   - P V is an m64n128k16 product on each 128 of the chunk's columns, and
//     an m64n64k16 on the last 64 at 384, from P's registers as before;
//   - the causal loop runs through tile (q0 + 64) / 32, the two tiles on the
//     CTA's own keys masked;
//   - every chunk computes the same (m, l) by the same instructions in the
//     same order; the first writes the logsumexp.
// One consumer warpgroup (O at 96 or 128 registers beside S's 16), a
// producer warp, 160 threads, one CTA an SM.  A simple tiling that is right;
// the recomputed scores are the next thing to speed up.
//
// Head_dim 640 and up: the streamed tiling, one instantiation for every
// multiple of 128, head_dim a kernel argument.  The chunked tiling cannot
// reach 640 (Q alone is 80 KB there, 128 KB at 1024), so no tile holds a
// whole row:
//   - each CTA owns 64 Q rows and one 128-column chunk of O's columns
//     (head_dim / 128 chunks, the grid's fast axis the batch-head's
//     chunks), one consumer warpgroup and a producer warp, 160 threads;
//   - S = Q K^T for a 64-row K/V tile is summed over the head_dim in a
//     runtime loop of 128-column chunks: a stage of the ring holds one pair,
//     Q's and K's 64 x 128 chunks (two 64 x 64 boxes each, 32 KB), and the
//     warpgroup adds their m64n64k16 products into S's fp32 registers; Q is
//     re-read from L2 for every K/V tile;
//   - then V's 64 x 128 box pair of the CTA's columns comes through a ring of
//     its own (16 KB stages), and O += P V is four m64n128k16 products with P
//     from registers;
//   - rings of four pair stages and two V stages: 160 KB; O takes 64 fp32
//     registers a thread, S 32 and P 16;
//   - every chunk computes the same (m, l) in the same order; the first
//     writes the logsumexp.
// Every chunk recomputes the scores over the whole row: with n = d / 128
// chunks a pair costs 2 d n + 2 d operations against the minimum 4 d (3.0
// times at 640, 4.5 times at 1024).  A simple tiling that is right; sharing
// the scores across chunks is later work.
//
// Bound.  Each (batch-head, Q row, K row) pair that the causal loop visits
// costs 4 d operations (two products).  At the serving prefill's shape (b8,
// s512, h4, d128, causal) the pairs below the diagonal are 32 * 512 * 513 / 2,
// or 2.15 GFLOP: 2.2 us at the H100 SXM's 989 TFLOP/s dense bf16, against
// 16.8 MB of Q, K, V and O, or 5.0 us at 3.35 TB/s: memory bounds that shape.
// At the training shape (b1, s2048, h4) it is 4.3 GFLOP, 4.3 us, and at (b2,
// s4096, h8) 68.7 GFLOP, or 69.5 us, against 67.1 MB, 20.0 us: the tensor
// cores bound both (NVIDIA H100 SXM data sheet).  At head_dim 256 (b8 s512
// h8, the prefill of a 2048-wide model of 8 heads) it is 8.6 GFLOP, 8.7 us,
// against 67.1 MB, 20.0 us: memory bounds it; at (b1, s2048, h8) 17.2 GFLOP,
// 17.4 us, against 33.6 MB, 10.0 us: the tensor cores do.  At head_dim 384
// and 512 in 4 heads (D_MODEL=1536 and 2048) the prefill (b8 s512 h4) moves
// 50.3 and 67.1 MB, 15.0 and 20.0 us: memory bounds it; the training shape
// (b1 s2048 h4) is 12.9 and 17.2 GFLOP, 13.0 and 17.4 us: the tensor cores
// do.  At head_dim 1024 in 2 heads (D_MODEL=2048 N_HEADS=2) the prefill (b8
// s512 h2) moves 67.1 MB, 20.0 us, against 8.6 GFLOP, 8.7 us: memory bounds
// it; the training shape (b1 s2048 h2) is 17.2 GFLOP, 17.4 us, against 33.6
// MB, 10.0 us: the tensor cores do.
//
// Layout.  Q, K, V are [B, S, H, D] with D contiguous and any other strides
// (element counts, multiples of 8); a [B*H, S, D] tensor is the case H = 1.
// O has its own strides; lse is [B*H, S] fp32, contiguous.  S must be a
// multiple of the Q tile (64).  The Python wrapper (ops/flash_attention.py)
// checks all of this before it calls in.  The backward kernels are in
// flash_attention_bwd.cu.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "smem_desc.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kBK = 64;     // Q rows a CTA: one warpgroup's wgmma M
constexpr int kWgK = 16;    // one wgmma's K
constexpr uint32_t kBoxBytes = kBK * kBox * 2;  // 8 KB
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 64 Q rows a CTA on SPLIT consumer warpgroups (1 or 2) that take turns
// over its K/V tiles, and kDc of O's D columns: all of them, or at head_dim
// 384 and 512 half (the chunked tiling of the file's note)
template <int D, int SPLIT>
struct Cfg {
  static_assert(D == 64 || D == 128 || D == 256 || D == 384 || D == 512,
                "head_dim 64, 128, 256, 384 or 512");
  static_assert(SPLIT == 1 || D <= 128, "past head_dim 128 one consumer warpgroup a CTA");
  static constexpr int kDc = D > 256 ? D / 2 : D;  // O's columns a CTA
  static constexpr int kChunks = D / kDc;
  static constexpr int kKv = stream_rows(D);  // K/V rows a tile
  static constexpr int kBoxes = D / kBox;     // boxes across a row of Q or K
  static constexpr uint32_t kKvBoxBytes = kKv * kBox * 2;
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;  // Q's 64 rows
  static constexpr uint32_t kKBytes = kBoxes * kKvBoxBytes;   // a K tile
  // a K tile and V's tile of the CTA's columns
  static constexpr uint32_t kStageBytes = kKBytes + kDc / kBox * kKvBoxBytes;
  // two stages where two CTAs share an SM, four where one has it alone
  // (two warpgroups a CTA), three at head_dim 256 (one warpgroup, one CTA);
  // at 384 and 512 as many as fit beside Q: four and three
  static constexpr int kStages = SPLIT == 2 ? 4 : D == 256 || D == 512 ? 3 : D == 384 ? 4 : 2;
  static constexpr int kThreads = 128 * SPLIT + 32;
  static constexpr int kCtasPerSm = SPLIT == 1 && D <= 128 ? 2 : 1;
  // the second warpgroup hands over its O, m and l there
  static constexpr uint32_t kXchgBytes = SPLIT == 1 ? 0 : (D / 2 + 4) * 128 * sizeof(float);
  // Q, the ring, its barriers, Q's and the hand-over's, the hand-over, and
  // room to align to the swizzle atom
  static constexpr size_t kSmem = kTileBytes + kStages * kStageBytes +
                                  (2 * kStages + 2) * sizeof(uint64_t) + kXchgBytes +
                                  kSwizzleAtom;
  // an SM's 228 KB less 1 KB a CTA, as its launch bounds promise
  static_assert(kCtasPerSm * (kSmem + 1024) <= 233472, "shared memory of an SM");
};

// O += P V for one 16-key step over O's N columns: P's A fragments from
// registers, V's 16 rows read N-major (its 64-column boxes `box` bytes
// apart); m64n128k16 products on 128 columns each, then an m64n64k16 on the
// last 64 where N is an odd multiple of 64 (the accumulator layout of
// m64n256k16: O's first 64 values are columns 0-127)
template <int N>
__device__ __forceinline__ void pv_step(float (&o)[N / 2], const uint32_t (&a)[4],
                                        const unsigned char* v_rows, uint32_t box) {
#pragma unroll
  for (int n = 0; n < N / 128; ++n) {
    wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(o + 64 * n), a,
                             desc_mn_major(v_rows + 2 * n * box, box), 1);
  }
  if constexpr (N % 128) {
    wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(o + 64 * (N / 128)), a,
                            desc_mn_major(v_rows + 2 * (N / 128) * box, box), 1);
  }
}

// The causal mask where `diagonal` (keys from `key0`; thread t holds rows
// row0 and row0 + 8, columns col0 + {0, 1} of each 8-column block), then
// the online softmax update: S becomes P (fp32, against the new running
// max), `corr` the factor the earlier sums scale by.  The scale is
// positive, so the row max is taken on the raw scores and scaled once, and
// each score is scaled and offset by one fma
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float (&m_run)[2],
                                               float (&l_run)[2], float (&corr)[2],
                                               bool diagonal, int key0, int row0, int col0,
                                               float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    if (diagonal && row0 + (i % 4 / 2) * 8 < key0 + (i / 4) * 8 + col0 + i % 2) s[i] = kNegInf;
    mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s[i]);
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m_run[r], mx[r] * scale_log2);
    corr[r] = exp2_approx(m_run[r] - mx[r]);
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -mx[i % 4 / 2]));
    rs[i % 4 / 2] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
}

struct Params {
  CUtensorMap q, k, v;  // [b, s, h, d], box 64 (d) x 1 x 64 (s) x 1
  Elem* o;
  float* lse;  // null: no logsumexp output
  int64_t o_sb, o_ss, o_sh;
  int heads, seq;
  float scale_log2;  // 1/sqrt(d) * log2(e)
  int causal;
  int head_dim;
};

template <int D, int SPLIT>
__global__ void __launch_bounds__(Cfg<D, SPLIT>::kThreads, Cfg<D, SPLIT>::kCtasPerSm)
    flash_fwd_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D, SPLIT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of the shared address: align the tiles to it
  unsigned char* q_s =
      smem_raw + (kSwizzleAtom - smem_u32(smem_raw) % kSwizzleAtom) % kSwizzleAtom;
  unsigned char* ring = q_s + C::kTileBytes;  // stage s: K tile, then V tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* q_full = empty + C::kStages;
  uint64_t* handed = q_full + 1;
  float* xchg = reinterpret_cast<float*>(handed + 1);

  // the grid's fast axis: the batch-head's chunks of O's columns, each
  // chunk a CTA
  const int bh = blockIdx.x / C::kChunks;
  const int chunk = blockIdx.x % C::kChunks;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBK;
  // the CTA's KV tiles: through its diagonal
  const int n_kv = p.causal ? (q0 + kBK) / C::kKv : p.seq / C::kKv;
  // tile j lies in stage j % kStages, in the ring's round j / kStages
  auto stage_of = [](int j) { return j % C::kStages; };
  auto phase_of = [](int j) { return static_cast<uint32_t>(j / C::kStages) & 1u; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);  // one warpgroup reads each tile
    }
    mbar_init(q_full, 1);
    mbar_init(handed, 128);
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, taken from lane 0 so the compiler sees it uniform across
  // the warp: branches on it are then not divergent, and it does not
  // serialize the wgmma under them
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == SPLIT) {
    // producer: one thread loads Q once, then K and the CTA's columns of V
    // tile by tile
    if (threadIdx.x % 32 == 0) {
      mbar_arrive_expect_tx(q_full, C::kTileBytes);
      for (int c = 0; c < C::kBoxes; ++c) {
        tma_load_4d(q_s + c * kBoxBytes, &p.q, q_full, c * kBox, h, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int st = stage_of(j);
        mbar_wait(&empty[st], phase_of(j) ^ 1);  // a fresh ring starts empty
        unsigned char* k_tile = ring + st * C::kStageBytes;
        unsigned char* v_tile = k_tile + C::kKBytes;
        mbar_arrive_expect_tx(&full[st], C::kStageBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_4d(k_tile + c * C::kKvBoxBytes, &p.k, &full[st], c * kBox, h, j * C::kKv, b);
        }
        for (int c = 0; c < C::kDc / kBox; ++c) {
          tma_load_4d(v_tile + c * C::kKvBoxBytes, &p.v, &full[st], chunk * C::kDc + c * kBox, h,
                      j * C::kKv, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup `wg`: of the CTA's tiles the ones j = wg (mod SPLIT)
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int mine = n_kv > wg ? (n_kv - wg + SPLIT - 1) / SPLIT : 0;

  // Thread t holds rows 16 warp + lane/4 (r = 0) and + 8 (r = 1) of the
  // warpgroup's 64, and in each 8-column block of S or O the columns
  // 2 (lane % 4) + {0, 1}: element 4 j + e is block j, row e / 2.
  const int row0 = q0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float o[C::kDc / 2];
#pragma unroll
  for (int i = 0; i < C::kDc / 2; ++i) o[i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};  // in log2 units
  float l_run[2] = {0.0f, 0.0f};       // this thread's share of the row sums

  if (mine > 0) {
    float s[C::kKv / 2] = {};
    uint32_t pk[C::kKv / kWgK][4];  // P in Elem pairs: A of P V, 16 keys each
    float corr[2];

    // S = Q K^T for tile j (K-major both: 32-byte steps along a row, the
    // next 64-column box every four), over every column of Q and K
    auto issue_scores = [&](int j) {
      const unsigned char* k_tile = ring + stage_of(j) * C::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < D / kWgK; ++kk) {
        const uint32_t along = (kk % 4) * kWgK * 2;
        const uint64_t qd = desc_k_major(q_s + (kk / 4) * kBoxBytes + along);
        const uint64_t kd = desc_k_major(k_tile + (kk / 4) * C::kKvBoxBytes + along);
        if constexpr (C::kKv == 64) {
          wgmma_m64n64k16_ss(s, qd, kd, kk > 0);
        } else {
          wgmma_m64n32k16_ss(s, qd, kd, kk > 0);
        }
      }
      wgmma_commit();
    };
    // the mask on the tiles that reach past the CTA's first row (the
    // diagonal one, or at 32 rows a tile the two that cover the CTA's own
    // keys), and the online softmax update
    auto softmax = [&](int j) {
      online_softmax<C::kKv>(s, m_run, l_run, corr, p.causal && (j + 1) * C::kKv > q0,
                             j * C::kKv, row0, col0, p.scale_log2);
    };
    // O += P V for tile j, P from the registers
    auto issue_pv = [&](int j) {
      const unsigned char* v_tile = ring + stage_of(j) * C::kStageBytes + C::kKBytes;
#pragma unroll
      for (int kc = 0; kc < C::kKv / kWgK; ++kc) {
        pv_step<C::kDc>(o, pk[kc], v_tile + kc * kWgK * kSwizzleRow, C::kKvBoxBytes);
      }
      wgmma_commit();
    };

    int cur = wg;  // the tile whose P is packed
    mbar_wait(q_full, 0);
    mbar_wait(&full[stage_of(cur)], phase_of(cur));
    wgmma_fence();
    issue_scores(cur);
    wgmma_wait<0>();
    wgmma_fence_operands(s);
    softmax(cur);  // o is still zero: corr needs no applying
    pack<C::kKv>(pk, s);
    // each step issues tile j's Q K^T, then the previous tile's P V, and
    // runs tile j's softmax while P V is in flight; no wgmma sits under a
    // condition
    for (int i = 1; i < mine; ++i) {
      const int j = wg + i * SPLIT;
      mbar_wait(&full[stage_of(j)], phase_of(j));
      wgmma_fence();  // this thread's writes of o and pk precede the products
      wgmma_fence_operands(o);
      wgmma_fence_operands(pk);
      issue_scores(j);
      issue_pv(cur);
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      softmax(j);
      wgmma_wait<0>();
      wgmma_fence_operands(o);
      wgmma_fence_operands(pk);
      if (t == 0) mbar_arrive(&empty[stage_of(cur)]);  // P V is done with its stage
#pragma unroll
      for (int k = 0; k < C::kDc / 2; ++k) o[k] *= corr[k % 4 / 2];
      pack<C::kKv>(pk, s);
      cur = j;
    }
    wgmma_fence();
    wgmma_fence_operands(o);
    wgmma_fence_operands(pk);
    issue_pv(cur);
    wgmma_wait<0>();
    wgmma_fence_operands(o);
    if (t == 0) mbar_arrive(&empty[stage_of(cur)]);
  }

  // the four threads of a row hold parts of its sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if constexpr (SPLIT == 2) {
    // the second warpgroup hands its (m, l, O) over, thread by thread in
    // the same layout, and the first merges them into its own
    if (wg == 1) {
#pragma unroll
      for (int k = 0; k < D / 2; ++k) xchg[k * 128 + t] = o[k];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xchg[(D / 2 + r) * 128 + t] = m_run[r];
        xchg[(D / 2 + 2 + r) * 128 + t] = l_run[r];
      }
      mbar_arrive(handed);
      return;
    }
    mbar_wait(handed, 0);
    float own[2], their[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_their = xchg[(D / 2 + r) * 128 + t];
      const float m = fmaxf(m_run[r], m_their);
      own[r] = exp2_approx(m_run[r] - m);
      their[r] = exp2_approx(m_their - m);
      l_run[r] = l_run[r] * own[r] + xchg[(D / 2 + 2 + r) * 128 + t] * their[r];
      m_run[r] = m;
    }
#pragma unroll
    for (int k = 0; k < D / 2; ++k) {
      o[k] = o[k] * own[k % 4 / 2] + xchg[k * 128 + t] * their[k % 4 / 2];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(l_run[r], 1e-30f);
    const int row = row0 + r * 8;
    Elem* out = p.o + b * p.o_sb + static_cast<int64_t>(row) * p.o_ss + h * p.o_sh +
                chunk * C::kDc;
#pragma unroll
    for (int i = 0; i < C::kDc / 8; ++i) {
      store_pair(out + i * 8 + col0, o[4 * i + 2 * r] / l_safe, o[4 * i + 2 * r + 1] / l_safe);
    }
    // every chunk computes the same (m, l): the first writes the logsumexp
    if (p.lse != nullptr && chunk == 0 && lane % 4 == 0) {
      p.lse[static_cast<int64_t>(bh) * p.seq + row] = m_run[r] * kLn2 + logf(l_safe);
    }
  }
}

// The streamed tiling (the file's note)
struct Streamed {
  static constexpr int kDc = 128;  // O's columns a CTA
  static constexpr int kKv = 64;   // K/V rows a tile
  static constexpr int kStages = 4;   // pair stages: Q's and K's chunks
  static constexpr int kVStages = 2;  // V stages
  static constexpr uint32_t kChunkBytes = 2 * kBoxBytes;  // 64 x 128: two boxes
  static constexpr uint32_t kPairBytes = 2 * kChunkBytes;
  static constexpr int kThreads = 160;
  static constexpr size_t kSmem = kStages * kPairBytes + kVStages * kChunkBytes +
                                  2 * (kStages + kVStages) * sizeof(uint64_t) + kSwizzleAtom;
  static_assert(kSmem + 1024 <= 233472, "shared memory of an SM");
};

__global__ void __launch_bounds__(Streamed::kThreads, 1)
    flash_fwd_streamed_kernel(const __grid_constant__ Params p) {
  using C = Streamed;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + (kSwizzleAtom - smem_u32(smem_raw) % kSwizzleAtom) % kSwizzleAtom;
  unsigned char* v_ring = ring + C::kStages * C::kPairBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_ring + C::kVStages * C::kChunkBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* v_full = empty + C::kStages;
  uint64_t* v_empty = v_full + C::kVStages;

  // the grid's fast axis: the batch-head's chunks of O's columns
  const int chunks = p.head_dim / C::kDc;
  const int bh = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBK;
  const int n_kv = p.causal ? (q0 + kBK) / C::kKv : p.seq / C::kKv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int s = 0; s < C::kVStages; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 1) {
    // producer: one thread streams, for each K/V tile, the pairs of Q's and
    // K's chunks, then V's chunk of the CTA's columns; pair n of the CTA
    // lies in stage n % kStages, in the ring's round n / kStages
    if (threadIdx.x == 128) {
      int n = 0;
      for (int j = 0; j < n_kv; ++j) {
        for (int c = 0; c < chunks; ++c, ++n) {
          const int st = n % C::kStages;
          mbar_wait(&empty[st], (static_cast<uint32_t>(n / C::kStages) & 1u) ^ 1);
          unsigned char* pair = ring + st * C::kPairBytes;
          mbar_arrive_expect_tx(&full[st], C::kPairBytes);
          for (int x = 0; x < 2; ++x) {
            tma_load_4d(pair + x * kBoxBytes, &p.q, &full[st], c * C::kDc + x * kBox, h, q0, b);
            tma_load_4d(pair + C::kChunkBytes + x * kBoxBytes, &p.k, &full[st],
                        c * C::kDc + x * kBox, h, j * C::kKv, b);
          }
        }
        const int vs = j % C::kVStages;
        mbar_wait(&v_empty[vs], (static_cast<uint32_t>(j / C::kVStages) & 1u) ^ 1);
        mbar_arrive_expect_tx(&v_full[vs], C::kChunkBytes);
        for (int x = 0; x < 2; ++x) {
          tma_load_4d(v_ring + vs * C::kChunkBytes + x * kBoxBytes, &p.v, &v_full[vs],
                      chunk * C::kDc + x * kBox, h, j * C::kKv, b);
        }
      }
    }
    return;
  }

  // consumer: thread t holds rows 16 warp + lane/4 (r = 0) and + 8 (r = 1),
  // and in each 8-column block of S or O the columns 2 (lane % 4) + {0, 1}
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int row0 = q0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float o[C::kDc / 2];
#pragma unroll
  for (int i = 0; i < C::kDc / 2; ++i) o[i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};  // in log2 units
  float l_run[2] = {0.0f, 0.0f};       // this thread's share of the row sums
  float s[C::kKv / 2] = {};
  uint32_t pk[C::kKv / kWgK][4];  // P in Elem pairs: A of P V, 16 keys each

  int n = 0;  // the pairs consumed
  for (int j = 0; j < n_kv; ++j) {
    // S = Q K^T over the head_dim, one pair of 128-column chunks a stage
    for (int c = 0; c < chunks; ++c, ++n) {
      const int st = n % C::kStages;
      mbar_wait(&full[st], static_cast<uint32_t>(n / C::kStages) & 1u);
      const unsigned char* pair = ring + st * C::kPairBytes;
      wgmma_fence();
      wgmma_fence_operands(s);
#pragma unroll
      for (int kk = 0; kk < C::kDc / kWgK; ++kk) {
        const uint32_t at = (kk / 4) * kBoxBytes + (kk % 4) * kWgK * 2;
        wgmma_m64n64k16_ss(s, desc_k_major(pair + at), desc_k_major(pair + C::kChunkBytes + at),
                           c > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(s);
      if (t == 0) mbar_arrive(&empty[st]);  // the products are done with the pair
    }
    // the causal mask on the diagonal tile, and the online softmax update
    float corr[2];
    online_softmax<C::kKv>(s, m_run, l_run, corr, p.causal && (j + 1) * C::kKv > q0,
                           j * C::kKv, row0, col0, p.scale_log2);
#pragma unroll
    for (int k = 0; k < C::kDc / 2; ++k) o[k] *= corr[k % 4 / 2];
    pack<C::kKv>(pk, s);
    // O += P V on the CTA's columns
    const int vs = j % C::kVStages;
    mbar_wait(&v_full[vs], static_cast<uint32_t>(j / C::kVStages) & 1u);
    const unsigned char* v_tile = v_ring + vs * C::kChunkBytes;
    wgmma_fence();
    wgmma_fence_operands(o);
    wgmma_fence_operands(pk);
#pragma unroll
    for (int kc = 0; kc < C::kKv / kWgK; ++kc) {
      pv_step<C::kDc>(o, pk[kc], v_tile + kc * kWgK * kSwizzleRow, kBoxBytes);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(o);
    wgmma_fence_operands(pk);
    if (t == 0) mbar_arrive(&v_empty[vs]);  // P V is done with V's stage
  }

  // the four threads of a row hold parts of its sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const float l_safe = fmaxf(l_run[r], 1e-30f);
    const int row = row0 + r * 8;
    Elem* out = p.o + b * p.o_sb + static_cast<int64_t>(row) * p.o_ss + h * p.o_sh +
                chunk * C::kDc;
#pragma unroll
    for (int i = 0; i < C::kDc / 8; ++i) {
      store_pair(out + i * 8 + col0, o[4 * i + 2 * r] / l_safe, o[4 * i + 2 * r + 1] / l_safe);
    }
    // every chunk computes the same (m, l): the first writes the logsumexp
    if (chunk == 0 && p.lse != nullptr && lane % 4 == 0) {
      p.lse[static_cast<int64_t>(bh) * p.seq + row] = m_run[r] * kLn2 + logf(l_safe);
    }
  }
}

// the head_dims of the fixed tilings (64-512), and of the streamed one
bool fixed_width(int head_dim) {
  return head_dim == 64 || head_dim == 128 || head_dim == 256 || head_dim == 384 ||
         head_dim == 512;
}
bool streamed(int head_dim) { return head_dim >= 640 && head_dim % Streamed::kDc == 0; }

template <int D, int SPLIT>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(flash_fwd_kernel<D, SPLIT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Cfg<D, SPLIT>::kSmem));
}

template <int D, int SPLIT>
void launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const dim3 grid(batch_heads * Cfg<D, SPLIT>::kChunks, p.seq / kBK);
  flash_fwd_kernel<D, SPLIT><<<grid, Cfg<D, SPLIT>::kThreads, Cfg<D, SPLIT>::kSmem, stream>>>(p);
}

int put_config(const int (&values)[6], int* out, int n) {
  for (int i = 0; i < n && i < 6; ++i) out[i] = values[i];
  return 6;
}

template <class C>
int config_of(int* out, int n) {
  return put_config({C::kThreads, C::kStages, C::kCtasPerSm, static_cast<int>(C::kSmem),
                     C::kChunks, C::kKv}, out, n);
}

}  // namespace

// C entries, bound with ctypes.
//
// flash_attention_init opts the eight instantiations (head_dim 64 and 128 by
// one or two consumer warpgroups, 256, 384 and 512 by one, and the streamed
// one) in to the dynamic
// shared memory they need above the default 48 KB and looks up the CUDA driver
// API's cuTensorMapEncodeTiled.  It is called once per device before the
// first launch, never at launch: a launch may sit inside CUDA-graph
// capture.  Returns a cudaError_t.
extern "C" int flash_attention_init(int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = opt_in<64, 1>();
  if (err == cudaSuccess) err = opt_in<64, 2>();
  if (err == cudaSuccess) err = opt_in<128, 1>();
  if (err == cudaSuccess) err = opt_in<128, 2>();
  if (err == cudaSuccess) err = opt_in<256, 1>();
  if (err == cudaSuccess) err = opt_in<384, 1>();
  if (err == cudaSuccess) err = opt_in<512, 1>();
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_streamed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Streamed::kSmem));
  }
  if (err == cudaSuccess) err = find_encode();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The configuration of the instantiation for (head_dim, kv_split), for
// reports: threads, stages, CTAs an SM by launch bounds, dynamic shared
// memory in bytes, CTAs a (batch-head, Q tile) (chunks of O's columns), and
// K/V rows a tile.  Writes at most `n` values; returns how many there are,
// or 0 where there is no such instantiation.
extern "C" int flash_attention_config(int head_dim, int kv_split, int* out, int n) {
  if (kv_split != 1 && kv_split != 2) return 0;
  if (head_dim == 64) {
    return kv_split == 2 ? config_of<Cfg<64, 2>>(out, n) : config_of<Cfg<64, 1>>(out, n);
  }
  if (head_dim == 128) {
    return kv_split == 2 ? config_of<Cfg<128, 2>>(out, n) : config_of<Cfg<128, 1>>(out, n);
  }
  if (kv_split != 1) return 0;
  if (head_dim == 256) return config_of<Cfg<256, 1>>(out, n);
  if (head_dim == 384) return config_of<Cfg<384, 1>>(out, n);
  if (head_dim == 512) return config_of<Cfg<512, 1>>(out, n);
  if (streamed(head_dim)) {
    using C = Streamed;
    return put_config({C::kThreads, C::kStages, 1, static_cast<int>(C::kSmem),
                       head_dim / C::kDc, C::kKv}, out, n);
  }
  return 0;
}

// `strides` holds 12 element strides: (batch, seq, head) for Q, K, V and O.
// `lse` may be null.  A CTA takes 64 Q rows on `kv_split` consumer
// warpgroups (1 or 2; 1 past head_dim 128) that take turns over its K/V
// tiles, and at head_dim 384 and 512 half of O's columns, from 640 on (any
// multiple of 128) a 128-column chunk of them.  `device` is the
// CUDA ordinal the pointers live on, initialised with flash_attention_init,
// and `stream` the caller's cudaStream_t.
// Returns cudaGetLastError() after the launch: nonzero means the launch was
// refused and nothing ran.  A refused tensor map returns the CUDA driver
// API's CUresult.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const int64_t* strides, int kv_split,
                                   int batch, int heads, int seq, int head_dim, int causal,
                                   float scale, int device, void* stream) {
  if (g_encode == nullptr) return static_cast<int>(cudaErrorInitializationError);
  const bool known = head_dim == 64 || head_dim == 128
                         ? kv_split == 1 || kv_split == 2
                         : (fixed_width(head_dim) || streamed(head_dim)) && kv_split == 1;
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cudaSetDevice makes the device's context current in this thread, which
  // cuTensorMapEncodeTiled needs; a thread's first cudaGetDevice does not
  if ((err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  Params p;
  // Q in 64-row boxes, K and V in the tiles' rows
  const int rows = stream_rows(head_dim);
  CUresult refused = encode_bshd(&p.q, q, batch, seq, heads, head_dim, strides);
  if (refused == CUDA_SUCCESS) {
    refused = encode_bshd(&p.k, k, batch, seq, heads, head_dim, strides + 3, rows);
  }
  if (refused == CUDA_SUCCESS) {
    refused = encode_bshd(&p.v, v, batch, seq, heads, head_dim, strides + 6, rows);
  }
  if (refused != CUDA_SUCCESS) {
    if (cur != device) cudaSetDevice(cur);
    return static_cast<int>(refused);
  }
  p.o = static_cast<Elem*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = strides[9], p.o_ss = strides[10], p.o_sh = strides[11];
  p.heads = heads;
  p.seq = seq;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.head_dim = head_dim;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (streamed(head_dim)) {
    const dim3 grid(bh * (head_dim / Streamed::kDc), seq / kBK);
    flash_fwd_streamed_kernel<<<grid, Streamed::kThreads, Streamed::kSmem, s>>>(p);
  } else if (head_dim == 512) {
    launch<512, 1>(p, bh, s);
  } else if (head_dim == 384) {
    launch<384, 1>(p, bh, s);
  } else if (head_dim == 256) {
    launch<256, 1>(p, bh, s);
  } else if (head_dim == 128) {
    kv_split == 2 ? launch<128, 2>(p, bh, s) : launch<128, 1>(p, bh, s);
  } else {
    kv_split == 2 ? launch<64, 2>(p, bh, s) : launch<64, 1>(p, bh, s);
  }
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}
