// Flash attention forward for Hopper (sm_90a): O = softmax(Q K^T / sqrt(d)) V
// over bf16 operands, fp32 online softmax, optional causal mask and per-row
// logsumexp.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// k8s_gpu_hpa_tpu/ops/flash_attention.py (pallas_call in `_flash_bhsd`).  It
// computes what that kernel computes: scores in fp32 times 1/sqrt(d), the
// causal mask q_pos >= k_pos with -1e30 (not -inf), the online softmax
// (m, l, acc) in fp32, P rounded to bf16 before P V, fp32 accumulation,
// out = acc / max(l, 1e-30), and with an lse pointer lse = m + log(l_safe).
// Causal tiles past the diagonal are skipped, not masked: the 64 Q rows from
// q0 stop their KV loop at tile q0 / 64, the diagonal, the only one masked.
// The exponentials are exp2 of log2(e)-prescaled scores, and the logsumexp
// is brought back to natural log at the end.
//
// The TPU kernel keeps a whole K/V stripe of one batch-head in VMEM and loops
// over it.  A Hopper CTA has at most 227 KB of shared memory, so this kernel
// streams K/V tiles of 64 rows instead (FlashAttention-3 style):
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
//     registers: the fp32 S accumulators, packed to bf16 pairs, are its A
//     fragments, so scores never leave the registers; V is read N-major
//     with the transpose bit.  Within a warpgroup the next tile's Q K^T is
//     issued before this tile's P V, and its softmax runs while P V is in
//     flight;
//   - tensors reach the TMA unit through 4-D tensor maps over (d, h, s, b)
//     with the caller's strides, so the transformer's views of its fused QKV
//     product are read where they lie; the map's s extent is the sequence,
//     so a box past it reads zeros and never the next batch's rows.  Boxes
//     are 64 x 64 (128-byte rows, the swizzle's width): d = 128 is two boxes.
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
//
// Bound.  Each (batch-head, Q row, K row) pair that the causal loop visits
// costs 4 d operations (two products).  At the serving prefill's shape (b8,
// s512, h4, d128, causal) the pairs below the diagonal are 32 * 512 * 513 / 2,
// or 2.15 GFLOP: 2.2 us at the H100 SXM's 989 TFLOP/s dense bf16, against
// 16.8 MB of Q, K, V and O, or 5.0 us at 3.35 TB/s: memory bounds that shape.
// At the training shape (b1, s2048, h4) it is 4.3 GFLOP, 4.3 us, and at (b2,
// s4096, h8) 68.7 GFLOP, or 69.5 us, against 67.1 MB, 20.0 us: the tensor
// cores bound both (NVIDIA H100 SXM data sheet).
//
// Layout.  Q, K, V are [B, S, H, D] with D contiguous and any other strides
// (element counts, multiples of 8); a [B*H, S, D] tensor is the case H = 1.
// O has its own strides; lse is [B*H, S] fp32, contiguous.  S must be a
// multiple of the KV tile (64).  The Python wrapper (ops/flash_attention.py)
// checks all of this before it calls in.  The backward kernels are in
// flash_attention_bwd.cu.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "smem_desc.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kBK = 64;     // K/V rows per tile, and Q rows per warpgroup
constexpr int kWgK = 16;    // one wgmma's K
constexpr uint32_t kBoxBytes = kBK * kBox * 2;  // 8 KB
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// two floats rounded to a bf16 pair, the first in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 Q rows a CTA on SPLIT consumer warpgroups (1 or 2) that take turns
// over its K/V tiles
template <int D, int SPLIT>
struct Cfg {
  static constexpr int kBoxes = D / kBox;  // boxes across a row of Q, K or V
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;  // 64 rows of Q, K or V
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;  // K and V
  // two stages where two CTAs share an SM, four where one has it alone
  static constexpr int kStages = SPLIT == 1 ? 2 : 4;
  static constexpr int kThreads = 128 * SPLIT + 32;
  static constexpr int kCtasPerSm = SPLIT == 1 ? 2 : 1;
  // the second warpgroup hands over its O, m and l there
  static constexpr uint32_t kXchgBytes = SPLIT == 1 ? 0 : (D / 2 + 4) * 128 * sizeof(float);
  // Q, the ring, its barriers, Q's and the hand-over's, the hand-over, and
  // room to align to the swizzle atom
  static constexpr size_t kSmem = kTileBytes + kStages * kStageBytes +
                                  (2 * kStages + 2) * sizeof(uint64_t) + kXchgBytes +
                                  kSwizzleAtom;
};

struct Params {
  CUtensorMap q, k, v;  // [b, s, h, d], box 64 (d) x 1 x 64 (s) x 1
  __nv_bfloat16* o;
  float* lse;  // null: no logsumexp output
  int64_t o_sb, o_ss, o_sh;
  int heads, seq;
  float scale_log2;  // 1/sqrt(d) * log2(e)
  int causal;
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

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBK;
  // the CTA's KV tiles: through its diagonal
  const int n_kv = p.causal ? q0 / kBK + 1 : p.seq / kBK;
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
    // producer: one thread loads Q once, then K and V tile by tile
    if (threadIdx.x % 32 == 0) {
      mbar_arrive_expect_tx(q_full, C::kTileBytes);
      for (int c = 0; c < C::kBoxes; ++c) {
        tma_load_4d(q_s + c * kBoxBytes, &p.q, q_full, c * kBox, h, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int st = stage_of(j);
        mbar_wait(&empty[st], phase_of(j) ^ 1);  // a fresh ring starts empty
        unsigned char* k_tile = ring + st * C::kStageBytes;
        unsigned char* v_tile = k_tile + C::kTileBytes;
        mbar_arrive_expect_tx(&full[st], C::kStageBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_4d(k_tile + c * kBoxBytes, &p.k, &full[st], c * kBox, h, j * kBK, b);
          tma_load_4d(v_tile + c * kBoxBytes, &p.v, &full[st], c * kBox, h, j * kBK, b);
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
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};  // in log2 units
  float l_run[2] = {0.0f, 0.0f};       // this thread's share of the row sums

  if (mine > 0) {
    float s[32] = {};
    uint32_t pk[kBK / kWgK][4];  // P in bf16 pairs: A of P V, 16 keys each
    float corr[2];

    // S = Q K^T for tile j (K-major both: 32-byte steps along a row, the
    // next 64-column box every four)
    auto issue_scores = [&](int j) {
      const unsigned char* k_tile = ring + stage_of(j) * C::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < D / kWgK; ++kk) {
        const uint32_t at = (kk / 4) * kBoxBytes + (kk % 4) * kWgK * 2;
        wgmma_m64n64k16_ss_bf16(s, desc_k_major(q_s + at), desc_k_major(k_tile + at), kk > 0);
      }
      wgmma_commit();
    };
    // causal mask on the diagonal tile, scale, and the online softmax
    // update: S becomes P (fp32, against the new running max), corr the
    // factor the earlier sums scale by.  The scale is positive, so the row
    // max is taken on the raw scores and scaled once, and each score is
    // scaled and offset by one fma.
    auto softmax = [&](int j) {
      const bool diagonal = p.causal && j * kBK == q0;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (diagonal && row0 + (i % 4 / 2) * 8 < j * kBK + (i / 4) * 8 + col0 + i % 2) {
          s[i] = kNegInf;
        }
        mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s[i]);
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m_run[r], mx[r] * p.scale_log2);
        corr[r] = exp2_approx(m_run[r] - mx[r]);
        m_run[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2_approx(fmaf(s[i], p.scale_log2, -mx[i % 4 / 2]));
        rs[i % 4 / 2] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
    };
    // P to bf16 pairs: keys 16 kc .. 16 kc + 15 are S blocks 2 kc, 2 kc + 1
    auto pack = [&] {
#pragma unroll
      for (int kc = 0; kc < kBK / kWgK; ++kc) {
        pk[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
        pk[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pk[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pk[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }
    };
    // O += P V for tile j, P from the registers
    auto issue_pv = [&](int j) {
      const unsigned char* v_tile = ring + stage_of(j) * C::kStageBytes + C::kTileBytes;
#pragma unroll
      for (int kc = 0; kc < kBK / kWgK; ++kc) {
        const uint64_t dv = desc_mn_major(v_tile + kc * kWgK * kSwizzleRow, kBoxBytes);
        if constexpr (D == 128) {
          wgmma_m64n128k16_rs_bf16(o, pk[kc], dv, 1);
        } else {
          wgmma_m64n64k16_rs_bf16(o, pk[kc], dv, 1);
        }
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
    pack();
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
      for (int k = 0; k < D / 2; ++k) o[k] *= corr[k % 4 / 2];
      pack();
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
    __nv_bfloat16* out = p.o + b * p.o_sb + static_cast<int64_t>(row) * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(out + i * 8 + col0) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] / l_safe, o[4 * i + 2 * r + 1] / l_safe);
    }
    if (p.lse != nullptr && lane % 4 == 0) {
      p.lse[static_cast<int64_t>(bh) * p.seq + row] = m_run[r] * kLn2 + logf(l_safe);
    }
  }
}

template <int D, int SPLIT>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(flash_fwd_kernel<D, SPLIT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Cfg<D, SPLIT>::kSmem));
}

template <int D>
void launch(const Params& p, int kv_split, int batch_heads, cudaStream_t stream) {
  const dim3 grid(batch_heads, p.seq / kBK);
  if (kv_split == 2) {
    flash_fwd_kernel<D, 2><<<grid, Cfg<D, 2>::kThreads, Cfg<D, 2>::kSmem, stream>>>(p);
  } else {
    flash_fwd_kernel<D, 1><<<grid, Cfg<D, 1>::kThreads, Cfg<D, 1>::kSmem, stream>>>(p);
  }
}

template <class C>
int config_of(int* out, int n) {
  const int values[] = {C::kThreads, C::kStages, C::kCtasPerSm, static_cast<int>(C::kSmem)};
  const int count = static_cast<int>(sizeof(values) / sizeof(values[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = values[i];
  return count;
}

}  // namespace

// C entries, bound with ctypes.
//
// flash_attention_init opts the four instantiations (head_dim 64 and 128 by
// one or two consumer warpgroups) in to the dynamic shared memory they need
// above the default 48 KB and looks up the CUDA driver API's cuTensorMapEncodeTiled.
// It is called once per device before the first launch, never at launch: a
// launch may sit inside CUDA-graph capture.  Returns a cudaError_t.
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
  if (err == cudaSuccess) err = find_encode();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The configuration of the instantiation for (head_dim, kv_split), for
// reports: threads, stages, CTAs an SM by launch bounds, dynamic shared
// memory in bytes.  Writes at most `n` values; returns how many there are,
// or 0 where there is no such instantiation.
extern "C" int flash_attention_config(int head_dim, int kv_split, int* out, int n) {
  if (kv_split != 1 && kv_split != 2) return 0;
  if (head_dim == 64) {
    return kv_split == 2 ? config_of<Cfg<64, 2>>(out, n) : config_of<Cfg<64, 1>>(out, n);
  }
  if (head_dim == 128) {
    return kv_split == 2 ? config_of<Cfg<128, 2>>(out, n) : config_of<Cfg<128, 1>>(out, n);
  }
  return 0;
}

// `strides` holds 12 element strides: (batch, seq, head) for Q, K, V and O.
// `lse` may be null.  A CTA takes 64 Q rows on `kv_split` consumer
// warpgroups (1 or 2) that take turns over its K/V tiles.  `device` is the
// CUDA ordinal the pointers live on, initialised with flash_attention_init,
// and `stream` the caller's cudaStream_t.  Returns cudaGetLastError() after
// the launch: nonzero means the launch was refused and nothing ran.  A
// refused tensor map returns the CUDA driver API's CUresult.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const int64_t* strides, int kv_split,
                                   int batch, int heads, int seq, int head_dim, int causal,
                                   float scale, int device, void* stream) {
  if (g_encode == nullptr) return static_cast<int>(cudaErrorInitializationError);
  if ((head_dim != 64 && head_dim != 128) || (kv_split != 1 && kv_split != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (refused != CUDA_SUCCESS) {
    if (cur != device) cudaSetDevice(cur);
    return static_cast<int>(refused);
  }
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = strides[9], p.o_ss = strides[10], p.o_sh = strides[11];
  p.heads = heads;
  p.seq = seq;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) {
    launch<128>(p, kv_split, batch * heads, s);
  } else {
    launch<64>(p, kv_split, batch * heads, s);
  }
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}
