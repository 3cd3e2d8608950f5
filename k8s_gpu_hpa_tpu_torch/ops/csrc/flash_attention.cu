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
// Causal tiles past the diagonal are skipped, not masked: Q tile i stops its
// KV loop at min(n_kv_tiles, ceil((i+1) * BQ / BK)), the bound of :100-104.
//
// The TPU kernel keeps a whole K/V stripe of one batch-head in VMEM and loops
// over it.  A Hopper CTA has at most 227 KB of shared memory, so this kernel
// streams K/V instead (FlashAttention-2 style): one CTA per (batch-head, Q tile
// of 128 rows), eight warps of 16 Q rows each, K/V tiles of 64 rows staged in
// shared memory with cp.async and double-buffered so the next tile's copy
// overlaps this tile's products.  Q stays in registers as mma fragments for the
// whole loop; S = Q K^T and O += P V run on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  The S accumulators are
// reused in registers as the A operand of P V, so scores never touch shared
// or device memory.  Shared-memory rows are padded by 8 elements so the
// ldmatrix row addresses of one 8x8 matrix fall in distinct banks.
//
// Bound.  Each (batch-head, Q row, K row) pair that the causal loop visits
// costs 4 d operations (two products).  At the serving prefill's shape (b8, s512,
// h4, d128, causal) the pairs below the diagonal are 32 * 512 * 513 / 2, or
// 2.15 GFLOP: 2.2 us at the H100 SXM's 989 TFLOP/s dense bf16, against 16.8 MB
// of Q, K, V and O, or 5.0 us at 3.35 TB/s: memory bounds that shape.  At
// (b2, s4096, h8, d128, causal) the work is 68.7 GFLOP, or 69.5 us, against
// 67.1 MB, 20.0 us: the tensor cores bound it (NVIDIA H100 SXM data sheet).
// wgmma, TMA and warp specialisation, which the card needs to approach either
// bound, are later work.
//
// Layout.  Q, K, V are [B, S, H, D] with D contiguous and any other strides
// (element counts, multiples of 8); a [B*H, S, D] tensor is the case H = 1.
// O has its own strides; lse is [B*H, S] fp32, contiguous.  S must be a
// multiple of the KV tile (64); the last Q tile may be ragged.  The Python
// wrapper (ops/flash_attention.py) checks all of this before it calls in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;  // Q rows per CTA
constexpr int kBK = 64;   // K/V rows per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // null: no logsumexp output
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int heads, seq;
  float scale;
  int causal;
};

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;  // padded row stride, elements
  static constexpr int kQ = kBQ * kLd;
  static constexpr int kKV = kBK * kLd;
  static constexpr size_t kBytes = (kQ + 4 * kKV) * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b for one 16x8x16 tile: a is 16x16 row-major (4 registers of two
// bf16), b is 16x8 column-major (2 registers), d is 16x8 fp32 (4 floats).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  using S = Smem<D>;
  constexpr int kLd = S::kLd;
  constexpr int kChunks = D / 8;  // 16-byte chunks in one row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + S::kQ;       // [2][kBK][kLd]
  __nv_bfloat16* v_s = k_s + 2 * S::kKV;  // [2][kBK][kLd]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // heaviest causal tiles first, so the short ones fill the tail
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = iq * kBQ;

  const __nv_bfloat16* q_base = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k_base = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v_base = p.v + b * p.v_sb + h * p.v_sh;

  // Q tile: rows past the end of the sequence read as zeros and are never
  // stored.
  for (int id = tid; id < kBQ * kChunks; id += kThreads) {
    const int r = id / kChunks;
    const int c = (id % kChunks) * 8;
    __nv_bfloat16* dst = q_s + r * kLd + c;
    if (q0 + r < p.seq) {
      cp_async16(dst, q_base + static_cast<int64_t>(q0 + r) * p.q_ss + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kBK;
    __nv_bfloat16* ks = k_s + stage * S::kKV;
    __nv_bfloat16* vs = v_s + stage * S::kKV;
    for (int id = tid; id < kBK * kChunks; id += kThreads) {
      const int r = id / kChunks;
      const int c = (id % kChunks) * 8;
      cp_async16(ks + r * kLd + c, k_base + static_cast<int64_t>(k0 + r) * p.k_ss + c);
      cp_async16(vs + r * kLd + c, v_base + static_cast<int64_t>(k0 + r) * p.v_ss + c);
    }
  };

  const int n_kv = p.seq / kBK;
  const int hi = p.causal ? min(n_kv, (q0 + kBQ + kBK - 1) / kBK) : n_kv;

  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_one();  // the Q group has landed
  __syncthreads();

  // Q fragments of this warp's 16 rows, one per 16-wide slice of D
  uint32_t qf[D / 16][4];
  {
    const int row = warp * 16 + (lane % 16);
    const int col = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_s + row * kLd + kk * 16 + col);
  }

  // Thread `lane` holds rows g and g + 8 of the warp's 16, and in each
  // 8-column block of S or O the two columns 2 * (lane % 4) + {0, 1}.
  const int g = lane / 4;
  const int row0 = q0 + warp * 16 + g;  // sequence position of row g
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  for (int j = 0; j < hi; ++j) {
    const int cur = j & 1;
    if (j + 1 < hi) load_kv(cur ^ 1, j + 1);
    // an empty group on the last tile keeps "all but the newest" meaning
    // "tile j has landed"
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* ks = k_s + cur * S::kKV;
    const __nv_bfloat16* vs = v_s + cur * S::kKV;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kBK / 16; ++nb) {
        // matrices: keys nb*16 + {0..7, 8..15} x d kk*16 + {0..7, 8..15}
        const int m = lane / 8;
        const int key = nb * 16 + (lane % 8) + (m / 2) * 8;
        const int col = kk * 16 + (m % 2) * 8;
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + key * kLd + col);
        mma_bf16(s[2 * nb], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * nb + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, causal mask, and the online softmax update
    const int key0 = j * kBK + 2 * (lane % 4);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * p.scale;
        if (p.causal) {
          const int qpos = row0 + (e / 2) * 8;
          const int kpos = key0 + nb * 8 + (e % 2);
          if (qpos < kpos) x = kNegInf;
        }
        s[nb][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nb][e] - mx[e / 2]);
        s[nb][e] = pe;
        rs[e / 2] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V, P rounded to bf16 and taken from the S registers as the A
    // operand: keys kc*16 .. kc*16 + 15 are S blocks 2 kc and 2 kc + 1
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        // matrices, transposed: keys kc*16 + {0..7, 8..15} x d nd*16 + {0..7, 8..15}
        const int key = kc * 16 + (lane % 16);
        const int col = nd * 16 + (lane / 16) * 8;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + key * kLd + col);
        mma_bf16(acc[2 * nd], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * nd + 1], pa, vf[2], vf[3]);
      }
    }
    // every warp is done reading `cur` before the next tile refills it
    __syncthreads();
  }

  // the four threads of a row hold parts of its sum
  float l_div[2];
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    l_div[r] = l_safe;
    lse[r] = m_run[r] + logf(l_safe);
  }
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.seq) continue;
    __nv_bfloat16* out = p.o + b * p.o_sb + static_cast<int64_t>(row) * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(out + i * 8 + c0) =
          __floats2bfloat162_rn(acc[i][2 * r] / l_div[r], acc[i][2 * r + 1] / l_div[r]);
    }
    if (p.lse != nullptr && lane % 4 == 0) {
      p.lse[static_cast<int64_t>(bh) * p.seq + row] = lse[r];
    }
  }
}

}  // namespace

// C entries, bound with ctypes.
//
// flash_attention_init opts both instantiations in to the dynamic shared
// memory they need above the default 48 KB.  It is called once when the
// library is loaded, never at launch: a launch may sit inside CUDA-graph
// capture.  Returns a cudaError_t.
extern "C" int flash_attention_init(int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(flash_fwd_kernel<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Smem<64>::kBytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Smem<128>::kBytes));
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// `strides` holds 12 element strides: (batch, seq, head) for Q, K, V and O.
// `lse` may be null.  `device` is the CUDA ordinal the pointers live on and
// `stream` the caller's cudaStream_t.  Returns cudaGetLastError() after the
// launch: nonzero means the launch was refused and nothing ran.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const int64_t* strides, int batch,
                                   int heads, int seq, int head_dim, int causal,
                                   float scale, int device, void* stream) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.o_sb = strides[9], p.o_ss = strides[10], p.o_sh = strides[11];
  p.heads = heads;
  p.seq = seq;
  p.scale = scale;
  p.causal = causal;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, Smem<128>::kBytes, s>>>(p);
  } else if (head_dim == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, Smem<64>::kBytes, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}
