// Flash attention forward for f32 operands on Hopper (sm_90a): O =
// softmax(Q K^T / sqrt(d)) V, fp32 throughout, optional causal mask and
// per-row logsumexp, at head_dim 64, 128 or 256, and on the streamed tiling
// (below) at any multiple of 128 from 384 on.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// k8s_gpu_hpa_tpu/ops/flash_attention.py (pallas_call in `_flash_bhsd`) at
// f32, the dtype the JAX package's own tests run it in
// (tests/test_flash_attention.py).  It computes what that kernel computes:
// scores in fp32 times 1/sqrt(d), the causal mask q_pos >= k_pos with -1e30,
// the online softmax (m, l, acc) in fp32, P kept in f32 (the operand dtype)
// for P V, out = acc / max(l, 1e-30), and with an lse pointer lse = m +
// log(l_safe).  Causal tiles past the diagonal are skipped; tiles that
// cross it are masked.  The exponentials are exp2 of log2(e)-prescaled
// scores, the logsumexp brought back to natural log at the end.  The bf16
// and f16 kernels are flash_attention.cu.
//
// Bound.  The same 4 d operations a (batch-head, query, key) pair the
// causal loop visits as the bf16 kernel, but on the CUDA cores: the H100
// SXM's f32 peak is 67 TFLOP/s (NVIDIA H100 SXM data sheet), so at the
// training shape (b1, s2048, h4, d128, causal) the 4.30 GFLOP take 64 us
// against 16.8 MB (5.0 us at 3.35 TB/s), and at the serving prefill (b8,
// s512, h4) 2.15 GFLOP, 32 us, against 33.6 MB, 10 us: the FFMA rate bounds
// both.  ffma_tiles.cuh says why not the tensor cores (tf32 reads no
// operand N-major and misses the f32 bars).
//
// Design, the simplest that is right (making it fast is later work):
//   - one CTA of 256 threads per (batch-head, 64 Q rows), heaviest causal
//     tiles first, as the bf16 kernel's grid;
//   - Q stays in shared memory; K and V stream through one stage of 64 rows
//     (32 at head_dim 256, the backward's tiling there, where its two own
//     tiles leave no room for two 64-row streamed ones; here Q and the
//     stage take 133 KB, one CTA an SM): the CTA loads a tile with float4
//     loads, synchronises, and computes, with no copy in flight behind the
//     products.  Two CTAs an SM at head_dim 64 and 128 hide one's loads
//     behind the other's FFMA;
//   - S = Q K^T and O += P V as ffma_tiles.cuh's 4 x 4 and 4 x (D / 16)
//     register tiles a thread; the row max and sum over the 16 threads of a
//     row by shuffles; P goes through shared memory, over K's tile, which
//     S no longer needs.
//
// Head_dim 384 and up: the streamed tiling, one instantiation for every
// multiple of 128, head_dim a kernel argument.  No tile holds a whole row:
//   - each CTA of 256 threads owns 64 Q rows and one 128-column chunk of O's
//     columns (head_dim / 128 chunks, the grid's fast axis the batch-head's
//     chunks);
//   - S = Q K^T for a 64-row K/V tile is summed over the head_dim in a
//     runtime loop of 128-column chunks: Q's and K's chunks (64 x 128 each)
//     are loaded with float4 loads, Q re-read from L2 for every K/V tile,
//     and ffma_tiles.cuh's D = 128 score tile adds their product; then V's
//     chunk of the CTA's columns, and O += P V on those columns alone;
//   - shared memory holds Q's chunk (P over it), K's and V's: 101 KB, two
//     CTAs an SM;
//   - every chunk computes the same (m, l) in the same order; the first
//     writes the logsumexp.
// Every chunk recomputes the scores over the whole row: with n = d / 128
// chunks a pair costs 2 d n + 2 d operations against the minimum 4 d (2 d
// at 384, 2.5 d at 512, 4.5 d at 1024).  At the training shape of a 2048-wide
// model of four heads of 512 in f32 (b1, s2048, h4, causal) the minimum is
// 17.2 GFLOP, 257 us at 67 TFLOP/s, against 67.1 MB, 20 us at 3.35 TB/s: the
// FFMA rate bounds it.
//
// Layout.  Q, K, V are [B, S, H, D] with D contiguous and any other strides
// (element counts, multiples of 8); a [B*H, S, D] tensor is the case H = 1.
// O has its own strides; lse is [B*H, S] fp32, contiguous.  S must be a
// multiple of 64.  The Python wrapper (ops/flash_attention.py) checks all of
// this before it calls in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ffma_tiles.cuh"

namespace {

template <int D>
struct Cfg {
  using T = F32Tiles<D>;
  // Q, one K and one V tile (P over K's)
  static constexpr size_t kSmem = (T::kTileFloats + 2 * T::kOtherFloats) * sizeof(float);
  static_assert(T::kScoreFloats <= T::kOtherFloats, "P fits over the K tile");
  static constexpr int kCtasPerSm = D == 256 ? 1 : 2;
  static_assert(kCtasPerSm * (kSmem + 1024) <= 233472, "shared memory of an SM");
};

struct Params {
  const float* qkv[3];
  float* o;
  float* lse;  // null: no logsumexp output
  int64_t st[4][3];  // (batch, seq, head) element strides of q, k, v, o
  int heads, seq;
  float scale_log2;  // 1/sqrt(d) * log2(e)
  int causal;
  int head_dim;
};

// row `row` of tensor `which` (q, k, v, o) at batch b, head h
__device__ __forceinline__ int64_t at(const Params& p, int which, int b, int row, int h) {
  return b * p.st[which][0] + static_cast<int64_t>(row) * p.st[which][1] + h * p.st[which][2];
}

// The mask where the K/V tile from kv0 reaches past the CTA's first row q0
// (`crossing`), then the online softmax update of the tile's scores against
// the new running max: S becomes P, and O and l scale by the correction.
// The scale is positive, so the max is taken on the raw scores and scaled
// once
template <class T>
__device__ __forceinline__ void online_softmax(float (&s)[4][T::kCols], float (&o)[4][T::kOut],
                                               float (&m_run)[4], float (&l_run)[4],
                                               bool crossing, int q0, int kv0, int ty, int tx,
                                               float scale_log2) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    float mx = kF32NegInf;
#pragma unroll
    for (int jj = 0; jj < T::kCols; ++jj) {
      if (crossing && q0 + 4 * ty + ii < kv0 + tx + 16 * jj) s[ii][jj] = kF32NegInf;
      mx = fmaxf(mx, s[ii][jj]);
    }
    mx = fmaxf(m_run[ii], row_max(mx) * scale_log2);
    const float corr = exp2f(m_run[ii] - mx);
    m_run[ii] = mx;
    float rs = 0.0f;
#pragma unroll
    for (int jj = 0; jj < T::kCols; ++jj) {
      s[ii][jj] = exp2f(fmaf(s[ii][jj], scale_log2, -mx));
      rs += s[ii][jj];
    }
    l_run[ii] = l_run[ii] * corr + rs;
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) o[ii][c] *= corr;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, Cfg<D>::kCtasPerSm)
    flash_fwd_f32_kernel(const __grid_constant__ Params p) {
  using T = F32Tiles<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + T::kTileFloats;
  float* v_s = k_s + T::kOtherFloats;
  float* p_s = k_s;  // P over K, once S is done with it

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;
  // the CTA's K/V tiles: through its last row's key
  const int n_kv = (p.causal ? q0 + kF32Rows : p.seq) / T::kOther;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<D>(q_s, p.qkv[0] + at(p, 0, b, q0, h), kF32Rows, p.st[0][1]);
  float o[4][T::kOut];
  float m_run[4], l_run[4];  // m in log2 units; l this thread's share of the row sum
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m_run[ii] = kF32NegInf;
    l_run[ii] = 0.0f;
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) o[ii][c] = 0.0f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * T::kOther;
    __syncthreads();  // the previous tile's P V is done with P and V
    load_rows<D>(k_s, p.qkv[1] + at(p, 1, b, kv0, h), T::kOther, p.st[1][1]);
    load_rows<D>(v_s, p.qkv[2] + at(p, 2, b, kv0, h), T::kOther, p.st[2][1]);
    __syncthreads();
    float s[4][T::kCols];
    scores<D>(s, q_s, k_s, ty, tx);
    const bool crossing = p.causal && kv0 + T::kOther - 1 > q0;
    online_softmax<T>(s, o, m_run, l_run, crossing, q0, kv0, ty, tx, p.scale_log2);
    __syncthreads();  // every thread's S is done with K
    put_scores<D>(p_s, s, ty, tx);
    __syncthreads();
    accumulate<D>(o, p_s, v_s, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const float l_safe = fmaxf(row_sum(l_run[ii]), 1e-30f);
    inv[ii] = 1.0f / l_safe;
    const int row = q0 + 4 * ty + ii;
    if (p.lse != nullptr && tx == 0) {
      p.lse[static_cast<int64_t>(bh) * p.seq + row] = m_run[ii] * kF32Ln2 + logf(l_safe);
    }
  }
  store_out<D>(p.o + at(p, 3, b, q0, h), p.st[3][1], o, inv, ty, tx);
}

// the streamed tiling (the file's note): Q's chunk (P over it), K's, V's
constexpr size_t kStreamedSmem =
    (F32Chunk::kTileFloats + 2 * F32Chunk::kOtherFloats) * sizeof(float);
static_assert(2 * (kStreamedSmem + 1024) <= 233472, "two CTAs an SM");

__global__ void __launch_bounds__(kF32Threads, 2)
    flash_fwd_f32_streamed_kernel(const __grid_constant__ Params p) {
  using T = F32Chunk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + T::kTileFloats;
  float* v_s = k_s + T::kOtherFloats;
  float* p_s = q_s;  // P over Q's chunk, once S is done with it

  // the grid's fast axis: the batch-head's chunks of O's columns
  const int chunks = p.head_dim / kF32ChunkCols;
  const int bh = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;
  const int n_kv = (p.causal ? q0 + kF32Rows : p.seq) / T::kOther;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* q_rows = p.qkv[0] + at(p, 0, b, q0, h);

  float o[4][T::kOut];
  float m_run[4], l_run[4];  // m in log2 units; l this thread's share of the row sum
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m_run[ii] = kF32NegInf;
    l_run[ii] = 0.0f;
#pragma unroll
    for (int c = 0; c < T::kOut; ++c) o[ii][c] = 0.0f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * T::kOther;
    const float* k_rows = p.qkv[1] + at(p, 1, b, kv0, h);
    float s[4][T::kCols];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int jj = 0; jj < T::kCols; ++jj) s[ii][jj] = 0.0f;
    }
    // S over the head_dim, a 128-column chunk of Q and of K at a time
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();  // the previous chunk's (or tile's) products are done
      load_rows<kF32ChunkCols>(q_s, q_rows + c * kF32ChunkCols, kF32Rows, p.st[0][1]);
      load_rows<kF32ChunkCols>(k_s, k_rows + c * kF32ChunkCols, T::kOther, p.st[1][1]);
      if (c == 0) {
        load_rows<kF32ChunkCols>(v_s, p.qkv[2] + at(p, 2, b, kv0, h) + chunk * kF32ChunkCols,
                                 T::kOther, p.st[2][1]);
      }
      __syncthreads();
      add_scores<kF32ChunkCols>(s, q_s, k_s, ty, tx);
    }
    const bool crossing = p.causal && kv0 + T::kOther - 1 > q0;
    online_softmax<T>(s, o, m_run, l_run, crossing, q0, kv0, ty, tx, p.scale_log2);
    __syncthreads();  // every thread's S is done with Q's chunk
    put_scores<kF32ChunkCols>(p_s, s, ty, tx);
    __syncthreads();
    accumulate<kF32ChunkCols>(o, p_s, v_s, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const float l_safe = fmaxf(row_sum(l_run[ii]), 1e-30f);
    inv[ii] = 1.0f / l_safe;
    const int row = q0 + 4 * ty + ii;
    // every chunk computes the same (m, l): the first writes the logsumexp
    if (p.lse != nullptr && chunk == 0 && tx == 0) {
      p.lse[static_cast<int64_t>(bh) * p.seq + row] = m_run[ii] * kF32Ln2 + logf(l_safe);
    }
  }
  store_out<kF32ChunkCols>(p.o + at(p, 3, b, q0, h) + chunk * kF32ChunkCols, p.st[3][1], o, inv,
                           ty, tx);
}

// head_dims of the fixed tilings, and of the streamed one
bool fixed_width(int head_dim) { return head_dim == 64 || head_dim == 128 || head_dim == 256; }
bool streamed(int head_dim) { return head_dim >= 384 && head_dim % kF32ChunkCols == 0; }

template <int D>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Cfg<D>::kSmem));
}

template <int D>
void launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const dim3 grid(batch_heads, p.seq / kF32Rows);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, Cfg<D>::kSmem, stream>>>(p);
}

int put_config(const int (&values)[6], int* out, int n) {
  for (int i = 0; i < n && i < 6; ++i) out[i] = values[i];
  return 6;
}

template <int D>
int config_of(int* out, int n) {
  // one CTA a (batch-head, Q tile): its chunks, 1
  return put_config({kF32Threads, 1, Cfg<D>::kCtasPerSm, static_cast<int>(Cfg<D>::kSmem), 1,
                     F32Tiles<D>::kOther}, out, n);
}

}  // namespace

// C entries, bound with ctypes, as flash_attention.cu's: the same names and
// arguments, so ops/flash_attention.py drives either library alike.
//
// flash_attention_init opts the four instantiations (head_dim 64, 128, 256
// and the streamed one) in to the dynamic shared memory they need above the
// default 48 KB, once per device before the first launch (a launch may sit
// inside CUDA-graph capture).  Returns a cudaError_t.
extern "C" int flash_attention_init(int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = opt_in<64>();
  if (err == cudaSuccess) err = opt_in<128>();
  if (err == cudaSuccess) err = opt_in<256>();
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_f32_streamed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStreamedSmem));
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// The configuration at (head_dim, kv_split): threads, stages (one), CTAs an
// SM by launch bounds, dynamic shared memory in bytes, CTAs a (batch-head,
// Q tile) (chunks of O's columns) and K/V rows a tile; 0 values where there
// is no such instantiation (every head_dim has one CTA tiling, kv_split 1).
extern "C" int flash_attention_config(int head_dim, int kv_split, int* out, int n) {
  if (kv_split != 1) return 0;
  if (head_dim == 64) return config_of<64>(out, n);
  if (head_dim == 128) return config_of<128>(out, n);
  if (head_dim == 256) return config_of<256>(out, n);
  if (streamed(head_dim)) {
    return put_config({kF32Threads, 1, 2, static_cast<int>(kStreamedSmem),
                       head_dim / kF32ChunkCols, F32Chunk::kOther}, out, n);
  }
  return 0;
}

// `strides` holds 12 element strides: (batch, seq, head) for Q, K, V and O.
// `lse` may be null; `kv_split` must be 1; head_dim 64, 128, 256 or a
// multiple of 128 from 384 on (the streamed tiling).  `device` is the CUDA ordinal the
// pointers live on, initialised with flash_attention_init, and `stream` the
// caller's cudaStream_t.  Returns cudaGetLastError() after the launch:
// nonzero means the launch was refused and nothing ran.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const int64_t* strides, int kv_split,
                                   int batch, int heads, int seq, int head_dim, int causal,
                                   float scale, int device, void* stream) {
  if (kv_split != 1 || !(fixed_width(head_dim) || streamed(head_dim))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.qkv[0] = static_cast<const float*>(q);
  p.qkv[1] = static_cast<const float*>(k);
  p.qkv[2] = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  for (int t = 0; t < 4; ++t) {
    for (int a = 0; a < 3; ++a) p.st[t][a] = strides[3 * t + a];
  }
  p.heads = heads;
  p.seq = seq;
  p.scale_log2 = scale * kF32Log2e;
  p.causal = causal;
  p.head_dim = head_dim;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (streamed(head_dim)) {
    const dim3 grid(bh * (head_dim / kF32ChunkCols), seq / kF32Rows);
    flash_fwd_f32_streamed_kernel<<<grid, kF32Threads, kStreamedSmem, s>>>(p);
  } else if (head_dim == 256) {
    launch<256>(p, bh, s);
  } else if (head_dim == 128) {
    launch<128>(p, bh, s);
  } else {
    launch<64>(p, bh, s);
  }
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}
