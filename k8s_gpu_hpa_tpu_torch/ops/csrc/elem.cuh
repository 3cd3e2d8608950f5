// The element type of the wgmma kernels (matmul.cu, flash_attention.cu,
// flash_attention_bwd.cu): bf16, or f16 where the build defines ELEM_F16.
// Each source is compiled once for each type into a library of its own
// (ops/matmul.py and ops/flash_attention.py build both), so the two builds
// run in parallel and their kernels keep one name.  The two types have one
// size, so tiles, rings, the 128-byte swizzle (64 elements a row), shared
// memory and registers are the same in both; what differs is named here:
// the wgmma type (hopper_ptx.cuh reads ELEM_PTX), the TMA data type, and
// the conversions from fp32, each rounding to nearest even, subnormals kept
// (f16's narrower exponent sends small P and dS there, where bf16 keeps
// them normal; the plain versions' .to(dtype) rounds the same way).
// Compiled as it is by the CPU simulator (tools/warpsim), whose cuda_bf16.h
// and cuda_fp16.h supply the types and conversions.

#pragma once

#include <cuda.h>
#include <stdint.h>

#if defined(ELEM_F16)
#include <cuda_fp16.h>
#define ELEM_PTX "f16"
#else
#include <cuda_bf16.h>
#define ELEM_PTX "bf16"
#endif

namespace {

#if defined(ELEM_F16)
using Elem = __half;
using Elem2 = __half2;
constexpr CUtensorMapDataType kElemTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
__device__ __forceinline__ Elem2 to_elem2(float lo, float hi) { return __floats2half2_rn(lo, hi); }
#else
using Elem = __nv_bfloat16;
using Elem2 = __nv_bfloat162;
constexpr CUtensorMapDataType kElemTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
__device__ __forceinline__ Elem2 to_elem2(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}
#endif

static_assert(sizeof(Elem) == 2, "a 2-byte element");

// two floats rounded to an element pair, the first in the lower half: an A
// fragment register of a wgmma with A from registers
__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  Elem2 v = to_elem2(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// fp32 accumulators of N columns (the wgmma layout: element 4 j + e is
// 8-column block j) to Elem pairs, the A fragments of a product with A from
// registers: columns 16 kc .. 16 kc + 15 are blocks 2 kc and 2 kc + 1
template <int N>
__device__ __forceinline__ void pack(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    a[kc][0] = pack_pair(x[8 * kc + 0], x[8 * kc + 1]);
    a[kc][1] = pack_pair(x[8 * kc + 2], x[8 * kc + 3]);
    a[kc][2] = pack_pair(x[8 * kc + 4], x[8 * kc + 5]);
    a[kc][3] = pack_pair(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// two floats rounded and stored at `dst` (4-byte aligned), the first lower
__device__ __forceinline__ void store_pair(Elem* dst, float lo, float hi) {
  *reinterpret_cast<Elem2*>(dst) = to_elem2(lo, hi);
}

}  // namespace
