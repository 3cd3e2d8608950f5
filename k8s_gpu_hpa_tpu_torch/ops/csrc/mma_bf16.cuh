// Warp-level building blocks of the flash-attention backward kernels
// (flash_attention_bwd.cu): the PTX-level
// copies, fragment loads and mma.sync of mma_ptx.cuh, and the packing of
// fp32 accumulators into bf16 operands.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A, 16x16 row-major, 4 registers of two bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, cols 2t..), a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..);
//   B, 16x8 column-major, 2 registers: b0 (k rows 2t.., col g), b1 (k rows 2t+8.., col g);
//   C/D, 16x8 fp32: d0, d1 (row g, cols 2t, 2t+1), d2, d3 (row g+8, cols 2t, 2t+1).
// So two neighbouring 16x8 accumulators, packed to bf16, are the A fragment
// of the next product with no shuffle.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 bf16 operand from two 16x8 fp32 accumulators
// (columns 0-7 and 8-15), rounded to nearest.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace
