// wgmma's shared-memory matrix descriptor, shared by the Hopper kernels
// (matmul.cu, flash_attention.cu, flash_attention_bwd.cu).  Only bit packing over hopper_ptx.cuh's
// smem_u32, so the CPU simulator (tools/warpsim) compiles it as it is and
// decodes what it packs.
//
// Every operand these kernels hand to wgmma lies in shared memory under the
// 128-byte swizzle, as TMA wrote it: rows of 128 bytes (64 bf16), the
// pattern repeating every 8 rows (1024 bytes, the swizzle atom), each tile
// aligned to the atom.

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kSwizzleRow = 128;               // bytes
constexpr uint32_t kSwizzleAtom = 8 * kSwizzleRow;  // the pattern repeats every 1024 bytes

// The descriptor (PTX ISA, "Matrix Descriptor"): the start address, the
// leading and the stride byte offsets, each in units of 16 bytes, and the
// layout (1: the 128-byte swizzle).  Base offset 0: tiles are aligned to the
// swizzle atom.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// A K-major operand (K contiguous): row r of the tile is 128 bytes of K,
// 8-row groups one swizzle atom apart (stride byte offset); the leading
// offset is unused with the swizzle, as one instruction's K (16 bf16, 32
// bytes) stays inside a row.  `tile` points at the instruction's first K
// column: step kk of a 64-column box starts 32 kk bytes along the row.
__device__ __forceinline__ uint64_t desc_k_major(const unsigned char* tile) {
  return smem_desc(tile, 1 << 4, kSwizzleAtom);
}

// An MN-major operand (M or N contiguous), read with wgmma's transpose bit:
// each 64-column box of M or N is K rows of 128 bytes; the boxes lie `box`
// bytes apart (leading byte offset), 8-row groups of K one swizzle atom
// apart (stride byte offset).  `tile` points at the instruction's first K
// row: step kk starts 16 kk rows further down.
__device__ __forceinline__ uint64_t desc_mn_major(const unsigned char* tile, uint32_t box) {
  return smem_desc(tile, box, kSwizzleAtom);
}

}  // namespace
