// TMA tensor maps of the flash-attention kernels (flash_attention.cu, the
// forward, and flash_attention_bwd.cu, the backward), encoded on the host
// at each launch with the CUDA driver API's cuTensorMapEncodeTiled.  The
// entry point is looked up once per process through the runtime's
// cudaGetDriverEntryPointByVersion, so nothing new is linked.  The encoder
// needs the device's context current in the calling thread: call
// cudaSetDevice first.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kBox = 64;      // an Elem box's columns: one 128-byte swizzle row
constexpr int kBoxRows = 64;  // a box's rows: one tile of Q, K, V or dO

// the rows of a streamed tile (K/V in the forward and dQ, Q/dO in dK/dV):
// 64, and 32 at head_dim 384 and 512, where a 64-row ring does not fit
// shared memory beside the CTA's own 64-row tiles (from 640 on the streamed
// tilings hold no whole row, and stream 64-row chunks of every tensor)
constexpr int stream_rows(int head_dim) {
  return head_dim > 256 && head_dim <= 512 ? 32 : kBoxRows;
}

PFN_cuTensorMapEncodeTiled g_encode = nullptr;

// Looks up cuTensorMapEncodeTiled, once.
cudaError_t find_encode() {
  if (g_encode != nullptr) return cudaSuccess;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  // the entry point's CUDA 12.0 signature, which <cudaTypedefs.h> names
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
  if (err == cudaSuccess && found != cudaDriverEntryPointSuccess) err = cudaErrorSymbolNotFound;
  if (err == cudaSuccess) g_encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  return err;
}

// a [b, s, h, d] Elem tensor with element strides (sb, ss, sh, 1), read in
// boxes of 64 (d) x `rows` (s) under the 128-byte swizzle; out of bounds
// reads zero
CUresult encode_bshd(CUtensorMap* map, const void* base, int batch, int seq, int heads, int d,
                     const int64_t* strides, int rows = kBoxRows) {
  // a head stride never stepped (one head) may be anything legal
  const int64_t sh = heads == 1 ? d : strides[2];
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(sh) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return g_encode(map, kElemTma, 4, const_cast<void*>(base), dims, bytes,
                  box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// a contiguous [rows, seq] fp32 tensor, read in boxes of `box` values of
// one row, unswizzled
CUresult encode_rows_f32(CUtensorMap* map, const float* base, int rows, int seq,
                         int box = kBoxRows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(rows)};
  const cuuint64_t bytes[1] = {static_cast<cuuint64_t>(seq) * sizeof(float)};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t steps[2] = {1, 1};
  return g_encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, bytes,
                  boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
