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

namespace {

constexpr int kBox = 64;      // a bf16 box's columns: one 128-byte swizzle row
constexpr int kBoxRows = 64;  // a box's rows: one tile of Q, K, V or dO

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

// a [b, s, h, d] bf16 tensor with element strides (sb, ss, sh, 1), read in
// 64 x 64 boxes of (d, s) under the 128-byte swizzle; out of bounds reads
// zero
CUresult encode_bshd(CUtensorMap* map, const void* base, int batch, int seq, int heads, int d,
                     const int64_t* strides) {
  // a head stride never stepped (one head) may be anything legal
  const int64_t sh = heads == 1 ? d : strides[2];
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(sh) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {kBox, 1, kBoxRows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return g_encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, bytes,
                  box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// a contiguous [rows, seq] fp32 tensor, read in boxes of 64 values of one
// row, unswizzled
CUresult encode_rows_f32(CUtensorMap* map, const float* base, int rows, int seq) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(rows)};
  const cuuint64_t bytes[1] = {static_cast<cuuint64_t>(seq) * sizeof(float)};
  const cuuint32_t box[2] = {kBoxRows, 1};
  const cuuint32_t steps[2] = {1, 1};
  return g_encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, bytes,
                  box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
