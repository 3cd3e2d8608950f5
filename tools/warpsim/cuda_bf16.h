// Lockstep CPU simulator of the CUDA features the port's kernels use, so that
// their sources run on the CPU: tests/test_torch_kernel_sim.py compiles them
// with g++ against these files.  One host thread stands for each CUDA thread
// of a block; every warp-collective operation (ldmatrix, mma, shuffle) meets
// at a barrier of its warp, every warpgroup one (wgmma) at a barrier of its
// warpgroup, __syncthreads at a barrier of the block; mbarriers are shared
// state under a lock.  Blocks run one after another, so shared memory is one
// buffer.
//
// This header stands in for <cuda_bf16.h> and carries the rest of the
// device environment: the qualifiers, threadIdx/blockIdx/gridDim, bf16 with
// round-to-nearest-even, and the checks the hardware makes on shared-memory
// addresses (16-byte alignment, inside the block's dynamic allocation).
#pragma once
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <stddef.h>
#include <unordered_map>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 a, b; };

inline uint16_t sim_f2bf(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}
inline float sim_bf2f(uint16_t h) {
  const uint32_t u = uint32_t(h) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {{sim_f2bf(a)}, {sim_f2bf(b)}};
}

struct uint3 { unsigned x, y, z; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

extern thread_local uint3 threadIdx, blockIdx;
extern dim3 gridDim;
// the block's dynamic shared memory (the kernels' `extern __shared__` array)
alignas(1024) extern unsigned char smem_raw[];

// an mbarrier (hopper_ptx.cuh): arrivals still due in the current phase and
// the phase's parity, the transaction bytes still due, the block that set it
struct SimMbar {
  int count, pending;
  int64_t tx;
  unsigned parity, block;
};
// one thread's wgmma operands, held against its warpgroup's
struct SimWgmma {
  uint64_t a, b;
  int scale_d;
};

struct Sim {
  std::barrier<>* block;
  std::barrier<>* warps[32];
  std::barrier<>* warpgroups[8];
  size_t smem_bytes;
  const void* addr[32][32];
  uint32_t a[32][32][4], b[32][32][2];
  float x[32][32];
  SimWgmma wgmma[8][128];
  // mbarriers by shared address, and the block that runs (blocks run in turn)
  std::mutex mbar_lock;
  std::condition_variable mbar_moved;
  std::unordered_map<uint32_t, SimMbar> mbars;
  unsigned block_serial;
};
extern Sim sim;

inline int sim_lane() { return threadIdx.x % 32; }
inline int sim_warp() { return threadIdx.x / 32; }
inline void sim_warp_sync() { sim.warps[sim_warp()]->arrive_and_wait(); }
inline void __syncthreads() { sim.block->arrive_and_wait(); }
inline int min(int a, int b) { return a < b ? a : b; }

[[noreturn]] inline void sim_fail(const char* what, const void* p) {
  std::fprintf(stderr, "warpsim: %s at %p (block %u,%u thread %u)\n", what, p, blockIdx.x,
               blockIdx.y, threadIdx.x);
  std::abort();
}
// a 16-byte access at p must be aligned and inside the block's shared memory
inline void sim_check_smem(const void* p) {
  const auto* c = static_cast<const unsigned char*>(p);
  if (reinterpret_cast<uintptr_t>(p) % 16) sim_fail("misaligned shared-memory access", p);
  if (c < smem_raw || c + 16 > smem_raw + sim.smem_bytes) sim_fail("shared memory out of bounds", p);
}

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  sim.x[sim_warp()][sim_lane()] = v;
  sim_warp_sync();
  const float r = sim.x[sim_warp()][sim_lane() ^ mask];
  sim_warp_sync();
  return r;
}
