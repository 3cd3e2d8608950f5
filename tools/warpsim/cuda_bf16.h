// Lockstep CPU simulator of the CUDA features the port's kernels use, so that
// their sources run on the CPU: tests/test_torch_kernel_sim.py compiles them
// with g++ against these files.  One host thread stands for each CUDA thread
// of a block; every warp-collective operation (a shuffle) meets at a barrier
// of its warp, every warpgroup one (wgmma) at a barrier of its warpgroup,
// __syncthreads at a barrier of the block; mbarriers are shared state under
// a lock.  Clusters run one after another, the CTAs of a cluster at once
// (a launch without one is a cluster of one CTA), each CTA with its own
// shared memory and barriers (SimCta); a cluster barrier, and loads from a
// peer's shared memory, are hopper_ptx.cuh's.
//
// This header stands in for <cuda_bf16.h> and carries the rest of the
// device environment: the qualifiers, threadIdx/blockIdx/gridDim, float2,
// float4, and bf16 with round-to-nearest-even (cuda_fp16.h adds f16).
#pragma once
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <memory>
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
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

extern thread_local uint3 threadIdx, blockIdx;
extern dim3 gridDim;
// the CTA's dynamic shared memory (the kernels' `extern __shared__` array,
// which the tests' rewrite of a source takes out): each thread points at
// its own CTA's
extern thread_local unsigned char* smem_raw;

// an mbarrier (hopper_ptx.cuh): arrivals still due in the current phase and
// the phase's parity, the transaction bytes still due
struct SimMbar {
  int count, pending;
  int64_t tx;
  unsigned parity;
};
// one thread's wgmma operands, held against its warpgroup's
struct SimWgmma {
  uint64_t a, b;
  int scale_d;
};

// one CTA: its barriers, a shuffle's values, its wgmma operands, its
// shared memory, and its serial number, which keys its mbarriers
struct SimCta {
  std::barrier<>* block;
  std::barrier<>* warps[32];
  std::barrier<>* warpgroups[8];
  float x[32][32];  // a shuffle's values, by warp and lane
  SimWgmma wgmma[8][128];
  uint32_t wgmma_a[8][128][4];  // A's registers of a wgmma that takes them
  unsigned char* smem;
  unsigned serial;
};
// the CTA of the calling thread
extern thread_local SimCta* sim_cta;

// the cluster that runs (clusters run in turn): for each CTA its shared
// memory as it stood when the last cluster barrier completed (`seen`, what
// a peer's load reads), and for each 16 bytes of it the cluster barriers
// its last reader had passed, plus one (`read`, 0: never read); the
// barriers each CTA had passed when it exited
constexpr int kSimMaxCluster = 8;
struct SimCluster {
  unsigned size = 1, threads = 0;
  unsigned char* live[kSimMaxCluster];
  std::unique_ptr<unsigned char[]> seen[kSimMaxCluster];
  std::unique_ptr<std::atomic<uint32_t>[]> read[kSimMaxCluster];
  unsigned exited[kSimMaxCluster];
  // the barrier: arrivals in the current phase, phases completed
  std::mutex lock;
  std::condition_variable moved;
  unsigned arrivals = 0, phases = 0;
  // a fault of the exchange was found (its message printed): the launch
  // runs on, and cudaGetLastError reports a launch failure
  bool faulted = false;
};

struct Sim {
  size_t smem_bytes;
  // mbarriers by (CTA serial, shared address)
  std::mutex mbar_lock;
  std::condition_variable mbar_moved;
  std::unordered_map<uint64_t, SimMbar> mbars;
  SimCluster cluster;
};
extern Sim sim;
// the cluster barriers this thread has passed, and whether it has arrived
// at the next without waiting yet
extern thread_local unsigned sim_passed;
extern thread_local bool sim_arrived;

inline int sim_lane() { return threadIdx.x % 32; }
inline int sim_warp() { return threadIdx.x / 32; }
inline void sim_warp_sync() { sim_cta->warps[sim_warp()]->arrive_and_wait(); }
inline void __syncthreads() { sim_cta->block->arrive_and_wait(); }
inline int min(int a, int b) { return a < b ? a : b; }

[[noreturn]] inline void sim_fail(const char* what, const void* p) {
  std::fprintf(stderr, "warpsim: %s at %p (block %u,%u thread %u)\n", what, p, blockIdx.x,
               blockIdx.y, threadIdx.x);
  std::abort();
}

inline int __shfl_sync(unsigned, int v, int src) {
  sim_cta->x[sim_warp()][sim_lane()] = static_cast<float>(v);
  sim_warp_sync();
  const int r = static_cast<int>(sim_cta->x[sim_warp()][src]);
  sim_warp_sync();
  return r;
}

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  sim_cta->x[sim_warp()][sim_lane()] = v;
  sim_warp_sync();
  const float r = sim_cta->x[sim_warp()][sim_lane() ^ mask];
  sim_warp_sync();
  return r;
}
