// The simulator's version of the GEMM's hopper_ptx.cuh (the PTX layer under
// ops/csrc/matmul.cu, which the simulation compiles as it is).
//
// - A shared address is the offset into the block's shared memory.
// - An mbarrier is shared state under one lock: a phase completes when its
//   arrivals and its transaction bytes are all in, and a wait blocks until
//   the phase of the parity it names has completed (the PTX ISA's
//   try_wait.parity).  A wait that lasts 20 s fails as a deadlock.
// - A TMA load copies its box at once, zero where the box leaves the tensor,
//   into shared memory under the 128-byte swizzle, and completes its bytes
//   on the barrier.
// - wgmma meets at the warpgroup's barrier, checks that all 128 threads
//   issue the same operands, and computes at once: each thread reads the
//   operands through the matrix descriptors (start address, leading and
//   stride byte offsets, the 128-byte swizzle) in the PTX ISA's canonical
//   layouts and sums into the accumulators the PTX ISA assigns it; the
//   threads meet again when all have read.  So commit and wait have nothing
//   to wait for, and setmaxnreg does nothing.
//
// The 128-byte swizzle, on TMA's writes and wgmma's reads alike, is a
// function of the shared address: bits 4-6 (the 16-byte chunk of a 128-byte
// row) XOR bits 7-9 (the row within a 1024-byte atom).
#pragma once
#include <chrono>

#include "cuda.h"
#include "cuda_bf16.h"

namespace {

inline uint32_t smem_u32(const void* p) {
  const auto* c = static_cast<const unsigned char*>(p);
  if (c < smem_raw || c >= smem_raw + sim.smem_bytes) sim_fail("not a shared-memory address", p);
  return static_cast<uint32_t>(c - smem_raw);
}

inline uint32_t sim_swizzle128(uint32_t addr) { return addr ^ (((addr >> 7) & 7u) << 4); }

// ---- mbarrier

inline SimMbar& sim_mbar(uint64_t* bar) {  // under sim.mbar_lock
  const uint32_t at = smem_u32(bar);
  if (at % 8) sim_fail("misaligned mbarrier", bar);
  auto it = sim.mbars.find(at);
  if (it == sim.mbars.end() || it->second.block != sim.block_serial) {
    sim_fail("mbarrier used before its init in this block", bar);
  }
  return it->second;
}

inline void sim_mbar_settle(SimMbar& m, uint64_t* bar) {
  if (m.pending < 0) sim_fail("mbarrier: more arrivals than its count in one phase", bar);
  if (m.pending == 0 && m.tx == 0) {
    m.parity ^= 1;
    m.pending = m.count;
    sim.mbar_moved.notify_all();
  }
}

inline void mbar_init(uint64_t* bar, uint32_t arrivals) {
  std::lock_guard<std::mutex> hold(sim.mbar_lock);
  const uint32_t at = smem_u32(bar);
  if (at % 8) sim_fail("misaligned mbarrier", bar);
  sim.mbars[at] = {static_cast<int>(arrivals), static_cast<int>(arrivals), 0, 0, sim.block_serial};
}

inline void mbar_fence_init() {}

inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> hold(sim.mbar_lock);
  SimMbar& m = sim_mbar(bar);
  --m.pending;
  sim_mbar_settle(m, bar);
}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> hold(sim.mbar_lock);
  SimMbar& m = sim_mbar(bar);
  m.tx += bytes;
  --m.pending;
  sim_mbar_settle(m, bar);
}

inline void sim_mbar_complete_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> hold(sim.mbar_lock);
  SimMbar& m = sim_mbar(bar);
  m.tx -= bytes;
  sim_mbar_settle(m, bar);
}

inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  std::lock_guard<std::mutex> hold(sim.mbar_lock);
  return sim_mbar(bar).parity != (parity & 1u);
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> hold(sim.mbar_lock);
  SimMbar& m = sim_mbar(bar);
  if (!sim.mbar_moved.wait_for(hold, std::chrono::seconds(20),
                               [&] { return m.parity != (parity & 1u); })) {
    sim_fail("mbarrier wait lasted 20 s: deadlock", bar);
  }
}

// ---- TMA

inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int inner, int outer) {
  if (!map->encoded) sim_fail("TMA load through a tensor map never encoded", map);
  const uint32_t at = smem_u32(dst);
  const bool swizzled = map->swizzle == CU_TENSOR_MAP_SWIZZLE_128B;
  if (at % (swizzled ? 1024 : 128)) sim_fail("TMA destination misaligned for its swizzle", dst);
  const uint32_t row_bytes = map->box[0] * 2, bytes = row_bytes * map->box[1];
  if (at + bytes > sim.smem_bytes) sim_fail("TMA box outside shared memory", dst);
  for (uint32_t r = 0; r < map->box[1]; ++r) {
    for (uint32_t c = 0; c < map->box[0]; ++c) {
      const int64_t x = static_cast<int64_t>(inner) + c, y = static_cast<int64_t>(outer) + r;
      uint16_t v = 0;
      if (x >= 0 && y >= 0 && x < static_cast<int64_t>(map->dims[0]) &&
          y < static_cast<int64_t>(map->dims[1])) {
        std::memcpy(&v, map->base + y * map->stride + x * 2, 2);
      }
      const uint32_t to = at + r * row_bytes + c * 2;
      std::memcpy(smem_raw + (swizzled ? sim_swizzle128(to) : to), &v, 2);
    }
  }
  sim_mbar_complete_tx(bar, bytes);  // the whole box, filled or not
}

// ---- wgmma

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
inline void wgmma_fence_operands(float (&)[128]) {}

struct SimDesc {
  uint32_t start, lbo, sbo;
};

inline SimDesc sim_desc(uint64_t d) {
  if ((d >> 62) != 1) {
    sim_fail("wgmma descriptor: the simulator takes the 128-byte swizzle", nullptr);
  }
  if ((d >> 49) & 7) sim_fail("wgmma descriptor: nonzero base offset", nullptr);
  return {static_cast<uint32_t>(d & 0x3FFF) << 4, static_cast<uint32_t>((d >> 16) & 0x3FFF) << 4,
          static_cast<uint32_t>((d >> 32) & 0x3FFF) << 4};
}

inline float sim_operand(uint32_t addr) {
  const uint32_t at = sim_swizzle128(addr);
  if (at + 2 > sim.smem_bytes) sim_fail("wgmma operand outside shared memory", smem_raw + at);
  uint16_t h;
  std::memcpy(&h, smem_raw + at, 2);
  return sim_bf2f(h);
}

// K-major under the 128-byte swizzle: row r of the tile is 128 bytes of K at
// (r % 8) * 128, 8-row groups the stride byte offset apart; an instruction's
// 16 K values (32 bytes) lie inside one row, so the leading offset is unused
inline uint32_t sim_k_major(const SimDesc& d, int row, int k) {
  return d.start + (row % 8) * 128 + (row / 8) * d.sbo + k * 2;
}

// MN-major under the 128-byte swizzle: 64 elements of M or N make a 128-byte
// row, K rows follow at 128 bytes; 64-element blocks of M or N lie the
// leading byte offset apart, 8-row groups of K the stride byte offset apart
inline uint32_t sim_mn_major(const SimDesc& d, int mn, int k) {
  return d.start + (mn % 64) * 2 + (mn / 64) * d.lbo + (k % 8) * 128 + (k / 8) * d.sbo;
}

inline void wgmma_m64n256k16_bf16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                  int scale_d) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  sim.wgmma[wg][t] = {desc_a, desc_b, scale_d != 0};
  sim.warpgroups[wg]->arrive_and_wait();
  const SimWgmma first = sim.wgmma[wg][0];
  sim.warpgroups[wg]->arrive_and_wait();
  if (first.a != desc_a || first.b != desc_b || first.scale_d != (scale_d != 0)) {
    sim_fail("wgmma operands differ across the warpgroup", nullptr);
  }
  const SimDesc a = sim_desc(desc_a), b = sim_desc(desc_b);
  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
  float arow[2][16];  // this thread's rows 16 warp + g and + 8 of A
  for (int h = 0; h < 2; ++h) {
    for (int k = 0; k < 16; ++k) arow[h][k] = sim_operand(sim_k_major(a, 16 * warp + g + 8 * h, k));
  }
  for (int j = 0; j < 32; ++j) {
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * q + e % 2;
      float acc = scale_d ? d[4 * j + e] : 0.0f;
      for (int k = 0; k < 16; ++k) acc += arow[e / 2][k] * sim_operand(sim_mn_major(b, col, k));
      d[4 * j + e] = acc;
    }
  }
  // the product is one operation of the warpgroup: no thread goes on (and
  // releases its stage) before every thread has read its operands
  sim.warpgroups[wg]->arrive_and_wait();
}

// ---- setmaxnreg

template <int N>
inline void setmaxnreg_dec() {}
template <int N>
inline void setmaxnreg_inc() {}

}  // namespace
