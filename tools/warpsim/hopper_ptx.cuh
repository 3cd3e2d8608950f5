// The simulator's version of hopper_ptx.cuh (the PTX layer under
// ops/csrc/matmul.cu, ops/csrc/flash_attention.cu,
// ops/csrc/flash_attention_bwd.cu and ops/csrc/flash_attention_bwd_f32.cu,
// which the simulation compiles as they are).
//
// - A shared address is the offset into the CTA's shared memory.
// - An mbarrier is shared state under one lock: a phase completes when its
//   arrivals and its transaction bytes are all in, and a wait blocks until
//   the phase of the parity it names has completed (the PTX ISA's
//   try_wait.parity).  A wait that lasts 20 s fails as a deadlock.
// - A TMA load copies its box of bf16, f16 or fp32 at once, zero wherever one of
//   its coordinates leaves the tensor's extent in that dimension, into
//   shared memory under the 128-byte swizzle or none, as its tensor map
//   says, and completes its bytes on the barrier.
// - A cluster barrier completes when every thread of the cluster has
//   arrived; a wait that lasts 20 s fails as a deadlock.  A load from a
//   peer's shared memory (ld.shared::cluster, at an address mapa made) is
//   bounds-checked against the peer's shared memory and reads it as it
//   stood when the last cluster barrier completed (fresh shared memory
//   holds 0xff bytes), so a load before the barrier that should order it
//   reads stale bytes.  Two faults of the exchange are reported, and the
//   launch runs on to its end and then fails (cudaGetLastError): a CTA
//   that rewrote 16 bytes a peer loaded since the barrier before (found
//   when the next barrier completes), and a CTA that exited before a
//   barrier that its last peer load precedes (found at the cluster's end).
//   A load between a thread's arrive and its wait fails at once (the
//   hardware allows it; the kernels here do not need it).
// - wgmma meets at the warpgroup's barrier, checks that all 128 threads
//   issue the same operands, and computes at once: each thread reads the
//   operands through the matrix descriptors (start address, leading and
//   stride byte offsets, the 128-byte swizzle) in the PTX ISA's canonical
//   layouts, or A from the 128 threads' registers in the PTX ISA's fragment
//   layout, and sums into the accumulators the PTX ISA assigns it; the
//   threads meet again when all have read.  So commit and wait have nothing
//   to wait for, and setmaxnreg does nothing.
//
// The 128-byte swizzle, on TMA's writes and wgmma's reads alike, is a
// function of the shared address: bits 4-6 (the 16-byte chunk of a 128-byte
// row) XOR bits 7-9 (the row within a 1024-byte atom).
#pragma once
#include <algorithm>
#include <chrono>

#include "cuda.h"
#include "cuda_bf16.h"
#include "elem.cuh"

namespace {

inline uint32_t smem_u32(const void* p) {
  const auto* c = static_cast<const unsigned char*>(p);
  if (c < smem_raw || c >= smem_raw + sim.smem_bytes) sim_fail("not a shared-memory address", p);
  return static_cast<uint32_t>(c - smem_raw);
}

inline uint32_t sim_swizzle128(uint32_t addr) { return addr ^ (((addr >> 7) & 7u) << 4); }

// ---- mbarrier

// an mbarrier's key: its CTA's serial number and its shared address
inline uint64_t sim_mbar_key(uint64_t* bar) {
  const uint32_t at = smem_u32(bar);
  if (at % 8) sim_fail("misaligned mbarrier", bar);
  return static_cast<uint64_t>(sim_cta->serial) << 32 | at;
}

inline SimMbar& sim_mbar(uint64_t* bar) {  // under sim.mbar_lock
  auto it = sim.mbars.find(sim_mbar_key(bar));
  if (it == sim.mbars.end()) sim_fail("mbarrier used before its init in this block", bar);
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
  sim.mbars[sim_mbar_key(bar)] = {static_cast<int>(arrivals), static_cast<int>(arrivals), 0, 0};
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

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> hold(sim.mbar_lock);
  SimMbar& m = sim_mbar(bar);
  if (!sim.mbar_moved.wait_for(hold, std::chrono::seconds(20),
                               [&] { return m.parity != (parity & 1u); })) {
    sim_fail("mbarrier wait lasted 20 s: deadlock", bar);
  }
}

// ---- TMA

// box element (i0, i1, ...) innermost first lands at row-major offset
// ((.. i2) * box1 + i1) * box0 + i0 of the destination
inline void sim_tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, const int* coord,
                         uint32_t rank) {
  if (!map->encoded) sim_fail("TMA load through a tensor map never encoded", map);
  if (rank != map->rank) sim_fail("TMA load of another rank than its tensor map's", map);
  const uint32_t at = smem_u32(dst);
  const bool swizzled = map->swizzle == CU_TENSOR_MAP_SWIZZLE_128B;
  if (at % (swizzled ? 1024 : 128)) sim_fail("TMA destination misaligned for its swizzle", dst);
  uint32_t elems = 1;
  for (uint32_t i = 0; i < rank; ++i) elems *= map->box[i];
  const uint32_t bytes = elems * map->elem;
  if (at + bytes > sim.smem_bytes) sim_fail("TMA box outside shared memory", dst);
  for (uint32_t n = 0; n < elems; ++n) {
    uint32_t rest = n;
    bool inside = true;
    int64_t from = 0;
    for (uint32_t i = 0; i < rank; ++i) {
      const int64_t x = static_cast<int64_t>(coord[i]) + rest % map->box[i];
      rest /= map->box[i];
      inside = inside && x >= 0 && x < static_cast<int64_t>(map->dims[i]);
      from += x * static_cast<int64_t>(map->strides[i]);
    }
    uint32_t v = 0;
    if (inside) std::memcpy(&v, map->base + from, map->elem);
    const uint32_t to = at + n * map->elem;
    std::memcpy(smem_raw + (swizzled ? sim_swizzle128(to) : to), &v, map->elem);
  }
  sim_mbar_complete_tx(bar, bytes);  // the whole box, filled or not
}

inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int inner, int outer) {
  const int coord[2] = {inner, outer};
  sim_tma_load(dst, map, bar, coord, 2);
}

inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                        int c3) {
  const int coord[4] = {c0, c1, c2, c3};
  sim_tma_load(dst, map, bar, coord, 4);
}

// ---- wgmma

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
template <int N>
inline void wgmma_fence_operands(float (&)[N]) {}
template <int N>
inline void wgmma_fence_operands(uint32_t (&)[N][4]) {}

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

// an operand's 16 bits as the type the build's wgmma reads (elem.cuh)
inline float sim_elem2f(uint16_t h) {
#if defined(ELEM_F16)
  return sim_h2f(h);
#else
  return sim_bf2f(h);
#endif
}

inline float sim_operand(uint32_t addr) {
  const uint32_t at = sim_swizzle128(addr);
  if (at + 2 > sim.smem_bytes) sim_fail("wgmma operand outside shared memory", smem_raw + at);
  uint16_t h;
  std::memcpy(&h, smem_raw + at, 2);
  return sim_elem2f(h);
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

// d = A B (+ d) for a 64xNx16 tile.  A comes through `desc_a` (K-major in
// shared memory) or, with `a_regs`, from the warpgroup's registers in the
// m16n8k16 fragment layout; B through `desc_b`, N-major (`b_n_major`, the
// transpose bit) or K-major.
template <int N>
inline void sim_wgmma(float (&d)[N / 2], uint64_t desc_a, const uint32_t* a_regs,
                      uint64_t desc_b, bool b_n_major, int scale_d) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  sim_cta->wgmma[wg][t] = {desc_a, desc_b, scale_d != 0};
  if (a_regs) std::memcpy(sim_cta->wgmma_a[wg][t], a_regs, sizeof(sim_cta->wgmma_a[wg][t]));
  sim_cta->warpgroups[wg]->arrive_and_wait();
  const SimWgmma first = sim_cta->wgmma[wg][0];
  if (first.a != desc_a || first.b != desc_b || first.scale_d != (scale_d != 0)) {
    sim_fail("wgmma operands differ across the warpgroup", nullptr);
  }
  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
  float arow[2][16];  // this thread's rows 16 warp + g and + 8 of A
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + g + 8 * h;
    for (int k = 0; k < 16; ++k) {
      if (a_regs) {
        // row r, column k sits with thread 32 (r / 16) + 4 (r % 8) + (k % 8) / 2,
        // in register (r % 16) / 8 + 2 (k / 8), half k % 2
        const uint32_t reg =
            sim_cta->wgmma_a[wg][32 * (row / 16) + 4 * (row % 8) + (k % 8) / 2][(row % 16) / 8 + 2 * (k / 8)];
        arow[h][k] = sim_elem2f(static_cast<uint16_t>(k % 2 ? reg >> 16 : reg & 0xffffu));
      } else {
        arow[h][k] = sim_operand(sim_k_major(sim_desc(desc_a), row, k));
      }
    }
  }
  const SimDesc b = sim_desc(desc_b);
  for (int j = 0; j < N / 8; ++j) {
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * q + e % 2;
      float acc = scale_d ? d[4 * j + e] : 0.0f;
      for (int k = 0; k < 16; ++k) {
        const uint32_t at = b_n_major ? sim_mn_major(b, col, k) : sim_k_major(b, col, k);
        acc += arow[e / 2][k] * sim_operand(at);
      }
      d[4 * j + e] = acc;
    }
  }
  // the product is one operation of the warpgroup: no thread goes on (and
  // releases its stage, or rewrites A's registers) before every thread has
  // read its operands
  sim_cta->warpgroups[wg]->arrive_and_wait();
}

inline void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                  int scale_d) {
  sim_wgmma<256>(d, desc_a, nullptr, desc_b, true, scale_d);
}

inline void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                    int scale_d) {
  sim_wgmma<64>(d, desc_a, nullptr, desc_b, false, scale_d);
}

inline void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                    int scale_d) {
  sim_wgmma<32>(d, desc_a, nullptr, desc_b, false, scale_d);
}

inline void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                    int scale_d) {
  sim_wgmma<64>(d, 0, a, desc_b, true, scale_d);
}

inline void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                     int scale_d) {
  sim_wgmma<128>(d, 0, a, desc_b, true, scale_d);
}

// ---- clusters
//
// A shared::cluster address is the CTA's rank times kSimRankStride plus the
// offset into its shared memory.

constexpr uint32_t kSimRankStride = 1u << 20;

inline const void* sim_addr(uint32_t addr) {
  return reinterpret_cast<const void*>(static_cast<uintptr_t>(addr));
}

inline uint32_t cluster_ctarank() { return blockIdx.x % sim.cluster.size; }

// under sim.cluster.lock, once every thread of the cluster has arrived: no
// CTA may have rewritten what a peer loaded since the barrier before; then
// what the peers' loads read becomes each CTA's shared memory as it stands
inline void sim_cluster_complete() {
  SimCluster& c = sim.cluster;
  for (unsigned r = 0; r < c.size; ++r) {
    for (size_t u = 0; u < sim.smem_bytes / 16 && !c.faulted; ++u) {
      if (c.read[r][u].load(std::memory_order_relaxed) == c.phases + 1 &&
          std::memcmp(c.live[r] + 16 * u, c.seen[r].get() + 16 * u, 16) != 0) {
        std::fprintf(stderr, "warpsim: CTA rank %u rewrote bytes %zu-%zu of its shared memory "
                     "that a peer loaded before the next cluster barrier\n", r, 16 * u,
                     16 * u + 15);
        c.faulted = true;
      }
    }
    std::memcpy(c.seen[r].get(), c.live[r], sim.smem_bytes);
  }
}

inline void cluster_arrive() {
  SimCluster& c = sim.cluster;
  if (sim_arrived) sim_fail("barrier.cluster.arrive twice without a wait", nullptr);
  std::lock_guard<std::mutex> hold(c.lock);
  sim_arrived = true;
  if (++c.arrivals == c.threads) {
    sim_cluster_complete();
    c.arrivals = 0;
    ++c.phases;
    c.moved.notify_all();
  }
}

inline void cluster_wait() {
  SimCluster& c = sim.cluster;
  if (!sim_arrived) sim_fail("barrier.cluster.wait without an arrive", nullptr);
  std::unique_lock<std::mutex> hold(c.lock);
  const unsigned want = sim_passed + 1;
  if (!c.moved.wait_for(hold, std::chrono::seconds(20), [&] { return c.phases >= want; })) {
    sim_fail("cluster barrier wait lasted 20 s: deadlock", nullptr);
  }
  sim_passed = want;
  sim_arrived = false;
}

inline void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

inline uint32_t mapa(uint32_t addr, uint32_t rank) {
  if (addr >= sim.smem_bytes) sim_fail("mapa of an address outside shared memory", sim_addr(addr));
  if (rank >= sim.cluster.size) sim_fail("mapa to a rank outside the cluster", sim_addr(addr));
  return rank * kSimRankStride + addr;
}

inline float4 ld_cluster_f4(uint32_t addr) {
  const uint32_t rank = addr / kSimRankStride, at = addr % kSimRankStride;
  if (rank >= sim.cluster.size) sim_fail("shared::cluster load outside the cluster", sim_addr(addr));
  if (at % 16) sim_fail("misaligned v4 shared::cluster load", sim_addr(addr));
  if (at + 16 > sim.smem_bytes) {
    sim_fail("shared::cluster load outside the peer's shared memory", sim_addr(addr));
  }
  if (sim_arrived) {
    sim_fail("shared::cluster load between a cluster barrier's arrive and its wait", sim_addr(addr));
  }
  sim.cluster.read[rank][at / 16].store(sim_passed + 1, std::memory_order_relaxed);
  float4 v;
  std::memcpy(&v, sim.cluster.seen[rank].get() + at, 16);
  return v;
}

// ---- math

inline float exp2_approx(float x) { return std::exp2(x); }

// ---- setmaxnreg

template <int N>
inline void setmaxnreg_dec() {}
template <int N>
inline void setmaxnreg_inc() {}

}  // namespace
