// The simulator's version of the kernels' mma_ptx.cuh (the PTX layer under
// ops/csrc/mma_bf16.cuh, which the simulation includes as it is): each
// warp-level operation gathers the operands of its 32 lanes at the warp's
// barrier and hands every lane the fragment elements the PTX ISA assigns
// it.  cp.async copies at once, so the waits have nothing to wait for.
#pragma once
#include "cuda_bf16.h"

namespace {

inline void cp_async16(void* smem, const void* gmem) {
  sim_check_smem(smem);
  if (reinterpret_cast<uintptr_t>(gmem) % 16) sim_fail("misaligned cp.async source", gmem);
  std::memcpy(smem, gmem, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_one() {}

// Lanes 8i .. 8i+7 give the row addresses of matrix i; lane l receives, of
// each matrix, row l/4 columns 2(l%4), 2(l%4)+1, or with `trans` column l/4
// rows 2(l%4), 2(l%4)+1.
inline void sim_ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  sim_check_smem(p);
  const int w = sim_warp(), l = sim_lane();
  sim.addr[w][l] = p;
  sim_warp_sync();
  const int g = l / 4, t = l % 4;
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (trans) {
      lo = static_cast<const uint16_t*>(sim.addr[w][8 * i + 2 * t])[g];
      hi = static_cast<const uint16_t*>(sim.addr[w][8 * i + 2 * t + 1])[g];
    } else {
      const auto* row = static_cast<const uint16_t*>(sim.addr[w][8 * i + g]);
      lo = row[2 * t];
      hi = row[2 * t + 1];
    }
    r[i] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  sim_warp_sync();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { sim_ldmatrix(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { sim_ldmatrix(r, p, true); }

inline float sim_half(uint32_t v, int h) { return sim_bf2f(uint16_t(h ? v >> 16 : v & 0xffffu)); }

// d += a * b, m16n8k16: A[r][k] sits in lane (r%8)*4 + (k%8)/2, register
// r/8 + 2(k/8); B[k][n] in lane n*4 + (k%8)/2, register k/8; D[r][c] in
// lane (r%8)*4 + c/2, element 2(r/8) + c%2.
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = sim_warp(), l = sim_lane();
  for (int i = 0; i < 4; ++i) sim.a[w][l][i] = a[i];
  sim.b[w][l][0] = b0;
  sim.b[w][l][1] = b1;
  sim_warp_sync();
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int r = g + (e / 2) * 8, c = 2 * t + (e % 2);
    float acc = d[e];
    for (int k = 0; k < 16; ++k) {
      acc += sim_half(sim.a[w][(r % 8) * 4 + (k % 8) / 2][r / 8 + 2 * (k / 8)], k % 2) *
             sim_half(sim.b[w][c * 4 + (k % 8) / 2][k / 8], k % 2);
    }
    d[e] = acc;
  }
  sim_warp_sync();
}

}  // namespace
