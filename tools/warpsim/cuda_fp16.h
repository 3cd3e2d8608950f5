// Stands in for <cuda_fp16.h> in the lockstep simulator (cuda_bf16.h): f16
// and its pair, with the conversion from fp32 that the kernels use
// (elem.cuh), rounding to nearest even with subnormals kept, as cvt.rn.f16
// does on the card.
#pragma once
#include "cuda_bf16.h"

struct __half { uint16_t x; };
struct __half2 { __half a, b; };

inline uint16_t sim_f2h(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  const uint16_t sign = static_cast<uint16_t>((u >> 16) & 0x8000u);
  const uint32_t mag = u & 0x7fffffffu;
  if (mag >= 0x7f800000u) return sign | 0x7c00u | (mag > 0x7f800000u ? 0x200u : 0u);
  if (mag >= 0x477ff000u) return sign | 0x7c00u;  // rounds past 65504
  if (mag < 0x38800000u) {
    // below 2^-14: a subnormal (or zero) in units of 2^-24, rounded to even
    float a;
    std::memcpy(&a, &mag, 4);
    return sign | static_cast<uint16_t>(std::nearbyint(a * 16777216.0f));
  }
  uint32_t h = (((mag >> 23) - 112u) << 10) | ((mag >> 13) & 0x3ffu);
  const uint32_t rest = mag & 0x1fffu;
  if (rest > 0x1000u || (rest == 0x1000u && (h & 1u))) ++h;  // a carry moves the exponent
  return static_cast<uint16_t>(sign | h);
}

inline float sim_h2f(uint16_t h) {
  const uint32_t exp = (h >> 10) & 0x1fu, mant = h & 0x3ffu;
  float f;
  if (exp == 0) {
    f = std::ldexp(static_cast<float>(mant), -24);
  } else {
    const uint32_t u = exp == 31 ? 0x7f800000u | (mant << 13) : ((exp + 112u) << 23) | (mant << 13);
    std::memcpy(&f, &u, 4);
  }
  return h & 0x8000u ? -f : f;
}

inline __half2 __floats2half2_rn(float a, float b) { return {{sim_f2h(a)}, {sim_f2h(b)}}; }
