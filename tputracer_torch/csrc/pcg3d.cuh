// pcg3d of (path uid, salt, seed) to three U[0,1) floats (Jarzynski &
// Olano, JCGT 2020): the device code of the counter-based sampler, shared
// by csrc/rng.cu's uniform3_kernel and the kernels that draw inside
// themselves (csrc/pt.cu).
//
// Bits: the uid's low 32 bits, then uint32 arithmetic that wraps and
// shifts logically, as rng.uniform3_plain's int32 ops with their masks;
// then the top 24 bits converted to float (exact below 2^24) and scaled
// by 2^-24 (exact).  So a draw equals the torch version's bit for bit.

#pragma once

#include <cstdint>

namespace tpt {

__device__ __forceinline__ void pcg3d(uint32_t& x, uint32_t& y,
                                      uint32_t& z) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  x += y * z;
  y += z * x;
  z += x * y;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  y += z * x;
  z += x * y;
}

__device__ __forceinline__ float to_unit(uint32_t v) {
  return static_cast<float>(v >> 8) * 0x1p-24f;
}

__device__ __forceinline__ void draw(long long uid, uint32_t salt,
                                     uint32_t seed, float& u0, float& u1,
                                     float& u2) {
  uint32_t x = static_cast<uint32_t>(uid), y = salt, z = seed;
  pcg3d(x, y, z);
  u0 = to_unit(x);
  u1 = to_unit(y);
  u2 = to_unit(z);
}

}  // namespace tpt
