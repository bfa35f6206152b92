// Counter-based random numbers of the fused kernels.
//
// Device twin of nuts_rs_tpu_torch/kernels/rng.py, which is the port of
// nuts_rs_tpu/kernels/nuts_pallas.py::_hash_bits, _uniform, _normals and
// _tz (:54-79,180-194).  The murmur3 finalizer keyed by (seed, it, salt,
// idx) gives the same bits on the card as the plain PyTorch version does on
// any device, so a kernel can be held draw for draw against it.
#pragma once

#include <stdint.h>

namespace nrt {

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t it,
                                              uint32_t salt, uint32_t idx) {
  uint32_t h = (seed ^ (salt * 2654435761u)) + it * 0x9E3779B9u +
               idx * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// 24-bit uniform clipped to [1e-12, 1 - 1e-7], as jnp.clip(min, max).
__device__ __forceinline__ float uniform(uint32_t seed, uint32_t it,
                                         uint32_t salt, uint32_t idx) {
  const float f = (float)(int)(hash_bits(seed, it, salt, idx) >> 8) *
                  (1.0f / 16777216.0f);
  return fminf(fmaxf(f, 1e-12f), (float)(1.0 - 1e-7));
}

// Box-Muller from the uniforms of two salts at one site.
__device__ __forceinline__ float normal(uint32_t seed, uint32_t it,
                                        uint32_t salt1, uint32_t salt2,
                                        uint32_t idx) {
  const float u1 = uniform(seed, it, salt1, idx);
  const float u2 = uniform(seed, it, salt2, idx);
  return sqrtf(-2.0f * logf(u1)) *
         cosf((float)(2.0 * 3.14159265358979323846) * u2);
}

// Index of a vector site's element for lane b of a logical block and
// coordinate j: the flat position in the block's (d, B) shape in the
// chains-on-lanes layout is j * B + b (written out in those kernels); in
// the dim-on-lanes layout the shape is (B, d).
__device__ __forceinline__ uint32_t ld_site(int b, int d, int j) {
  return (uint32_t)b * (uint32_t)d + (uint32_t)j;
}

// Trailing zeros over bits 0..cap-1; cap for x == 0; 0 when no bit below
// cap is set (exactly the Pallas _tz loop).
__device__ __forceinline__ int tz(int x, int cap) {
  if (x == 0) return cap;
  const int b = __ffs(x) - 1;
  return b < cap ? b : 0;
}

}  // namespace nrt
