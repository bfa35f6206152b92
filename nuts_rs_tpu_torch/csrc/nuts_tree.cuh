// Tree pieces shared by the fused posterior and warmup kernels.
//
// Counterpart of the U-turn ladder, the top-level checks and the helper
// arithmetic of nuts_rs_tpu/kernels/nuts_pallas.py (:405-576, repeated in
// make_warmup_kernel :1174-1312).  The Pallas body gathers stack rows with
// one-hot masks and masked sums (Mosaic has no dynamic row index); one
// thread per chain indexes its own stacks directly, which gives the same
// values.  Every dot product sums in coordinate order j = 0..d-1, as the
// plain PyTorch versions do (nuts_rs_tpu_torch/ops.py::dsum).
#pragma once

#include <math.h>

#include "rng.cuh"

namespace nrt {

constexpr int NSTATS = 13;    // STAT_NAMES
constexpr int NSTATS_W = 15;  // WARMUP_STAT_NAMES
constexpr int MAX_BLOCK = 128;

template <int DIM>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = a[0] * b[0];
#pragma unroll
  for (int j = 1; j < DIM; ++j) s = s + a[j] * b[j];
  return s;
}

template <int DIM>
__device__ __forceinline__ void copy(float* dst, const float* src) {
#pragma unroll
  for (int j = 0; j < DIM; ++j) dst[j] = src[j];
}

// min(x, 0) with NaN propagation, as jnp.minimum.
__device__ __forceinline__ float min0(float x) {
  return (x != x) ? x : fminf(x, 0.0f);
}

// jax.lax.logaddexp's formula.
__device__ __forceinline__ float logaddexp(float x1, float x2) {
  const float delta = x1 - x2;
  if (delta != delta) return x1 + x2;
  return fmaxf(x1, x2) + log1pf(expf(-fabsf(delta)));
}

__device__ __forceinline__ bool turn2(float dirf, float a, float b, float c,
                                      float d) {
  return (dirf * (a - b) < 0.0f) || (dirf * (c - d) < 0.0f);
}

// Internal U-turn checks of the spans that leaf `leaf` completes: the static
// levels 1 <= j < tzn and the boundary level j == tzn (nuts_pallas.py
// :405-553).  Stacks hold this leapfrog's writes already.
template <int DIM, int D>
__device__ __forceinline__ bool uturn_internal(
    int leaf, int tzn, float dirf, const float* z1, const float* v2,
    float d1, float (*lz)[DIM], float (*lv)[DIM], const float* bl,
    float (*mz)[DIM], float (*mv)[DIM], const float* bm) {
  bool turning = false;
  for (int j = 1; j < tzn; ++j) {
    bool t = turn2(dirf, dot<DIM>(z1, lv[j]), bl[j], d1, dot<DIM>(lz[j], v2));
    if (j >= 2) {
      t = t || turn2(dirf, dot<DIM>(z1, mv[j]), bm[j], d1,
                     dot<DIM>(mz[j], v2));
      t = t || turn2(dirf, dot<DIM>(lz[j - 1], lv[j]), bl[j], bl[j - 1],
                     dot<DIM>(lz[j], lv[j - 1]));
    }
    turning = turning || t;
  }
  if (tzn >= 1) {
    const int ra = min(tz(leaf + 1 - (1 << tzn), D), D);
    const float a_b = bl[ra];
    turning = turning ||
              turn2(dirf, dot<DIM>(z1, lv[ra]), a_b, d1, dot<DIM>(lz[ra], v2));
    if (tzn >= 2) {
      const int rb = tzn - 1;
      turning = turning ||
                turn2(dirf, dot<DIM>(z1, mv[tzn]), bm[tzn], d1,
                      dot<DIM>(mz[tzn], v2)) ||
                turn2(dirf, dot<DIM>(lz[rb], lv[ra]), a_b, bl[rb],
                      dot<DIM>(lz[ra], lv[rb]));
    }
  }
  return turning;
}

// Top-level checks against the trajectory's far and near ends and the first
// leaf of the new subtree (nuts_pallas.py:559-576).
template <int DIM>
__device__ __forceinline__ bool uturn_top(
    int depth, float dirf, const float* z1, const float* v2, float d1,
    const float* far_z, const float* far_v, const float* near_z,
    const float* near_v, const float* b0_z, const float* b0_v, float b0_d) {
  const float far_zv = dot<DIM>(far_z, far_v);
  const bool t_out =
      turn2(dirf, dot<DIM>(z1, far_v), far_zv, d1, dot<DIM>(far_z, v2));
  if (t_out) return true;
  if (depth <= 0) return false;
  const float near_zv = dot<DIM>(near_z, near_v);
  return turn2(dirf, dot<DIM>(z1, near_v), near_zv, d1,
               dot<DIM>(near_z, v2)) ||
         turn2(dirf, dot<DIM>(b0_z, far_v), far_zv, b0_d,
               dot<DIM>(far_z, b0_v));
}

}  // namespace nrt
