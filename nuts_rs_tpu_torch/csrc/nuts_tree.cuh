// Tree pieces shared by the fused posterior and warmup kernels.
//
// Counterpart of the U-turn ladder, the top-level checks and the helper
// arithmetic of nuts_rs_tpu/kernels/nuts_pallas.py (:405-576, repeated in
// make_warmup_kernel :1174-1312).  The Pallas body gathers stack rows with
// one-hot masks and masked sums (Mosaic has no dynamic row index); a chain
// indexes its own stacks directly, which gives the same values.
//
// In K1 and K2 a chain's coordinates lie on a group of T lanes (lanes.cuh,
// nuts_lanes): each lane holds its slots of every vector and of every stack
// row, and every dot product is an ordered gather, summed in coordinate
// order j = 0..d-1 on every lane, as the plain PyTorch versions do
// (nuts_rs_tpu_torch/ops.py::dsum).
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "lanes.cuh"
#include "rng.cuh"

namespace nrt {

constexpr int NSTATS = 13;    // STAT_NAMES
constexpr int NSTATS_W = 15;  // WARMUP_STAT_NAMES
constexpr int MAX_BLOCK = 128;

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

// Threads of a K1 / K2 block at most; the ablation macro
// NRT_NUTS_MAX_THREADS=n lowers it (512: up to 128 registers a thread).
#ifdef NRT_NUTS_MAX_THREADS
constexpr int NUTS_MAX_THREADS = NRT_NUTS_MAX_THREADS;
#else
constexpr int NUTS_MAX_THREADS = MAX_THREADS;
#endif

// Lanes a chain of K1 / K2 at d coordinates in logical chain blocks of B
// (_build.nuts_lanes, the same rule, checked at every launch): 4 at every
// instantiated d and block, so a block of B chains is B / 8 warps (at
// most 512 threads, up to 128 registers a thread).  Timed at d = 10 and
// B = 32 on the path's own states (profile_main_path.py item 18), 4 lanes
// beat 8 and 16: the scalar work of a chain (its uniforms, energies,
// weights and tree bookkeeping) runs on every lane of its group, so 16
// lanes issue it 16 times on the block's one SM, while 4 lanes keep one
// warp on each of the SM's four schedulers.  The ablation macro
// NRT_NUTS_LANES=n fixes T = n for every shape.
__host__ __device__ constexpr int nuts_lanes(int d, int B) {
#ifdef NRT_NUTS_LANES
  return NRT_NUTS_LANES + 0 * (d + B);
#else
  return 4 + 0 * (d + B);
#endif
}

// The threads a K1 / K2 instantiation at T lanes takes at most, for its
// __launch_bounds__.
__host__ __device__ constexpr int nuts_block_threads(int T) {
  return T * MAX_BLOCK < NUTS_MAX_THREADS ? T * MAX_BLOCK : NUTS_MAX_THREADS;
}

// Whether K1 / K2 instantiate lanes T at d: some block B in 1..MAX_BLOCK
// takes it (the most lanes at B = 1, the fewest at MAX_BLOCK, every power
// of 2 between).
__host__ __device__ constexpr bool nuts_lanes_taken(int d, int T) {
  return T <= nuts_lanes(d, 1) && T >= nuts_lanes(d, MAX_BLOCK);
}

// The four checkpoint stacks of a chain's tree (lz, lv, mz, mv), D + 1 rows
// each, a lane's NC slots of every row; SMEM: in shared memory, slot i of
// row r of stack p at base[((p (D+1) + r) NC + i) * stride] with base this
// thread's first float and stride the block's threads (the threads of a
// warp on 32 banks); else an array of the thread's own (local memory).
// Under the timing ablation NRT_NUTS_SMEM_STACKS the kernels take shared
// memory (results unchanged).
enum { ST_LZ = 0, ST_LV, ST_MZ, ST_MV, NSTACKS };

template <int NC, int D, bool SMEM>
struct LaneStacks;

template <int NC, int D>
struct LaneStacks<NC, D, false> {
  float s[NSTACKS][D + 1][NC];
  __device__ __forceinline__ float& at(int p, int r, int i) {
    return s[p][r][i];
  }
};

template <int NC, int D>
struct LaneStacks<NC, D, true> {
  float* base;
  int stride;
  __device__ __forceinline__ float& at(int p, int r, int i) {
    return base[((p * (D + 1) + r) * NC + i) * stride];
  }
};

// Shared memory of a block's checkpoint stacks in the SMEM form.
template <int DIM, int D, int T>
constexpr size_t stack_smem_bytes(int B) {
  return sizeof(float) * NSTACKS * (D + 1) * slots<DIM, T>() * B * T;
}

// x . (row r of stack p), summed in coordinate order on every lane.
template <int DIM, int T, class S>
__device__ __forceinline__ float row_dot(const float* x, S& st, int p, int r,
                                         const Lane<T>& g) {
  constexpr int NC = slots<DIM, T>();
  float t[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) t[i] = x[i] * st.at(p, r, i);
  return ordered_sum<DIM, T>(t, g);
}

// (row r of stack p) . (row r2 of stack p2), in coordinate order.
template <int DIM, int T, class S>
__device__ __forceinline__ float rows_dot(S& st, int p, int r, int p2, int r2,
                                          const Lane<T>& g) {
  constexpr int NC = slots<DIM, T>();
  float t[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) t[i] = st.at(p, r, i) * st.at(p2, r2, i);
  return ordered_sum<DIM, T>(t, g);
}

// Internal U-turn checks of the spans that leaf `leaf` completes: the static
// levels 1 <= k < tzn and the boundary level k == tzn (nuts_pallas.py
// :405-553), with the stacks holding this leapfrog's writes already.  Level
// k compares the new point with row ra of l (k, or the boundary's dynamic
// row) and, from level 2 on, with row k of m, and row ra of l with row
// k - 1.  Every dot of an active level is evaluated and the booleans ORed,
// where the one-thread form stopped at the first turn: the dots have no side
// effects, so the booleans are the same, and a level's 2 or 6 gathers are
// independent of each other and interleave.
template <int DIM, int D, int T, class S>
__device__ __forceinline__ bool uturn_internal_lanes(
    int leaf, int tzn, float dirf, const float* z1, const float* v2,
    float d1, S& st, const float* bl, const float* bm, const Lane<T>& g) {
  const int r_bound = min(tz(leaf + 1 - (1 << tzn), D), D);
  bool turning = false;
  for (int k = 1; k <= tzn; ++k) {
    const int ra = k == tzn ? r_bound : k;
    const int rb = k - 1;
    const float a_b = bl[ra];
    if (k >= 2) {
      const float s1 = row_dot<DIM, T>(z1, st, ST_LV, ra, g);
      const float s2 = row_dot<DIM, T>(v2, st, ST_LZ, ra, g);
      const float s3 = row_dot<DIM, T>(z1, st, ST_MV, k, g);
      const float s4 = row_dot<DIM, T>(v2, st, ST_MZ, k, g);
      const float s5 = rows_dot<DIM, T>(st, ST_LZ, rb, ST_LV, ra, g);
      const float s6 = rows_dot<DIM, T>(st, ST_LZ, ra, ST_LV, rb, g);
      turning = turning | turn2(dirf, s1, a_b, d1, s2) |
                turn2(dirf, s3, bm[k], d1, s4) |
                turn2(dirf, s5, a_b, bl[rb], s6);
    } else {
      const float s1 = row_dot<DIM, T>(z1, st, ST_LV, ra, g);
      const float s2 = row_dot<DIM, T>(v2, st, ST_LZ, ra, g);
      turning = turning | turn2(dirf, s1, a_b, d1, s2);
    }
  }
  return turning;
}

// Top-level checks against the trajectory's far and near ends and the first
// leaf of the new subtree, row D of l (nuts_pallas.py:559-576).  Every dot
// is evaluated (see uturn_internal_lanes): 3 at depth 0, 8 above.
template <int DIM, int D, int T, class S>
__device__ __forceinline__ bool uturn_top_lanes(
    int depth, float dirf, const float* z1, const float* v2, float d1,
    const float* far_z, const float* far_v, const float* near_z,
    const float* near_v, S& st, float b0_d, const Lane<T>& g) {
  const float far_zv = ordered_dot<DIM, T>(far_z, far_v, g);
  const float s1 = ordered_dot<DIM, T>(z1, far_v, g);
  const float s2 = ordered_dot<DIM, T>(far_z, v2, g);
  if (depth <= 0) return turn2(dirf, s1, far_zv, d1, s2);
  const float near_zv = ordered_dot<DIM, T>(near_z, near_v, g);
  const float s3 = ordered_dot<DIM, T>(z1, near_v, g);
  const float s4 = ordered_dot<DIM, T>(near_z, v2, g);
  const float s5 = row_dot<DIM, T>(far_v, st, ST_LZ, D, g);
  const float s6 = row_dot<DIM, T>(far_z, st, ST_LV, D, g);
  return turn2(dirf, s1, far_zv, d1, s2) |
         turn2(dirf, s3, near_zv, d1, s4) |
         turn2(dirf, s5, far_zv, b0_d, s6);
}

// Standard normals of a vector site at (seed, it, salt1, salt2), slot i at
// the chains-on-lanes site (lane + T i) * B + b.  Under the timing ablation
// NRT_ABLATE_NUTS_NORMALS a value from the site alone, without the hashes
// and Box-Muller's log, sqrt and cos (changes results).
template <int DIM, int T>
__device__ __forceinline__ void nuts_lane_normals(float* out, uint32_t seed,
                                                  uint32_t it, uint32_t salt1,
                                                  uint32_t salt2, int b,
                                                  int B, const Lane<T>& g) {
#pragma unroll
  for (int i = 0; i < slots<DIM, T>(); ++i) {
    const uint32_t idx = (uint32_t)((g.lane + T * i) * B + b);
#ifdef NRT_ABLATE_NUTS_NORMALS
    out[i] = 0.25f * (float)((idx + it + salt1) % 7u) - 0.75f +
             0.0f * (float)(seed + salt2);
#else
    out[i] = normal(seed, it, salt1, salt2, idx);
#endif
  }
}

}  // namespace nrt
