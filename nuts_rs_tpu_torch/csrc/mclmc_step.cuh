// MCLMC pieces shared by the fused posterior (K3) and warmup (K4) kernels.
//
// Counterpart of the ESH half step, the partial momentum refresh,
// num_steps_for and the step-halving stack of
// nuts_rs_tpu/kernels/mclmc_pallas.py (:132-169, :202-282, repeated in
// make_mclmc_warmup_kernel :577-746); plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py (_esh, _refresh, _num_steps,
// _leapfrog_try).  The Pallas body keeps the halving stack as f32 planes
// read back with masked sums (Mosaic has no dynamic row index); a chain
// indexes its own int stack.  Every expression keeps the Pallas grouping,
// including log((1+a)+(1-a)z^2) for log1p and exp(x)-1 for expm1.
//
// A chain's coordinates lie on a group of T lanes (T = 4, 8 or 16, a
// power of 2 that divides the warp; mclmc_lanes): coordinate j on lane
// j mod T, in slot j / T of that lane's arrays.  Every step on one
// coordinate runs on its own lane: the divisions of the ESH step and the
// refresh, the leapfrog's updates, the model's term, the Box-Muller normals
// at site j * B + b.  A sum over d is lanes.cuh's ordered gather, which
// keeps the bits of the one-thread sum and of the plain version's ops.dsum.
// Scalars (kinetic energy, logp, the halving stack, the step counts) are
// computed alike on every lane of a group, so no lane broadcasts them; a
// group's lanes take the same branches.
#pragma once

#include <math.h>
#include <stdint.h>

#include "lanes.cuh"  // Lane, slots, ordered_sum, ordered_dot, MAX_THREADS
#include "nuts_tree.cuh"  // MAX_BLOCK
#include "rng.cuh"

namespace nrt {

constexpr int MAX_HALVINGS = 10;  // kernels/mclmc.py::MAX_HALVINGS
constexpr int NSTATS_M = 8;       // mclmc.py::STAT_NAMES
constexpr int NSTATS_MW = 9;      // + transformation_index

// Lanes a chain of K3 / K4 at d coordinates in logical chain blocks of B
// (_build.mclmc_lanes, the same rule): one coordinate a lane, 4 lanes at
// d <= 4, 8 at d <= 8, 16 above, halved while the block's B * T threads
// exceed 1024 (16 -> 8 at B > 64).  The ablation macro NRT_MCLMC_LANES=n
// fixes T for every shape (profile_main_path.py item 17).
__host__ __device__ constexpr int mclmc_lanes(int d, int B) {
#ifdef NRT_MCLMC_LANES
  return NRT_MCLMC_LANES + 0 * (d + B);
#else
  int T = d <= 4 ? 4 : (d <= 8 ? 8 : 16);
  while (T > 4 && B * T > MAX_THREADS) T /= 2;
  return T;
#endif
}

// Whether K3 / K4 instantiate lanes T at d: some block B in 1..MAX_BLOCK
// takes it (the rule gives the most lanes at B = 1, the fewest at
// MAX_BLOCK, and every power of 2 in between).
__host__ __device__ constexpr bool mclmc_lanes_taken(int d, int T) {
  return T <= mclmc_lanes(d, 1) && T >= mclmc_lanes(d, MAX_BLOCK);
}

// Per-run constants, f32 as the Pallas body rounds its Python floats.
struct McConst {
  float max_err;   // max_energy_error
  float ell;       // momentum_decoherence_length L
  float fsub_ell;  // subsample_frequency * L (product taken in f64)
  float sqrt_n;    // sqrt(d)
};

// One chain's trajectory state; each lane holds its slots of the vectors
// and every scalar.
template <int DIM, int T, int H>
struct McState {
  static constexpr int NC = slots<DIM, T>();
  float z[NC], v[NC], zg[NC], noise[NC];
  float logp, ke;
  int rem;         // steps left at the current factor
  float factor;    // step factor, a power of 2
  int ssize;       // halving-stack depth
  int stack[H > 0 ? H : 1];
  int steps;       // successful leapfrogs of the draw
  float ttime;     // integrated time of the draw
};

// Standard normals of a vector site at (seed, it, salt1, salt2), slot i
// at site (lane + T i) * B + b.  Under the timing ablation
// NRT_ABLATE_MCLMC_NORMALS a value from the site alone, without the hashes
// and Box-Muller's log, sqrt and cos (changes results).
template <int DIM, int T>
__device__ __forceinline__ void lane_normals(float* out, uint32_t seed,
                                             uint32_t it, uint32_t salt1,
                                             uint32_t salt2, int b, int B,
                                             const Lane<T>& g) {
#pragma unroll
  for (int i = 0; i < slots<DIM, T>(); ++i) {
    const uint32_t idx = (uint32_t)((g.lane + T * i) * B + b);
#ifdef NRT_ABLATE_MCLMC_NORMALS
    out[i] = 0.25f * (float)((idx + it + salt1) % 7u) - 0.75f +
             0.0f * (float)(seed + salt2);
#else
    out[i] = normal(seed, it, salt1, salt2, idx);
#endif
  }
}

// x / y, the IEEE division of every per-coordinate quotient of the ESH step
// and the refresh; under the timing ablation NRT_ABLATE_MCLMC_DIVISIONS the
// approximate __fdividef (changes results).
__device__ __forceinline__ float coord_div(float x, float y) {
#ifdef NRT_ABLATE_MCLMC_DIVISIONS
  return __fdividef(x, y);
#else
  return x / y;
#endif
}

// ESH momentum half-step (math.rs:188-204): writes the new unit momentum to
// vn and returns the kinetic-energy change.
template <int DIM, int T>
__device__ __forceinline__ float esh(const float* zg, const float* v,
                                     float step, float* vn,
                                     const Lane<T>& g) {
  constexpr int NC = slots<DIM, T>();
  const float dm1 = (float)(DIM - 1);
  const float gn = sqrtf(ordered_dot<DIM, T>(zg, zg, g));
  float gh[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) gh[i] = coord_div(zg[i], gn);
  const float alpha = ordered_dot<DIM, T>(v, gh, g);
  const float delta = step * gn / dm1;
  const float zeta = expf(-delta);
  const float cg = (1.0f - zeta) * (1.0f + zeta + alpha * (1.0f - zeta));
  const float tz2 = 2.0f * zeta;
  float vr[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) vr[i] = cg * gh[i] + tz2 * v[i];
  const float nrm = sqrtf(ordered_dot<DIM, T>(vr, vr, g));
#pragma unroll
  for (int i = 0; i < NC; ++i) vn[i] = coord_div(vr[i], nrm);
  return (delta - (float)0.69314718055994530942 +
          logf((1.0f + alpha) + (1.0f - alpha) * zeta * zeta)) *
         dm1;
}

// Partial momentum refresh (transformed_hamiltonian.rs:777-826): writes the
// refreshed momentum to out; returns its kinetic energy (Euclidean) or 0.
template <int DIM, int T, bool MICRO>
__device__ __forceinline__ float refresh(const float* v, const float* noise,
                                         float half, float ell, float* out,
                                         const Lane<T>& g) {
  constexpr int NC = slots<DIM, T>();
  if (MICRO) {
    const float nu = sqrtf((expf(2.0f * half / ell) - 1.0f) / (float)DIM);
    float vr[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) vr[i] = v[i] + nu * noise[i];
    const float nrm = sqrtf(ordered_dot<DIM, T>(vr, vr, g));
#pragma unroll
    for (int i = 0; i < NC; ++i) out[i] = coord_div(vr[i], nrm);
    return 0.0f;
  }
  const float alpha = expf(-half / ell);
  const float beta = sqrtf(1.0f - alpha * alpha);
#pragma unroll
  for (int i = 0; i < NC; ++i) out[i] = alpha * v[i] + beta * noise[i];
  return 0.5f * ordered_dot<DIM, T>(out, out, g);
}

// round(F L / eps), half to even as jnp.round, clipped to [1, 1e6].
__device__ __forceinline__ int num_steps_for(float step, const McConst& k) {
  return (int)fminf(fmaxf(rintf(k.fsub_ell / step), 1.0f), 1e6f);
}

// Reset the counters and the halving stack for a fresh trajectory of nsd
// base steps (position, gradient and momentum are set by the caller).
template <int DIM, int T, int H>
__device__ __forceinline__ void start_trajectory(McState<DIM, T, H>& s,
                                                 int nsd) {
  s.rem = nsd;
  s.factor = 1.0f;
  s.ssize = 0;
  s.steps = 0;
  s.ttime = 0.0f;
}

enum { MC_CONTINUE = 0, MC_DONE = 1, MC_GAVE_UP = 2 };

// One leapfrog attempt with the halving stack (mclmc.rs:274-359): refresh,
// leapfrog, energy check.  On success the post-step refresh (noise at salts
// salt, salt+1) and the next noise (salt+2, salt+3) at (seed, it) are drawn
// and the stack unwinds; on a divergence the state stays at its pre-refresh
// values, the factor halves and the remaining count is pushed, or, with the
// stack full, the draw gives up.  Returns MC_CONTINUE, MC_DONE (remaining
// count reached 0) or MC_GAVE_UP.  The model contributes its one-coordinate
// term on each lane and its finish of their ordered sum.
template <int DIM, int T, bool MICRO, int H, class Model>
__device__ __forceinline__ int leapfrog_try(
    McState<DIM, T, H>& s, float step, int nsd, float ld, const float* stds,
    const float* mean, const Model& model, const McConst& k, uint32_t seed,
    uint32_t it, uint32_t salt, int b, int B, const Lane<T>& g) {
  constexpr int NC = slots<DIM, T>();
  const float f = s.factor;
  const float eps = step * f;
  const float half = eps / 2.0f;
  float vr[NC];
  float ke_r = refresh<DIM, T, MICRO>(s.v, s.noise, half, k.ell, vr, g);
  if (MICRO) ke_r = s.ke;
  const float base = ke_r - (s.logp + ld);

  float v1[NC], z1[NC], zg1[NC], v2[NC], sq[NC];
  float logp1, ke2;
  if (MICRO) {
    const float ke1 = ke_r + esh<DIM, T>(s.zg, vr, k.sqrt_n * eps / 2.0f, v1,
                                         g);
    const float es = eps * k.sqrt_n;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      z1[i] = s.z[i] + es * v1[i];
      sq[i] = model.term(z1[i] * stds[i] + mean[i], zg1[i]);
    }
    logp1 = model.finish(ordered_sum<DIM, T>(sq, g));
#pragma unroll
    for (int i = 0; i < NC; ++i) zg1[i] = zg1[i] * stds[i];
    ke2 = ke1 + esh<DIM, T>(zg1, v1, k.sqrt_n * eps / 2.0f, v2, g);
  } else {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      v1[i] = vr[i] + half * s.zg[i];
      z1[i] = s.z[i] + eps * v1[i];
      sq[i] = model.term(z1[i] * stds[i] + mean[i], zg1[i]);
    }
    logp1 = model.finish(ordered_sum<DIM, T>(sq, g));
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      zg1[i] = zg1[i] * stds[i];
      v2[i] = v1[i] + half * zg1[i];
    }
    ke2 = 0.5f * ordered_dot<DIM, T>(v2, v2, g);
  }
  const float err = (ke2 - (logp1 + ld)) - base;
  const float max_err_step = (k.max_err / (float)nsd) * f;
  const bool bad = MICRO ? fabsf(err) >= max_err_step : err > max_err_step;
  if (bad || !isfinite(err)) {
    if (s.ssize >= H) return MC_GAVE_UP;
    s.stack[s.ssize] = s.rem;
    s.rem = 2;
    s.factor = f * 0.5f;
    s.ssize += 1;
    return MC_CONTINUE;
  }

  float n1[NC];
  lane_normals<DIM, T>(n1, seed, it, salt, salt + 1u, b, B, g);
  const float ke3 = refresh<DIM, T, MICRO>(v2, n1, half, k.ell, s.v, g);
  s.ke = MICRO ? ke2 : ke3;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    s.z[i] = z1[i];
    s.zg[i] = zg1[i];
  }
  s.logp = logp1;
  lane_normals<DIM, T>(s.noise, seed, it, salt + 2u, salt + 3u, b, B, g);
  s.rem -= 1;
  s.steps += 1;
  s.ttime = s.ttime + f * step;
  while (s.rem == 0 && s.ssize > 0) {
    s.rem = s.stack[s.ssize - 1] - 1;
    s.factor = s.factor * 2.0f;
    s.ssize -= 1;
  }
  return s.rem == 0 ? MC_DONE : MC_CONTINUE;
}

// The momentum and kinetic energy emitted by a give-up draw: fresh normals
// at (salt, salt+1), on the unit sphere for the microcanonical kind.
template <int DIM, int T, bool MICRO>
__device__ __forceinline__ float give_up_momentum(uint32_t seed, uint32_t it,
                                                  uint32_t salt, int b, int B,
                                                  float* vf,
                                                  const Lane<T>& g) {
  constexpr int NC = slots<DIM, T>();
  lane_normals<DIM, T>(vf, seed, it, salt, salt + 1u, b, B, g);
  const float s2 = ordered_dot<DIM, T>(vf, vf, g);
  if (MICRO) {
    const float nrm = sqrtf(s2);
#pragma unroll
    for (int i = 0; i < NC; ++i) vf[i] = vf[i] / nrm;
    return 0.0f;
  }
  return 0.5f * s2;
}

}  // namespace nrt
