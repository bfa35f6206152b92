// MCLMC pieces shared by the fused posterior (K3) and warmup (K4) kernels.
//
// Counterpart of the ESH half step, the partial momentum refresh,
// num_steps_for and the step-halving stack of
// nuts_rs_tpu/kernels/mclmc_pallas.py (:132-169, :202-282, repeated in
// make_mclmc_warmup_kernel :577-746); plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py (_esh, _refresh, _num_steps,
// _leapfrog_try).  The Pallas body keeps the halving stack as f32 planes
// read back with masked sums (Mosaic has no dynamic row index); one thread
// per chain indexes its own int stack.  Sums run in coordinate order and
// every expression keeps the Pallas grouping, including log((1+a)+(1-a)z^2)
// for log1p and exp(x)-1 for expm1.
#pragma once

#include <math.h>
#include <stdint.h>

#include "nuts_tree.cuh"  // dot, copy, MAX_BLOCK
#include "rng.cuh"

namespace nrt {

constexpr int MAX_HALVINGS = 10;  // kernels/mclmc.py::MAX_HALVINGS
constexpr int NSTATS_M = 8;       // mclmc.py::STAT_NAMES
constexpr int NSTATS_MW = 9;      // + transformation_index

// Per-run constants, f32 as the Pallas body rounds its Python floats.
struct McConst {
  float max_err;   // max_energy_error
  float ell;       // momentum_decoherence_length L
  float fsub_ell;  // subsample_frequency * L (product taken in f64)
  float sqrt_n;    // sqrt(d)
};

// One chain's trajectory state.
template <int DIM, int H>
struct McState {
  float z[DIM], v[DIM], zg[DIM], noise[DIM];
  float logp, ke;
  int rem;         // steps left at the current factor
  float factor;    // step factor, a power of 2
  int ssize;       // halving-stack depth
  int stack[H > 0 ? H : 1];
  int steps;       // successful leapfrogs of the draw
  float ttime;     // integrated time of the draw
};

// ESH momentum half-step (math.rs:188-204): writes the new unit momentum to
// vn and returns the kinetic-energy change.
template <int DIM>
__device__ __forceinline__ float esh(const float* zg, const float* v,
                                     float step, float* vn) {
  const float dm1 = (float)(DIM - 1);
  const float gn = sqrtf(dot<DIM>(zg, zg));
  float gh[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) gh[j] = zg[j] / gn;
  const float alpha = dot<DIM>(v, gh);
  const float delta = step * gn / dm1;
  const float zeta = expf(-delta);
  const float cg = (1.0f - zeta) * (1.0f + zeta + alpha * (1.0f - zeta));
  const float tz2 = 2.0f * zeta;
  float vr[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) vr[j] = cg * gh[j] + tz2 * v[j];
  const float nrm = sqrtf(dot<DIM>(vr, vr));
#pragma unroll
  for (int j = 0; j < DIM; ++j) vn[j] = vr[j] / nrm;
  return (delta - (float)0.69314718055994530942 +
          logf((1.0f + alpha) + (1.0f - alpha) * zeta * zeta)) *
         dm1;
}

// Partial momentum refresh (transformed_hamiltonian.rs:777-826): writes the
// refreshed momentum to out; returns its kinetic energy (Euclidean) or 0.
template <int DIM, bool MICRO>
__device__ __forceinline__ float refresh(const float* v, const float* noise,
                                         float half, float ell, float* out) {
  if (MICRO) {
    const float nu = sqrtf((expf(2.0f * half / ell) - 1.0f) / (float)DIM);
    float vr[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) vr[j] = v[j] + nu * noise[j];
    const float nrm = sqrtf(dot<DIM>(vr, vr));
#pragma unroll
    for (int j = 0; j < DIM; ++j) out[j] = vr[j] / nrm;
    return 0.0f;
  }
  const float alpha = expf(-half / ell);
  const float beta = sqrtf(1.0f - alpha * alpha);
#pragma unroll
  for (int j = 0; j < DIM; ++j) out[j] = alpha * v[j] + beta * noise[j];
  return 0.5f * dot<DIM>(out, out);
}

// round(F L / eps), half to even as jnp.round, clipped to [1, 1e6].
__device__ __forceinline__ int num_steps_for(float step, const McConst& k) {
  return (int)fminf(fmaxf(rintf(k.fsub_ell / step), 1.0f), 1e6f);
}

// Reset the counters and the halving stack for a fresh trajectory of nsd
// base steps (position, gradient and momentum are set by the caller).
template <int DIM, int H>
__device__ __forceinline__ void start_trajectory(McState<DIM, H>& s, int nsd) {
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
// count reached 0) or MC_GAVE_UP.
template <int DIM, bool MICRO, int H, class Model>
__device__ __forceinline__ int leapfrog_try(
    McState<DIM, H>& s, float step, int nsd, float ld, const float* stds,
    const float* mean, const Model& model, const McConst& k, uint32_t seed,
    uint32_t it, uint32_t salt, int b, int B) {
  const float f = s.factor;
  const float eps = step * f;
  const float half = eps / 2.0f;
  float vr[DIM];
  float ke_r = refresh<DIM, MICRO>(s.v, s.noise, half, k.ell, vr);
  if (MICRO) ke_r = s.ke;
  const float base = ke_r - (s.logp + ld);

  float v1[DIM], z1[DIM], q1[DIM], zg1[DIM], v2[DIM];
  float logp1, ke2;
  if (MICRO) {
    const float ke1 = ke_r + esh<DIM>(s.zg, vr, k.sqrt_n * eps / 2.0f, v1);
    const float es = eps * k.sqrt_n;
#pragma unroll
    for (int j = 0; j < DIM; ++j) z1[j] = s.z[j] + es * v1[j];
#pragma unroll
    for (int j = 0; j < DIM; ++j) q1[j] = z1[j] * stds[j] + mean[j];
    logp1 = model.template eval<DIM>(q1, zg1);
#pragma unroll
    for (int j = 0; j < DIM; ++j) zg1[j] = zg1[j] * stds[j];
    ke2 = ke1 + esh<DIM>(zg1, v1, k.sqrt_n * eps / 2.0f, v2);
  } else {
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      v1[j] = vr[j] + half * s.zg[j];
      z1[j] = s.z[j] + eps * v1[j];
    }
#pragma unroll
    for (int j = 0; j < DIM; ++j) q1[j] = z1[j] * stds[j] + mean[j];
    logp1 = model.template eval<DIM>(q1, zg1);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      zg1[j] = zg1[j] * stds[j];
      v2[j] = v1[j] + half * zg1[j];
    }
    ke2 = 0.5f * dot<DIM>(v2, v2);
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

  float n1[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j)
    n1[j] = normal(seed, it, salt, salt + 1u, (uint32_t)(j * B + b));
  const float ke3 = refresh<DIM, MICRO>(v2, n1, half, k.ell, s.v);
  s.ke = MICRO ? ke2 : ke3;
  copy<DIM>(s.z, z1);
  copy<DIM>(s.zg, zg1);
  s.logp = logp1;
#pragma unroll
  for (int j = 0; j < DIM; ++j)
    s.noise[j] = normal(seed, it, salt + 2u, salt + 3u, (uint32_t)(j * B + b));
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
template <int DIM, bool MICRO>
__device__ __forceinline__ float give_up_momentum(uint32_t seed, uint32_t it,
                                                  uint32_t salt, int b, int B,
                                                  float* vf) {
#pragma unroll
  for (int j = 0; j < DIM; ++j)
    vf[j] = normal(seed, it, salt, salt + 1u, (uint32_t)(j * B + b));
  const float s2 = dot<DIM>(vf, vf);
  if (MICRO) {
    const float nrm = sqrtf(s2);
#pragma unroll
    for (int j = 0; j < DIM; ++j) vf[j] = vf[j] / nrm;
    return 0.0f;
  }
  return 0.5f * s2;
}

}  // namespace nrt
