// MCLMC pieces of the mid-d fused kernels (K3-args, K4-args): the trajectory
// of one chain shared by the LD_T threads of a CUDA block.
//
// Counterpart of the ESH half step, the partial momentum refresh and the
// step-halving stack of nuts_rs_tpu/kernels/mclmc_pallas.py (:132-169,
// :202-282, repeated in make_mclmc_warmup_kernel :577-746) with the model
// evaluated as logp_grad_batched(q, *model_args) (:122-125); the
// thread-per-chain form is mclmc_step.cuh, the plain PyTorch version
// nuts_rs_tpu_torch/kernels/mclmc_fused.py (_esh, _refresh, _leapfrog_try)
// with the "mid" evaluators.
//
// Thread t owns the coordinates j = t, t + LD_T, ... of every vector of its
// chain, in shared memory, and touches no other thread's coordinates; the
// only shared reads are the model's, of the whole new position, after one
// __syncthreads.  Scalars (energies, the step factor, the halving stack, the
// counters, the scalar random sites) are computed by every thread from the
// same inputs, so control flow is uniform within the block.  Every sum over
// d goes through Reducer::sum (block_sum.cuh, the order of ops.py::tsum) and
// every expression keeps the Pallas grouping: gh = zg / gn before
// alpha = sum(v * gh), log((1 + a) + (1 - a) z^2) for log1p, exp(x) - 1 for
// expm1, divisions by float(d - 1) and float(d).
//
// The sums of one iteration depend on each other (a norm, then the vector it
// normalises, then that vector's dot), so they are separate reductions, one
// barrier each: 8 and the model's own for a microcanonical iteration (the
// norm of the carried gradient shares the pre-step refresh's reduction,
// which changes no rounding), 3 and the model's for a Euclidean one.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "mclmc_step.cuh"    // McConst, num_steps_for, MAX_HALVINGS, MC_*
#include "nuts_tree_ld.cuh"  // ClusterMax, LD_MAX_CLUSTER, ld_launch
#include "rng.cuh"

namespace nrt {

// live vectors of a chain in shared memory (McChain's)
constexpr int MC_MID_NVEC = 15;

// One chain's vectors, d floats of shared memory each.
struct McChain {
  int d, n;  // n = ceil(d / LD_T): coordinates a thread may own
  float *stds, *mean;
  float *z, *v, *zg, *noise;             // the trajectory's carried state
  float *z0, *zg0;                       // the draw-start snapshot
  float *vr, *v1, *z1, *q1, *zg1, *v2;   // one leapfrog's temporaries
  float *gh;                             // unit gradient of an ESH half step
};

// One chain's scalars, the same in every thread of its block.
template <int H>
struct McScalars {
  float logp, ke;
  int rem;       // steps left at the current factor
  float factor;  // step factor, a power of 2
  int ssize;     // halving-stack depth
  int stack[H > 0 ? H : 1];
  int steps;     // successful leapfrogs of the draw
  float ttime;   // integrated time of the draw
};

// Point the chain's vectors at consecutive d-float slices from p; returns
// the first float after them.
__device__ __forceinline__ float* mc_chain_layout(McChain& ch, int d,
                                                  float* p) {
  ch.d = d;
  ch.n = (d + LD_T - 1) / LD_T;
  float** vecs[MC_MID_NVEC] = {&ch.stds, &ch.mean, &ch.z,  &ch.v,  &ch.zg,
                               &ch.noise, &ch.z0,  &ch.zg0, &ch.vr, &ch.v1,
                               &ch.z1,   &ch.q1,   &ch.zg1, &ch.v2, &ch.gh};
  for (float** v : vecs) {
    *v = p;
    p += d;
  }
  return p;
}

// Shared-memory floats of a chain block: the vectors, the reduction scratch
// and the cluster slots; a model functor's scratch follows them.
__host__ __device__ inline size_t mc_smem_floats(int d) {
  return (size_t)MC_MID_NVEC * d + 2 * LD_NRED * LD_W +
         2 * LD_MAX_CLUSTER;
}

template <int H>
__device__ __forceinline__ void start_trajectory(McScalars<H>& s, int nsd) {
  s.rem = nsd;
  s.factor = 1.0f;
  s.ssize = 0;
  s.steps = 0;
  s.ttime = 0.0f;
}

// sum(a * a) over the chain's coordinates.
__device__ __forceinline__ float mc_sumsq(const McChain& c, Reducer& red,
                                          const float* a) {
  float s[1];
  for (int i = 0; i < c.n; ++i) {
    const int j = threadIdx.x + i * LD_T;
    acc(s[0], i, j < c.d ? a[j] * a[j] : 0.0f);
  }
  red.sum(s);
  return s[0];
}

// a[j] = a[j] / x on the thread's coordinates.
__device__ __forceinline__ void mc_divide(const McChain& c, float* a,
                                          float x) {
  for (int j = threadIdx.x; j < c.d; j += LD_T) a[j] = a[j] / x;
}

// ESH momentum half-step (math.rs:188-204) with gn2 = sum(zg * zg) given:
// writes the new unit momentum to out and returns the kinetic-energy change.
__device__ __forceinline__ float esh_block(const McChain& c, Reducer& red,
                                           const float* zg, const float* v,
                                           float gn2, float step,
                                           float* out) {
  const float dm1 = (float)(c.d - 1);
  const float gn = sqrtf(gn2);
  float a[1];
  for (int i = 0; i < c.n; ++i) {
    const int j = threadIdx.x + i * LD_T;
    float term = 0.0f;
    if (j < c.d) {
      const float gh = zg[j] / gn;
      c.gh[j] = gh;
      term = v[j] * gh;
    }
    acc(a[0], i, term);
  }
  red.sum(a);
  const float alpha = a[0];
  const float delta = step * gn / dm1;
  const float zeta = expf(-delta);
  const float cg = (1.0f - zeta) * (1.0f + zeta + alpha * (1.0f - zeta));
  const float tz2 = 2.0f * zeta;
  float n2[1];
  for (int i = 0; i < c.n; ++i) {
    const int j = threadIdx.x + i * LD_T;
    float term = 0.0f;
    if (j < c.d) {
      const float vr = cg * c.gh[j] + tz2 * v[j];
      out[j] = vr;
      term = vr * vr;
    }
    acc(n2[0], i, term);
  }
  red.sum(n2);
  mc_divide(c, out, sqrtf(n2[0]));
  return (delta - (float)0.69314718055994530942 +
          logf((1.0f + alpha) + (1.0f - alpha) * zeta * zeta)) *
         dm1;
}

// One leapfrog attempt with the halving stack (mclmc.rs:274-359): refresh,
// leapfrog with the model in its eval_block form, energy check.  On success
// the post-step refresh (noise at salts salt, salt+1) and the next noise
// (salt+2, salt+3) at (seed, it) are drawn and the stack unwinds; on a
// divergence the state stays at its pre-refresh values, the factor halves
// and the remaining count is pushed, or, with the stack full, the draw gives
// up.  Returns MC_CONTINUE, MC_DONE (remaining count reached 0) or
// MC_GAVE_UP, the same in every thread.
template <bool MICRO, int H, class Model>
__device__ __forceinline__ int leapfrog_try_block(
    const McChain& c, McScalars<H>& s, Reducer& red, const Model& model,
    float* scratch, float step, int nsd, float ld, const McConst& k,
    uint32_t seed, uint32_t it, uint32_t salt, int b, int B) {
  const int d = c.d;
  const int t0 = threadIdx.x;
  const float f = s.factor;
  const float eps = step * f;
  const float half = eps / 2.0f;

  // ---- pre-step refresh with the carried noise, into vr ----
  float ke_r, gn2 = 0.0f;
  if (MICRO) {
    const float nu = sqrtf((expf(2.0f * half / k.ell) - 1.0f) / (float)d);
    float r[2];  // |vr|^2, |zg|^2 (the first ESH half step's)
    for (int i = 0; i < c.n; ++i) {
      const int j = t0 + i * LD_T;
      float t_v = 0.0f, t_g = 0.0f;
      if (j < d) {
        const float vr = c.v[j] + nu * c.noise[j];
        c.vr[j] = vr;
        t_v = vr * vr;
        t_g = c.zg[j] * c.zg[j];
      }
      acc(r[0], i, t_v);
      acc(r[1], i, t_g);
    }
    red.sum(r);
    mc_divide(c, c.vr, sqrtf(r[0]));
    gn2 = r[1];
    ke_r = s.ke;
  } else {
    const float alpha = expf(-half / k.ell);
    const float beta = sqrtf(1.0f - alpha * alpha);
    float r[1];
    for (int i = 0; i < c.n; ++i) {
      const int j = t0 + i * LD_T;
      float t_v = 0.0f;
      if (j < d) {
        const float vr = alpha * c.v[j] + beta * c.noise[j];
        c.vr[j] = vr;
        t_v = vr * vr;
      }
      acc(r[0], i, t_v);
    }
    red.sum(r);
    ke_r = 0.5f * r[0];
  }
  const float base = ke_r - (s.logp + ld);

  // ---- leapfrog ----
  float logp1, ke2;
  if (MICRO) {
    const float ke1 =
        ke_r + esh_block(c, red, c.zg, c.vr, gn2, k.sqrt_n * eps / 2.0f, c.v1);
    const float es = eps * k.sqrt_n;
    for (int j = t0; j < d; j += LD_T) {
      const float z1 = c.z[j] + es * c.v1[j];
      c.z1[j] = z1;
      c.q1[j] = z1 * c.stds[j] + c.mean[j];
    }
    __syncthreads();
    logp1 = model.eval_block(c.q1, c.zg1, d, red, scratch);
    float g2[1];
    for (int i = 0; i < c.n; ++i) {
      const int j = t0 + i * LD_T;
      float term = 0.0f;
      if (j < d) {
        const float zg1 = c.zg1[j] * c.stds[j];
        c.zg1[j] = zg1;
        term = zg1 * zg1;
      }
      acc(g2[0], i, term);
    }
    red.sum(g2);
    ke2 = ke1 + esh_block(c, red, c.zg1, c.v1, g2[0],
                          k.sqrt_n * eps / 2.0f, c.v2);
  } else {
    for (int j = t0; j < d; j += LD_T) {
      const float v1 = c.vr[j] + half * c.zg[j];
      const float z1 = c.z[j] + eps * v1;
      c.v1[j] = v1;
      c.z1[j] = z1;
      c.q1[j] = z1 * c.stds[j] + c.mean[j];
    }
    __syncthreads();
    logp1 = model.eval_block(c.q1, c.zg1, d, red, scratch);
    float r[1];
    for (int i = 0; i < c.n; ++i) {
      const int j = t0 + i * LD_T;
      float term = 0.0f;
      if (j < d) {
        const float zg1 = c.zg1[j] * c.stds[j];
        const float v2 = c.v1[j] + half * zg1;
        c.zg1[j] = zg1;
        c.v2[j] = v2;
        term = v2 * v2;
      }
      acc(r[0], i, term);
    }
    red.sum(r);
    ke2 = 0.5f * r[0];
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

  // ---- success: the post-step refresh into v, the new point, next noise ----
  float nu = 0.0f, alpha = 0.0f, beta = 0.0f;
  if (MICRO) {
    nu = sqrtf((expf(2.0f * half / k.ell) - 1.0f) / (float)d);
  } else {
    alpha = expf(-half / k.ell);
    beta = sqrtf(1.0f - alpha * alpha);
  }
  float r3[1];
  for (int i = 0; i < c.n; ++i) {
    const int j = t0 + i * LD_T;
    float term = 0.0f;
    if (j < d) {
      const uint32_t site = (uint32_t)j * (uint32_t)B + (uint32_t)b;
      const float n1 = normal(seed, it, salt, salt + 1u, site);
      const float vr = MICRO ? c.v2[j] + nu * n1 : alpha * c.v2[j] + beta * n1;
      c.v[j] = vr;
      term = vr * vr;
      c.z[j] = c.z1[j];
      c.zg[j] = c.zg1[j];
      c.noise[j] = normal(seed, it, salt + 2u, salt + 3u, site);
    }
    acc(r3[0], i, term);
  }
  red.sum(r3);
  if (MICRO) {
    mc_divide(c, c.v, sqrtf(r3[0]));
    s.ke = ke2;
  } else {
    s.ke = 0.5f * r3[0];
  }
  s.logp = logp1;
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

// The momentum a give-up draw emits, into v: fresh normals at (salt,
// salt+1), on the unit sphere for the microcanonical kind.  Returns its
// kinetic energy (0 for the microcanonical kind).
template <bool MICRO>
__device__ __forceinline__ float give_up_momentum_block(
    const McChain& c, Reducer& red, uint32_t seed, uint32_t it, uint32_t salt,
    int b, int B) {
  for (int j = threadIdx.x; j < c.d; j += LD_T)
    c.v[j] = normal(seed, it, salt, salt + 1u,
                    (uint32_t)j * (uint32_t)B + (uint32_t)b);
  const float s2 = mc_sumsq(c, red, c.v);
  if (MICRO) {
    mc_divide(c, c.v, sqrtf(s2));
    return 0.0f;
  }
  return 0.5f * s2;
}

}  // namespace nrt
