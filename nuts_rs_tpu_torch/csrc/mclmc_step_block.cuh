// MCLMC pieces of the block-form mid-d fused kernels (K3-args, K4-args): the
// trajectory of one chain on the T threads of a CUDA block, or, in the pair
// form, on each of the two CUDA blocks of a cluster.
//
// Counterpart of the ESH half step, the partial momentum refresh and the
// step-halving stack of nuts_rs_tpu/kernels/mclmc_pallas.py (:132-169,
// :202-282, repeated in make_mclmc_warmup_kernel :577-746) with the model
// evaluated as logp_grad_batched(q, *model_args) (:122-125); the
// thread-per-chain form is mclmc_step.cuh, the plain PyTorch version
// nuts_rs_tpu_torch/kernels/mclmc_fused.py (_esh, _refresh, _leapfrog_try)
// with the "mid" evaluators.
//
// Every sum over d takes ops.py::tsum's order over its 256 slots.  A chain
// runs on T = 256 or, in the pair form, 128 threads a block
// (mc_block_form): thread t holds the slots t + T s (s < 256 / T), slot s
// the coordinates t + T s + 256 i in ascending i, so it owns the coordinates j = t, t + T, ... of every vector
// of its chain, in shared memory, and touches no other thread's
// coordinates; the only shared reads are the model's, of the whole new
// position, after one __syncthreads.  Sums go through TeamReducer
// (block_sum.cuh), whose tree is Reducer::sum's.  Scalars (energies, the
// step factor, the halving stack, the counters, the scalar random sites) are
// computed by every thread from the same inputs, so control flow is uniform
// within the block.  Every expression keeps the Pallas grouping: gh = zg /
// gn before alpha = sum(v * gh), log((1 + a) + (1 - a) z^2) for log1p,
// exp(x) - 1 for expm1, divisions by float(d - 1) and float(d).
//
// The pair form (X = 2, the regression): both CUDA blocks of a cluster run
// the same trajectory on the same bits, each on T = 128 threads; only the
// model's rows are split between them (models.cuh,
// LogisticRegression::eval_pair), so that each block holds half of the data
// in its shared memory.  The first block writes the chain's outputs.
//
// The sums of one iteration depend on each other (a norm, then the vector it
// normalises, then that vector's dot), so they are separate reductions, one
// barrier each: 8 and the model's own for a microcanonical iteration (the
// norm of the carried gradient shares the pre-step refresh's reduction,
// which changes no rounding), 3 and the model's for a Euclidean one.
//
// Timing ablations (profile_main_path.py item 22; they change results):
// NRT_ABLATE_MCLMC_NORMALS takes a value from the site alone instead of the
// hashed normals, NRT_ABLATE_MCLMC_DIVISIONS __fdividef for the
// per-coordinate quotients (mclmc_step.cuh::coord_div), NRT_ABLATE_EVAL
// leaves the model's evaluation out (logp 0, gradient -q).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "block_sum.cuh"
#include "mclmc_step.cuh"    // McConst, num_steps_for, MAX_HALVINGS, MC_*
#include "models.cuh"        // the functors' forms, glm_pair_floats
#include "nuts_tree_ld.cuh"  // ClusterMax, LD_MAX_CLUSTER
#include "rng.cuh"

namespace nrt {

// live vectors of a chain in shared memory (McChain's)
constexpr int MC_MID_NVEC = 15;

// One chain's vectors, d floats of shared memory each.
struct McChain {
  int d, n;  // n = ceil(d / LD_T): coordinates a slot may own
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

// The block form of a launch (mclmc_fused_mid_*.cu): T threads a chain's
// block and X blocks a chain.  The pair form (T = 128, X = 2) for the
// regression under the Euclidean dynamics (its microcanonical draws take the
// group form) where its rows fit two blocks' shared memory and the logical
// chain block is one chain (its exchange waits at the cluster's barrier,
// which every block of the cluster must reach at the same point, and the
// chains of a larger block do not); else T = 256, X = 1, the form every
// launch took before (128 and 64 threads a chain without the pair lost to
// it at d = 400, PERF.md section 6).  _build.mclmc_block_form is the same
// rule, and a launch checks that the two agree.
struct McBlockForm {
  int T, X;
};

// Shared memory of the pair form's blocks, in bytes: the chain's part and
// the regression's half of the data (glm_pair_floats).
__host__ __device__ inline size_t mc_pair_bytes(int d, int N) {
  return 4 * (mc_smem_floats(d) + glm_pair_floats(d, N));
}

constexpr size_t MC_SMEM_OPT_IN = 232448;  // a block's opt-in on sm_90

__host__ __device__ inline McBlockForm mc_block_form(int d, int model_id,
                                                     int N, int B,
                                                     int micro) {
  if (model_id == MODEL_LOGISTIC_REGRESSION && !micro && B == 1 &&
      mc_pair_bytes(d, N) <= MC_SMEM_OPT_IN)
    return {128, 2};
  return {LD_T, 1};
}

template <int H>
__device__ __forceinline__ void start_trajectory(McScalars<H>& s, int nsd) {
  s.rem = nsd;
  s.factor = 1.0f;
  s.ssize = 0;
  s.steps = 0;
  s.ttime = 0.0f;
}

// The standard normal of a vector site (see the ablation above).
__device__ __forceinline__ float site_normal(uint32_t seed, uint32_t it,
                                             uint32_t salt1, uint32_t salt2,
                                             uint32_t site) {
#ifdef NRT_ABLATE_MCLMC_NORMALS
  return 0.25f * (float)((site + it + salt1) % 7u) - 0.75f +
         0.0f * (float)(seed + salt2);
#else
  return normal(seed, it, salt1, salt2, site);
#endif
}

// The N terms of every coordinate the thread's slots own, accumulated per
// slot in tsum's order into p: term(j, t) gives coordinate j < d's terms
// (and may write the thread's own coordinate j); 0.0 past d.
template <int T, int N, class F>
__device__ __forceinline__ void team_terms(const McChain& c, F&& term,
                                           float (&p)[LD_T / T][N]) {
#pragma unroll
  for (int s = 0; s < LD_T / T; ++s)
    for (int i = 0; i < c.n; ++i) {
      const int j = (int)threadIdx.x + T * s + LD_T * i;
      float t[N];
      if (j < c.d) {
        term(j, t);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) t[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) acc(p[s][k], i, t[k]);
    }
}

// The chain's model evaluation in the block form's shape (models.cuh):
// eval_block on 256 threads, eval_pair over the pair.
template <int T, int X, class Model>
__device__ __forceinline__ float team_eval(const Model& model, const float* q,
                                           float* g, int d,
                                           TeamReducer<T>& red,
                                           float* scratch) {
#ifdef NRT_ABLATE_EVAL  // timing ablation: no evaluation, logp 0, g = -q
  for (int j = threadIdx.x; j < d; j += T) g[j] = -q[j];
  return 0.0f;
#endif
  if constexpr (X == 2)
    return model.eval_pair(q, g, d, red, scratch);
  else
    return model.eval_block(q, g, d, red.r, scratch);
}

// sum(a * a) over the chain's coordinates.
template <int T>
__device__ __forceinline__ float mc_sumsq(const McChain& c,
                                          TeamReducer<T>& red,
                                          const float* a) {
  float p[LD_T / T][1], s[1];
  team_terms<T>(c, [&](int j, float (&t)[1]) { t[0] = a[j] * a[j]; }, p);
  red.sum(p, s);
  return s[0];
}

// a[j] = a[j] / x on the thread's coordinates.
template <int T>
__device__ __forceinline__ void mc_divide(const McChain& c, float* a,
                                          float x) {
  for (int j = threadIdx.x; j < c.d; j += T) a[j] = coord_div(a[j], x);
}

// ESH momentum half-step (math.rs:188-204) with gn2 = sum(zg * zg) given:
// writes the new unit momentum to out and returns the kinetic-energy change.
template <int T>
__device__ __forceinline__ float esh_block(const McChain& c,
                                           TeamReducer<T>& red,
                                           const float* zg, const float* v,
                                           float gn2, float step,
                                           float* out) {
  const float dm1 = (float)(c.d - 1);
  const float gn = sqrtf(gn2);
  float p[LD_T / T][1], a[1];
  team_terms<T>(
      c,
      [&](int j, float (&t)[1]) {
        const float gh = coord_div(zg[j], gn);
        c.gh[j] = gh;
        t[0] = v[j] * gh;
      },
      p);
  red.sum(p, a);
  const float alpha = a[0];
  const float delta = step * gn / dm1;
  const float zeta = expf(-delta);
  const float cg = (1.0f - zeta) * (1.0f + zeta + alpha * (1.0f - zeta));
  const float tz2 = 2.0f * zeta;
  float n2[1];
  team_terms<T>(
      c,
      [&](int j, float (&t)[1]) {
        const float vr = cg * c.gh[j] + tz2 * v[j];
        out[j] = vr;
        t[0] = vr * vr;
      },
      p);
  red.sum(p, n2);
  mc_divide<T>(c, out, sqrtf(n2[0]));
  return (delta - (float)0.69314718055994530942 +
          logf((1.0f + alpha) + (1.0f - alpha) * zeta * zeta)) *
         dm1;
}

// One leapfrog attempt with the halving stack (mclmc.rs:274-359): refresh,
// leapfrog with the model in its block-form shape, energy check.  On success
// the post-step refresh (noise at salts salt, salt+1) and the next noise
// (salt+2, salt+3) at (seed, it) are drawn and the stack unwinds; on a
// divergence the state stays at its pre-refresh values, the factor halves
// and the remaining count is pushed, or, with the stack full, the draw gives
// up.  Returns MC_CONTINUE, MC_DONE (remaining count reached 0) or
// MC_GAVE_UP, the same in every thread.
template <bool MICRO, int H, int T, int X, class Model>
__device__ __forceinline__ int leapfrog_try_block(
    const McChain& c, McScalars<H>& s, TeamReducer<T>& red,
    const Model& model, float* scratch, float step, int nsd, float ld,
    const McConst& k, uint32_t seed, uint32_t it, uint32_t salt, int b,
    int B) {
  constexpr int S = LD_T / T;
  const int d = c.d;
  const int t0 = threadIdx.x;
  const float f = s.factor;
  const float eps = step * f;
  const float half = eps / 2.0f;
  float p1[S][1];
  MC_MARK(-1);

  // ---- pre-step refresh with the carried noise, into vr ----
  float ke_r, gn2 = 0.0f;
  if (MICRO) {
    const float nu = sqrtf((expf(2.0f * half / k.ell) - 1.0f) / (float)d);
    float p2[S][2], r[2];  // |vr|^2, |zg|^2 (the first ESH half step's)
    team_terms<T>(
        c,
        [&](int j, float (&t)[2]) {
          const float vr = c.v[j] + nu * c.noise[j];
          c.vr[j] = vr;
          t[0] = vr * vr;
          t[1] = c.zg[j] * c.zg[j];
        },
        p2);
    red.sum(p2, r);
    mc_divide<T>(c, c.vr, sqrtf(r[0]));
    gn2 = r[1];
    ke_r = s.ke;
  } else {
    const float alpha = expf(-half / k.ell);
    const float beta = sqrtf(1.0f - alpha * alpha);
    float r[1];
    team_terms<T>(
        c,
        [&](int j, float (&t)[1]) {
          const float vr = alpha * c.v[j] + beta * c.noise[j];
          c.vr[j] = vr;
          t[0] = vr * vr;
        },
        p1);
    red.sum(p1, r);
    ke_r = 0.5f * r[0];
  }
  const float base = ke_r - (s.logp + ld);
  MC_MARK(0);

  // ---- leapfrog ----
  float logp1, ke2;
  if (MICRO) {
    const float ke1 = ke_r + esh_block<T>(c, red, c.zg, c.vr, gn2,
                                          k.sqrt_n * eps / 2.0f, c.v1);
    const float es = eps * k.sqrt_n;
    for (int j = t0; j < d; j += T) {
      const float z1 = c.z[j] + es * c.v1[j];
      c.z1[j] = z1;
      c.q1[j] = z1 * c.stds[j] + c.mean[j];
    }
    __syncthreads();
    logp1 = team_eval<T, X>(model, c.q1, c.zg1, d, red, scratch);
    MC_MARK(1);
    float g2[1];
    team_terms<T>(
        c,
        [&](int j, float (&t)[1]) {
          const float zg1 = c.zg1[j] * c.stds[j];
          c.zg1[j] = zg1;
          t[0] = zg1 * zg1;
        },
        p1);
    red.sum(p1, g2);
    ke2 = ke1 + esh_block<T>(c, red, c.zg1, c.v1, g2[0],
                             k.sqrt_n * eps / 2.0f, c.v2);
  } else {
    for (int j = t0; j < d; j += T) {
      const float v1 = c.vr[j] + half * c.zg[j];
      const float z1 = c.z[j] + eps * v1;
      c.v1[j] = v1;
      c.z1[j] = z1;
      c.q1[j] = z1 * c.stds[j] + c.mean[j];
    }
    __syncthreads();
    logp1 = team_eval<T, X>(model, c.q1, c.zg1, d, red, scratch);
    MC_MARK(1);
    float r[1];
    team_terms<T>(
        c,
        [&](int j, float (&t)[1]) {
          const float zg1 = c.zg1[j] * c.stds[j];
          const float v2 = c.v1[j] + half * zg1;
          c.zg1[j] = zg1;
          c.v2[j] = v2;
          t[0] = v2 * v2;
        },
        p1);
    red.sum(p1, r);
    ke2 = 0.5f * r[0];
  }
  const float err = (ke2 - (logp1 + ld)) - base;
  const float max_err_step = (k.max_err / (float)nsd) * f;
  const bool bad = MICRO ? fabsf(err) >= max_err_step : err > max_err_step;
  MC_MARK(2);
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
  team_terms<T>(
      c,
      [&](int j, float (&t)[1]) {
        const uint32_t site = (uint32_t)j * (uint32_t)B + (uint32_t)b;
        const float n1 = site_normal(seed, it, salt, salt + 1u, site);
        const float vr =
            MICRO ? c.v2[j] + nu * n1 : alpha * c.v2[j] + beta * n1;
        c.v[j] = vr;
        t[0] = vr * vr;
        c.z[j] = c.z1[j];
        c.zg[j] = c.zg1[j];
        c.noise[j] = site_normal(seed, it, salt + 2u, salt + 3u, site);
      },
      p1);
  red.sum(p1, r3);
  if (MICRO) {
    mc_divide<T>(c, c.v, sqrtf(r3[0]));
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
  MC_MARK(3);
  return s.rem == 0 ? MC_DONE : MC_CONTINUE;
}

// The momentum a give-up draw emits, into v: fresh normals at (salt,
// salt+1), on the unit sphere for the microcanonical kind.  Returns its
// kinetic energy (0 for the microcanonical kind).
template <bool MICRO, int T>
__device__ __forceinline__ float give_up_momentum_block(
    const McChain& c, TeamReducer<T>& red, uint32_t seed, uint32_t it,
    uint32_t salt, int b, int B) {
  for (int j = threadIdx.x; j < c.d; j += T)
    c.v[j] = site_normal(seed, it, salt, salt + 1u,
                         (uint32_t)j * (uint32_t)B + (uint32_t)b);
  const float s2 = mc_sumsq<T>(c, red, c.v);
  if (MICRO) {
    mc_divide<T>(c, c.v, sqrtf(s2));
    return 0.0f;
  }
  return 0.5f * s2;
}

// A chain's place in its launch: chain c of logical block (cluster) lane b
// of B, its block `rank` of X in the chain (0: the one that writes).
template <int X>
struct McPlace {
  int c, b, B, rank;
  __device__ __forceinline__ static McPlace get() {
    cg::cluster_group cluster = cg::this_cluster();
    const int r = (int)cluster.block_rank();
    return {(int)blockIdx.x / X, r / X, (int)cluster.num_blocks() / X,
            r % X};
  }
};

// Launch a block-form kernel: C chains of X blocks of T threads, a thread
// block cluster of B X blocks each logical chain block.
template <class Kernel, class Args, class Model>
cudaError_t mc_block_launch(Kernel kernel, const Args& a, const Model& model,
                            int C, int B, int T, int X, size_t smem_bytes,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * X));
  cfg.blockDim = dim3((unsigned)T);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)(B * X);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, model);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether a functor has eval_pair (PAIR).
template <class M, class = void>
struct pair_form : std::false_type {};
template <class M>
struct pair_form<M, std::void_t<decltype(M::PAIR)>>
    : std::bool_constant<M::PAIR> {};

// Dispatch a launch to its form's instantiation: fn(std::integral_constant
// T, X) for a model that has the form's evaluation; cudaErrorInvalidValue
// for a form the rule never gives the model.  The caller instantiates the
// pair form for the Euclidean dynamics alone.
template <class Model, class Fn>
cudaError_t with_block_form(McBlockForm form, Fn&& fn) {
  if (form.X == 2) {
    if constexpr (pair_form<Model>::value)
      return fn(std::integral_constant<int, 128>{},
                std::integral_constant<int, 2>{});
    return cudaErrorInvalidValue;
  }
  if (form.T != LD_T) return cudaErrorInvalidValue;
  return fn(std::integral_constant<int, LD_T>{},
            std::integral_constant<int, 1>{});
}

}  // namespace nrt
