// Fused lock-step MCLMC warmup with in-kernel adaptation (kernel K4).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/mclmc_pallas.py::make_mclmc_warmup_kernel (:504),
// launched by mclmc_pallas_warmup_run (:887, pallas_call :992), with the
// plain diagonal evaluation.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py::mclmc_fused_warmup_run_reference.
//
// An outer loop runs over the launch's K draws with the host's schedule
// flags for each draw (FLAG_* columns of mclmc_fused.py; column 6 resamples
// the momentum); each draw takes the FIXED step with its jitter, and an
// inner loop runs leapfrog attempts until every chain of the block finished
// its trajectory, with every update gated on the chain still being active.
// Between draws each thread feeds the trajectory end to its chain's fg/bg
// estimators and applies the window switch and the diagonal rule
// (diag_adapt.cuh, shared with the NUTS warmup kernel), while the emitted
// draw reverts to the draw start with fresh momentum on a give-up
// (mclmc.rs:361-394).
//
// What bounds it on this card: the latency of one chain's dependent scalar
// work, plus the wait for the block's longest trajectory in each draw.  What
// the design does about it: a chain's coordinates on a group of T lanes, as
// in K3 (mclmc_step.cuh, mclmc_lanes), each lane with its coordinates'
// state and eight estimator rows, the adaptation by diag_adapt.cuh's
// one-coordinate functions on each lane and logdet = -sum log stds by the
// ordered gather; one CUDA block per logical chain block of B chains, so the
// wait is over B chains and not the whole chunk; the loop condition is
// __syncthreads_or.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "diag_adapt.cuh"
#include "mclmc_step.cuh"
#include "models.cuh"
#include "rng.cuh"
#include "nrt_sizes.h"  // NRT_FOR_EACH_DIM(X), generated by _build.py

namespace nrt {

// flags columns and packed scalar rows, as mclmc_fused.py FLAG_* / SCA_*
enum { MF_UPD_EST = 0, MF_DO_UPDATE = 1, MF_DO_SWITCH = 5, MF_RESAMPLE = 6,
       MF_NFLAGS = 8 };
enum { MS_TID = 0, MS_LOGDET, MS_CNT_FG, MS_CNT_BG, MS_NSCA };

struct McWarmArgs {
  int C, K;
  uint32_t seed;
  McConst k;
  float fixed_step;
  int has_jitter;
  float jc1, jc2;
  int use_grad_based;
  const int* flags;
  const float *q, *g, *logp, *v, *stds, *mean, *est, *sca;
  float *draws, *stats, *q_f, *g_f, *logp_f, *v_f, *stds_f, *mean_f, *est_f,
      *sca_f;
  int* iters;
};

template <int DIM, int T, bool MICRO, int H, class Model>
__global__ void __launch_bounds__(T * MAX_BLOCK < MAX_THREADS ? T * MAX_BLOCK
                                                              : MAX_THREADS)
    mclmc_warmup_kernel(const McWarmArgs a, const Model model) {
  constexpr int NC = slots<DIM, T>();
  const Lane<T> ln;
  const int B = blockDim.x / T;
  const int b = threadIdx.x / T;
  const int c = blockIdx.x * B + b;
  const int C = a.C;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)blockIdx.x;
  const McConst& k = a.k;
  // salts shift by one when the jitter draw (salt 1) is present
  const uint32_t sj = a.has_jitter ? 1u : 0u;

  float q[NC], g[NC], v[NC], stds[NC], mean[NC];
  float est[NEST][NC];
  float sca[MS_NSCA];
  float logp = a.logp[c];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int j = ln.lane + T * i;
    const bool own = j < DIM;
    q[i] = own ? a.q[c * DIM + j] : 0.0f;
    g[i] = own ? a.g[c * DIM + j] : 0.0f;
    v[i] = own ? a.v[c * DIM + j] : 0.0f;
    stds[i] = own ? a.stds[c * DIM + j] : 1.0f;
    mean[i] = own ? a.mean[c * DIM + j] : 0.0f;
#pragma unroll
    for (int p = 0; p < NEST; ++p)
      est[p][i] = own ? a.est[(c * NEST + p) * DIM + j] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < MS_NSCA; ++r) sca[r] = a.sca[c * MS_NSCA + r];

  McState<DIM, T, H> s;
  float z0[NC], zg0[NC];
  uint32_t it = 1;
  for (int i = 0; i < a.K; ++i) {
    const int* fl = a.flags + i * MF_NFLAGS;
    const float logdet = sca[MS_LOGDET];
    float step = a.fixed_step;
    if (a.has_jitter)
      step = step * (a.jc1 + a.jc2 * uniform(seed, it, 1u, (uint32_t)b));
    const int nsd = num_steps_for(step, k);

    // ---- fresh trajectory (initialize_trajectory semantics) ----
    if (fl[MF_RESAMPLE] != 0) {
      lane_normals<DIM, T>(v, seed, it, 1u + sj, 2u + sj, b, B, ln);
      if (MICRO) {
        const float nrm = sqrtf(ordered_dot<DIM, T>(v, v, ln));
#pragma unroll
        for (int m = 0; m < NC; ++m) v[m] = v[m] / nrm;
      }
    }
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      z0[m] = (q[m] - mean[m]) / stds[m];
      zg0[m] = g[m] * stds[m];
      s.z[m] = z0[m];
      s.zg[m] = zg0[m];
      s.v[m] = v[m];
    }
    lane_normals<DIM, T>(s.noise, seed, it, 3u + sj, 4u + sj, b, B, ln);
    s.logp = logp;
    s.ke = MICRO ? 0.0f : 0.5f * ordered_dot<DIM, T>(v, v, ln);
    const float e_init = s.ke - (logp + logdet);
    start_trajectory(s, nsd);

    bool done = false, div = false;
    while (__syncthreads_or(!done)) {
      if (!done) {
        const int r = leapfrog_try<DIM, T, MICRO, H>(
            s, step, nsd, logdet, stds, mean, model, k, seed, it, 5u + sj, b,
            B, ln);
        done = r != MC_CONTINUE;
        div = r == MC_GAVE_UP;
      }
      it += 1;
    }

    // ---- adaptation: the collector sees the trajectory end ----
    float q_coll[NC], g_coll[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      q_coll[m] = s.z[m] * stds[m] + mean[m];
      g_coll[m] = s.zg[m] / stds[m];
    }
    const bool is_good = (div && s.steps > 4) || (!div && s.steps != 0);
    const float e_change = (s.ke - (s.logp + logdet)) - e_init;

    // ---- emitted draw: the trajectory end, or on a give-up the draw start
    // with fresh momentum ----
    float em_ke = s.ke, em_logp = s.logp;
    float e[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const float em_z = div ? z0[m] : s.z[m];
      const float em_zg = div ? zg0[m] : s.zg[m];
      e[m] = em_z + em_zg;
      q[m] = em_z * stds[m] + mean[m];
      g[m] = em_zg / stds[m];
      const int j = ln.lane + T * m;
      if (j < DIM) a.draws[((size_t)i * DIM + j) * C + c] = q[m];
    }
    if (div) {
      em_ke = give_up_momentum<DIM, T, MICRO>(seed, it, 9u + sj, b, B, v, ln);
      em_logp = logp;
    } else {
#pragma unroll
      for (int m = 0; m < NC; ++m) v[m] = s.v[m];
    }
    const float fisher = ordered_dot<DIM, T>(e, e, ln);
    logp = em_logp;

    sca[MS_LOGDET] = adapt_draw_lanes<DIM, T>(
        est, sca[MS_CNT_FG], sca[MS_CNT_BG], sca[MS_TID], stds, mean, q_coll,
        g_coll, (fl[MF_UPD_EST] != 0) && is_good, fl[MF_DO_SWITCH] != 0,
        fl[MF_DO_UPDATE] != 0, a.use_grad_based != 0, ln);

    // ---- emit row i ----
    if (ln.lane == 0) {
      const float row[NSTATS_MW] = {
          div ? 1.0f : 0.0f, (float)s.steps, e_change,
          s.ttime / (float)max(s.steps, 1), step, em_logp,
          em_ke - (em_logp + logdet), fisher, sca[MS_TID]};
#pragma unroll
      for (int t = 0; t < NSTATS_MW; ++t)
        a.stats[((size_t)i * NSTATS_MW + t) * C + c] = row[t];
    }
  }

#pragma unroll
  for (int m = 0; m < NC; ++m) {
    const int j = ln.lane + T * m;
    if (j < DIM) {
      a.q_f[c * DIM + j] = q[m];
      a.g_f[c * DIM + j] = g[m];
      a.v_f[c * DIM + j] = v[m];
      a.stds_f[c * DIM + j] = stds[m];
      a.mean_f[c * DIM + j] = mean[m];
#pragma unroll
      for (int p = 0; p < NEST; ++p)
        a.est_f[(c * NEST + p) * DIM + j] = est[p][m];
    }
  }
  if (ln.lane == 0) {
#pragma unroll
    for (int r = 0; r < MS_NSCA; ++r) a.sca_f[c * MS_NSCA + r] = sca[r];
    a.logp_f[c] = logp;
    a.iters[c] = (int)it;
  }
}

template <int DIM, int T, bool MICRO, int H>
cudaError_t launch_mclmc_warmup(const McWarmArgs& a, int B, int model_id,
                                const float* params, cudaStream_t stream) {
  if (model_id != MODEL_IID_NORMAL) return cudaErrorInvalidValue;
  mclmc_warmup_kernel<DIM, T, MICRO, H, IidNormal>
      <<<a.C / B, B * T, 0, stream>>>(a, IidNormal{params[0]});
  return cudaGetLastError();
}

// As launch_mclmc_posterior_lanes (mclmc_fused_posterior.cu).
template <int DIM, int T>
cudaError_t launch_mclmc_warmup_lanes(const McWarmArgs& a, int B, int micro,
                                      int dynamic, int model_id,
                                      const float* params,
                                      cudaStream_t stream) {
  if constexpr (mclmc_lanes_taken(DIM, T)) {
    if (micro && dynamic)
      return launch_mclmc_warmup<DIM, T, true, MAX_HALVINGS>(
          a, B, model_id, params, stream);
    if (micro)
      return launch_mclmc_warmup<DIM, T, true, 0>(a, B, model_id, params,
                                                  stream);
    if (dynamic)
      return launch_mclmc_warmup<DIM, T, false, MAX_HALVINGS>(
          a, B, model_id, params, stream);
    return launch_mclmc_warmup<DIM, T, false, 0>(a, B, model_id, params,
                                                 stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace nrt

// lanes: as nrt_mclmc_posterior_launch's.
extern "C" int nrt_mclmc_warmup_launch(
    int dim, int micro, int dynamic, int lanes, int C, int B, int K,
    uint32_t seed, float max_err, float ell, float fsub_ell, float sqrt_n,
    float fixed_step, int has_jitter, float jc1, float jc2,
    int use_grad_based, int model_id, const float* model_params,
    const int* flags, const float* q, const float* g, const float* logp,
    const float* v, const float* stds, const float* mean, const float* est,
    const float* sca, float* draws, float* stats, float* q_f, float* g_f,
    float* logp_f, float* v_f, float* stds_f, float* mean_f, float* est_f,
    float* sca_f, int* iters, void* stream) {
  if (B < 1 || B > nrt::MAX_BLOCK || C % B != 0 ||
      lanes != nrt::mclmc_lanes(dim, B) || B * lanes > nrt::MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const nrt::McWarmArgs a{C,      K,      seed,   {max_err, ell, fsub_ell, sqrt_n},
                          fixed_step, has_jitter, jc1, jc2, use_grad_based,
                          flags,  q,      g,      logp,   v,      stds,
                          mean,   est,    sca,    draws,  stats,  q_f,
                          g_f,    logp_f, v_f,    stds_f, mean_f, est_f,
                          sca_f,  iters};
  cudaStream_t s = (cudaStream_t)stream;
#define NRT_LANES(DIM_, T_)                                                \
  if (lanes == T_)                                                         \
    return (int)nrt::launch_mclmc_warmup_lanes<DIM_, T_>(                  \
        a, B, micro, dynamic, model_id, model_params, s);
#define NRT_CASE(DIM_)                                                     \
  if (dim == DIM_) {                                                       \
    NRT_LANES(DIM_, 1)                                                     \
    NRT_LANES(DIM_, 4)                                                     \
    NRT_LANES(DIM_, 8)                                                     \
    NRT_LANES(DIM_, 16)                                                    \
  }
  NRT_FOR_EACH_DIM(NRT_CASE)
#undef NRT_CASE
#undef NRT_LANES
  return (int)cudaErrorInvalidValue;
}
