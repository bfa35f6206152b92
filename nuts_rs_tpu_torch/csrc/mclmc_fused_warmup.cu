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
// What bounds it on this card: latency-bound scalar work per thread, plus the
// wait for the block's longest trajectory in each draw.  What the design
// does about it: one thread per chain, one warp-sized block per logical
// chain block, so the wait is over 32 chains and not the whole chunk; the
// loop condition is __syncthreads_or; state, the halving stack and the eight
// estimator planes stay in registers or local memory of the thread.

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

template <int DIM, bool MICRO, int H, class Model>
__global__ void __launch_bounds__(MAX_BLOCK)
    mclmc_warmup_kernel(const McWarmArgs a, const Model model) {
  const int B = blockDim.x;
  const int b = threadIdx.x;
  const int c = blockIdx.x * B + b;
  const int C = a.C;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)blockIdx.x;
  const McConst& k = a.k;
  // salts shift by one when the jitter draw (salt 1) is present
  const uint32_t sj = a.has_jitter ? 1u : 0u;

  float q[DIM], g[DIM], v[DIM], stds[DIM], mean[DIM];
  float est[NEST][DIM];
  float sca[MS_NSCA];
  float logp = a.logp[c];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    q[j] = a.q[c * DIM + j];
    g[j] = a.g[c * DIM + j];
    v[j] = a.v[c * DIM + j];
    stds[j] = a.stds[c * DIM + j];
    mean[j] = a.mean[c * DIM + j];
  }
#pragma unroll
  for (int p = 0; p < NEST; ++p)
#pragma unroll
    for (int j = 0; j < DIM; ++j) est[p][j] = a.est[(c * NEST + p) * DIM + j];
#pragma unroll
  for (int r = 0; r < MS_NSCA; ++r) sca[r] = a.sca[c * MS_NSCA + r];

  McState<DIM, H> s;
  float z0[DIM], zg0[DIM];
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
#pragma unroll
      for (int j = 0; j < DIM; ++j)
        v[j] = normal(seed, it, 1u + sj, 2u + sj, (uint32_t)(j * B + b));
      if (MICRO) {
        const float nrm = sqrtf(dot<DIM>(v, v));
#pragma unroll
        for (int j = 0; j < DIM; ++j) v[j] = v[j] / nrm;
      }
    }
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      z0[j] = (q[j] - mean[j]) / stds[j];
      zg0[j] = g[j] * stds[j];
      s.z[j] = z0[j];
      s.zg[j] = zg0[j];
      s.v[j] = v[j];
      s.noise[j] = normal(seed, it, 3u + sj, 4u + sj, (uint32_t)(j * B + b));
    }
    s.logp = logp;
    s.ke = MICRO ? 0.0f : 0.5f * dot<DIM>(v, v);
    const float e_init = s.ke - (logp + logdet);
    start_trajectory(s, nsd);

    bool done = false, div = false;
    while (__syncthreads_or(!done)) {
      if (!done) {
        const int r = leapfrog_try<DIM, MICRO, H>(s, step, nsd, logdet, stds,
                                                  mean, model, k, seed, it,
                                                  5u + sj, b, B);
        done = r != MC_CONTINUE;
        div = r == MC_GAVE_UP;
      }
      it += 1;
    }

    // ---- adaptation: the collector sees the trajectory end ----
    float q_coll[DIM], g_coll[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      q_coll[j] = s.z[j] * stds[j] + mean[j];
      g_coll[j] = s.zg[j] / stds[j];
    }
    const bool is_good = (div && s.steps > 4) || (!div && s.steps != 0);
    const float e_change = (s.ke - (s.logp + logdet)) - e_init;

    // ---- emitted draw: the trajectory end, or on a give-up the draw start
    // with fresh momentum ----
    float em_ke = s.ke, em_logp = s.logp;
    float em_z[DIM], em_zg[DIM];
    copy<DIM>(em_z, div ? z0 : s.z);
    copy<DIM>(em_zg, div ? zg0 : s.zg);
    if (div) {
      em_ke = give_up_momentum<DIM, MICRO>(seed, it, 9u + sj, b, B, v);
      em_logp = logp;
    } else {
      copy<DIM>(v, s.v);
    }
    float fisher = 0.0f;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float e = em_z[j] + em_zg[j];
      fisher = (j == 0) ? e * e : fisher + e * e;
      q[j] = em_z[j] * stds[j] + mean[j];
      g[j] = em_zg[j] / stds[j];
      a.draws[((size_t)i * DIM + j) * C + c] = q[j];
    }
    logp = em_logp;

    sca[MS_LOGDET] = adapt_draw<DIM>(
        est, sca[MS_CNT_FG], sca[MS_CNT_BG], sca[MS_TID], stds, mean, q_coll,
        g_coll, (fl[MF_UPD_EST] != 0) && is_good, fl[MF_DO_SWITCH] != 0,
        fl[MF_DO_UPDATE] != 0, a.use_grad_based != 0);

    // ---- emit row i ----
    const float row[NSTATS_MW] = {
        div ? 1.0f : 0.0f, (float)s.steps, e_change,
        s.ttime / (float)max(s.steps, 1), step, em_logp,
        em_ke - (em_logp + logdet), fisher, sca[MS_TID]};
#pragma unroll
    for (int t = 0; t < NSTATS_MW; ++t)
      a.stats[((size_t)i * NSTATS_MW + t) * C + c] = row[t];
  }

#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    a.q_f[c * DIM + j] = q[j];
    a.g_f[c * DIM + j] = g[j];
    a.v_f[c * DIM + j] = v[j];
    a.stds_f[c * DIM + j] = stds[j];
    a.mean_f[c * DIM + j] = mean[j];
  }
#pragma unroll
  for (int p = 0; p < NEST; ++p)
#pragma unroll
    for (int j = 0; j < DIM; ++j) a.est_f[(c * NEST + p) * DIM + j] = est[p][j];
#pragma unroll
  for (int r = 0; r < MS_NSCA; ++r) a.sca_f[c * MS_NSCA + r] = sca[r];
  a.logp_f[c] = logp;
  a.iters[c] = (int)it;
}

template <int DIM, bool MICRO, int H>
cudaError_t launch_mclmc_warmup(const McWarmArgs& a, int B, int model_id,
                                const float* params, cudaStream_t stream) {
  if (model_id != MODEL_IID_NORMAL) return cudaErrorInvalidValue;
  mclmc_warmup_kernel<DIM, MICRO, H, IidNormal>
      <<<a.C / B, B, 0, stream>>>(a, IidNormal{params[0]});
  return cudaGetLastError();
}

}  // namespace nrt

extern "C" int nrt_mclmc_warmup_launch(
    int dim, int micro, int dynamic, int C, int B, int K, uint32_t seed,
    float max_err, float ell, float fsub_ell, float sqrt_n, float fixed_step,
    int has_jitter, float jc1, float jc2, int use_grad_based, int model_id,
    const float* model_params, const int* flags, const float* q,
    const float* g, const float* logp, const float* v, const float* stds,
    const float* mean, const float* est, const float* sca, float* draws,
    float* stats, float* q_f, float* g_f, float* logp_f, float* v_f,
    float* stds_f, float* mean_f, float* est_f, float* sca_f, int* iters,
    void* stream) {
  if (B < 1 || B > nrt::MAX_BLOCK || C % B != 0)
    return (int)cudaErrorInvalidValue;
  const nrt::McWarmArgs a{C,      K,      seed,   {max_err, ell, fsub_ell, sqrt_n},
                          fixed_step, has_jitter, jc1, jc2, use_grad_based,
                          flags,  q,      g,      logp,   v,      stds,
                          mean,   est,    sca,    draws,  stats,  q_f,
                          g_f,    logp_f, v_f,    stds_f, mean_f, est_f,
                          sca_f,  iters};
  cudaStream_t s = (cudaStream_t)stream;
#define NRT_CASE(DIM_)                                                      \
  if (dim == DIM_) {                                                        \
    if (micro && dynamic)                                                   \
      return (int)nrt::launch_mclmc_warmup<DIM_, true, nrt::MAX_HALVINGS>(  \
          a, B, model_id, model_params, s);                                 \
    if (micro)                                                              \
      return (int)nrt::launch_mclmc_warmup<DIM_, true, 0>(                  \
          a, B, model_id, model_params, s);                                 \
    if (dynamic)                                                            \
      return (int)nrt::launch_mclmc_warmup<DIM_, false, nrt::MAX_HALVINGS>( \
          a, B, model_id, model_params, s);                                 \
    return (int)nrt::launch_mclmc_warmup<DIM_, false, 0>(                   \
        a, B, model_id, model_params, s);                                   \
  }
  NRT_FOR_EACH_DIM(NRT_CASE)
#undef NRT_CASE
  return (int)cudaErrorInvalidValue;
}
