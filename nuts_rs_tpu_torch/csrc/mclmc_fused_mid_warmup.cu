// Fused lock-step MCLMC warmup with in-kernel adaptation for data-carrying
// models and mid d (kernel K4-args).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/mclmc_pallas.py::make_mclmc_warmup_kernel (:504) with
// n_model_args > 0 (:506,532-536,574), launched by mclmc_pallas_warmup_run
// (:887; model_args :901,948-951,986-1000): K lock-step MCLMC tuning draws
// with the FIXED jittered step, the fg/bg estimators and the diagonal rule in
// the kernel, the model evaluated as logp_grad_batched(q, *model_args).  The
// launch of one chain group per pallas_call (:916-929) works around a Mosaic
// fault with identical streams and has no counterpart here: one launch takes
// every block.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py::mclmc_fused_warmup_run_reference
// on a model the mid-d kernels serve (nuts_fused.cl_kernel).
//
// The design is the one of K3-args (mclmc_fused_mid_posterior.cu: 256 threads
// a chain on mclmc_step_block.cuh, 15 live vectors in shared memory, the
// chains-on-lanes site index j * B + b, the model in its eval_block form with
// its data read through L2, every sum in ops.tsum's order), with the draw
// loop of K4 (mclmc_fused_warmup.cu): each draw re-derives z and zg from the
// chain's q and g under the current (stds, mean) and carries v verbatim
// unless the schedule resamples it; the adaptation sees the trajectory end;
// on a give-up the emitted draw is the draw start with fresh momentum.  The
// counter `it` is shared by the logical block and the give-up momentum is
// drawn at the block's `it` after the draw's last iteration, so the chains
// of a block stay in step from draw to draw: a chain runs its trajectory
// alone, counting from the draw's first counter, and one cluster barrier per
// draw (ClusterMax) gives the longest trajectory's count, by which every
// chain advances.  The adaptation runs per coordinate on diag_adapt.cuh's
// functions, the new logdet through the block reduction.  The chain's
// current q and g and the eight estimator planes, touched once per draw,
// stay in device memory (the output buffers, which the launcher fills with
// the inputs) as in K2-ld: eight more vectors of shared memory per block
// would buy nothing beside six evaluations a draw.
//
// What bounds it: as K3-args, plus the wait for the longest trajectory among
// the B chains of a block in every draw (none at the default B = 1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "diag_adapt.cuh"
#include "mclmc_step_block.cuh"
#include "models.cuh"

namespace nrt {

// flags columns and packed scalar rows, as mclmc_fused.py FLAG_* / SCA_*
enum { MM_UPD_EST = 0, MM_DO_UPDATE = 1, MM_DO_SWITCH = 5, MM_RESAMPLE = 6,
       MM_NFLAGS = 8 };
enum { MMS_TID = 0, MMS_LOGDET, MMS_CNT_FG, MMS_CNT_BG, MMS_NSCA };

struct McMidWarmArgs {
  int C, K, d;
  uint32_t seed;
  McConst k;
  float fixed_step;
  int has_jitter;
  float jc1, jc2;
  int use_grad_based;
  const int* flags;
  const float *logp, *v, *stds, *mean, *sca;
  // q_f, g_f and est_f hold the inputs q, g and est at launch
  float *draws, *stats, *q_f, *g_f, *logp_f, *v_f, *stds_f, *mean_f, *est_f,
      *sca_f;
  int* iters;
};

template <bool MICRO, int H, class Model>
__global__ void __launch_bounds__(LD_T)
    mclmc_mid_warmup_kernel(const McMidWarmArgs a, const Model model) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int B = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  const int c = blockIdx.x;
  const int C = a.C, d = a.d;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)(c / B);
  const McConst& k = a.k;
  const int t0 = threadIdx.x;
  // salts shift by one when the jitter draw (salt 1) is present
  const uint32_t sj = a.has_jitter ? 1u : 0u;

  McChain ch;
  float* p = mc_chain_layout(ch, d, smem);
  Reducer red{p, 0};
  p += 2 * LD_NRED * LD_W;
  ClusterMax longest{reinterpret_cast<uint32_t*>(p), 0};
  float* scratch = p + 2 * LD_MAX_CLUSTER;  // the model functor's
  float* q = a.q_f + (size_t)c * d;  // the chain's current point
  float* g = a.g_f + (size_t)c * d;
  float* est = a.est_f + (size_t)c * NEST * d;  // [NEST][d]

  float sca[MMS_NSCA];
#pragma unroll
  for (int r = 0; r < MMS_NSCA; ++r) sca[r] = a.sca[c * MMS_NSCA + r];
  float logp = a.logp[c];
  for (int j = t0; j < d; j += LD_T) {
    const size_t gj = (size_t)c * d + j;
    ch.stds[j] = a.stds[gj];
    ch.mean[j] = a.mean[gj];
    ch.v[j] = a.v[gj];
  }
  // every block of the cluster runs before any writes into its slots
  cluster.sync();

  McScalars<H> s;
  uint32_t it0 = 1;  // the block's counter at the draw's first iteration
  for (int i = 0; i < a.K; ++i) {
    uint32_t it = it0;
    const int* fl = a.flags + i * MM_NFLAGS;
    const float logdet = sca[MMS_LOGDET];
    float step = a.fixed_step;
    if (a.has_jitter)
      step = step * (a.jc1 + a.jc2 * uniform(seed, it, 1u, (uint32_t)b));
    const int nsd = num_steps_for(step, k);

    // ---- fresh trajectory (initialize_trajectory semantics) ----
    const bool resample = fl[MM_RESAMPLE] != 0;
    float vv[1];
    for (int ii = 0; ii < ch.n; ++ii) {
      const int j = t0 + ii * LD_T;
      float term = 0.0f;
      if (j < d) {
        const uint32_t site = (uint32_t)j * (uint32_t)B + (uint32_t)b;
        const float sd = ch.stds[j];
        const float z0 = (q[j] - ch.mean[j]) / sd;
        const float zg0 = g[j] * sd;
        ch.z[j] = ch.z0[j] = z0;
        ch.zg[j] = ch.zg0[j] = zg0;
        if (resample) ch.v[j] = normal(seed, it, 1u + sj, 2u + sj, site);
        ch.noise[j] = normal(seed, it, 3u + sj, 4u + sj, site);
        term = ch.v[j] * ch.v[j];
      }
      acc(vv[0], ii, term);
    }
    if (MICRO) {
      if (resample) {
        red.sum(vv);
        mc_divide(ch, ch.v, sqrtf(vv[0]));
      }
      s.ke = 0.0f;
    } else {
      red.sum(vv);
      s.ke = 0.5f * vv[0];
    }
    s.logp = logp;
    const float e_init = s.ke - (logp + logdet);
    start_trajectory(s, nsd);

    bool div = false;
    while (true) {
      const int r = leapfrog_try_block<MICRO, H>(ch, s, red, model, scratch,
                                                 step, nsd, logdet, k, seed,
                                                 it, 5u + sj, b, B);
      it += 1;
      if (r != MC_CONTINUE) {
        div = r == MC_GAVE_UP;
        break;
      }
    }
    it = it0 + longest.max(it - it0);
    it0 = it;

    // ---- the emitted draw: the trajectory end, or on a give-up the draw
    // start with fresh momentum; the adaptation sees the trajectory end ----
    const bool is_good = (div && s.steps > 4) || (!div && s.steps != 0);
    const float e_change = (s.ke - (s.logp + logdet)) - e_init;
    float em_ke = s.ke, em_logp = s.logp;
    if (div) {
      em_ke = give_up_momentum_block<MICRO>(ch, red, seed, it, 9u + sj, b, B);
      em_logp = logp;
    }
    const bool inc = (fl[MM_UPD_EST] != 0) && is_good;
    const bool do_switch = fl[MM_DO_SWITCH] != 0;
    const float cnt_fg_in = sca[MMS_CNT_FG] + 1.0f;  // counts after the draw
    const float cnt_bg_in = sca[MMS_CNT_BG] + 1.0f;
    float cnt_fg = sca[MMS_CNT_FG] + (inc ? 1.0f : 0.0f);
    float cnt_bg = sca[MMS_CNT_BG] + (inc ? 1.0f : 0.0f);
    if (do_switch) {
      cnt_fg = cnt_bg;
      cnt_bg = 0.0f;
    }
    const bool enough = (fl[MM_DO_UPDATE] != 0) && cnt_fg >= 3.0f;
    const bool grad_based = a.use_grad_based != 0;
    float* out = a.draws + ((size_t)i * C + c) * d;
    float s2[2];  // fisher distance, sum log stds
    for (int ii = 0; ii < ch.n; ++ii) {
      const int j = t0 + ii * LD_T;
      float fisher = 0.0f, lg = 0.0f;
      if (j < d) {
        float sd = ch.stds[j], mn = ch.mean[j];
        const float q_coll = ch.z[j] * sd + mn;
        const float g_coll = ch.zg[j] / sd;
        const float em_z = div ? ch.z0[j] : ch.z[j];
        const float em_zg = div ? ch.zg0[j] : ch.zg[j];
        const float fs = em_z + em_zg;
        fisher = fs * fs;
        const float em_q = em_z * sd + mn;
        out[j] = em_q;
        q[j] = em_q;
        g[j] = em_zg / sd;
        float e[NEST];
#pragma unroll
        for (int pl = 0; pl < NEST; ++pl) e[pl] = est[(size_t)pl * d + j];
        if (inc) {
          add2_coord(e[0], e[1], cnt_fg_in, q_coll);
          add2_coord(e[2], e[3], cnt_fg_in, g_coll);
          add2_coord(e[4], e[5], cnt_bg_in, q_coll);
          add2_coord(e[6], e[7], cnt_bg_in, g_coll);
        }
        if (do_switch) {
#pragma unroll
          for (int pl = 0; pl < 4; ++pl) {
            e[pl] = e[pl + 4];
            e[pl + 4] = 0.0f;
          }
        }
        if (inc || do_switch) {
#pragma unroll
          for (int pl = 0; pl < NEST; ++pl) est[(size_t)pl * d + j] = e[pl];
        }
        if (enough) {
          diag_rule_coord(e[0], e[1], e[2], e[3], cnt_fg, grad_based, sd, mn);
          ch.stds[j] = sd;
          ch.mean[j] = mn;
        }
        lg = logf(sd);
      }
      acc(s2[0], ii, fisher);
      acc(s2[1], ii, lg);
    }
    red.sum(s2);
    const float tid_n = sca[MMS_TID] + (enough ? 1.0f : 0.0f);

    // ---- emit row i ----
    if (t0 == 0) {
      const float row[NSTATS_MW] = {
          div ? 1.0f : 0.0f, (float)s.steps, e_change,
          s.ttime / (float)max(s.steps, 1), step, em_logp,
          em_ke - (em_logp + logdet), s2[0], tid_n};
      float* st = a.stats + ((size_t)i * C + c) * NSTATS_MW;
#pragma unroll
      for (int t = 0; t < NSTATS_MW; ++t) st[t] = row[t];
    }
    sca[MMS_TID] = tid_n;
    sca[MMS_LOGDET] = -s2[1];
    sca[MMS_CNT_FG] = cnt_fg;
    sca[MMS_CNT_BG] = cnt_bg;
    logp = em_logp;
  }

  for (int j = t0; j < d; j += LD_T) {
    const size_t gj = (size_t)c * d + j;
    a.v_f[gj] = ch.v[j];
    a.stds_f[gj] = ch.stds[j];
    a.mean_f[gj] = ch.mean[j];
  }
  if (t0 == 0) {
#pragma unroll
    for (int r = 0; r < MMS_NSCA; ++r) a.sca_f[c * MMS_NSCA + r] = sca[r];
    a.logp_f[c] = logp;
    a.iters[c] = (int)it0;
  }
}

}  // namespace nrt

extern "C" int nrt_mclmc_mid_warmup_launch(
    int dim, int micro, int dynamic, int C, int B, int K, uint32_t seed,
    float max_err, float ell, float fsub_ell, float sqrt_n, float fixed_step,
    int has_jitter, float jc1, float jc2, int use_grad_based, int model_id,
    const float* model_params, const void* const* model_ptrs,
    const int* model_ints, const int* flags, const float* logp,
    const float* v, const float* stds, const float* mean, const float* sca,
    float* draws, float* stats, float* q_f, float* g_f, float* logp_f,
    float* v_f, float* stds_f, float* mean_f, float* est_f, float* sca_f,
    int* iters, void* stream) {
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const nrt::McMidWarmArgs a{C,      K,      dim,    seed,
                             {max_err, ell, fsub_ell, sqrt_n},
                             fixed_step, has_jitter, jc1, jc2, use_grad_based,
                             flags,  logp,   v,      stds,   mean,   sca,
                             draws,  stats,  q_f,    g_f,    logp_f, v_f,
                             stds_f, mean_f, est_f,  sca_f,  iters};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)nrt::with_block_model(
      model_id, model_params, model_ptrs, model_ints, [&](auto model) {
        using M = decltype(model);
        const size_t smem =
            4 * (nrt::mc_smem_floats(dim) + model.scratch_floats());
        constexpr int H = nrt::MAX_HALVINGS;
        if (micro && dynamic)
          return nrt::ld_launch(nrt::mclmc_mid_warmup_kernel<true, H, M>, a,
                                model, C, B, smem, s);
        if (micro)
          return nrt::ld_launch(nrt::mclmc_mid_warmup_kernel<true, 0, M>, a,
                                model, C, B, smem, s);
        if (dynamic)
          return nrt::ld_launch(nrt::mclmc_mid_warmup_kernel<false, H, M>, a,
                                model, C, B, smem, s);
        return nrt::ld_launch(nrt::mclmc_mid_warmup_kernel<false, 0, M>, a,
                              model, C, B, smem, s);
      });
}
