// Fused lock-step NUTS warmup with in-kernel adaptation (kernel K2).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/nuts_pallas.py::make_warmup_kernel (:942), launched by
// nuts_pallas_warmup_run (:1532, pallas_call :1689), in the chains-on-lanes
// layout with no model args.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_warmup_run_reference.
//
// An outer loop runs over the launch's K draws with the host's schedule
// flags for each draw (FLAG_* columns); an inner tree loop runs until every
// chain of the block finished its tree, with every update gated on the
// chain still being active; between draws each thread updates its chain's
// fg/bg Welford estimators, switches windows, applies the diagonal
// mass-matrix rule (diag_adapt.cuh, shared with the MCLMC warmup) and
// advances dual averaging (nuts_pallas.py:1399-1482).
//
// What bounds it on this card: as the posterior kernel, latency-bound scalar
// work per thread with the checkpoint stacks and the eight estimator planes
// in local memory; lock-step draws add the wait for the block's longest tree.
// What the design does about it: one thread per chain and one warp-sized
// block per logical chain block, so the wait is over 32 chains and not the
// whole chunk; the loop condition is __syncthreads_or; direct stack indexing
// and active-level-only U-turn checks (see nuts_fused_posterior.cu).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "diag_adapt.cuh"
#include "models.cuh"
#include "nuts_tree.cuh"
#include "rng.cuh"
#include "nrt_sizes.h"  // NRT_FOR_EACH_SIZE(X), generated by _build.py

namespace nrt {

// flags columns and packed scalar rows, as nuts_fused.py FLAG_* / SCA_*
enum { F_UPD_EST = 0, F_DO_UPDATE, F_ADVANCE_DA, F_USE_LATE, F_USE_BEST,
       F_DO_SWITCH, NFLAGS = 8 };
enum { S_STEP = 0, S_DA_LS, S_DA_LSA, S_DA_HBAR, S_DA_MU, S_DA_CNT,
       S_CNT_FG, S_CNT_BG, S_TID, S_LOGDET, NSCA };

struct WarmArgs {
  int C, K;
  uint32_t seed;
  float max_err;
  int has_jitter;
  float jc1, jc2;
  int use_grad_based;
  float target_accept, da_t0, da_gamma, da_neg_k, ls_max;
  const int* flags;
  const float *q, *g, *logp, *stds, *mean, *est, *sca;
  float *draws, *stats, *q_f, *g_f, *logp_f, *stds_f, *mean_f, *est_f, *sca_f;
  int* iters;
};

template <int DIM, int D, class Model>
__global__ void __launch_bounds__(MAX_BLOCK)
    warmup_kernel(const WarmArgs a, const Model model) {
  const int B = blockDim.x;
  const int b = threadIdx.x;
  const int c = blockIdx.x * B + b;
  const int C = a.C;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)blockIdx.x;

  float q[DIM], g[DIM], stds[DIM], mean[DIM];
  float est[NEST][DIM];
  float sca[NSCA];
  float logp = a.logp[c];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    q[j] = a.q[c * DIM + j];
    g[j] = a.g[c * DIM + j];
    stds[j] = a.stds[c * DIM + j];
    mean[j] = a.mean[c * DIM + j];
  }
#pragma unroll
  for (int p = 0; p < NEST; ++p)
#pragma unroll
    for (int j = 0; j < DIM; ++j) est[p][j] = a.est[(c * NEST + p) * DIM + j];
#pragma unroll
  for (int r = 0; r < NSCA; ++r) sca[r] = a.sca[c * NSCA + r];

  float e_z[DIM], e_v[DIM], e_zg[DIM];
  float m_z[DIM], m_v[DIM], m_zg[DIM];
  float p_z[DIM], p_v[DIM], p_zg[DIM];
  float dm_z[DIM], dm_zg[DIM];
  float ds_z[DIM], ds_zg[DIM];
  float lz[D + 1][DIM], lv[D + 1][DIM], mz[D + 1][DIM], mv[D + 1][DIM];
  float bl[D + 1], bm[D + 1];

  uint32_t it = 1;
  for (int i = 0; i < a.K; ++i) {
    const int* fl = a.flags + i * NFLAGS;
    const float logdet = sca[S_LOGDET];
    const float step = sca[S_STEP];

    // ---- fresh trajectory ----
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float z0 = (q[j] - mean[j]) / stds[j];
      const float zg0 = g[j] * stds[j];
      const float v0 = normal(seed, it, 1u, 2u, (uint32_t)(j * B + b));
      e_z[j] = m_z[j] = p_z[j] = dm_z[j] = ds_z[j] = z0;
      e_zg[j] = m_zg[j] = p_zg[j] = dm_zg[j] = ds_zg[j] = zg0;
      e_v[j] = m_v[j] = p_v[j] = v0;
    }
    for (int r = 0; r <= D; ++r) {
      bl[r] = bm[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < DIM; ++j)
        lz[r][j] = lv[r][j] = mz[r][j] = mv[r][j] = 0.0f;
    }
    const float ke0 = 0.5f * dot<DIM>(e_v, e_v);
    const float e_init = ke0 - (logp + logdet);
    bool done = false, div = false, turn = false;
    int e_idx = 0, m_idx = 0, p_idx = 0, dm_idx = 0, ds_idx = 0;
    float dm_logp = logp, dm_ke = ke0, ds_logp = logp, ds_ke = ke0;
    float logw_m = 0.0f, logw_s = -INFINITY;
    int depth = 0, leaf = 0, n_steps = 0;
    float s_acc = 0.0f, s_sym = 0.0f, mx_err = 0.0f;
    float direction =
        uniform(seed, it, 3u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;

    while (__syncthreads_or(!done)) {
      if (!done) {
        const float r_sel = uniform(seed, it, 4u, (uint32_t)b);
        const float r_acc = uniform(seed, it, 5u, (uint32_t)b);
        const float dirf = direction;
        const float eps = dirf * step;
        const float half = eps / 2.0f;
        float v1[DIM], z1[DIM], q1[DIM], zg1[DIM], v2[DIM];
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
          v1[j] = e_v[j] + half * e_zg[j];
          z1[j] = e_z[j] + eps * v1[j];
          q1[j] = z1[j] * stds[j] + mean[j];
        }
        const float logp1 = model.template eval<DIM>(q1, zg1);
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
          zg1[j] = zg1[j] * stds[j];
          v2[j] = v1[j] + half * zg1[j];
        }
        const float ke1 = 0.5f * dot<DIM>(v2, v2);
        const float err = (ke1 - (logp1 + logdet)) - e_init;
        const bool diverged = (err > a.max_err) || !isfinite(err);
        const int idx1 = e_idx + (int)dirf;

        const float diff = -err;
        const float acc = expf(min0(diff));
        n_steps += 1;
        s_acc = s_acc + (diverged ? 0.0f : acc);
        s_sym = s_sym + (diverged ? 0.0f : 2.0f * acc / (1.0f + expf(diff)));
        mx_err = diverged ? -INFINITY
                          : (fabsf(diff) > fabsf(mx_err) ? diff : mx_err);

        const float logw_leaf = -err;
        const bool first = leaf == 0;
        logw_s = first ? logw_leaf : logaddexp(logw_s, logw_leaf);
        if (first || (logf(r_sel) < logw_leaf - logw_s)) {
          copy<DIM>(ds_z, z1);
          copy<DIM>(ds_zg, zg1);
          ds_logp = logp1;
          ds_ke = ke1;
          ds_idx = idx1;
        }

        const float d1 = dot<DIM>(z1, v2);
        const int row_l = min(tz(leaf, D), D);
        const int tzn = tz(leaf + 1, D);
        const int row_m = min(tzn + 1, D);
        copy<DIM>(lz[row_l], z1);
        copy<DIM>(lv[row_l], v2);
        bl[row_l] = d1;
        copy<DIM>(mz[row_m], z1);
        copy<DIM>(mv[row_m], v2);
        bm[row_m] = d1;
        const bool turning_int = uturn_internal<DIM, D>(
            leaf, tzn, dirf, z1, v2, d1, lz, lv, bl, mz, mv, bm);
        const bool fwd = dirf > 0.0f;
        const bool turning_top = uturn_top<DIM>(
            depth, dirf, z1, v2, d1, fwd ? m_z : p_z, fwd ? m_v : p_v,
            fwd ? p_z : m_z, fwd ? p_v : m_v, lz[D], lv[D], bl[D]);

        const bool subtree_done = (leaf + 1) == (1 << depth);
        const bool do_merge = subtree_done && !diverged && !turning_int;
        if (do_merge) {
          if ((logw_s >= logw_m) || (logf(r_acc) < logw_s - logw_m)) {
            copy<DIM>(dm_z, ds_z);
            copy<DIM>(dm_zg, ds_zg);
            dm_logp = ds_logp;
            dm_ke = ds_ke;
            dm_idx = ds_idx;
          }
          logw_m = logaddexp(logw_m, logw_s);
          if (fwd) {
            copy<DIM>(p_z, z1);
            copy<DIM>(p_v, v2);
            copy<DIM>(p_zg, zg1);
            p_idx = idx1;
          } else {
            copy<DIM>(m_z, z1);
            copy<DIM>(m_v, v2);
            copy<DIM>(m_zg, zg1);
            m_idx = idx1;
          }
          depth += 1;
        }
        const bool turned = turning_int || (do_merge && turning_top);
        const bool tree_done = diverged || turned || depth >= D;
        const bool new_doub = do_merge && depth < D && !turned;
        done = tree_done;
        div = div || diverged;
        turn = turn || turned;
        if (new_doub) {
          const bool jump_p =
              uniform(seed, it, 6u, (uint32_t)b) < 0.5f;  // new direction
          copy<DIM>(e_z, jump_p ? p_z : m_z);
          copy<DIM>(e_v, jump_p ? p_v : m_v);
          copy<DIM>(e_zg, jump_p ? p_zg : m_zg);
          e_idx = jump_p ? p_idx : m_idx;
          leaf = 0;
          direction = jump_p ? 1.0f : -1.0f;
        } else {
          copy<DIM>(e_z, z1);
          copy<DIM>(e_v, v2);
          copy<DIM>(e_zg, zg1);
          e_idx = idx1;
          leaf += 1;
        }
      }
      it += 1;
    }

    // ---- draw results (q-space) ----
    float dm_q[DIM], dm_g[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      dm_q[j] = dm_z[j] * stds[j] + mean[j];
      dm_g[j] = dm_zg[j] / stds[j];
    }
    const bool is_good = (div && abs(dm_idx) > 4) || (!div && dm_idx != 0);

    // ---- estimators, window switch, mass-matrix update ----
    float cnt_fg = sca[S_CNT_FG], cnt_bg = sca[S_CNT_BG], tid_n = sca[S_TID];
    const float logdet_n = adapt_draw<DIM>(
        est, cnt_fg, cnt_bg, tid_n, stds, mean, dm_q, dm_g,
        (fl[F_UPD_EST] != 0) && is_good, fl[F_DO_SWITCH] != 0,
        fl[F_DO_UPDATE] != 0, a.use_grad_based != 0);

    // ---- dual averaging (step_size.py::advance) ----
    const float nst = fmaxf((float)n_steps, 1.0f);
    const float accept = (fl[F_USE_LATE] != 0) ? s_sym / nst : s_acc / nst;
    float da_cnt = sca[S_DA_CNT];
    float da_ls = sca[S_DA_LS], da_lsa = sca[S_DA_LSA],
          da_hbar = sca[S_DA_HBAR];
    if (fl[F_ADVANCE_DA] != 0) {
      const float w = 1.0f / (da_cnt + a.da_t0);
      const float hbar_n =
          (1.0f - w) * da_hbar + w * (a.target_accept - accept);
      float ls_n = sca[S_DA_MU] - hbar_n * sqrtf(da_cnt) / a.da_gamma;
      ls_n = fminf(ls_n, a.ls_max);
      const float mk = expf(a.da_neg_k * logf(da_cnt));
      da_lsa = mk * ls_n + (1.0f - mk) * da_lsa;
      da_ls = ls_n;
      da_hbar = hbar_n;
      da_cnt = da_cnt + 1.0f;
    }
    float base = expf((fl[F_USE_BEST] != 0) ? da_lsa : da_ls);
    if (a.has_jitter)
      base = base * (a.jc1 + a.jc2 * uniform(seed, it, 7u, (uint32_t)b));
    const float bar = expf(da_lsa);

    // ---- emit row i ----
    const float energy_m = dm_ke - (dm_logp + logdet);
    float fisher = 0.0f;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float s = dm_z[j] + dm_zg[j];
      fisher = (j == 0) ? s * s : fisher + s * s;
      a.draws[((size_t)i * DIM + j) * C + c] = dm_q[j];
    }
    const float row[NSTATS_W] = {
        (float)depth, div ? 1.0f : 0.0f, (float)n_steps, s_acc, s_sym,
        mx_err, dm_logp, energy_m, energy_m - e_init, (float)dm_idx, fisher,
        base, (depth >= D && !div && !turn) ? 1.0f : 0.0f, bar, tid_n};
#pragma unroll
    for (int s = 0; s < NSTATS_W; ++s)
      a.stats[((size_t)i * NSTATS_W + s) * C + c] = row[s];

    sca[S_STEP] = base;
    sca[S_DA_LS] = da_ls;
    sca[S_DA_LSA] = da_lsa;
    sca[S_DA_HBAR] = da_hbar;
    sca[S_DA_CNT] = da_cnt;
    sca[S_CNT_FG] = cnt_fg;
    sca[S_CNT_BG] = cnt_bg;
    sca[S_TID] = tid_n;
    sca[S_LOGDET] = logdet_n;
    copy<DIM>(q, dm_q);
    copy<DIM>(g, dm_g);
    logp = dm_logp;
  }

#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    a.q_f[c * DIM + j] = q[j];
    a.g_f[c * DIM + j] = g[j];
    a.stds_f[c * DIM + j] = stds[j];
    a.mean_f[c * DIM + j] = mean[j];
  }
#pragma unroll
  for (int p = 0; p < NEST; ++p)
#pragma unroll
    for (int j = 0; j < DIM; ++j) a.est_f[(c * NEST + p) * DIM + j] = est[p][j];
#pragma unroll
  for (int r = 0; r < NSCA; ++r) a.sca_f[c * NSCA + r] = sca[r];
  a.logp_f[c] = logp;
  a.iters[c] = (int)it;
}

template <int DIM, int D>
cudaError_t launch_warmup(const WarmArgs& a, int B, int model_id,
                          const float* params, cudaStream_t stream) {
  if (model_id != MODEL_IID_NORMAL) return cudaErrorInvalidValue;
  warmup_kernel<DIM, D, IidNormal>
      <<<a.C / B, B, 0, stream>>>(a, IidNormal{params[0]});
  return cudaGetLastError();
}

}  // namespace nrt

extern "C" int nrt_warmup_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed,
    float max_err, int has_jitter, float jc1, float jc2,
    int use_grad_based, float target_accept, float da_t0, float da_gamma,
    float da_neg_k, float ls_max, int model_id, const float* model_params,
    const int* flags, const float* q, const float* g, const float* logp,
    const float* stds, const float* mean, const float* est, const float* sca,
    float* draws, float* stats, float* q_f, float* g_f, float* logp_f,
    float* stds_f, float* mean_f, float* est_f, float* sca_f, int* iters,
    void* stream) {
  if (B < 1 || B > nrt::MAX_BLOCK || C % B != 0)
    return (int)cudaErrorInvalidValue;
  const nrt::WarmArgs a{C,        K,          seed,     max_err,
                        has_jitter, jc1,      jc2,      use_grad_based,
                        target_accept, da_t0, da_gamma, da_neg_k, ls_max,
                        flags,    q,          g,        logp,     stds,
                        mean,     est,        sca,      draws,    stats,
                        q_f,      g_f,        logp_f,   stds_f,   mean_f,
                        est_f,    sca_f,      iters};
  cudaStream_t s = (cudaStream_t)stream;
#define NRT_CASE(DIM_, D_)                                               \
  if (dim == DIM_ && maxdepth == D_)                                     \
    return (int)nrt::launch_warmup<DIM_, D_>(a, B, model_id, model_params, s);
  NRT_FOR_EACH_SIZE(NRT_CASE)
#undef NRT_CASE
  return (int)cudaErrorInvalidValue;
}
