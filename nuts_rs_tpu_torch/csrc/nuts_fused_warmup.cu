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
// work per chain; lock-step draws add the wait for the block's longest tree.
// What the design does about it: a chain's coordinates on a group of T
// lanes, as in K1 (nuts_tree.cuh::nuts_lanes, lanes.cuh): each lane holds
// its coordinates' state and stack rows, and runs
// their divisions (q - mean) / stds and zg / stds, normals and Welford
// updates and the diagonal rule (diag_adapt.cuh::adapt_draw_lanes) on
// its coordinates' eight estimator rows, which stay in est_f between draws
// (in registers through the tree loop they spilled at 128 a thread); every
// sum over d, logdet included, is the ordered gather; the dual averaging
// and the tree's bookkeeping are computed alike on every lane of a group.
// One CUDA block of B * T threads per logical block of B chains, so the
// wait is over B chains and not the whole chunk; the loop condition is
// __syncthreads_or; direct stack indexing and active-level-only U-turn
// checks (see nuts_fused_posterior.cu).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "diag_adapt.cuh"
#include "lanes.cuh"
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

template <int DIM, int D, int T, bool SMEM, class Model>
__global__ void __launch_bounds__(nuts_block_threads(T))
    warmup_kernel(const WarmArgs a, const Model model) {
  constexpr int NC = slots<DIM, T>();
  const Lane<T> ln;
  const int B = blockDim.x / T;
  const int b = threadIdx.x / T;
  const int c = blockIdx.x * B + b;
  const int C = a.C;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)blockIdx.x;

  float q[NC], g[NC], stds[NC], mean[NC];
  float sca[NSCA];
  float logp = a.logp[c];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int j = ln.lane + T * i;
    const bool own = j < DIM;
    q[i] = own ? a.q[c * DIM + j] : 0.0f;
    g[i] = own ? a.g[c * DIM + j] : 0.0f;
    stds[i] = own ? a.stds[c * DIM + j] : 1.0f;
    mean[i] = own ? a.mean[c * DIM + j] : 0.0f;
    // the estimator rows live in est_f between draws, out of the
    // registers the tree loop needs
    if (own)
#pragma unroll
      for (int p = 0; p < NEST; ++p)
        a.est_f[(c * NEST + p) * DIM + j] = a.est[(c * NEST + p) * DIM + j];
  }
#pragma unroll
  for (int r = 0; r < NSCA; ++r) sca[r] = a.sca[c * NSCA + r];

  float e_z[NC], e_v[NC], e_zg[NC];
  float m_z[NC], m_v[NC], m_zg[NC];
  float p_z[NC], p_v[NC], p_zg[NC];
  float dm_z[NC], dm_zg[NC];
  float ds_z[NC], ds_zg[NC];
  LaneStacks<NC, D, SMEM> st;
  if constexpr (SMEM) {
    extern __shared__ float stack_smem[];
    st.base = stack_smem + threadIdx.x;
    st.stride = blockDim.x;
  }
  float bl[D + 1], bm[D + 1];

  uint32_t it = 1;
  for (int k = 0; k < a.K; ++k) {
    const int* fl = a.flags + k * NFLAGS;
    const float logdet = sca[S_LOGDET];
    const float step = sca[S_STEP];

    // ---- fresh trajectory ----
    nuts_lane_normals<DIM, T>(e_v, seed, it, 1u, 2u, b, B, ln);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float z0 = (q[i] - mean[i]) / stds[i];
      const float zg0 = g[i] * stds[i];
      e_z[i] = m_z[i] = p_z[i] = dm_z[i] = ds_z[i] = z0;
      e_zg[i] = m_zg[i] = p_zg[i] = dm_zg[i] = ds_zg[i] = zg0;
      m_v[i] = p_v[i] = e_v[i];
    }
    for (int r = 0; r <= D; ++r) {
      bl[r] = bm[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int p = 0; p < NSTACKS; ++p) st.at(p, r, i) = 0.0f;
    }
    const float ke0 = 0.5f * ordered_dot<DIM, T>(e_v, e_v, ln);
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
        // the iteration's uniforms' logs first, beside the leapfrog (the
        // counter hash makes a draw that goes unused free of side effects)
        const float log_r_sel = logf(uniform(seed, it, 4u, (uint32_t)b));
        const float log_r_acc = logf(uniform(seed, it, 5u, (uint32_t)b));
        const float dirf = direction;
        const float eps = dirf * step;
        const float half = eps / 2.0f;
        float v1[NC], z1[NC], zg1[NC], v2[NC], sq[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          v1[i] = e_v[i] + half * e_zg[i];
          z1[i] = e_z[i] + eps * v1[i];
          sq[i] = model.term(z1[i] * stds[i] + mean[i], zg1[i]);
          zg1[i] = zg1[i] * stds[i];
          v2[i] = v1[i] + half * zg1[i];
        }
        const float logp1 = model.finish(ordered_sum<DIM, T>(sq, ln));
        const float ke1 = 0.5f * ordered_dot<DIM, T>(v2, v2, ln);
        const float d1 = ordered_dot<DIM, T>(z1, v2, ln);
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
        if (first || (log_r_sel < logw_leaf - logw_s)) {
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            ds_z[i] = z1[i];
            ds_zg[i] = zg1[i];
          }
          ds_logp = logp1;
          ds_ke = ke1;
          ds_idx = idx1;
        }

        const int row_l = min(tz(leaf, D), D);
        const int tzn = tz(leaf + 1, D);
        const int row_m = min(tzn + 1, D);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          st.at(ST_LZ, row_l, i) = z1[i];
          st.at(ST_LV, row_l, i) = v2[i];
          st.at(ST_MZ, row_m, i) = z1[i];
          st.at(ST_MV, row_m, i) = v2[i];
        }
        bl[row_l] = d1;
        bm[row_m] = d1;
        const bool turning_int = uturn_internal_lanes<DIM, D, T>(
            leaf, tzn, dirf, z1, v2, d1, st, bl, bm, ln);

        const bool subtree_done = (leaf + 1) == (1 << depth);
        const bool do_merge = subtree_done && !diverged && !turning_int;
        const bool fwd = dirf > 0.0f;
        bool turning_top = false;
        if (do_merge) {
          float far_z[NC], far_v[NC], near_z[NC], near_v[NC];
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            far_z[i] = fwd ? m_z[i] : p_z[i];
            far_v[i] = fwd ? m_v[i] : p_v[i];
            near_z[i] = fwd ? p_z[i] : m_z[i];
            near_v[i] = fwd ? p_v[i] : m_v[i];
          }
          turning_top = uturn_top_lanes<DIM, D, T>(
              depth, dirf, z1, v2, d1, far_z, far_v, near_z, near_v, st,
              bl[D], ln);
          if ((logw_s >= logw_m) || (log_r_acc < logw_s - logw_m)) {
#pragma unroll
            for (int i = 0; i < NC; ++i) {
              dm_z[i] = ds_z[i];
              dm_zg[i] = ds_zg[i];
            }
            dm_logp = ds_logp;
            dm_ke = ds_ke;
            dm_idx = ds_idx;
          }
          logw_m = logaddexp(logw_m, logw_s);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            if (fwd) {
              p_z[i] = z1[i];
              p_v[i] = v2[i];
              p_zg[i] = zg1[i];
            } else {
              m_z[i] = z1[i];
              m_v[i] = v2[i];
              m_zg[i] = zg1[i];
            }
          }
          if (fwd)
            p_idx = idx1;
          else
            m_idx = idx1;
          depth += 1;
        }
        const bool turned = turning_int || turning_top;
        const bool tree_done = diverged || turned || depth >= D;
        const bool new_doub = do_merge && depth < D && !turned;
        done = tree_done;
        div = div || diverged;
        turn = turn || turned;
        if (new_doub) {
          const bool jump_p =
              uniform(seed, it, 6u, (uint32_t)b) < 0.5f;  // new direction
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            e_z[i] = jump_p ? p_z[i] : m_z[i];
            e_v[i] = jump_p ? p_v[i] : m_v[i];
            e_zg[i] = jump_p ? p_zg[i] : m_zg[i];
          }
          e_idx = jump_p ? p_idx : m_idx;
          leaf = 0;
          direction = jump_p ? 1.0f : -1.0f;
        } else {
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            e_z[i] = z1[i];
            e_v[i] = v2[i];
            e_zg[i] = zg1[i];
          }
          e_idx = idx1;
          leaf += 1;
        }
      }
      it += 1;
    }

    // ---- draw results (q-space) ----
    float dm_q[NC], dm_g[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      dm_q[i] = dm_z[i] * stds[i] + mean[i];
      dm_g[i] = dm_zg[i] / stds[i];
    }
    const bool is_good = (div && abs(dm_idx) > 4) || (!div && dm_idx != 0);

    // ---- estimators, window switch, mass-matrix update ----
    float est[NEST][NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int j = ln.lane + T * i;
#pragma unroll
      for (int p = 0; p < NEST; ++p)
        est[p][i] = j < DIM ? a.est_f[(c * NEST + p) * DIM + j] : 0.0f;
    }
    float cnt_fg = sca[S_CNT_FG], cnt_bg = sca[S_CNT_BG], tid_n = sca[S_TID];
    const float logdet_n = adapt_draw_lanes<DIM, T>(
        est, cnt_fg, cnt_bg, tid_n, stds, mean, dm_q, dm_g,
        (fl[F_UPD_EST] != 0) && is_good, fl[F_DO_SWITCH] != 0,
        fl[F_DO_UPDATE] != 0, a.use_grad_based != 0, ln);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int j = ln.lane + T * i;
      if (j < DIM)
#pragma unroll
        for (int p = 0; p < NEST; ++p)
          a.est_f[(c * NEST + p) * DIM + j] = est[p][i];
    }

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

    // ---- emit row k ----
    const float energy_m = dm_ke - (dm_logp + logdet);
    float e[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      e[i] = dm_z[i] + dm_zg[i];
      const int j = ln.lane + T * i;
      if (j < DIM) a.draws[((size_t)k * DIM + j) * C + c] = dm_q[i];
    }
    const float fisher = ordered_dot<DIM, T>(e, e, ln);
    const float row[NSTATS_W] = {
        (float)depth, div ? 1.0f : 0.0f, (float)n_steps, s_acc, s_sym,
        mx_err, dm_logp, energy_m, energy_m - e_init, (float)dm_idx, fisher,
        base, (depth >= D && !div && !turn) ? 1.0f : 0.0f, bar, tid_n};
#pragma unroll
    for (int s = 0; s < NSTATS_W; ++s)
      if (s % T == ln.lane)
        a.stats[((size_t)k * NSTATS_W + s) * C + c] = row[s];

    sca[S_STEP] = base;
    sca[S_DA_LS] = da_ls;
    sca[S_DA_LSA] = da_lsa;
    sca[S_DA_HBAR] = da_hbar;
    sca[S_DA_CNT] = da_cnt;
    sca[S_CNT_FG] = cnt_fg;
    sca[S_CNT_BG] = cnt_bg;
    sca[S_TID] = tid_n;
    sca[S_LOGDET] = logdet_n;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      q[i] = dm_q[i];
      g[i] = dm_g[i];
    }
    logp = dm_logp;
  }

#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int j = ln.lane + T * i;
    if (j < DIM) {
      a.q_f[c * DIM + j] = q[i];
      a.g_f[c * DIM + j] = g[i];
      a.stds_f[c * DIM + j] = stds[i];
      a.mean_f[c * DIM + j] = mean[i];
    }
  }
#pragma unroll
  for (int r = 0; r < NSCA; ++r)
    if (r % T == ln.lane) a.sca_f[c * NSCA + r] = sca[r];
  if (ln.lane == 0) {
    a.logp_f[c] = logp;
    a.iters[c] = (int)it;
  }
}

template <int DIM, int D, int T, bool SMEM>
cudaError_t launch_warmup(const WarmArgs& a, int B, int model_id,
                          const float* params, cudaStream_t stream) {
  if (model_id != MODEL_IID_NORMAL) return cudaErrorInvalidValue;
  auto kernel = warmup_kernel<DIM, D, T, SMEM, IidNormal>;
  const size_t smem = SMEM ? stack_smem_bytes<DIM, D, T>(B) : 0;
  if (SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.C / B, B * T, smem, stream>>>(a, IidNormal{params[0]});
  return cudaGetLastError();
}

// As launch_posterior_lanes (nuts_fused_posterior.cu).
template <int DIM, int D, int T>
cudaError_t launch_warmup_lanes(const WarmArgs& a, int B, int model_id,
                                const float* params, cudaStream_t stream) {
  if constexpr (nuts_lanes_taken(DIM, T)) {
#ifdef NRT_NUTS_SMEM_STACKS
    return launch_warmup<DIM, D, T, true>(a, B, model_id, params, stream);
#else
    return launch_warmup<DIM, D, T, false>(a, B, model_id, params, stream);
#endif
  }
  return cudaErrorInvalidValue;
}

}  // namespace nrt

// As nrt_nuts_lanes of nuts_fused_posterior.cu, for the warmup's wrapper.
extern "C" int nrt_nuts_lanes(int dim, int B) {
  return nrt::nuts_lanes(dim, B);
}

// lanes: as nrt_posterior_launch's.
extern "C" int nrt_warmup_launch(
    int dim, int maxdepth, int lanes, int C, int B, int K, uint32_t seed,
    float max_err, int has_jitter, float jc1, float jc2,
    int use_grad_based, float target_accept, float da_t0, float da_gamma,
    float da_neg_k, float ls_max, int model_id, const float* model_params,
    const int* flags, const float* q, const float* g, const float* logp,
    const float* stds, const float* mean, const float* est, const float* sca,
    float* draws, float* stats, float* q_f, float* g_f, float* logp_f,
    float* stds_f, float* mean_f, float* est_f, float* sca_f, int* iters,
    void* stream) {
  if (B < 1 || B > nrt::MAX_BLOCK || C % B != 0 ||
      lanes != nrt::nuts_lanes(dim, B) ||
      B * lanes > nrt::nuts_block_threads(lanes))
    return (int)cudaErrorInvalidValue;
  const nrt::WarmArgs a{C,        K,          seed,     max_err,
                        has_jitter, jc1,      jc2,      use_grad_based,
                        target_accept, da_t0, da_gamma, da_neg_k, ls_max,
                        flags,    q,          g,        logp,     stds,
                        mean,     est,        sca,      draws,    stats,
                        q_f,      g_f,        logp_f,   stds_f,   mean_f,
                        est_f,    sca_f,      iters};
  cudaStream_t s = (cudaStream_t)stream;
#define NRT_LANES(DIM_, D_, T_)                                            \
  if (lanes == T_)                                                         \
    return (int)nrt::launch_warmup_lanes<DIM_, D_, T_>(a, B, model_id,     \
                                                       model_params, s);
#define NRT_CASE(DIM_, D_)                                                 \
  if (dim == DIM_ && maxdepth == D_) {                                     \
    NRT_LANES(DIM_, D_, 1)                                                 \
    NRT_LANES(DIM_, D_, 2)                                                 \
    NRT_LANES(DIM_, D_, 4)                                                 \
    NRT_LANES(DIM_, D_, 8)                                                 \
    NRT_LANES(DIM_, D_, 16)                                                \
  }
  NRT_FOR_EACH_SIZE(NRT_CASE)
#undef NRT_CASE
#undef NRT_LANES
  return (int)cudaErrorInvalidValue;
}
