// Fused lock-step NUTS warmup with in-kernel adaptation and several threads
// a chain: the kernel body of K2-ld (dim-on-lanes layout,
// nuts_fused_ld_warmup.cu), of K2-ld-args (the same with the model's data,
// its eval_block form, nuts_fused_ld_args_warmup.cu).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/nuts_pallas.py::make_warmup_kernel (:942) with
// layout="ld" (:959-986,1026,1202,1454,1500), launched by
// nuts_pallas_warmup_run (:1532, ld shapes :1592,1627,1699, pallas_call
// :1689).  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_warmup_run_reference
// with layout="ld".  d and maxdepth are launch arguments.
//
// As in nuts_fused_warmup.cu, an outer loop runs over the launch's K draws
// with the host's schedule flags and an inner tree loop runs until every
// chain of the logical block finished its tree; between draws the block
// updates its chain's fg/bg Welford estimators, switches windows, applies
// the diagonal rule (diag_adapt.cuh, per coordinate) and advances dual
// averaging.  The iteration counter `it` is shared by the logical block, so
// the draw at which a chain starts its next tree depends on its block
// mates' longest tree: the B chains must stay in step.  One CUDA block of
// LD_T threads runs one chain and one thread block cluster of B blocks is
// the logical block (nuts_tree_ld.cuh).  Within a draw a chain's tree does
// not depend on its mates, so each chain builds its tree alone, counting
// its iterations from the draw's first counter; one cluster barrier per
// draw (ClusterMax) gives the longest tree's count, by which every chain
// advances `it` (a finished chain's idle iterations do nothing else).
//
// What bounds it on this card: as K1-ld, the latency of a leapfrog's
// dependent steps, plus the wait for the longest tree among the B chains of
// a block in every draw.  What the design does about it: as K1-ld (18 live
// vectors in shared memory, the stacks in a global workspace of which only
// the needed rows are read); B = 8 keeps the wait short; the estimator
// planes, touched once per draw, stay in global memory (the output buffer,
// which the launcher fills with the input planes), as do the current q and g.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "diag_adapt.cuh"
#include "models.cuh"
#include "nuts_tree_ld.cuh"
#include "rng.cuh"

namespace nrt {

// flags columns and packed scalar rows, as nuts_fused.py FLAG_* / SCA_*
enum { LF_UPD_EST = 0, LF_DO_UPDATE, LF_ADVANCE_DA, LF_USE_LATE, LF_USE_BEST,
       LF_DO_SWITCH, LD_NFLAGS = 8 };
enum { LS_STEP = 0, LS_DA_LS, LS_DA_LSA, LS_DA_HBAR, LS_DA_MU, LS_DA_CNT,
       LS_CNT_FG, LS_CNT_BG, LS_TID, LS_LOGDET, LD_NSCA };

struct LdWarmArgs {
  int C, K, d, D;
  uint32_t seed;
  float max_err;
  int has_jitter;
  float jc1, jc2;
  int use_grad_based;
  float target_accept, da_t0, da_gamma, da_neg_k, ls_max;
  const int* flags;
  const float *logp, *stds, *mean, *sca;
  // q_f, g_f and est_f hold the inputs q, g and est at launch
  float *draws, *stats, *q_f, *g_f, *logp_f, *stds_f, *mean_f, *est_f, *sca_f;
  int* iters;
  float* work;  // [C][4][D + 1][d] checkpoint stacks
};

// MIN_BLOCKS resident an SM (at 2: at most 128 registers a thread); MERGED
// (K2-ld): the merged leapfrog (nuts_tree_ld.cuh::ld_leap_merged), with the
// wide reduction's scratch after the cluster slots.
template <class Model, bool EVAL_BLOCK, int MIN_BLOCKS = 1,
          bool MERGED = false>
__global__ void __launch_bounds__(LD_T, MIN_BLOCKS)
    ld_warmup_kernel(const LdWarmArgs a, const Model model) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int B = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  const int c = blockIdx.x;
  const int pid = c / B;
  const int C = a.C, d = a.d, D = a.D;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)pid;
  const int t0 = threadIdx.x;

  LdChain ch;
  ch.d = d;
  ch.D = D;
  ch.n = (d + LD_T - 1) / LD_T;
#ifdef NRT_LD_CLOCKS
  LdClocks clocks{clock64(), {0, 0, 0, 0}};  // counted in the posterior only
  ch.clk = &clocks;
#endif
  float* p = smem;
  float** vecs[] = {&ch.stds, &ch.mean, &ch.e_z, &ch.e_v, &ch.e_zg, &ch.m_z,
                    &ch.m_v, &ch.m_zg, &ch.p_z, &ch.p_v, &ch.p_zg, &ch.dm_z,
                    &ch.dm_zg, &ch.ds_z, &ch.ds_zg, &ch.z1, &ch.v2, &ch.zg1};
  for (float** v : vecs) {
    *v = p;
    p += d;
  }
  float* q1 = nullptr;  // the new position, where the model needs it whole
  if (EVAL_BLOCK) {
    q1 = p;
    p += d;
  }
  ch.bl = p;
  ch.bm = p + (D + 1);
  p += 2 * (D + 1);
  Reducer red{p, 0};
  p += 2 * LD_NRED * LD_W;
  ClusterMax longest{reinterpret_cast<uint32_t*>(p), 0};
  p += 2 * LD_MAX_CLUSTER;
  WideReducer wide{p, 0};
  if constexpr (MERGED) p += LD_WIDE_FLOATS;
  float* scratch = p;  // the model functor's
  const size_t row = (size_t)(D + 1) * d;
  ch.lz = a.work + (size_t)c * 4 * row;
  ch.lv = ch.lz + row;
  ch.mz = ch.lv + row;
  ch.mv = ch.mz + row;
  float* q = a.q_f + (size_t)c * d;    // the chain's current point
  float* g = a.g_f + (size_t)c * d;
  float* est = a.est_f + (size_t)c * NEST * d;  // [NEST][d]

  float sca[LD_NSCA];
#pragma unroll
  for (int r = 0; r < LD_NSCA; ++r) sca[r] = a.sca[c * LD_NSCA + r];
  float logp = a.logp[c];
  for (int j = t0; j < d; j += LD_T) {
    ch.stds[j] = a.stds[(size_t)c * d + j];
    ch.mean[j] = a.mean[(size_t)c * d + j];
  }
  if (t0 <= D) ch.bl[t0] = ch.bm[t0] = 0.0f;
  // every block of the cluster runs before any writes into its slots
  cluster.sync();

  uint32_t it0 = 1;  // the block's counter at the draw's first iteration
  for (int i = 0; i < a.K; ++i) {
    uint32_t it = it0;
    const int* fl = a.flags + i * LD_NFLAGS;
    const float logdet = sca[LS_LOGDET];
    const float step = sca[LS_STEP];

    // ---- fresh trajectory ----
    float s1[1];
    for (int ii = 0; ii < ch.n; ++ii) {
      const int j = t0 + ii * LD_T;
      float vv = 0.0f;
      if (j < d) {
        const float sd = ch.stds[j];
        const float z0 = (q[j] - ch.mean[j]) / sd;
        const float zg0 = g[j] * sd;
        const float v0 = normal(seed, it, 1u, 2u, ld_site(b, d, j));
        ch.e_z[j] = ch.m_z[j] = ch.p_z[j] = ch.dm_z[j] = ch.ds_z[j] = z0;
        ch.e_zg[j] = ch.m_zg[j] = ch.p_zg[j] = ch.dm_zg[j] = ch.ds_zg[j] = zg0;
        ch.e_v[j] = ch.m_v[j] = ch.p_v[j] = v0;
        vv = v0 * v0;
      }
      acc(s1[0], ii, vv);
    }
    red.sum(s1);
    const float ke0 = 0.5f * s1[0];
    const float e_init = ke0 - (logp + logdet);
    bool done = false, div = false, turn = false;
    int e_idx = 0, m_idx = 0, p_idx = 0, dm_idx = 0, ds_idx = 0;
    float dm_logp = logp, dm_ke = ke0, ds_logp = logp, ds_ke = ke0;
    float logw_m = 0.0f, logw_s = -INFINITY;
    int depth = 0, leaf = 0, n_steps = 0;
    float s_acc = 0.0f, s_sym = 0.0f, mx_err = 0.0f;
    float direction =
        uniform(seed, it, 3u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;

    while (!done) {
      {
        const float r_sel = uniform(seed, it, 4u, (uint32_t)b);
        const float r_acc = uniform(seed, it, 5u, (uint32_t)b);
        const float dirf = direction;
        const LdLeap lf = ld_leapfrog<EVAL_BLOCK, Model, false, MERGED>(
            ch, red, wide, model, dirf, step, leaf, depth, q1, scratch);
        const float logp1 = lf.logp1, ke1 = lf.ke1;
        const float err = (ke1 - (logp1 + logdet)) - e_init;
        const bool diverged =
            ablate_keep((err > a.max_err) || !isfinite(err));
        const int idx1 = e_idx + (int)dirf;

        const float diff = -err;
        const float acc_p = expf(min0(diff));
        n_steps += 1;
        s_acc = s_acc + (diverged ? 0.0f : acc_p);
        s_sym =
            s_sym + (diverged ? 0.0f : 2.0f * acc_p / (1.0f + expf(diff)));
        mx_err = diverged ? -INFINITY
                          : (fabsf(diff) > fabsf(mx_err) ? diff : mx_err);

        const float logw_leaf = -err;
        const bool first = leaf == 0;
        logw_s = first ? logw_leaf : logaddexp(logw_s, logw_leaf);
        if (first || (logf(r_sel) < logw_leaf - logw_s)) {
          if constexpr (MERGED) {
            ld_copy_n<2>(ch, {ch.ds_z, ch.ds_zg}, {ch.z1, ch.zg1});
          } else {
            ld_copy(ch, ch.ds_z, ch.z1);
            ld_copy(ch, ch.ds_zg, ch.zg1);
          }
          ds_logp = logp1;
          ds_ke = ke1;
          ds_idx = idx1;
        }

        const bool fwd = dirf > 0.0f;
        const bool subtree_done = (leaf + 1) == (1 << depth);
        const bool do_merge = subtree_done && !diverged && !lf.turning_int;
        if (do_merge) {
          if ((logw_s >= logw_m) || (logf(r_acc) < logw_s - logw_m)) {
            if constexpr (MERGED) {
              ld_copy_n<2>(ch, {ch.dm_z, ch.dm_zg}, {ch.ds_z, ch.ds_zg});
            } else {
              ld_copy(ch, ch.dm_z, ch.ds_z);
              ld_copy(ch, ch.dm_zg, ch.ds_zg);
            }
            dm_logp = ds_logp;
            dm_ke = ds_ke;
            dm_idx = ds_idx;
          }
          logw_m = logaddexp(logw_m, logw_s);
          if (fwd) {
            if constexpr (MERGED) {
              ld_copy_n<3>(ch, {ch.p_z, ch.p_v, ch.p_zg},
                           {ch.z1, ch.v2, ch.zg1});
            } else {
              ld_copy(ch, ch.p_z, ch.z1);
              ld_copy(ch, ch.p_v, ch.v2);
              ld_copy(ch, ch.p_zg, ch.zg1);
            }
            p_idx = idx1;
          } else {
            if constexpr (MERGED) {
              ld_copy_n<3>(ch, {ch.m_z, ch.m_v, ch.m_zg},
                           {ch.z1, ch.v2, ch.zg1});
            } else {
              ld_copy(ch, ch.m_z, ch.z1);
              ld_copy(ch, ch.m_v, ch.v2);
              ld_copy(ch, ch.m_zg, ch.zg1);
            }
            m_idx = idx1;
          }
          depth += 1;
        }
        const bool turned = lf.turning_int || (do_merge && lf.turning_top);
        const bool tree_done = diverged || turned || depth >= D;
        const bool new_doub = do_merge && depth < D && !turned;
        done = tree_done;
        div = div || diverged;
        turn = turn || turned;
        if (new_doub) {
          const bool jump_p =
              uniform(seed, it, 6u, (uint32_t)b) < 0.5f;  // new direction
          if constexpr (MERGED) {
            ld_copy_n<3>(ch, {ch.e_z, ch.e_v, ch.e_zg},
                         {jump_p ? ch.p_z : ch.m_z, jump_p ? ch.p_v : ch.m_v,
                          jump_p ? ch.p_zg : ch.m_zg});
          } else {
            ld_copy(ch, ch.e_z, jump_p ? ch.p_z : ch.m_z);
            ld_copy(ch, ch.e_v, jump_p ? ch.p_v : ch.m_v);
            ld_copy(ch, ch.e_zg, jump_p ? ch.p_zg : ch.m_zg);
          }
          e_idx = jump_p ? p_idx : m_idx;
          leaf = 0;
          direction = jump_p ? 1.0f : -1.0f;
        } else {
          if constexpr (MERGED) {
            ld_swap_edge(ch);
          } else {
            ld_copy(ch, ch.e_z, ch.z1);
            ld_copy(ch, ch.e_v, ch.v2);
            ld_copy(ch, ch.e_zg, ch.zg1);
          }
          e_idx = idx1;
          leaf += 1;
        }
      }
      it += 1;
    }
    it = it0 + longest.max(it - it0);
    it0 = it;

    // ---- draw results, estimators, window switch, mass-matrix update ----
    const bool is_good = (div && abs(dm_idx) > 4) || (!div && dm_idx != 0);
    const bool inc = (fl[LF_UPD_EST] != 0) && is_good;
    const bool do_switch = fl[LF_DO_SWITCH] != 0;
    const float cnt_fg_in = sca[LS_CNT_FG] + 1.0f;  // counts after the draw
    const float cnt_bg_in = sca[LS_CNT_BG] + 1.0f;
    float cnt_fg = sca[LS_CNT_FG] + (inc ? 1.0f : 0.0f);
    float cnt_bg = sca[LS_CNT_BG] + (inc ? 1.0f : 0.0f);
    if (do_switch) {
      cnt_fg = cnt_bg;
      cnt_bg = 0.0f;
    }
    const bool enough = (fl[LF_DO_UPDATE] != 0) && cnt_fg >= 3.0f;
    const bool grad_based = a.use_grad_based != 0;
    float* out = a.draws + ((size_t)i * C + c) * d;
    float s2[2];  // fisher distance, sum log stds
    for (int ii = 0; ii < ch.n; ++ii) {
      const int j = t0 + ii * LD_T;
      float fisher = 0.0f, lg = 0.0f;
      if (j < d) {
        float sd = ch.stds[j], mn = ch.mean[j];
        const float dz = ch.dm_z[j], dzg = ch.dm_zg[j];
        const float dq = dz * sd + mn;
        const float dg = dzg / sd;
        const float fs = dz + dzg;
        fisher = fs * fs;
        out[j] = dq;
        q[j] = dq;
        g[j] = dg;
        float e[NEST];
#pragma unroll
        for (int pl = 0; pl < NEST; ++pl) e[pl] = est[(size_t)pl * d + j];
        if (inc) {
          add2_coord(e[0], e[1], cnt_fg_in, dq);
          add2_coord(e[2], e[3], cnt_fg_in, dg);
          add2_coord(e[4], e[5], cnt_bg_in, dq);
          add2_coord(e[6], e[7], cnt_bg_in, dg);
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
    const float logdet_n = -s2[1];
    const float tid_n = sca[LS_TID] + (enough ? 1.0f : 0.0f);

    // ---- dual averaging (step_size.py::advance) ----
    const float nst = fmaxf((float)n_steps, 1.0f);
    const float accept = (fl[LF_USE_LATE] != 0) ? s_sym / nst : s_acc / nst;
    float da_cnt = sca[LS_DA_CNT];
    float da_ls = sca[LS_DA_LS], da_lsa = sca[LS_DA_LSA],
          da_hbar = sca[LS_DA_HBAR];
    if (fl[LF_ADVANCE_DA] != 0) {
      const float w = 1.0f / (da_cnt + a.da_t0);
      const float hbar_n =
          (1.0f - w) * da_hbar + w * (a.target_accept - accept);
      float ls_n = sca[LS_DA_MU] - hbar_n * sqrtf(da_cnt) / a.da_gamma;
      ls_n = fminf(ls_n, a.ls_max);
      const float mk = expf(a.da_neg_k * logf(da_cnt));
      da_lsa = mk * ls_n + (1.0f - mk) * da_lsa;
      da_ls = ls_n;
      da_hbar = hbar_n;
      da_cnt = da_cnt + 1.0f;
    }
    float base = expf((fl[LF_USE_BEST] != 0) ? da_lsa : da_ls);
    if (a.has_jitter)
      base = base * (a.jc1 + a.jc2 * uniform(seed, it, 7u, (uint32_t)b));
    const float bar = expf(da_lsa);

    // ---- emit row i ----
    if (t0 == 0) {
      const float energy_m = dm_ke - (dm_logp + logdet);
      const float rowv[NSTATS_W] = {
          (float)depth, div ? 1.0f : 0.0f, (float)n_steps, s_acc, s_sym,
          mx_err, dm_logp, energy_m, energy_m - e_init, (float)dm_idx, s2[0],
          base, (depth >= D && !div && !turn) ? 1.0f : 0.0f, bar, tid_n};
      float* st = a.stats + ((size_t)i * C + c) * NSTATS_W;
#pragma unroll
      for (int s = 0; s < NSTATS_W; ++s) st[s] = rowv[s];
    }

    sca[LS_STEP] = base;
    sca[LS_DA_LS] = da_ls;
    sca[LS_DA_LSA] = da_lsa;
    sca[LS_DA_HBAR] = da_hbar;
    sca[LS_DA_CNT] = da_cnt;
    sca[LS_CNT_FG] = cnt_fg;
    sca[LS_CNT_BG] = cnt_bg;
    sca[LS_TID] = tid_n;
    sca[LS_LOGDET] = logdet_n;
    logp = dm_logp;
  }

  for (int j = t0; j < d; j += LD_T) {
    a.stds_f[(size_t)c * d + j] = ch.stds[j];
    a.mean_f[(size_t)c * d + j] = ch.mean[j];
  }
  if (t0 == 0) {
#pragma unroll
    for (int r = 0; r < LD_NSCA; ++r) a.sca_f[c * LD_NSCA + r] = sca[r];
    a.logp_f[c] = logp;
    a.iters[c] = (int)it0;
  }
}

}  // namespace nrt
