// Fused lock-step NUTS warmup with in-kernel adaptation for data-carrying
// models and mid d, chains-on-lanes random stream (kernel K2-args).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/nuts_pallas.py::make_warmup_kernel (:942) with
// n_model_args > 0 (:944,975-979,1038), launched by nuts_pallas_warmup_run
// (:1532; model_args :1545,1621-1624,1686,1697): K lock-step tuning draws
// with the fg/bg estimators, the diagonal rule and dual averaging in the
// kernel, the model evaluated as logp_grad_batched(q, *model_args).  The
// launch of one chain group per pallas_call (:1564-1579) works around a
// Mosaic fault and has no counterpart here: one launch takes every block.
// Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_warmup_run_reference
// with layout="cl" and a model the mid-d kernel serves
// (nuts_fused.cl_kernel).  d, maxdepth and the data sizes are launch
// arguments.
//
// The design is the one of K1-args (nuts_fused_mid_posterior.cu, points 1-6:
// G <= 8 chains a CUDA block, a warp a chain in tsum's order, the
// regression evaluated by the whole block for all G chains and every other
// functor by the chain's warp, the chains-on-lanes site index j * B + b,
// the JAX body's spellings), with the steps of K2-ld's body
// (nuts_fused_ld_warmup.cuh) for each chain: the adaptation per coordinate
// from diag_adapt.cuh, the current q and g and the estimator planes in
// global memory, the new position q1 kept as a 19th shared-memory vector.
// With B = 1 a chain's counter advances by its own trees alone, so the
// chains of a block move through their K tuning draws each at its own pace
// (each reads the schedule row of its own draw) and the block runs until
// its last chain is done; with B > 1 a logical block's chains wait for its
// longest tree in every draw, as the ld body's cluster does.  What bounds
// it: as K1-args, plus the wait of a block for the chain with the most
// leapfrogs over the launch's draws.

#include "nuts_fused_ld_warmup.cuh"
#include "nuts_tree_group.cuh"

namespace nrt {

// A chain's place in its draws: the first pass of a fresh trajectory is
// next (START), a tree is being built (TREE), the tree is done and the
// chain waits for its logical block's longest (WAIT, B > 1 only), all K
// draws are done or the chain is absent (DONE).
enum { GW_START = 0, GW_TREE, GW_WAIT, GW_DONE };

// A chain's loop-carried scalars and its vectors' base pointers, parked in
// shared memory while the block evaluates the regression's group form (as
// K1-args' GrPostScalars).
struct GrWarmScalars {
  GrChain ch;
  const int* fl;
  float sca[LD_NSCA];
  float logp, logdet, step, e_init, dm_logp, dm_ke, ds_logp, ds_ke, logw_m,
      logw_s, s_acc, s_sym, mx_err, direction;
  int state, i, e_idx, m_idx, p_idx, dm_idx, ds_idx, depth, leaf, n_steps;
  uint32_t it0, it;
  bool div, turn;
};
static_assert(sizeof(GrWarmScalars) <= 4 * GR_SCALAR_FLOATS,
              "a chain's slot of scalars");

// K2-args: G chains a block, chain cb on warp cb, each on ld_warmup_kernel's
// steps and in its own draw: one block iteration is one leapfrog of every
// chain in a tree, with the model evaluated between the leapfrog's two
// passes.  With B = 1 a chain's counter `it` advances by its own trees
// alone, so the chains of a block move through their K draws at their own
// pace, each reading the schedule row of its own draw, and the block runs
// until its last chain is done.  With B > 1 a chain whose tree is done
// waits until its logical block's chains are all done (one barrier an
// iteration for their flags), and they advance `it` by the longest tree
// together, as ClusterMax does in the ld body.
template <class Model>
__global__ void __launch_bounds__(LD_T, 1)
    mid_warmup_kernel(const LdWarmArgs a, const Model model, int B, int G) {
  extern __shared__ float4 gr_smem[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(gr_smem);
  const int lane = gr_lane(), cb = threadIdx.x >> 5;
  const int C = a.C, d = a.d, D = a.D;
  const int c = blockIdx.x * G + cb;
  const bool present = cb < G && c < C;
  float* gs = smem;  // the group form's
  int* waiting = reinterpret_cast<int*>(smem + gr_group_floats(model, G));
  int* tree_len = waiting + GR_MAX;
  GrWarmScalars* saved = reinterpret_cast<GrWarmScalars*>(
      smem + gr_group_floats(model, G) + GR_FLAG_FLOATS);
  const size_t cf = gr_chain_floats(model, GR_WARM_NVEC, d, D);
  GrChain ch = gr_chain(smem + gr_group_floats(model, G) + GR_FLAG_FLOATS +
                            gr_scalar_floats(model) + (size_t)cb * cf,
                        a.work, c, d, D);
  float* q1 = ch.q1();  // the new position, which the model reads whole
  float* const scratch = ch.v(GR_WARM_NVEC);  // a team functor's
  float* qg = nullptr;
  if constexpr (Model::GROUP) {
    qg = gs + cb;
    // the staged positions of absent chains stay 0.0: finite logits
    for (int j = threadIdx.x; j < GR_MAX * d; j += LD_T) gs[j] = 0.0f;
  }
  const int b = c % B, pid = c / B;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)pid;
  float* q = a.q_f + (size_t)c * d;  // the chain's current point
  float* g = a.g_f + (size_t)c * d;
  float* est = a.est_f + (size_t)c * NEST * d;  // [NEST][d]

  float sca[LD_NSCA];
  float logp = 0.0f;
  if (present) {
#pragma unroll
    for (int r = 0; r < LD_NSCA; ++r) sca[r] = a.sca[c * LD_NSCA + r];
    logp = a.logp[c];
    for (int j = lane; j < d; j += 32) {
      ch.stds()[j] = a.stds[(size_t)c * d + j];
      ch.mean()[j] = a.mean[(size_t)c * d + j];
    }
    for (int j = lane; j <= D; j += 32) ch.bl()[j] = ch.bm()[j] = 0.0f;
    __syncwarp();
  }

  int state = present ? GW_START : GW_DONE;
  int i = 0;            // the chain's draw
  uint32_t it0 = 1;     // its counter at the draw's first iteration
  uint32_t it = 1;
  const int* fl = a.flags;
  float logdet = 0.0f, step = 0.0f, e_init = 0.0f, logp_team = 0.0f;
  bool div = false, turn = false;
  int e_idx = 0, m_idx = 0, p_idx = 0, dm_idx = 0, ds_idx = 0;
  float dm_logp = 0.0f, dm_ke = 0.0f, ds_logp = 0.0f, ds_ke = 0.0f;
  float logw_m = 0.0f, logw_s = -INFINITY;
  int depth = 0, leaf = 0, n_steps = 0;
  float s_acc = 0.0f, s_sym = 0.0f, mx_err = 0.0f, direction = 1.0f;
  while (true) {
    if (state == GW_START) {
      // ---- fresh trajectory ----
      it = it0;
      fl = a.flags + i * LD_NFLAGS;
      logdet = sca[LS_LOGDET];
      step = sca[LS_STEP];
      float s1[1];
      slot_sums(d, [&](int j, float (&t)[1]) {
        const float sd = ch.stds()[j];
        const float z0 = (q[j] - ch.mean()[j]) / sd;
        const float zg0 = g[j] * sd;
        const float v0 =
            normal(seed, it, 1u, 2u, block_site<true>(b, B, d, j));
        ch.e_z()[j] = ch.m_z()[j] = ch.p_z()[j] = z0;
        ch.dm_z()[j] = ch.ds_z()[j] = z0;
        ch.e_zg()[j] = ch.m_zg()[j] = ch.p_zg()[j] = zg0;
        ch.dm_zg()[j] = ch.ds_zg()[j] = zg0;
        ch.e_v()[j] = ch.m_v()[j] = ch.p_v()[j] = v0;
        t[0] = v0 * v0;
      }, s1);
      const float ke0 = 0.5f * s1[0];
      e_init = ke0 - (logp + logdet);
      div = turn = false;
      e_idx = m_idx = p_idx = dm_idx = ds_idx = 0;
      dm_logp = ds_logp = logp;
      dm_ke = ds_ke = ke0;
      logw_m = 0.0f;
      logw_s = -INFINITY;
      depth = leaf = n_steps = 0;
      s_acc = s_sym = mx_err = 0.0f;
      direction = uniform(seed, it, 3u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;
      state = GW_TREE;
    }
    if (state == GW_TREE) {
      gr_leap_first(ch, direction, step, q1, qg);
      if constexpr (!Model::GROUP) {
        __syncwarp();
        logp_team = model.eval_team(q1, ch.zg1(), d, scratch);
        __syncwarp();
      }
    }
    if constexpr (Model::GROUP) {
      // every warp parks and reloads, so that no path keeps them live
      if (lane == 0) {
        GrWarmScalars& sv = saved[cb];
        sv.ch = ch, sv.fl = fl;
#pragma unroll
        for (int r = 0; r < LD_NSCA; ++r) sv.sca[r] = sca[r];
        sv.logp = logp, sv.logdet = logdet, sv.step = step;
        sv.e_init = e_init, sv.dm_logp = dm_logp, sv.dm_ke = dm_ke;
        sv.ds_logp = ds_logp, sv.ds_ke = ds_ke, sv.logw_m = logw_m;
        sv.logw_s = logw_s, sv.s_acc = s_acc, sv.s_sym = s_sym;
        sv.mx_err = mx_err, sv.direction = direction, sv.state = state;
        sv.i = i, sv.e_idx = e_idx, sv.m_idx = m_idx, sv.p_idx = p_idx;
        sv.dm_idx = dm_idx, sv.ds_idx = ds_idx, sv.depth = depth;
        sv.leaf = leaf, sv.n_steps = n_steps, sv.it0 = it0, sv.it = it;
        sv.div = div, sv.turn = turn;
      }
    }
    // the staged positions (and the parked scalars) are whole
    if (!__syncthreads_or(state != GW_DONE)) break;
    if constexpr (Model::GROUP) {
      model.eval_group(G, gs);
      {
        const GrWarmScalars& sv = saved[cb];
        ch = sv.ch, fl = sv.fl;
        q1 = ch.q1();
#pragma unroll
        for (int r = 0; r < LD_NSCA; ++r) sca[r] = sv.sca[r];
        logp = sv.logp, logdet = sv.logdet, step = sv.step;
        e_init = sv.e_init, dm_logp = sv.dm_logp, dm_ke = sv.dm_ke;
        ds_logp = sv.ds_logp, ds_ke = sv.ds_ke, logw_m = sv.logw_m;
        logw_s = sv.logw_s, s_acc = sv.s_acc, s_sym = sv.s_sym;
        mx_err = sv.mx_err, direction = sv.direction, state = sv.state;
        i = sv.i, e_idx = sv.e_idx, m_idx = sv.m_idx, p_idx = sv.p_idx;
        dm_idx = sv.dm_idx, ds_idx = sv.ds_idx, depth = sv.depth;
        leaf = sv.leaf, n_steps = sv.n_steps, it0 = sv.it0, it = sv.it;
        div = sv.div, turn = sv.turn;
      }
    }
    if (state == GW_TREE) {
      const float r_sel = uniform(seed, it, 4u, (uint32_t)b);
      const float r_acc = uniform(seed, it, 5u, (uint32_t)b);
      const float dirf = direction;
      const LdLeap lf = gr_leap_second(ch, model, gs, G, cb, logp_team, dirf,
                                       step, leaf, depth, q1);
      const float logp1 = lf.logp1, ke1 = lf.ke1;
      const float err = (ke1 - (logp1 + logdet)) - e_init;
      const bool diverged = ablate_keep((err > a.max_err) || !isfinite(err));
      const int idx1 = e_idx + (int)dirf;

      const float diff = -err;
      const float acc_p = expf(min0(diff));
      n_steps += 1;
      s_acc = s_acc + (diverged ? 0.0f : acc_p);
      s_sym = s_sym + (diverged ? 0.0f : 2.0f * acc_p / (1.0f + expf(diff)));
      mx_err = diverged ? -INFINITY
                        : (fabsf(diff) > fabsf(mx_err) ? diff : mx_err);

      const float logw_leaf = -err;
      const bool first = leaf == 0;
      logw_s = first ? logw_leaf : logaddexp(logw_s, logw_leaf);
      if (first || (logf(r_sel) < logw_leaf - logw_s)) {
        gr_copy(ch, ch.ds_z(), ch.z1());
        gr_copy(ch, ch.ds_zg(), ch.zg1());
        ds_logp = logp1;
        ds_ke = ke1;
        ds_idx = idx1;
      }

      const bool fwd = dirf > 0.0f;
      const bool subtree_done = (leaf + 1) == (1 << depth);
      const bool do_merge = subtree_done && !diverged && !lf.turning_int;
      if (do_merge) {
        if ((logw_s >= logw_m) || (logf(r_acc) < logw_s - logw_m)) {
          gr_copy(ch, ch.dm_z(), ch.ds_z());
          gr_copy(ch, ch.dm_zg(), ch.ds_zg());
          dm_logp = ds_logp;
          dm_ke = ds_ke;
          dm_idx = ds_idx;
        }
        logw_m = logaddexp(logw_m, logw_s);
        if (fwd) {
          gr_copy(ch, ch.p_z(), ch.z1());
          gr_copy(ch, ch.p_v(), ch.v2());
          gr_copy(ch, ch.p_zg(), ch.zg1());
          p_idx = idx1;
        } else {
          gr_copy(ch, ch.m_z(), ch.z1());
          gr_copy(ch, ch.m_v(), ch.v2());
          gr_copy(ch, ch.m_zg(), ch.zg1());
          m_idx = idx1;
        }
        depth += 1;
      }
      const bool turned = lf.turning_int || (do_merge && lf.turning_top);
      const bool tree_done = diverged || turned || depth >= D;
      const bool new_doub = do_merge && depth < D && !turned;
      div = div || diverged;
      turn = turn || turned;
      if (new_doub) {
        const bool jump_p =
            uniform(seed, it, 6u, (uint32_t)b) < 0.5f;  // new direction
        gr_copy(ch, ch.e_z(), jump_p ? ch.p_z() : ch.m_z());
        gr_copy(ch, ch.e_v(), jump_p ? ch.p_v() : ch.m_v());
        gr_copy(ch, ch.e_zg(), jump_p ? ch.p_zg() : ch.m_zg());
        e_idx = jump_p ? p_idx : m_idx;
        leaf = 0;
        direction = jump_p ? 1.0f : -1.0f;
      } else {
        gr_copy(ch, ch.e_z(), ch.z1());
        gr_copy(ch, ch.e_v(), ch.v2());
        gr_copy(ch, ch.e_zg(), ch.zg1());
        e_idx = idx1;
        leaf += 1;
      }
      it += 1;
      if (tree_done) state = GW_WAIT;
    }

    // ---- the draw ends where the logical block's longest tree did ----
    bool draw_end = state == GW_WAIT;
    uint32_t longest = it - it0;
    if (B > 1) {
      if (lane == 0 && cb < G) {
        waiting[cb] = state == GW_WAIT;
        tree_len[cb] = (int)(it - it0);
      }
      __syncthreads();
      if (draw_end) {
        for (int m = cb - cb % B; m < cb - cb % B + B; ++m) {
          draw_end = draw_end && waiting[m] != 0;
          longest = max(longest, (uint32_t)tree_len[m]);
        }
      }
    }
    if (!draw_end) continue;
    it = it0 + longest;
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
    slot_sums(d, [&](int j, float (&t)[2]) {
      float sd = ch.stds()[j], mn = ch.mean()[j];
      const float dz = ch.dm_z()[j], dzg = ch.dm_zg()[j];
      const float dq = dz * sd + mn;
      const float dg = dzg / sd;
      const float fs = dz + dzg;
      t[0] = fs * fs;
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
        ch.stds()[j] = sd;
        ch.mean()[j] = mn;
      }
      t[1] = logf(sd);
    }, s2);
    const float fisher_sum = s2[0];
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
    if (lane == 0) {
      const float energy_m = dm_ke - (dm_logp + logdet);
      const float rowv[NSTATS_W] = {
          (float)depth, div ? 1.0f : 0.0f, (float)n_steps, s_acc, s_sym,
          mx_err, dm_logp, energy_m, energy_m - e_init, (float)dm_idx,
          fisher_sum, base, (depth >= D && !div && !turn) ? 1.0f : 0.0f, bar,
          tid_n};
      float* st = a.stats + ((size_t)i * C + c) * NSTATS_W;
#pragma unroll
      for (int k = 0; k < NSTATS_W; ++k) st[k] = rowv[k];
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
    i += 1;
    state = i < a.K ? GW_START : GW_DONE;
  }

  if (present) {
    for (int j = lane; j < d; j += 32) {
      a.stds_f[(size_t)c * d + j] = ch.stds()[j];
      a.mean_f[(size_t)c * d + j] = ch.mean()[j];
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < LD_NSCA; ++r) a.sca_f[c * LD_NSCA + r] = sca[r];
      a.logp_f[c] = logp;
      a.iters[c] = (int)it0;
    }
  }
}

// The kernel of a functor's launch.
template <class Model>
auto mid_warmup() {
  return mid_warmup_kernel<Model>;
}

}  // namespace nrt

// Blocks one SM holds of the warmup kernel for `model_id` at `smem` bytes
// (as nrt_mid_posterior_blocks_per_sm).
extern "C" int nrt_mid_warmup_blocks_per_sm(int model_id,
                                            const int* model_ints,
                                            long long smem) {
  int n = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  nrt::with_block_model(
      model_id, no_params, no_ptrs, model_ints, [&](auto model) {
        n = nrt::blocks_per_sm(nrt::mid_warmup<decltype(model)>(), smem);
        return cudaSuccess;
      });
  return n;
}

extern "C" int nrt_mid_warmup_launch(
    int dim, int maxdepth, int C, int B, int G, int K, uint32_t seed,
    float max_err, int has_jitter, float jc1, float jc2,
    int use_grad_based, float target_accept, float da_t0, float da_gamma,
    float da_neg_k, float ls_max, int model_id, const float* model_params,
    const void* const* model_ptrs, const int* model_ints, const int* flags,
    const float* logp, const float* stds, const float* mean,
    const float* sca, float* draws, float* stats, float* q_f, float* g_f,
    float* logp_f, float* stds_f, float* mean_f, float* est_f, float* sca_f,
    int* iters, float* work, void* stream) {
  if (B < 1 || C % B != 0 || dim < 1 || maxdepth < 1 || maxdepth > 30 ||
      K < 1)
    return (int)cudaErrorInvalidValue;
  const nrt::LdWarmArgs a{C,      K,        dim,      maxdepth, seed,
                          max_err, has_jitter, jc1,   jc2,      use_grad_based,
                          target_accept, da_t0, da_gamma, da_neg_k, ls_max,
                          flags,  logp,     stds,     mean,     sca,
                          draws,  stats,    q_f,      g_f,      logp_f,
                          stds_f, mean_f,   est_f,    sca_f,    iters,
                          work};
  const int nvec = nrt::GR_WARM_NVEC;
  return (int)nrt::with_block_model(
      model_id, model_params, model_ptrs, model_ints, [&](auto model) {
        if (!nrt::gr_valid(model, nvec, dim, maxdepth, B, G))
          return cudaErrorInvalidValue;
        return nrt::gr_launch(
            nrt::mid_warmup<decltype(model)>(), a, model, C, B, G,
            nrt::gr_block_bytes(model, nvec, dim, maxdepth, G),
            (cudaStream_t)stream);
      });
}
