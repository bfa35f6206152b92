// Fused lock-step MCLMC warmup with in-kernel adaptation for the logistic
// regression, G chains a CUDA block: the group form of kernel K4-args.
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/mclmc_pallas.py::make_mclmc_warmup_kernel (:504) with
// n_model_args > 0 (:506,532-536,574), launched by mclmc_pallas_warmup_run
// (:887; model_args :901,948-951,986-1000), for the Bernoulli GLM under the
// microcanonical dynamics: K lock-step MCLMC tuning draws with the FIXED
// jittered step, the fg/bg estimators and the diagonal rule in the kernel.
// The launch of one chain group per pallas_call (:916-929) works around a
// Mosaic fault with identical streams and has no counterpart here: one
// launch takes every block.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py::mclmc_fused_warmup_run_reference
// on a model the mid-d kernels serve (nuts_fused.cl_kernel).  The other
// functors, and the Euclidean dynamics (the warmup's first draws, whose
// trajectories differ most between chains), take the 256-threads-a-chain
// form of K4-args (mclmc_fused_mid_warmup.cu): _build.MCLMC_MID_FORMS holds
// the choice and the measurement behind it.
//
// The design is the one of K3-args' group form
// (mclmc_fused_group_posterior.cu: G <= 8 chains a CUDA block of 256
// threads, a chain's trajectory on its warp, mclmc_step_group.cuh, 15 live
// vectors in shared memory, the regression's group form evaluated by the
// whole block for its G chains, the chains-on-lanes site index j * B + b,
// every sum in ops.tsum's order), with the draw loop of K4
// (mclmc_fused_warmup.cu): each draw re-derives z and zg from the chain's q
// and g under the current (stds, mean) and carries v verbatim unless the
// schedule resamples it; the adaptation sees the trajectory end; on a
// give-up the emitted draw is the draw start with fresh momentum.
//
// The counter `it` is shared by the logical block of B chains (a divisor of
// G), and the give-up momentum is drawn at the block's `it` after the
// draw's last iteration, so the chains of a logical block stay in step from
// draw to draw.  One block iteration is one leapfrog try of every chain
// inside a trajectory; a chain whose trajectory has ended waits, counting
// the iterations, until every chain of its logical block has ended (B > 1:
// the warps tell each other between iterations, one barrier), so that all
// of them reach the draw's end at the longest trajectory's count; at the
// default B = 1 a chain ends its draw and starts the next in the iteration
// in which its trajectory ends.  No thread block cluster.  The adaptation
// runs per coordinate on diag_adapt.cuh's functions.  The chain's current
// q and g and the eight estimator planes, touched once per draw, stay in
// device memory (the output buffers, which the launcher fills with the
// inputs).
//
// What bounds it: as K3-args, and a CUDA block runs until the last of its
// G chains has its K draws.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "diag_adapt.cuh"
#include "mclmc_step_group.cuh"
#include "models.cuh"

namespace nrt {

// flags columns and packed scalar rows, as mclmc_fused.py FLAG_* / SCA_*
enum { MM_UPD_EST = 0, MM_DO_UPDATE = 1, MM_DO_SWITCH = 5, MM_RESAMPLE = 6,
       MM_NFLAGS = 8 };
enum { MMS_TID = 0, MMS_LOGDET, MMS_CNT_FG, MMS_CNT_BG, MMS_NSCA };
// where a chain is in its draw
enum { MW_TRAJ = 0, MW_WAIT = 1, MW_DONE = 2 };

struct McGroupWarmArgs {
  int C, K, d;
  int H;  // the halving stack's depth (0: no dynamic step size)
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

// A chain's loop-carried scalars, parked in shared memory while the block
// evaluates the regression's group form.
struct MgWarmState {
  MgChain ch;
  MgTraj s;
  MgHalf h;
  float sca[MMS_NSCA];
  float step, ld, e_init, logp;
  int nsd, i, phase, div;
  uint32_t it, it0;
};
static_assert(sizeof(MgWarmState) <= 4 * GR_SCALAR_FLOATS,
              "a chain's slot of parked scalars");

// A fresh trajectory for draw w.i at the block's counter w.it
// (initialize_trajectory semantics): z and zg from the chain's q and g,
// the momentum resampled where the schedule says so, the next noise.
__device__ __forceinline__ void mw_start_draw(const McGroupWarmArgs& a,
                                              MgWarmState& w,
                                              const float* q, const float* g,
                                              uint32_t seed, uint32_t sj,
                                              int b, int B) {
  const MgChain& ch = w.ch;
  const uint32_t it = w.it;
  const int* fl = a.flags + w.i * MM_NFLAGS;
  w.ld = w.sca[MMS_LOGDET];
  float step = a.fixed_step;
  if (a.has_jitter)
    step = step * (a.jc1 + a.jc2 * uniform(seed, it, 1u, (uint32_t)b));
  w.step = step;
  w.nsd = mg_num_steps(step, a.k);
  const bool resample = fl[MM_RESAMPLE] != 0;
  float vv[1];
  lane_sums(ch.d, [&](int j, float (&t)[1]) {
    const uint32_t site = mg_site(j, b, B);
    const float sd = ch.stds()[j];
    const float z0 = (q[j] - ch.mean()[j]) / sd;
    const float zg0 = g[j] * sd;
    ch.z()[j] = ch.z0()[j] = z0;
    ch.zg()[j] = ch.zg0()[j] = zg0;
    if (resample) ch.v()[j] = normal(seed, it, 1u + sj, 2u + sj, site);
    ch.noise()[j] = normal(seed, it, 3u + sj, 4u + sj, site);
    t[0] = ch.v()[j] * ch.v()[j];
  }, vv);
  if (resample) mg_divide(ch, ch.v(), sqrtf(vv[0]));
  w.s.ke = 0.0f;
  w.s.logp = w.logp;
  w.e_init = w.s.ke - (w.logp + w.ld);
  mg_start(w.s, w.nsd);
  w.phase = MW_TRAJ;
}

// The end of draw w.i at the logical block's counter w.it: the emitted draw
// (the trajectory end, or on a give-up the draw start with fresh momentum),
// the estimators and the diagonal rule on the trajectory end, row i of the
// stats.
__device__ __forceinline__ void mw_end_draw(const McGroupWarmArgs& a,
                                            MgWarmState& w, float* q,
                                            float* g, float* est, int c,
                                            uint32_t seed, uint32_t sj, int b,
                                            int B) {
  const MgChain& ch = w.ch;
  const int d = ch.d, C = a.C, i = w.i;
  const int* fl = a.flags + i * MM_NFLAGS;
  const bool div = w.div != 0;
  const float logdet = w.ld;
  const bool is_good = (div && w.s.steps > 4) || (!div && w.s.steps != 0);
  const float e_change = (w.s.ke - (w.s.logp + logdet)) - w.e_init;
  float em_ke = w.s.ke, em_logp = w.s.logp;
  if (div) {
    // the microcanonical give-up momentum has no kinetic energy
    mg_give_up_momentum(ch, seed, w.it, 9u + sj, b, B);
    em_ke = 0.0f;
    em_logp = w.logp;
  }
  const bool inc = (fl[MM_UPD_EST] != 0) && is_good;
  const bool do_switch = fl[MM_DO_SWITCH] != 0;
  const float cnt_fg_in = w.sca[MMS_CNT_FG] + 1.0f;  // counts after the draw
  const float cnt_bg_in = w.sca[MMS_CNT_BG] + 1.0f;
  float cnt_fg = w.sca[MMS_CNT_FG] + (inc ? 1.0f : 0.0f);
  float cnt_bg = w.sca[MMS_CNT_BG] + (inc ? 1.0f : 0.0f);
  if (do_switch) {
    cnt_fg = cnt_bg;
    cnt_bg = 0.0f;
  }
  const bool enough = (fl[MM_DO_UPDATE] != 0) && cnt_fg >= 3.0f;
  const bool grad_based = a.use_grad_based != 0;
  float* out = a.draws + ((size_t)i * C + c) * d;
  float s2[2];  // fisher distance, sum log stds
  lane_sums(d, [&](int j, float (&t)[2]) {
    float sd = ch.stds()[j], mn = ch.mean()[j];
    const float q_coll = ch.z()[j] * sd + mn;
    const float g_coll = ch.zg()[j] / sd;
    const float em_z = div ? ch.z0()[j] : ch.z()[j];
    const float em_zg = div ? ch.zg0()[j] : ch.zg()[j];
    const float fs = em_z + em_zg;
    t[0] = fs * fs;
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
      ch.stds()[j] = sd;
      ch.mean()[j] = mn;
    }
    t[1] = logf(sd);
  }, s2);
  const float tid_n = w.sca[MMS_TID] + (enough ? 1.0f : 0.0f);
  if (gr_lane() == 0) {
    const float row[NSTATS_MW] = {
        div ? 1.0f : 0.0f, (float)w.s.steps, e_change,
        w.s.ttime / (float)max(w.s.steps, 1), w.step, em_logp,
        em_ke - (em_logp + logdet), s2[0], tid_n};
    float* st = a.stats + ((size_t)i * C + c) * NSTATS_MW;
#pragma unroll
    for (int r = 0; r < NSTATS_MW; ++r) st[r] = row[r];
  }
  w.sca[MMS_TID] = tid_n;
  w.sca[MMS_LOGDET] = -s2[1];
  w.sca[MMS_CNT_FG] = cnt_fg;
  w.sca[MMS_CNT_BG] = cnt_bg;
  w.logp = em_logp;
}

__global__ void __launch_bounds__(LD_T, 1)
    mclmc_group_warmup_kernel(const McGroupWarmArgs a,
                              const LogisticRegression model, int B, int G) {
  extern __shared__ float4 mg_smem[];  // 16-byte aligned
  const MgBlock blk = mg_block(reinterpret_cast<float*>(mg_smem), model, G);
  const int lane = gr_lane(), cb = threadIdx.x >> 5;
  const int C = a.C, d = a.d;
  const int c = blockIdx.x * G + cb;
  const bool present = cb < G && c < C;
  const int b = c % B;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)(c / B);
  // salts shift by one when the jitter draw (salt 1) is present
  const uint32_t sj = a.has_jitter ? 1u : 0u;
  MgWarmState* parked = reinterpret_cast<MgWarmState*>(blk.parked);
  float* q = a.q_f + (size_t)c * d;  // the chain's current point
  float* g = a.g_f + (size_t)c * d;
  float* est = a.est_f + (size_t)c * NEST * d;  // [NEST][d]
  // the staged positions of absent chains stay 0.0: finite logits
  for (int j = threadIdx.x; j < GR_MAX * d; j += LD_T) blk.gs[j] = 0.0f;

  MgWarmState w;
  w.ch = MgChain{blk.chains + (size_t)cb * mg_chain_floats(d), d};
  w.h = MgHalf{0.0f, 0.0f};
  w.i = 0;
  w.div = 0;
  w.it = w.it0 = 1;  // the block's counter, and at the draw's first iteration
  w.phase = MW_DONE;
  if (present) {
#pragma unroll
    for (int r = 0; r < MMS_NSCA; ++r) w.sca[r] = a.sca[c * MMS_NSCA + r];
    w.logp = a.logp[c];
    for (int j = lane; j < d; j += 32) {
      const size_t gj = (size_t)c * d + j;
      w.ch.stds()[j] = a.stds[gj];
      w.ch.mean()[j] = a.mean[gj];
      w.ch.v()[j] = a.v[gj];
    }
    mw_start_draw(a, w, q, g, seed, sj, b, B);
  }

  while (true) {
    const bool traj = w.phase == MW_TRAJ;
    if (traj)
      w.h = mg_leap_first(w.ch, w.s, model, blk.gs, cb, w.step, w.ld, a.k);
    if (lane == 0) parked[cb] = w;
    // the staged positions (and the parked scalars) are whole
    if (!__syncthreads_or(w.phase != MW_DONE)) break;
#ifndef NRT_ABLATE_EVAL
    model.eval_group(G, blk.gs);
#else
    __syncthreads();
#endif
    w = parked[cb];
    __syncwarp();  // every lane has its scalars before lane 0 parks again
    if (traj) {
      const int r = mg_leap_second(a.H, w.ch, w.s, w.h, model, blk.gs, G, cb,
                                   w.step, w.nsd, w.ld, a.k, seed, w.it,
                                   5u + sj, b, B);
      w.it += 1;
      if (r != MC_CONTINUE) {
        w.div = r == MC_GAVE_UP;
        w.phase = MW_WAIT;
      }
    } else if (w.phase == MW_WAIT) {
      w.it += 1;  // the longest trajectory of the logical block runs on
    }
    // the draw ends where every chain of the logical block has ended its
    // trajectory: at the longest one's counter
    const bool ended =
        B > 1 ? !mg_block_any(blk.flag, cb, G, B, w.phase == MW_TRAJ) : true;
    if (ended && w.phase == MW_WAIT) {
      mw_end_draw(a, w, q, g, est, c, seed, sj, b, B);
      w.it0 = w.it;
      w.i += 1;
      if (w.i < a.K)
        mw_start_draw(a, w, q, g, seed, sj, b, B);
      else
        w.phase = MW_DONE;
    }
  }

  if (present) {
    for (int j = lane; j < d; j += 32) {
      const size_t gj = (size_t)c * d + j;
      a.v_f[gj] = w.ch.v()[j];
      a.stds_f[gj] = w.ch.stds()[j];
      a.mean_f[gj] = w.ch.mean()[j];
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < MMS_NSCA; ++r) a.sca_f[c * MMS_NSCA + r] = w.sca[r];
      a.logp_f[c] = w.logp;
      a.iters[c] = (int)w.it0;
    }
  }
}

}  // namespace nrt

// Blocks one SM holds of the warmup kernel at `smem` bytes (minus a CUDA
// error code where the query fails).
extern "C" int nrt_mclmc_group_warmup_blocks_per_sm(long long smem) {
  return nrt::blocks_per_sm(nrt::mclmc_group_warmup_kernel, smem);
}

extern "C" int nrt_mclmc_group_warmup_launch(
    int dim, int dynamic, int C, int B, int G, int K, uint32_t seed,
    float max_err, float ell, float fsub_ell, float sqrt_n, float fixed_step,
    int has_jitter, float jc1, float jc2, int use_grad_based,
    const void* const* model_ptrs, const int* model_ints, const int* flags,
    const float* logp, const float* v, const float* stds, const float* mean,
    const float* sca, float* draws, float* stats, float* q_f, float* g_f,
    float* logp_f, float* v_f, float* stds_f, float* mean_f, float* est_f,
    float* sca_f, int* iters, void* stream) {
  const nrt::LogisticRegression model =
      nrt::group_model(model_ints, model_ptrs);
  if (C % B != 0 || dim < 1 || K < 1 || model.d != dim ||
      !nrt::mg_valid(model, dim, B, G))
    return (int)cudaErrorInvalidValue;
  const nrt::McGroupWarmArgs a{C,      K,      dim,
                               dynamic ? nrt::MAX_HALVINGS : 0,
                               seed,   {max_err, ell, fsub_ell, sqrt_n},
                               fixed_step, has_jitter, jc1, jc2,
                               use_grad_based, flags, logp, v, stds, mean,
                               sca,    draws,  stats,  q_f,    g_f,
                               logp_f, v_f,    stds_f, mean_f, est_f,
                               sca_f,  iters};
  return (int)nrt::gr_launch(nrt::mclmc_group_warmup_kernel, a, model, C, B,
                             G, nrt::mg_block_bytes(model, dim, G),
                             (cudaStream_t)stream);
}
