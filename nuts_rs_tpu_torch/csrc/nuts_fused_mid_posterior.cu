// Fused draw-asynchronous NUTS posterior for data-carrying models and mid d,
// chains-on-lanes random stream (kernel K1-args).
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// (:82) with n_model_args > 0 (:84,159-166,260), launched by nuts_pallas_run
// (:718; model_args :734,812-817,861,872): K draw-asynchronous NUTS draws per
// chain with the model evaluated as logp_grad_batched(q, *model_args) on
// arrays that every block sees; for the Bernoulli GLM
// (models/gaussian.py:171-180) two [N, d] x [d] products, logaddexp and a
// sigmoid per chain and leapfrog.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference with
// layout="cl" and a model the mid-d kernel serves (nuts_fused.cl_kernel).
// d, maxdepth and the data sizes are launch arguments.
//
// What was chosen, and why:
//
// 1. Chains a block.  A CUDA block of LD_T = 256 threads serves G <= 8
//    chains (nuts_tree_group.cuh): chain cb runs its tree on warp cb, lane l
//    standing for tsum's virtual threads l + 32 w (w = 0..7), so the bits
//    are those of the 256-threads-a-chain body.  G is the most chains, a
//    power of two, whose live vectors (21 a chain, in dynamic shared
//    memory), cached-dot rows and the model's scratch fit a block's opt-in
//    shared memory (_build.mid_group; gr_chains here, checked at launch):
//    8 at d = 100 with the regression's scratch, so 1024 chains are 128
//    blocks, one wave on 132 SMs.  The stacks stay in a global workspace.
//    A chain count that G does not divide leaves the last block partly
//    empty; its absent chains' warps join only the evaluation.  Where G < 8
//    (d above about 340 at small maxdepth) the warps of absent chains idle
//    in the tree: a chain's tree always runs on one warp, whose slots and
//    sums are then the same code at every G.
// 2. Random stream.  The layout of a configuration is the JAX runners'
//    (chain.fused_layout), and these sizes are "cl" there, so a vector site
//    is element j * B + b of the block's (d, B) shape (block_site<true>),
//    not the dim-on-lanes b * d + j; scalar sites, salts and the block seed
//    seed + 0x51ED2701 * pid are those of every fused NUTS kernel.  With
//    that the plain version replays interpret-mode Pallas draw for draw.
// 3. The model.  The regression's group form (models.cuh::LogisticRegression
//    eval_group) is evaluated by all 256 threads for the G chains between
//    two block barriers, one load of x serving every chain; every other
//    functor's eval_team runs on the chain's warp.  LogisticRegression
//    holds device pointers to the data.
// 4. Sums.  Every sum has one order, shared with the plain version: a
//    logit's terms in ascending j by one thread (ops.dsum); the
//    log-likelihood's and each gradient column's terms over n, the prior's
//    terms over j and every dot product of the tree in the block order
//    (ops.tsum: a thread's terms ascending, the warp butterfly, the 8 warp
//    sums halved), which a warp forms for its chain slot by slot
//    (block_sum.cuh::slot_sums).  No atomics, no tensor cores: TF32 would
//    round the products' inputs, and the port keeps TF32 off.
// 5. Spellings are the JAX body's: y logits - logaddexp(0, logits),
//    p = 1 / (1 + exp(-logits)), grad = x^T (y - p) - q, in IEEE f32 with
//    -fmad=false.
// 6. The data, x transposed [d, N] so that the threads of a warp (rows
//    n, n + 1, ...) read neighbouring addresses in both products, stays in
//    global memory and is read through L2 (400 KB at N = 1000, d = 100).
//    Before this design a block served one chain, so every chain reread x
//    for every evaluation (0.8 MB of L2 traffic a chain and leapfrog, 24 of
//    a 27 us iteration at one chain block an SM); now a block's read serves
//    its G chains, thread t forming the logits of its rows for all of them
//    (a register tile of 4 rows x 8 chains, 64 FP32 operations a load of a
//    column's 4 rows), and the next columns' loads in flight while the
//    current ones are used.
// 7. Draw-asynchronous on each chain's counter `it`: one block iteration is
//    one leapfrog of every chain that still iterates; a chain iterates
//    while a chain of its logical block of B (a divisor of G, default 1)
//    lacks K draws, so at B = 1 each runs to its own K draws and the final
//    q/g/logp are the selected point there; the block runs until its last
//    chain is done.

#include "nuts_fused_ld_posterior.cuh"
#include "nuts_tree_group.cuh"

namespace nrt {

// A chain's loop-carried scalars and its vectors' base pointers, which wait
// in shared memory while the block evaluates the regression's group form:
// their registers (and those of every address the tree derives from the
// pointers) are then free for the products' tiles.
struct GrPostScalars {
  GrChain ch;
  float logdet, bar, step, e_init, dm_logp, dm_ke, ds_logp, ds_ke, logw_m,
      logw_s, s_acc, s_sym, mx_err, direction;
  int dc, e_idx, m_idx, p_idx, dm_idx, ds_idx, depth, leaf, n_steps;
  uint32_t it;
};
static_assert(sizeof(GrPostScalars) <= 4 * GR_SCALAR_FLOATS,
              "a chain's slot of scalars");

// K1-args: G chains a block, chain cb on warp cb (warps G.. only join the
// group form's evaluation).  Every chain runs ld_posterior_chain's steps on
// its warp; one block iteration is one leapfrog of every chain that still
// iterates, with the model evaluated between the leapfrog's two passes.  A
// chain iterates while a chain of its logical block of B (G is a multiple of
// B) lacks K draws: at B = 1 until its own K draws, so every chain runs
// draw-asynchronously to its K draws; B > 1 adds one barrier an iteration
// for the block mates' flags.  The block runs until its last chain is done.
template <class Model>
__global__ void __launch_bounds__(LD_T, 1)
    mid_posterior_kernel(const LdPostArgs a, const Model model, int B,
                         int G) {
  extern __shared__ float4 gr_smem[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(gr_smem);
  const int lane = gr_lane(), cb = threadIdx.x >> 5;
  const int C = a.C, K = a.K, d = a.d, D = a.D;
  const int c = blockIdx.x * G + cb;
  const bool present = cb < G && c < C;
  float* gs = smem;  // the group form's
  int* need = reinterpret_cast<int*>(smem + gr_group_floats(model, G));
  GrPostScalars* saved = reinterpret_cast<GrPostScalars*>(
      smem + gr_group_floats(model, G) + GR_FLAG_FLOATS);
  const size_t cf = gr_chain_floats(model, GR_POST_NVEC, d, D);
  GrChain ch = gr_chain(smem + gr_group_floats(model, G) + GR_FLAG_FLOATS +
                            gr_scalar_floats(model) + (size_t)cb * cf,
                        a.work, c, d, D);
  float* q1 = ch.q1();
  float* const scratch = ch.v(GR_POST_NVEC);  // a team functor's
  float* qg = nullptr;
  if constexpr (Model::GROUP) {
    qg = gs + cb;
    // the staged positions of absent chains stay 0.0: finite logits
    for (int j = threadIdx.x; j < GR_MAX * d; j += LD_T) gs[j] = 0.0f;
  }
  const int b = c % B, pid = c / B;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)pid;

  float logdet = 0.0f, bar = 0.0f, step = 0.0f, logp0 = 0.0f, e_init = 0.0f;
  int dc = 0;
  int e_idx = 0, m_idx = 0, p_idx = 0, dm_idx = 0, ds_idx = 0;
  float dm_logp = 0.0f, dm_ke = 0.0f, ds_logp = 0.0f, ds_ke = 0.0f;
  float logw_m = 0.0f, logw_s = -INFINITY;
  int depth = 0, leaf = 0, n_steps = 0;
  float s_acc = 0.0f, s_sym = 0.0f, mx_err = 0.0f, direction = 1.0f;
  if (present) {
    logdet = a.logdet[c];
    bar = a.bar[c];
    step = a.step0[c];
    logp0 = a.logp[c];
    float vv[1];
    slot_sums(d, [&](int j, float (&t)[1]) {
      const size_t gj = (size_t)c * d + j;
      const float sd = a.stds[gj];
      const float mn = a.mean[gj];
      const float q0 = a.q[gj];
      const float z0 = (q0 - mn) / sd;
      const float zg0 = a.g[gj] * sd;
      const float v0 = normal(seed, 0u, 1u, 2u, block_site<true>(b, B, d, j));
      ch.stds()[j] = sd;
      ch.mean()[j] = mn;
      ch.e_z()[j] = ch.m_z()[j] = ch.p_z()[j] = z0;
      ch.dm_z()[j] = ch.ds_z()[j] = z0;
      ch.e_zg()[j] = ch.m_zg()[j] = ch.p_zg()[j] = zg0;
      ch.dm_zg()[j] = ch.ds_zg()[j] = zg0;
      ch.e_v()[j] = ch.m_v()[j] = ch.p_v()[j] = v0;
      ch.dm_q()[j] = ch.ds_q()[j] = q0;
      t[0] = v0 * v0;
    }, vv);
    for (int j = lane; j <= D; j += 32) ch.bl()[j] = ch.bm()[j] = 0.0f;
    __syncwarp();
    const float ke0 = 0.5f * vv[0];
    e_init = ke0 - (logp0 + logdet);
    dm_logp = ds_logp = logp0;
    dm_ke = ds_ke = ke0;
    direction = uniform(seed, 0u, 3u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;
  }

  bool run = present;
  float logp_team = 0.0f;
  uint32_t it = 1;
  while (true) {
    if (run) {
      gr_leap_first(ch, direction, step, q1, qg);
#ifndef NRT_ABLATE_EVAL
      if constexpr (!Model::GROUP) {
        __syncwarp();
        logp_team = model.eval_team(q1, ch.zg1(), d, scratch);
        __syncwarp();
      }
#endif
    }
    if constexpr (Model::GROUP) {
      // every warp parks and reloads, so that no path keeps them live
      if (lane == 0) {
        GrPostScalars& sv = saved[cb];
        sv.ch = ch;
        sv.logdet = logdet, sv.bar = bar, sv.step = step, sv.e_init = e_init;
        sv.dm_logp = dm_logp, sv.dm_ke = dm_ke, sv.ds_logp = ds_logp;
        sv.ds_ke = ds_ke, sv.logw_m = logw_m, sv.logw_s = logw_s;
        sv.s_acc = s_acc, sv.s_sym = s_sym, sv.mx_err = mx_err;
        sv.direction = direction, sv.dc = dc, sv.e_idx = e_idx;
        sv.m_idx = m_idx, sv.p_idx = p_idx, sv.dm_idx = dm_idx;
        sv.ds_idx = ds_idx, sv.depth = depth, sv.leaf = leaf;
        sv.n_steps = n_steps, sv.it = it;
      }
    }
    // the staged positions (and the saved scalars) are whole
    if (!__syncthreads_or(run)) break;
    if constexpr (Model::GROUP) {
#ifndef NRT_ABLATE_EVAL
      model.eval_group(G, gs);
#endif
      {
        const GrPostScalars& sv = saved[cb];
        ch = sv.ch;
        q1 = ch.q1();
        logdet = sv.logdet, bar = sv.bar, step = sv.step, e_init = sv.e_init;
        dm_logp = sv.dm_logp, dm_ke = sv.dm_ke, ds_logp = sv.ds_logp;
        ds_ke = sv.ds_ke, logw_m = sv.logw_m, logw_s = sv.logw_s;
        s_acc = sv.s_acc, s_sym = sv.s_sym, mx_err = sv.mx_err;
        direction = sv.direction, dc = sv.dc, e_idx = sv.e_idx;
        m_idx = sv.m_idx, p_idx = sv.p_idx, dm_idx = sv.dm_idx;
        ds_idx = sv.ds_idx, depth = sv.depth, leaf = sv.leaf;
        n_steps = sv.n_steps, it = sv.it;
      }
    }
    if (run) {
      const float r_sel = uniform(seed, it, 4u, (uint32_t)b);
      const float r_acc = uniform(seed, it, 5u, (uint32_t)b);
      const float dirf = direction;
      const LdLeap lf = gr_leap_second(ch, model, gs, G, cb, logp_team, dirf,
                                       step, leaf, depth, q1);
      const float logp1 = lf.logp1, ke1 = lf.ke1;
      const float err = (ke1 - (logp1 + logdet)) - e_init;
      const bool diverged = ablate_keep((err > a.max_err) || !isfinite(err));
      const int idx1 = e_idx + (int)dirf;

      // ---- accept stats ----
      const float diff = -err;
      const float acc_p = expf(min0(diff));
      n_steps += 1;
      s_acc = s_acc + (diverged ? 0.0f : acc_p);
      s_sym = s_sym + (diverged ? 0.0f : 2.0f * acc_p / (1.0f + expf(diff)));
      mx_err = diverged ? -INFINITY
                        : (fabsf(diff) > fabsf(mx_err) ? diff : mx_err);

      // ---- progressive multinomial within the subtree ----
      const float logw_leaf = -err;
      const bool first = leaf == 0;
      logw_s = first ? logw_leaf : logaddexp(logw_s, logw_leaf);
      if (first || (logf(r_sel) < logw_leaf - logw_s)) {
        gr_copy(ch, ch.ds_z(), ch.z1());
        gr_copy(ch, ch.ds_zg(), ch.zg1());
        gr_copy(ch, ch.ds_q(), q1);
        ds_logp = logp1;
        ds_ke = ke1;
        ds_idx = idx1;
      }

      // ---- top-level merge (biased acceptance) ----
      const bool fwd = dirf > 0.0f;
      const bool subtree_done = (leaf + 1) == (1 << depth);
      const bool do_merge = subtree_done && !diverged && !lf.turning_int;
      if (do_merge) {
        if ((logw_s >= logw_m) || (logf(r_acc) < logw_s - logw_m)) {
          gr_copy(ch, ch.dm_z(), ch.ds_z());
          gr_copy(ch, ch.dm_zg(), ch.ds_zg());
          gr_copy(ch, ch.dm_q(), ch.ds_q());
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
      const bool fin = diverged || turned || depth >= D;

      // ---- emit the draw where the tree finished ----
      if (fin && dc < K) {
        float* out = a.draws + ((size_t)dc * C + c) * d;
        float fs[1];
        slot_sums(d, [&](int j, float (&t)[1]) {
          const float sm = ch.dm_z()[j] + ch.dm_zg()[j];
          t[0] = sm * sm;
          out[j] = ch.dm_q()[j];
        }, fs);
        const float fisher = fs[0];
        if (lane == 0) {
          const float energy_m = dm_ke - (dm_logp + logdet);
          const float rowv[NSTATS] = {
              (float)depth, diverged ? 1.0f : 0.0f, (float)n_steps, s_acc,
              s_sym, mx_err, dm_logp, energy_m, energy_m - e_init,
              (float)dm_idx, fisher, step,
              (depth >= D && !turned && !diverged) ? 1.0f : 0.0f};
          float* st = a.stats + ((size_t)dc * C + c) * NSTATS;
#pragma unroll
          for (int k = 0; k < NSTATS; ++k) st[k] = rowv[k];
        }
      }

      // ---- next state: fresh draw / new doubling / same subtree ----
      const float new_dir =
          uniform(seed, it, 6u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;
      const bool new_doub = do_merge && !fin;
      if (fin) {
        float ks[1];
        slot_sums(d, [&](int j, float (&t)[1]) {
          const float vn =
              normal(seed, it, 7u, 8u, block_site<true>(b, B, d, j));
          const float z = ch.dm_z()[j], zg = ch.dm_zg()[j];
          ch.e_z()[j] = ch.m_z()[j] = ch.p_z()[j] = z;
          ch.e_v()[j] = ch.m_v()[j] = ch.p_v()[j] = vn;
          ch.e_zg()[j] = ch.m_zg()[j] = ch.p_zg()[j] = zg;
          t[0] = vn * vn;
        }, ks);
        const float ke_new = 0.5f * ks[0];
        if (a.has_jitter)
          step = bar * (a.jc1 + a.jc2 * uniform(seed, it, 9u, (uint32_t)b));
        else
          step = bar;
        e_init = ke_new - (dm_logp + logdet);
        dc += 1;
        e_idx = m_idx = p_idx = dm_idx = 0;
        dm_ke = ke_new;
        logw_m = 0.0f;
        depth = 0;
        n_steps = 0;
        s_acc = s_sym = mx_err = 0.0f;
      } else if (new_doub) {
        const bool jump_p = new_dir > 0.0f;
        gr_copy(ch, ch.e_z(), jump_p ? ch.p_z() : ch.m_z());
        gr_copy(ch, ch.e_v(), jump_p ? ch.p_v() : ch.m_v());
        gr_copy(ch, ch.e_zg(), jump_p ? ch.p_zg() : ch.m_zg());
        e_idx = jump_p ? p_idx : m_idx;
      } else {
        gr_copy(ch, ch.e_z(), ch.z1());
        gr_copy(ch, ch.e_v(), ch.v2());
        gr_copy(ch, ch.e_zg(), ch.zg1());
        e_idx = idx1;
      }
      if (fin || new_doub) {
        leaf = 0;
        direction = new_dir;
      } else {
        leaf += 1;
      }
      it += 1;
    }
    // a chain iterates on while a chain of its logical block lacks draws
    if (B > 1) {
      if (lane == 0 && cb < G) need[cb] = run && dc < K;
      __syncthreads();
      bool any = false;
      if (cb < G)
        for (int m = cb - cb % B; m < cb - cb % B + B; ++m)
          any = any || need[m] != 0;
      run = run && any;
    } else {
      run = run && dc < K;
    }
  }

  if (present) {
    for (int j = lane; j < d; j += 32) {
      a.q_f[(size_t)c * d + j] = ch.dm_q()[j];
      a.g_f[(size_t)c * d + j] = ch.dm_zg()[j] / ch.stds()[j];
    }
    if (lane == 0) {
      a.logp_f[c] = dm_logp;
      a.iters[c] = (int)it;
    }
  }
}

// The kernel of a functor's launch.
template <class Model>
auto mid_posterior() {
  return mid_posterior_kernel<Model>;
}


}  // namespace nrt

// Shared memory of a block of G chains of the mid-d kernels, in bytes (0:
// posterior kernel, 1: warmup kernel, whose 19 vectors keep q1); -1 for a
// model id that no functor of the library has.
extern "C" long long nrt_mid_group_bytes(int warmup, int d, int maxdepth,
                                         int model_id, const int* model_ints,
                                         int G) {
  long long bytes = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  nrt::with_block_model(
      model_id, no_params, no_ptrs, model_ints, [&](auto model) {
        bytes = nrt::gr_block_bytes(
            model, warmup ? nrt::GR_WARM_NVEC : nrt::GR_POST_NVEC, d,
            maxdepth, G);
        return cudaSuccess;
      });
  return bytes;
}

// The rule's G for a launch (nrt::gr_chains); -1 for an unknown model id.
extern "C" int nrt_mid_group(int warmup, int d, int maxdepth, int model_id,
                             const int* model_ints) {
  int G = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  nrt::with_block_model(
      model_id, no_params, no_ptrs, model_ints, [&](auto model) {
        G = nrt::gr_chains(
            model, warmup ? nrt::GR_WARM_NVEC : nrt::GR_POST_NVEC, d,
            maxdepth);
        return cudaSuccess;
      });
  return G;
}

// Blocks one SM holds of the posterior kernel for `model_id` at `smem`
// bytes (minus a CUDA error code where the query fails; -1 for an unknown
// model id).
extern "C" int nrt_mid_posterior_blocks_per_sm(int model_id,
                                               const int* model_ints,
                                               long long smem) {
  int n = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  nrt::with_block_model(
      model_id, no_params, no_ptrs, model_ints, [&](auto model) {
        n = nrt::blocks_per_sm(nrt::mid_posterior<decltype(model)>(), smem);
        return cudaSuccess;
      });
  return n;
}

extern "C" int nrt_mid_posterior_launch(
    int dim, int maxdepth, int C, int B, int G, int K, uint32_t seed,
    float max_err, int has_jitter, float jc1, float jc2, int model_id,
    const float* model_params, const void* const* model_ptrs,
    const int* model_ints, const float* q, const float* g, const float* logp,
    const float* stds, const float* mean, const float* logdet,
    const float* step0, const float* bar, float* draws, float* stats,
    float* q_f, float* g_f, float* logp_f, int* iters, float* work,
    void* stream) {
  if (B < 1 || C % B != 0 || dim < 1 || maxdepth < 1 || maxdepth > 30)
    return (int)cudaErrorInvalidValue;
  const nrt::LdPostArgs a{C,    K,    dim,  maxdepth, seed,   max_err,
                          has_jitter, jc1, jc2, q,    g,      logp,
                          stds, mean, logdet, step0,  bar,    draws,
                          stats, q_f, g_f,  logp_f,   iters,  work};
  return (int)nrt::with_block_model(
      model_id, model_params, model_ptrs, model_ints, [&](auto model) {
        if (!nrt::gr_valid(model, nrt::GR_POST_NVEC, dim, maxdepth, B, G))
          return cudaErrorInvalidValue;
        return nrt::gr_launch(
            nrt::mid_posterior<decltype(model)>(), a, model, C, B, G,
            nrt::gr_block_bytes(model, nrt::GR_POST_NVEC, dim, maxdepth, G),
            (cudaStream_t)stream);
      });
}
