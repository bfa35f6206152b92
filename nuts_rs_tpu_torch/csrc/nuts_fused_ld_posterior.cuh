// Fused draw-asynchronous NUTS posterior with several threads a chain: the
// kernel body of K1-ld (dim-on-lanes layout, nuts_fused_ld_posterior.cu), of
// K1-ld-args (the same with the model's data, its eval_block form,
// nuts_fused_ld_args_posterior.cu) and, with CL_SITE and FLOW, of the
// chains-on-lanes kernel K1-flow (nuts_fused_flow_posterior.cu), which
// differs in the index of a vector random site (nuts_tree_ld.cuh).
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// (:82) with layout="ld" (:123-136,167-173,337-339,450-474), launched by
// nuts_pallas_run (:718, ld shapes :769-775,821-835,874-879, pallas_call
// :863).  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference with
// layout="ld".  d and maxdepth are launch arguments.
//
// What bounds it on this card: at d = 1000 a leapfrog moves a few KB per
// chain and does a few thousand operations, so neither bytes nor operations
// but the time of one block iteration's steps, which all 8 warps of the
// chain's block issue: a pass over the chain's coordinates, a block-wide sum
// (shuffles, one __syncthreads, shared-memory reads), the scalar tree
// logic, which every thread of the block repeats, and the sums of the
// active U-turn levels over stack rows read from L2.  Today's leapfrog
// (one reduction a U-turn level, copies of the new point) split its 7365
// cycles into the pass 1878, its reduction 1428, the checks 1330 and the
// scalar tree 2728 (one chain alone at d = 1000, every tree 15 leapfrogs;
// profile_main_path.py item 15, PERF.md).
//
// What the design does about it: one CUDA block of LD_T = 256 threads per
// chain, a thread owning every 256th coordinate (4 at d = 1000), so a pass
// is a few operations per thread.  The 21 live vectors of a chain sit in
// dynamic shared memory (87 KB at d = 1000; d up to 2757 at maxdepth 10);
// the four checkpoint stacks ((D + 1) x d each, 176 KB per chain at
// d = 1000, maxdepth 10) are a global-memory workspace of which a leapfrog
// writes two rows per stack and reads only the rows of the U-turn levels it
// completes (the Pallas body reads all 11 through masked sums or keeps a
// cross-dot matrix).  In K1-ld (MERGED) one pass forms the leapfrog's sums
// and the checks' dots, its inputs loaded ahead, and one wide reduction
// gives them all (nuts_tree_ld.cuh::ld_leap_merged); the moving edge takes
// the new point by swapping buffers and the other copies load before they
// store (ld_swap_edge, ld_copy_n): 5243 cycles a leapfrog, the pass
// 2338, the reduction 548, the checks 720, the scalar tree 1637.  Draws
// are written coalesced along d, [K, C, d].
//
// A thread block cluster of B chains is the Pallas kernel's logical chain
// block (nuts_tree_ld.cuh): the Pallas loop runs until every chain of the
// block has K draws, chains past K keep iterating and emit nothing, and the
// final q/g/logp are each chain's selected point at the block's last
// iteration, so a chain's results depend on when its block mates finish,
// and on nothing else of them.  A chain therefore runs alone until it has
// its K draws, learns the block's last iteration from one cluster barrier
// (ClusterMax over the counters at which the chains finished), and runs on
// to it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "models.cuh"
#include "nuts_tree_ld.cuh"
#include "rng.cuh"

namespace nrt {

struct LdPostArgs {
  int C, K, d, D;
  uint32_t seed;
  float max_err;
  int has_jitter;
  float jc1, jc2;  // jitter factor = jc1 + jc2 * u
  const float *q, *g, *logp, *stds, *mean, *logdet, *step0, *bar;
  float *draws, *stats, *q_f, *g_f, *logp_f;
  int* iters;
  float* work;  // [C][4][D + 1][d] checkpoint stacks
};

// The body of one chain of a logical chain block `grp` (ClusterBlock, or the
// streamed kernel's GridBlock, grid_sync.cuh).  Group::LOCKSTEP: the chains
// of the block take every iteration together, because the model's
// evaluation is the block's (the streamed functor, models.cuh, whose grid
// barriers every chain must meet): they agree at the top of each iteration
// on whether any of them still lacks draws.
//
// FLOW (kernel K1-flow, nuts_fused_flow_posterior.cu): the chain moves in the
// z-space of a frozen coupling flow; Model is a CouplingFlowModel
// (coupling_flow.cuh).  The q input carries z0 and one evaluation at the
// start gives q, logp, the gradient and the logdet there (g, logp, stds,
// mean and logdet are not read); the logdet is per point, carried with the
// selected points as the Pallas body's dm_ld / ds_ld (nuts_pallas.py:
// 268-282); the g output carries the final z (:709-710).
//
// MERGED (K1-ld): the merged leapfrog (nuts_tree_ld.cuh::ld_leap_merged), with
// the wide reduction's scratch after the cluster slots.
template <class Model, bool CL_SITE, bool EVAL_BLOCK, bool FLOW, class Group,
          bool MERGED = false>
__device__ __forceinline__ void ld_posterior_chain(const LdPostArgs& a,
                                                   const Model& model,
                                                   Group& grp, float* smem) {
  const int B = grp.B, b = grp.b, c = grp.c, pid = grp.pid;
  const int C = a.C, K = a.K, d = a.d, D = a.D;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)pid;
  const int t0 = threadIdx.x;

  LdChain ch;
  ch.d = d;
  ch.D = D;
  ch.n = (d + LD_T - 1) / LD_T;
#ifdef NRT_LD_CLOCKS
  LdClocks clocks{clock64(), {0, 0, 0, 0}};
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
  float* dm_q = p;
  float* ds_q = p + d;
  float* q1 = p + 2 * d;
  p += 3 * d;
  ch.bl = p;
  ch.bm = p + (D + 1);
  p += 2 * (D + 1);
  Reducer red{p, 0};
  p += 2 * LD_NRED * LD_W;
  grp.bind(reinterpret_cast<uint32_t*>(p));
  p += 2 * LD_MAX_CLUSTER;
  WideReducer wide{p, 0};
  if constexpr (MERGED) p += LD_WIDE_FLOATS;
  float* scratch = p;  // the model functor's
  const size_t row = (size_t)(D + 1) * d;
  ch.lz = a.work + (size_t)c * 4 * row;
  ch.lv = ch.lz + row;
  ch.mz = ch.lv + row;
  ch.mv = ch.mz + row;

  if constexpr (FLOW) model.setup(scratch);
  const float logdet = FLOW ? 0.0f : a.logdet[c];
  const float bar = a.bar[c];
  float step = a.step0[c];
  float logp0 = FLOW ? 0.0f : a.logp[c];
  float s1[1];
  for (int i = 0; i < ch.n; ++i) {
    const int j = t0 + i * LD_T;
    float vv = 0.0f;
    if (j < d) {
      const size_t gj = (size_t)c * d + j;
      const float sd = FLOW ? 1.0f : a.stds[gj];
      const float mn = FLOW ? 0.0f : a.mean[gj];
      const float q0 = a.q[gj];
      const float z0 = FLOW ? q0 : (q0 - mn) / sd;
      const float zg0 = FLOW ? 0.0f : a.g[gj] * sd;
      const float v0 =
          normal(seed, 0u, 1u, 2u, block_site<CL_SITE>(b, B, d, j));
      ch.stds[j] = sd;
      ch.mean[j] = mn;
      ch.e_z[j] = ch.m_z[j] = ch.p_z[j] = ch.dm_z[j] = ch.ds_z[j] = z0;
      ch.e_zg[j] = ch.m_zg[j] = ch.p_zg[j] = ch.dm_zg[j] = ch.ds_zg[j] = zg0;
      ch.e_v[j] = ch.m_v[j] = ch.p_v[j] = v0;
      dm_q[j] = ds_q[j] = q0;
      vv = v0 * v0;
    }
    acc(s1[0], i, vv);
  }
  if (t0 <= D) ch.bl[t0] = ch.bm[t0] = 0.0f;
  // every chain of the block runs before any writes into its slots
  grp.sync();
  red.sum(s1);
  const float ke0 = 0.5f * s1[0];
  float dm_ld = logdet, ds_ld = logdet;
  if constexpr (FLOW) {
    // the start through the flow: q into dm_q, zg into zg1, then copies
    __syncthreads();
    logp0 = model.eval_flow(ch.e_z, dm_q, ch.zg1, d, red, scratch);
    float ls[1];
    for (int i = 0; i < ch.n; ++i) {
      const int j = t0 + i * LD_T;
      acc(ls[0], i, j < d ? model.ld_term(scratch, j) : 0.0f);
    }
    red.sum(ls);
    dm_ld = ds_ld = ls[0];
    for (int j = t0; j < d; j += LD_T) {
      const float zg = ch.zg1[j];
      ch.e_zg[j] = ch.m_zg[j] = ch.p_zg[j] = ch.dm_zg[j] = ch.ds_zg[j] = zg;
      ds_q[j] = dm_q[j];
    }
  }
  float e_init = ke0 - (logp0 + dm_ld);
  int dc = 0;
  int e_idx = 0, m_idx = 0, p_idx = 0, dm_idx = 0, ds_idx = 0;
  float dm_logp = logp0, dm_ke = ke0, ds_logp = logp0, ds_ke = ke0;
  float logw_m = 0.0f, logw_s = -INFINITY;
  int depth = 0, leaf = 0, n_steps = 0;
  float s_acc = 0.0f, s_sym = 0.0f, mx_err = 0.0f;
  float direction = uniform(seed, 0u, 3u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;

  // the block's loop ends at the first counter at which every chain has K
  // draws: the largest of the chains' own such counters
  uint32_t it = 1, it_end = 0;
  bool have_end = false;
  while (true) {
    if constexpr (Group::LOCKSTEP) {
      if (!grp.any(dc < K)) break;
    } else {
      if (!have_end && dc >= K) {
        it_end = grp.max(it);
        have_end = true;
      }
      if (have_end && it >= it_end) break;
    }
    const float r_sel = uniform(seed, it, 4u, (uint32_t)b);
    const float r_acc = uniform(seed, it, 5u, (uint32_t)b);
    const float dirf = direction;

    const LdLeap lf = ld_leapfrog<EVAL_BLOCK, Model, FLOW, MERGED>(
        ch, red, wide, model, dirf, step, leaf, depth, q1, scratch);
    const float logp1 = lf.logp1, ke1 = lf.ke1;
    const float ld1 = FLOW ? lf.ld1 : logdet;
    const float err = (ke1 - (logp1 + ld1)) - e_init;
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
      if constexpr (MERGED) {
        ld_copy_n<3>(ch, {ch.ds_z, ch.ds_zg, ds_q}, {ch.z1, ch.zg1, q1});
      } else {
        ld_copy(ch, ch.ds_z, ch.z1);
        ld_copy(ch, ch.ds_zg, ch.zg1);
        ld_copy(ch, ds_q, q1);
      }
      ds_logp = logp1;
      ds_ke = ke1;
      ds_idx = idx1;
      if constexpr (FLOW) ds_ld = ld1;
    }

    // ---- top-level merge (biased acceptance) ----
    const bool fwd = dirf > 0.0f;
    const bool subtree_done = (leaf + 1) == (1 << depth);
    const bool do_merge = subtree_done && !diverged && !lf.turning_int;
    if (do_merge) {
      if ((logw_s >= logw_m) || (logf(r_acc) < logw_s - logw_m)) {
        if constexpr (MERGED) {
          ld_copy_n<3>(ch, {ch.dm_z, ch.dm_zg, dm_q},
                       {ch.ds_z, ch.ds_zg, ds_q});
        } else {
          ld_copy(ch, ch.dm_z, ch.ds_z);
          ld_copy(ch, ch.dm_zg, ch.ds_zg);
          ld_copy(ch, dm_q, ds_q);
        }
        dm_logp = ds_logp;
        dm_ke = ds_ke;
        dm_idx = ds_idx;
        if constexpr (FLOW) dm_ld = ds_ld;
      }
      logw_m = logaddexp(logw_m, logw_s);
      if (fwd) {
        if constexpr (MERGED) {
          ld_copy_n<3>(ch, {ch.p_z, ch.p_v, ch.p_zg}, {ch.z1, ch.v2, ch.zg1});
        } else {
          ld_copy(ch, ch.p_z, ch.z1);
          ld_copy(ch, ch.p_v, ch.v2);
          ld_copy(ch, ch.p_zg, ch.zg1);
        }
        p_idx = idx1;
      } else {
        if constexpr (MERGED) {
          ld_copy_n<3>(ch, {ch.m_z, ch.m_v, ch.m_zg}, {ch.z1, ch.v2, ch.zg1});
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
    const bool fin = diverged || turned || depth >= D;

    // ---- emit the draw where the tree finished ----
    if (fin && dc < K) {
      float* out = a.draws + ((size_t)dc * C + c) * d;
      float fs[1];
      for (int i = 0; i < ch.n; ++i) {
        const int j = t0 + i * LD_T;
        float term = 0.0f;
        if (j < d) {
          const float s = ch.dm_z[j] + ch.dm_zg[j];
          term = s * s;
          out[j] = dm_q[j];
        }
        acc(fs[0], i, term);
      }
      red.sum(fs);
      if (t0 == 0) {
        const float energy_m = dm_ke - (dm_logp + dm_ld);
        const float rowv[NSTATS] = {
            (float)depth, diverged ? 1.0f : 0.0f, (float)n_steps, s_acc,
            s_sym, mx_err, dm_logp, energy_m, energy_m - e_init,
            (float)dm_idx, fs[0], step,
            (depth >= D && !turned && !diverged) ? 1.0f : 0.0f};
        float* st = a.stats + ((size_t)dc * C + c) * NSTATS;
#pragma unroll
        for (int s = 0; s < NSTATS; ++s) st[s] = rowv[s];
      }
    }

    // ---- next state: fresh draw / new doubling / same subtree ----
    const float new_dir =
        uniform(seed, it, 6u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;
    const bool new_doub = do_merge && !fin;
    if (fin) {
      float ks[1];
      for (int i = 0; i < ch.n; ++i) {
        const int j = t0 + i * LD_T;
        float term = 0.0f;
        if (j < d) {
          const float vn = normal(seed, it, 7u, 8u,
                                  block_site<CL_SITE>(b, B, d, j));
          const float z = ch.dm_z[j], zg = ch.dm_zg[j];
          ch.e_z[j] = ch.m_z[j] = ch.p_z[j] = z;
          ch.e_v[j] = ch.m_v[j] = ch.p_v[j] = vn;
          ch.e_zg[j] = ch.m_zg[j] = ch.p_zg[j] = zg;
          term = vn * vn;
        }
        acc(ks[0], i, term);
      }
      red.sum(ks);
      const float ke_new = 0.5f * ks[0];
      if (a.has_jitter)
        step = bar * (a.jc1 + a.jc2 * uniform(seed, it, 9u, (uint32_t)b));
      else
        step = bar;
      e_init = ke_new - (dm_logp + dm_ld);
      dc += 1;
      e_idx = m_idx = p_idx = dm_idx = 0;
      dm_ke = ke_new;
      logw_m = 0.0f;
      depth = 0;
      n_steps = 0;
      s_acc = s_sym = mx_err = 0.0f;
    } else if (new_doub) {
      const bool jump_p = new_dir > 0.0f;
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
    } else {
      if constexpr (MERGED) {
        ld_swap_edge(ch);
      } else {
        ld_copy(ch, ch.e_z, ch.z1);
        ld_copy(ch, ch.e_v, ch.v2);
        ld_copy(ch, ch.e_zg, ch.zg1);
      }
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

  for (int j = t0; j < d; j += LD_T) {
    a.q_f[(size_t)c * d + j] = dm_q[j];
    a.g_f[(size_t)c * d + j] = FLOW ? ch.dm_z[j] : ch.dm_zg[j] / ch.stds[j];
  }
  if (t0 == 0) {
    a.logp_f[c] = dm_logp;
    a.iters[c] = (int)it;
  }
#ifdef NRT_LD_CLOCKS
  if (c == 0 && t0 == 0) {
    for (int k = 0; k < 4; ++k) nrt_ld_clocks[k] += clocks.acc[k];
    nrt_ld_clocks[4] += (unsigned long long)(it - 1);
  }
#endif
}

// One CUDA block of LD_T threads per chain, a thread block cluster per
// logical chain block; MIN_BLOCKS resident an SM (at 2: at most 128
// registers a thread).
template <class Model, bool CL_SITE, bool EVAL_BLOCK, bool FLOW = false,
          int MIN_BLOCKS = 1, bool MERGED = false>
__global__ void __launch_bounds__(LD_T, MIN_BLOCKS)
    ld_posterior_kernel(const LdPostArgs a, const Model model) {
  extern __shared__ float smem[];
  ClusterBlock grp;
  ld_posterior_chain<Model, CL_SITE, EVAL_BLOCK, FLOW, ClusterBlock, MERGED>(
      a, model, grp, smem);
}

// Dynamic shared memory of one chain block, in bytes, of the kernels that
// evaluate the model in its eval_block form (the ld_args ones, and K1-flow's
// posterior before the flow's work space): with `warmup` the warmup kernel's
// 19 vectors (it
// keeps q1), else the posterior's 21, then the functor's scratch; -1 for a
// model id that no functor of the library has.
inline long long block_smem_bytes(int warmup, int d, int maxdepth,
                                  int model_id, const int* model_ints) {
  const int nvec = warmup ? LD_WARM_NVEC + 1 : LD_POST_NVEC;
  long long bytes = -1;
  const float no_params[MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[MAX_MODEL_PTRS] = {};
  with_block_model(model_id, no_params, no_ptrs, model_ints,
                   [&](auto model) {
                     bytes = 4 * (long long)(ld_smem_floats(nvec, d,
                                                            maxdepth) +
                                             model.scratch_floats());
                     return cudaSuccess;
                   });
  return bytes;
}

}  // namespace nrt
