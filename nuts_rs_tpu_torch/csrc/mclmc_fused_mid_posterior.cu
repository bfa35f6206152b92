// Fused draw-asynchronous MCLMC posterior for data-carrying models and mid d
// (kernel K3-args).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/mclmc_pallas.py::make_mclmc_kernel (:59) with
// n_model_args > 0 (:61,82-85,124), launched by mclmc_pallas_run (:372;
// model_args :389,409-412,436-449): K draw-asynchronous MCLMC draws per chain
// with the model evaluated as logp_grad_batched(q, *model_args) on arrays that
// every block sees; for the Bernoulli GLM (models/gaussian.py:171-180) two
// [N, d] x [d] products, logaddexp and a sigmoid per chain and leapfrog.
// Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py::mclmc_fused_run_reference on a
// model the mid-d kernels serve (nuts_fused.cl_kernel).  d, the constants of
// the dynamics and the data sizes are launch arguments; the kinetic energy
// and the halving depth are template flags.
//
// What bounds it on this card.  With data, as K1-args: the L2 traffic and
// load latency of the evaluation's two products, which every chain repeats
// on the whole of x (models.cuh).  Around it the trajectory is a chain of
// dependent block-wide sums: a microcanonical iteration has 8 reductions of
// its own (mclmc_step_block.cuh), each a warp butterfly, a barrier and 8
// shared-memory loads, where a NUTS leapfrog shares one; without data (the
// iid normal at d = 100) that latency is all there is.  Neither device
// memory nor FP32 peak comes near: a chain block reads its state once and
// writes d floats a draw.  On an NVIDIA H100 80GB HBM3 at 700 W, d = 100,
// N = 1000: 28.9 us an iteration with the regression, 3.9 us without.
//
// What the design does about it: one CUDA block of LD_T = 256 threads per
// chain, thread t owning coordinates t, t + 256, ... of the 15 live vectors
// in dynamic shared memory (6 KB at d = 100, plus the functor's N + 8 d
// floats); no checkpoint stacks, so no global workspace.  ptxas keeps the
// kernels with data at 128 registers and those without at 64-80, so two
// (four) chain blocks share an SM and one chain's barriers and loads overlap
// another's: two blocks an SM run 1.8 times the evaluations a second of one.
// Scalars and the 10-deep halving stack are per thread and uniform across the
// block.  Draws are written coalesced along d, [K, C, d], so the trace needs
// no transpose.  Every sum takes ops.tsum's order through Reducer::sum, the
// regression's as models.cuh fixes them; no atomics.
//
// A thread block cluster of B <= 8 chains is the Pallas kernel's logical
// chain block (default 1): its chains share the seed and the counter `it`
// and number a vector site j * B + b.  The Pallas loop runs until every chain
// of the block has K draws, chains past K keep iterating (new draws, nothing
// emitted), and the final q / g / logp / v are each chain's state at the
// block's last iteration.  A chain's trajectory does not depend on its block
// mates, so it runs alone to its K draws, learns the block's last iteration
// from one cluster barrier (ClusterMax) and runs on to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mclmc_step_block.cuh"
#include "models.cuh"

namespace nrt {

struct McMidPostArgs {
  int C, K, d;
  uint32_t seed;
  McConst k;
  int has_jitter;
  float jc1, jc2;  // jitter factor = jc1 + jc2 * u
  const float *q, *g, *logp, *v, *stds, *mean, *logdet, *step0, *bar;
  float *draws, *stats, *q_f, *g_f, *logp_f, *v_f;
  int* iters;
};

template <bool MICRO, int H, class Model>
__global__ void __launch_bounds__(LD_T)
    mclmc_mid_posterior_kernel(const McMidPostArgs a, const Model model) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int B = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  const int c = blockIdx.x;
  const int C = a.C, K = a.K, d = a.d;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)(c / B);
  const McConst& k = a.k;
  const int t0 = threadIdx.x;

  McChain ch;
  float* p = mc_chain_layout(ch, d, smem);
  Reducer red{p, 0};
  p += 2 * LD_NRED * LD_W;
  ClusterMax last{reinterpret_cast<uint32_t*>(p), 0};
  float* scratch = p + 2 * LD_MAX_CLUSTER;  // the model functor's

  McScalars<H> s;
  const float ld = a.logdet[c];
  const float bar = a.bar[c];
  float step = a.step0[c];
  s.logp = a.logp[c];
  float v2[1];
  for (int i = 0; i < ch.n; ++i) {
    const int j = t0 + i * LD_T;
    float vv = 0.0f;
    if (j < d) {
      const size_t gj = (size_t)c * d + j;
      const float sd = a.stds[gj], mn = a.mean[gj], v0 = a.v[gj];
      const float z0 = (a.q[gj] - mn) / sd;
      const float zg0 = a.g[gj] * sd;
      ch.stds[j] = sd;
      ch.mean[j] = mn;
      ch.z[j] = ch.z0[j] = z0;
      ch.zg[j] = ch.zg0[j] = zg0;
      ch.v[j] = v0;
      ch.noise[j] =
          normal(seed, 0u, 1u, 2u, (uint32_t)j * (uint32_t)B + (uint32_t)b);
      vv = v0 * v0;
    }
    acc(v2[0], i, vv);
  }
  // every block of the cluster runs before any writes into its slots
  cluster.sync();
  if (MICRO) {
    s.ke = 0.0f;
  } else {
    red.sum(v2);
    s.ke = 0.5f * v2[0];
  }
  int nsd = num_steps_for(step, k);
  start_trajectory(s, nsd);
  float e_init = s.ke - (s.logp + ld);
  float lpi = s.logp;  // with z0 / zg0 the give-up target (mclmc.rs:361-384)
  int dc = 0;

  // the block's loop ends at the first counter at which every chain has K
  // draws: the largest of the chains' own such counters
  uint32_t it = 1, it_end = 0;
  bool have_end = false;
  while (true) {
    if (!have_end && dc >= K) {
      it_end = last.max(it);
      have_end = true;
    }
    if (have_end && it >= it_end) break;
    const int r = leapfrog_try_block<MICRO, H>(ch, s, red, model, scratch,
                                               step, nsd, ld, k, seed, it, 3u,
                                               b, B);
    if (r != MC_CONTINUE) {
      // energy_change uses the loop-exit point, as mclmc_draw does
      const float e_change = (s.ke - (s.logp + ld)) - e_init;
      float em_ke = s.ke;
      if (r == MC_GAVE_UP) {
        // the draw start with fresh momentum; the next noise as on success
        em_ke = give_up_momentum_block<MICRO>(ch, red, seed, it, 7u, b, B);
        for (int j = t0; j < d; j += LD_T) {
          ch.z[j] = ch.z0[j];
          ch.zg[j] = ch.zg0[j];
          ch.noise[j] = normal(seed, it, 5u, 6u,
                               (uint32_t)j * (uint32_t)B + (uint32_t)b);
        }
        s.logp = lpi;
      }
      if (dc < K) {
        float* out = a.draws + ((size_t)dc * C + c) * d;
        float fs[1];
        for (int i = 0; i < ch.n; ++i) {
          const int j = t0 + i * LD_T;
          float term = 0.0f;
          if (j < d) {
            const float e = ch.z[j] + ch.zg[j];
            term = e * e;
            out[j] = ch.z[j] * ch.stds[j] + ch.mean[j];
          }
          acc(fs[0], i, term);
        }
        red.sum(fs);
        if (t0 == 0) {
          const float row[NSTATS_M] = {
              r == MC_GAVE_UP ? 1.0f : 0.0f, (float)s.steps, e_change,
              s.ttime / (float)max(s.steps, 1), step, s.logp,
              em_ke - (s.logp + ld), fs[0]};
          float* st = a.stats + ((size_t)dc * C + c) * NSTATS_M;
#pragma unroll
          for (int i = 0; i < NSTATS_M; ++i) st[i] = row[i];
        }
      }
      // the next draw starts at the emitted point
      s.ke = MICRO ? 0.0f : em_ke;
      e_init = s.ke - (s.logp + ld);
      step = a.has_jitter
                 ? bar * (a.jc1 + a.jc2 * uniform(seed, it, 9u, (uint32_t)b))
                 : bar;
      nsd = num_steps_for(step, k);
      start_trajectory(s, nsd);
      for (int j = t0; j < d; j += LD_T) {
        ch.z0[j] = ch.z[j];
        ch.zg0[j] = ch.zg[j];
      }
      lpi = s.logp;
      dc += 1;
    }
    it += 1;
  }

  for (int j = t0; j < d; j += LD_T) {
    const size_t gj = (size_t)c * d + j;
    a.q_f[gj] = ch.z[j] * ch.stds[j] + ch.mean[j];
    a.g_f[gj] = ch.zg[j] / ch.stds[j];
    a.v_f[gj] = ch.v[j];
  }
  if (t0 == 0) {
    a.logp_f[c] = s.logp;
    a.iters[c] = (int)it;
  }
}

}  // namespace nrt

// Dynamic shared memory of one chain block of the mid-d MCLMC kernels, in
// bytes, with the model functor's scratch; -1 for a model without the
// eval_block form.
extern "C" long long nrt_mclmc_mid_smem_bytes(int d, int model_id,
                                              const int* model_ints) {
  long long bytes = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  nrt::with_block_model(
      model_id, no_params, no_ptrs, model_ints, [&](auto model) {
        bytes = 4 * (long long)(nrt::mc_smem_floats(d) +
                                model.scratch_floats());
        return cudaSuccess;
      });
  return bytes;
}

extern "C" int nrt_mclmc_mid_posterior_launch(
    int dim, int micro, int dynamic, int C, int B, int K, uint32_t seed,
    float max_err, float ell, float fsub_ell, float sqrt_n, int has_jitter,
    float jc1, float jc2, int model_id, const float* model_params,
    const void* const* model_ptrs, const int* model_ints, const float* q,
    const float* g, const float* logp, const float* v, const float* stds,
    const float* mean, const float* logdet, const float* step0,
    const float* bar, float* draws, float* stats, float* q_f, float* g_f,
    float* logp_f, float* v_f, int* iters, void* stream) {
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const nrt::McMidPostArgs a{C,    K,      dim,    seed,
                             {max_err, ell, fsub_ell, sqrt_n},
                             has_jitter, jc1, jc2, q,      g,      logp,
                             v,    stds,   mean,   logdet, step0,  bar,
                             draws, stats, q_f,    g_f,    logp_f, v_f,
                             iters};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)nrt::with_block_model(
      model_id, model_params, model_ptrs, model_ints, [&](auto model) {
        using M = decltype(model);
        const size_t smem =
            4 * (nrt::mc_smem_floats(dim) + model.scratch_floats());
        constexpr int H = nrt::MAX_HALVINGS;
        if (micro && dynamic)
          return nrt::ld_launch(nrt::mclmc_mid_posterior_kernel<true, H, M>,
                                a, model, C, B, smem, s);
        if (micro)
          return nrt::ld_launch(nrt::mclmc_mid_posterior_kernel<true, 0, M>,
                                a, model, C, B, smem, s);
        if (dynamic)
          return nrt::ld_launch(nrt::mclmc_mid_posterior_kernel<false, H, M>,
                                a, model, C, B, smem, s);
        return nrt::ld_launch(nrt::mclmc_mid_posterior_kernel<false, 0, M>, a,
                              model, C, B, smem, s);
      });
}
