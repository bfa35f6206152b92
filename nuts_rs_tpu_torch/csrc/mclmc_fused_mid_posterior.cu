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
// N = 1000: 28.9 us an iteration with the regression, 3.9 us without, in
// the 256-thread form (the pair form's in PERF.md section 6).
//
// What the design does about it: a chain's trajectory on the 256 threads of
// one CUDA block (mclmc_step_block.cuh::mc_block_form), thread t owning
// coordinates t, t + 256, ... of the 15 live vectors in dynamic shared
// memory (6 KB at d = 100, plus the functor's N + 8 d floats); no
// checkpoint stacks, so no global workspace.  (128 and 64 threads a chain,
// each thread holding slots t + T s of tsum's 256, lost to 256 at d = 400:
// PERF.md section 6.)  For the regression under the Euclidean dynamics at
// B = 1, where its rows fit two blocks' shared memory, the pair form: one
// chain on a thread block cluster of two blocks of 128 threads that run the
// same trajectory, each holding the rows of half of tsum's slot warps in
// its shared memory (200 KB at N = 1000, d = 100, staged once a launch), so
// that both products read x from shared memory and not through L2, and one
// exchange of d + 1 halves through distributed shared memory an evaluation
// (models.cuh::LogisticRegression::eval_pair).  One chain's iteration is
// what the Euclidean warmup launch waits for (its slowest chain takes ten
// times the mean chain's iterations), so the pair gives up throughput (one
// block an SM) for it.  The 256-thread kernels are held to two blocks an SM
// (__launch_bounds__(256, 2): 128 registers with data, the regression's
// batched loads spilling up to 120 bytes, where unbounded they took 206
// registers and one block an SM; 64-80 without data), so two (four) chain
// blocks share an SM and one chain's barriers and loads overlap another's.  Scalars and the
// 10-deep halving stack are per thread and uniform across the block.  Draws
// are written coalesced along d, [K, C, d], so the trace needs no
// transpose.  Every sum takes ops.tsum's order, the regression's as
// models.cuh fixes them; no atomics.
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

template <bool MICRO, int H, int T, int X, class Model>
__global__ void __launch_bounds__(T, X == 2 ? 1 : 2)
    mclmc_mid_posterior_kernel(const McMidPostArgs a, const Model model) {
  extern __shared__ float smem[];
  const McPlace<X> at = McPlace<X>::get();
  const int B = at.B, b = at.b, c = at.c;
  const bool writer = at.rank == 0;
  const int C = a.C, K = a.K, d = a.d;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)(c / B);
  const McConst& k = a.k;
  const int t0 = threadIdx.x;

  McChain ch;
  float* p = mc_chain_layout(ch, d, smem);
  TeamReducer<T> red{{p, 0}, 0};
  p += 2 * LD_NRED * LD_W;
  ClusterMax last{reinterpret_cast<uint32_t*>(p), 0};
  float* scratch = p + 2 * LD_MAX_CLUSTER;  // the model functor's
  if constexpr (X == 2) model.stage_pair(scratch, at.rank);

  McScalars<H> s;
  const float ld = a.logdet[c];
  const float bar = a.bar[c];
  float step = a.step0[c];
  s.logp = a.logp[c];
  float v2p[LD_T / T][1], v2[1];
  team_terms<T>(
      ch,
      [&](int j, float (&t)[1]) {
        const size_t gj = (size_t)c * d + j;
        const float sd = a.stds[gj], mn = a.mean[gj], v0 = a.v[gj];
        const float z0 = (a.q[gj] - mn) / sd;
        const float zg0 = a.g[gj] * sd;
        ch.stds[j] = sd;
        ch.mean[j] = mn;
        ch.z[j] = ch.z0[j] = z0;
        ch.zg[j] = ch.zg0[j] = zg0;
        ch.v[j] = v0;
        ch.noise[j] = site_normal(seed, 0u, 1u, 2u,
                                  (uint32_t)j * (uint32_t)B + (uint32_t)b);
        t[0] = v0 * v0;
      },
      v2p);
  // every block of the cluster runs before any writes into its slots
  cg::this_cluster().sync();
  if (MICRO) {
    s.ke = 0.0f;
  } else {
    red.sum(v2p, v2);
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
    const int r = leapfrog_try_block<MICRO, H, T, X>(
        ch, s, red, model, scratch, step, nsd, ld, k, seed, it, 3u, b, B);
    if (r != MC_CONTINUE) {
      // energy_change uses the loop-exit point, as mclmc_draw does
      const float e_change = (s.ke - (s.logp + ld)) - e_init;
      float em_ke = s.ke;
      if (r == MC_GAVE_UP) {
        // the draw start with fresh momentum; the next noise as on success
        em_ke =
            give_up_momentum_block<MICRO, T>(ch, red, seed, it, 7u, b, B);
        for (int j = t0; j < d; j += T) {
          ch.z[j] = ch.z0[j];
          ch.zg[j] = ch.zg0[j];
          ch.noise[j] = site_normal(seed, it, 5u, 6u,
                                    (uint32_t)j * (uint32_t)B + (uint32_t)b);
        }
        s.logp = lpi;
      }
      if (dc < K) {
        float* out = a.draws + ((size_t)dc * C + c) * d;
        float fsp[LD_T / T][1], fs[1];
        team_terms<T>(
            ch,
            [&](int j, float (&t)[1]) {
              const float e = ch.z[j] + ch.zg[j];
              t[0] = e * e;
              if (writer) out[j] = ch.z[j] * ch.stds[j] + ch.mean[j];
            },
            fsp);
        red.sum(fsp, fs);
        if (t0 == 0 && writer) {
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
      for (int j = t0; j < d; j += T) {
        ch.z0[j] = ch.z[j];
        ch.zg0[j] = ch.zg[j];
      }
      lpi = s.logp;
      dc += 1;
    }
    it += 1;
  }

  if (!writer) return;
  for (int j = t0; j < d; j += T) {
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

// The block form of a launch (nrt::mc_block_form): out = {T, X, the
// dynamic shared memory of each of its CUDA blocks in bytes}; -1 bytes for
// a model without the eval_block form.
extern "C" void nrt_mclmc_block_form(int d, int model_id,
                                     const int* model_ints, int B, int micro,
                                     long long* out) {
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  const int N = model_id == nrt::MODEL_LOGISTIC_REGRESSION ? model_ints[0]
                                                           : 0;
  const nrt::McBlockForm form = nrt::mc_block_form(d, model_id, N, B, micro);
  out[0] = form.T;
  out[1] = form.X;
  out[2] = -1;
  nrt::with_block_model(
      model_id, no_params, no_ptrs, model_ints, [&](auto model) {
        out[2] = form.X == 2 ? (long long)nrt::mc_pair_bytes(d, N)
                             : 4 * (long long)(nrt::mc_smem_floats(d) +
                                               model.scratch_floats());
        return cudaSuccess;
      });
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
  long long form[3];
  nrt_mclmc_block_form(dim, model_id, model_ints, B, micro, form);
  return (int)nrt::with_block_model(
      model_id, model_params, model_ptrs, model_ints, [&](auto model) {
        using M = decltype(model);
        return nrt::with_block_form<M>(
            {(int)form[0], (int)form[1]}, [&](auto T_, auto X_) {
              constexpr int T = decltype(T_)::value, X = decltype(X_)::value;
              constexpr int H = nrt::MAX_HALVINGS;
              const size_t smem = (size_t)form[2];
              if constexpr (X == 2) {
                if (micro) return cudaErrorInvalidValue;
              } else {
                if (micro && dynamic)
                  return nrt::mc_block_launch(
                      nrt::mclmc_mid_posterior_kernel<true, H, T, X, M>, a,
                      model, C, B, T, X, smem, s);
                if (micro)
                  return nrt::mc_block_launch(
                      nrt::mclmc_mid_posterior_kernel<true, 0, T, X, M>, a,
                      model, C, B, T, X, smem, s);
              }
              if (dynamic)
                return nrt::mc_block_launch(
                    nrt::mclmc_mid_posterior_kernel<false, H, T, X, M>, a,
                    model, C, B, T, X, smem, s);
              return nrt::mc_block_launch(
                  nrt::mclmc_mid_posterior_kernel<false, 0, T, X, M>, a,
                  model, C, B, T, X, smem, s);
            });
      });
}

#ifdef NRT_MCLMC_CLOCKS
// The cycles nrt_mc_clocks holds (block_sum.cuh), read and, with reset,
// zeroed.
extern "C" int nrt_mclmc_block_clocks(int reset, unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, nrt::nrt_mc_clocks,
                                         sizeof(nrt::nrt_mc_clocks));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[9] = {};
    err = cudaMemcpyToSymbol(nrt::nrt_mc_clocks, zero, sizeof(zero));
  }
  return (int)err;
}
#endif
