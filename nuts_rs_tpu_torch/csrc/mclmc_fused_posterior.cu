// Fused draw-asynchronous MCLMC posterior (kernel K3).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/mclmc_pallas.py::make_mclmc_kernel (:59), launched by
// mclmc_pallas_run (:372, pallas_call :441), with the plain diagonal
// evaluation.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py::mclmc_fused_run_reference.
//
// What bounds it on this card: latency-bound scalar work per thread.  One
// thread runs one chain: per iteration a partial momentum refresh, one
// leapfrog (two ESH half steps for the microcanonical kind) with the model
// functor, the energy check and, on success, the post-step refresh and two
// Box-Muller noise vectors (4d hashed uniforms).  State is a few d-vectors
// and a 10-deep int halving stack, in registers; device memory sees the
// inputs once and each emitted draw once.
//
// What the design does about it: one CUDA block per logical chain block of
// B chains (B = 32, one warp, by default), so the loop condition is a cheap
// __syncthreads_or and the random sites keep the Pallas block layout.  Each
// thread draws only the random numbers its branch uses (the counter hash
// has no state, so a skipped site changes nothing), indexes its own stack
// directly, and unwinds it with a loop of at most its depth.  Sizes, the
// kinetic energy and the halving depth are template parameters.
//
// Semantics kept from the Pallas kernel: a finished draw restarts in the
// same iteration from the emitted point with the carried momentum; the
// block loops until every chain has K draws, chains past K keep iterating
// and emit nothing; the final state is each chain's state at the block's
// last iteration; iters is the block's count.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mclmc_step.cuh"
#include "models.cuh"
#include "rng.cuh"
#include "nrt_sizes.h"  // NRT_FOR_EACH_DIM(X), generated by _build.py

namespace nrt {

struct McPostArgs {
  int C, K;
  uint32_t seed;
  McConst k;
  int has_jitter;
  float jc1, jc2;  // jitter factor = jc1 + jc2 * u
  const float *q, *g, *logp, *v, *stds, *mean, *logdet, *step0, *bar;
  float *draws, *stats, *q_f, *g_f, *logp_f, *v_f;
  int* iters;
};

template <int DIM, bool MICRO, int H, class Model>
__global__ void __launch_bounds__(MAX_BLOCK)
    mclmc_posterior_kernel(const McPostArgs a, const Model model) {
  const int B = blockDim.x;
  const int b = threadIdx.x;
  const int c = blockIdx.x * B + b;
  const int C = a.C;
  const int K = a.K;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)blockIdx.x;
  const McConst& k = a.k;

  float stds[DIM], mean[DIM];
  McState<DIM, H> s;
  const float ld = a.logdet[c];
  const float bar = a.bar[c];
  float step = a.step0[c];
  s.logp = a.logp[c];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    stds[j] = a.stds[c * DIM + j];
    mean[j] = a.mean[c * DIM + j];
    s.z[j] = (a.q[c * DIM + j] - mean[j]) / stds[j];
    s.zg[j] = a.g[c * DIM + j] * stds[j];
    s.v[j] = a.v[c * DIM + j];
    s.noise[j] = normal(seed, 0u, 1u, 2u, (uint32_t)(j * B + b));
  }
  s.ke = MICRO ? 0.0f : 0.5f * dot<DIM>(s.v, s.v);
  int nsd = num_steps_for(step, k);
  start_trajectory(s, nsd);
  float e_init = s.ke - (s.logp + ld);
  // draw-start snapshot, the give-up target (mclmc.rs:361-384)
  float zi[DIM], zgi[DIM];
  copy<DIM>(zi, s.z);
  copy<DIM>(zgi, s.zg);
  float lpi = s.logp;
  int dc = 0;

  uint32_t it = 1;
  while (__syncthreads_or(dc < K)) {
    const int r = leapfrog_try<DIM, MICRO, H>(s, step, nsd, ld, stds, mean,
                                              model, k, seed, it, 3u, b, B);
    if (r != MC_CONTINUE) {
      // energy_change uses the loop-exit point, as mclmc_draw does
      const float e_change = (s.ke - (s.logp + ld)) - e_init;
      float em_ke = s.ke;
      if (r == MC_GAVE_UP) {
        // the draw start with fresh momentum; the next noise as on success
        em_ke = give_up_momentum<DIM, MICRO>(seed, it, 7u, b, B, s.v);
        copy<DIM>(s.z, zi);
        copy<DIM>(s.zg, zgi);
        s.logp = lpi;
#pragma unroll
        for (int j = 0; j < DIM; ++j)
          s.noise[j] = normal(seed, it, 5u, 6u, (uint32_t)(j * B + b));
      }
      if (dc < K) {
        float fisher = 0.0f;
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
          const float e = s.z[j] + s.zg[j];
          fisher = (j == 0) ? e * e : fisher + e * e;
          a.draws[((size_t)dc * DIM + j) * C + c] = s.z[j] * stds[j] + mean[j];
        }
        const float row[NSTATS_M] = {
            r == MC_GAVE_UP ? 1.0f : 0.0f, (float)s.steps, e_change,
            s.ttime / (float)max(s.steps, 1), step, s.logp,
            em_ke - (s.logp + ld), fisher};
#pragma unroll
        for (int i = 0; i < NSTATS_M; ++i)
          a.stats[((size_t)dc * NSTATS_M + i) * C + c] = row[i];
      }
      // the next draw starts at the emitted point
      s.ke = MICRO ? 0.0f : em_ke;
      e_init = s.ke - (s.logp + ld);
      step = a.has_jitter
                 ? bar * (a.jc1 + a.jc2 * uniform(seed, it, 9u, (uint32_t)b))
                 : bar;
      nsd = num_steps_for(step, k);
      start_trajectory(s, nsd);
      copy<DIM>(zi, s.z);
      copy<DIM>(zgi, s.zg);
      lpi = s.logp;
      dc += 1;
    }
    it += 1;
  }

#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    a.q_f[c * DIM + j] = s.z[j] * stds[j] + mean[j];
    a.g_f[c * DIM + j] = s.zg[j] / stds[j];
    a.v_f[c * DIM + j] = s.v[j];
  }
  a.logp_f[c] = s.logp;
  a.iters[c] = (int)it;
}

template <int DIM, bool MICRO, int H>
cudaError_t launch_mclmc_posterior(const McPostArgs& a, int B, int model_id,
                                   const float* params, cudaStream_t stream) {
  if (model_id != MODEL_IID_NORMAL) return cudaErrorInvalidValue;
  mclmc_posterior_kernel<DIM, MICRO, H, IidNormal>
      <<<a.C / B, B, 0, stream>>>(a, IidNormal{params[0]});
  return cudaGetLastError();
}

}  // namespace nrt

extern "C" int nrt_mclmc_posterior_launch(
    int dim, int micro, int dynamic, int C, int B, int K, uint32_t seed,
    float max_err, float ell, float fsub_ell, float sqrt_n, int has_jitter,
    float jc1, float jc2, int model_id, const float* model_params,
    const float* q, const float* g, const float* logp, const float* v,
    const float* stds, const float* mean, const float* logdet,
    const float* step0, const float* bar, float* draws, float* stats,
    float* q_f, float* g_f, float* logp_f, float* v_f, int* iters,
    void* stream) {
  if (B < 1 || B > nrt::MAX_BLOCK || C % B != 0)
    return (int)cudaErrorInvalidValue;
  const nrt::McPostArgs a{C,    K,      seed,  {max_err, ell, fsub_ell, sqrt_n},
                          has_jitter, jc1, jc2, q, g, logp, v, stds, mean,
                          logdet, step0, bar, draws, stats, q_f, g_f, logp_f,
                          v_f,  iters};
  cudaStream_t s = (cudaStream_t)stream;
#define NRT_CASE(DIM_)                                                        \
  if (dim == DIM_) {                                                          \
    if (micro && dynamic)                                                     \
      return (int)nrt::launch_mclmc_posterior<DIM_, true, nrt::MAX_HALVINGS>( \
          a, B, model_id, model_params, s);                                   \
    if (micro)                                                                \
      return (int)nrt::launch_mclmc_posterior<DIM_, true, 0>(                 \
          a, B, model_id, model_params, s);                                   \
    if (dynamic)                                                              \
      return (int)nrt::launch_mclmc_posterior<DIM_, false, nrt::MAX_HALVINGS>( \
          a, B, model_id, model_params, s);                                   \
    return (int)nrt::launch_mclmc_posterior<DIM_, false, 0>(                  \
        a, B, model_id, model_params, s);                                     \
  }
  NRT_FOR_EACH_DIM(NRT_CASE)
#undef NRT_CASE
  return (int)cudaErrorInvalidValue;
}
