// Fused draw-asynchronous MCLMC posterior (kernel K3).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/mclmc_pallas.py::make_mclmc_kernel (:59), launched by
// mclmc_pallas_run (:372, pallas_call :441), with the plain diagonal
// evaluation.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py::mclmc_fused_run_reference.
//
// What bounds it on this card: the latency of one chain's dependent scalar
// work.  Per iteration a chain takes a partial momentum refresh, one
// leapfrog (two ESH half steps for the microcanonical kind) with the model
// functor, the energy check and, on success, the post-step refresh and two
// Box-Muller noise vectors (4d hashed uniforms): about 6 IEEE divisions and
// 2 normals a coordinate and 9 sums over d.  The 1024 chains of the main
// path fill only 32 logical blocks of 32, so at most 32 SMs work.  Device
// memory sees the inputs once and each emitted draw once.
//
// What the design does about it: a chain's coordinates on a group of T
// lanes (mclmc_step.cuh; T by mclmc_lanes, 16 at d = 10), so a lane runs one
// coordinate's divisions and normals and a block of B chains holds B * T
// threads, 16 warps at B = 32 whose latencies overlap.  Each sum over d is
// gathered by shuffles and added in coordinate order on every lane, which
// keeps every bit of the one-thread form.  One CUDA block per logical chain
// block of B chains, so the loop condition is a __syncthreads_or and the
// random sites keep the Pallas block layout; a lane draws only the random
// numbers of its own coordinates (the counter hash has no state, so a
// skipped site changes nothing); the halving stack is indexed directly and
// unwound by a loop of at most its depth.  Sizes, lanes, the kinetic energy
// and the halving depth are template parameters.
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

template <int DIM, int T, bool MICRO, int H, class Model>
__global__ void __launch_bounds__(T * MAX_BLOCK < MAX_THREADS ? T * MAX_BLOCK
                                                              : MAX_THREADS)
    mclmc_posterior_kernel(const McPostArgs a, const Model model) {
  constexpr int NC = slots<DIM, T>();
  const Lane<T> g;
  const int B = blockDim.x / T;
  const int b = threadIdx.x / T;
  const int c = blockIdx.x * B + b;
  const int C = a.C;
  const int K = a.K;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)blockIdx.x;
  const McConst& k = a.k;

  float stds[NC], mean[NC];
  McState<DIM, T, H> s;
  const float ld = a.logdet[c];
  const float bar = a.bar[c];
  float step = a.step0[c];
  s.logp = a.logp[c];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int j = g.lane + T * i;
    const bool own = j < DIM;
    stds[i] = own ? a.stds[c * DIM + j] : 1.0f;
    mean[i] = own ? a.mean[c * DIM + j] : 0.0f;
    s.z[i] = own ? (a.q[c * DIM + j] - mean[i]) / stds[i] : 0.0f;
    s.zg[i] = own ? a.g[c * DIM + j] * stds[i] : 0.0f;
    s.v[i] = own ? a.v[c * DIM + j] : 0.0f;
  }
  lane_normals<DIM, T>(s.noise, seed, 0u, 1u, 2u, b, B, g);
  s.ke = MICRO ? 0.0f : 0.5f * ordered_dot<DIM, T>(s.v, s.v, g);
  int nsd = num_steps_for(step, k);
  start_trajectory(s, nsd);
  float e_init = s.ke - (s.logp + ld);
  // draw-start snapshot, the give-up target (mclmc.rs:361-384)
  float zi[NC], zgi[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    zi[i] = s.z[i];
    zgi[i] = s.zg[i];
  }
  float lpi = s.logp;
  int dc = 0;

  uint32_t it = 1;
  while (__syncthreads_or(dc < K)) {
    const int r = leapfrog_try<DIM, T, MICRO, H>(
        s, step, nsd, ld, stds, mean, model, k, seed, it, 3u, b, B, g);
    if (r != MC_CONTINUE) {
      // energy_change uses the loop-exit point, as mclmc_draw does
      const float e_change = (s.ke - (s.logp + ld)) - e_init;
      float em_ke = s.ke;
      if (r == MC_GAVE_UP) {
        // the draw start with fresh momentum; the next noise as on success
        em_ke = give_up_momentum<DIM, T, MICRO>(seed, it, 7u, b, B, s.v, g);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          s.z[i] = zi[i];
          s.zg[i] = zgi[i];
        }
        s.logp = lpi;
        lane_normals<DIM, T>(s.noise, seed, it, 5u, 6u, b, B, g);
      }
      if (dc < K) {
        float e[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int j = g.lane + T * i;
          e[i] = s.z[i] + s.zg[i];
          if (j < DIM)
            a.draws[((size_t)dc * DIM + j) * C + c] = s.z[i] * stds[i] +
                                                      mean[i];
        }
        const float fisher = ordered_dot<DIM, T>(e, e, g);
        if (g.lane == 0) {
          const float row[NSTATS_M] = {
              r == MC_GAVE_UP ? 1.0f : 0.0f, (float)s.steps, e_change,
              s.ttime / (float)max(s.steps, 1), step, s.logp,
              em_ke - (s.logp + ld), fisher};
#pragma unroll
          for (int m = 0; m < NSTATS_M; ++m)
            a.stats[((size_t)dc * NSTATS_M + m) * C + c] = row[m];
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
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        zi[i] = s.z[i];
        zgi[i] = s.zg[i];
      }
      lpi = s.logp;
      dc += 1;
    }
    it += 1;
  }

#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int j = g.lane + T * i;
    if (j < DIM) {
      a.q_f[c * DIM + j] = s.z[i] * stds[i] + mean[i];
      a.g_f[c * DIM + j] = s.zg[i] / stds[i];
      a.v_f[c * DIM + j] = s.v[i];
    }
  }
  if (g.lane == 0) {
    a.logp_f[c] = s.logp;
    a.iters[c] = (int)it;
  }
}

template <int DIM, int T, bool MICRO, int H>
cudaError_t launch_mclmc_posterior(const McPostArgs& a, int B, int model_id,
                                   const float* params, cudaStream_t stream) {
  if (model_id != MODEL_IID_NORMAL) return cudaErrorInvalidValue;
  mclmc_posterior_kernel<DIM, T, MICRO, H, IidNormal>
      <<<a.C / B, B * T, 0, stream>>>(a, IidNormal{params[0]});
  return cudaGetLastError();
}

// The instantiation of (DIM, T) for the run's kinetic energy and halvings;
// an error for lanes the rule never gives at DIM (none is built).
template <int DIM, int T>
cudaError_t launch_mclmc_posterior_lanes(const McPostArgs& a, int B,
                                         int micro, int dynamic, int model_id,
                                         const float* params,
                                         cudaStream_t stream) {
  if constexpr (mclmc_lanes_taken(DIM, T)) {
    if (micro && dynamic)
      return launch_mclmc_posterior<DIM, T, true, MAX_HALVINGS>(
          a, B, model_id, params, stream);
    if (micro)
      return launch_mclmc_posterior<DIM, T, true, 0>(a, B, model_id, params,
                                                     stream);
    if (dynamic)
      return launch_mclmc_posterior<DIM, T, false, MAX_HALVINGS>(
          a, B, model_id, params, stream);
    return launch_mclmc_posterior<DIM, T, false, 0>(a, B, model_id, params,
                                                    stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace nrt

// The lanes K3 takes for d and B (mclmc_lanes), for the wrapper to check
// its own rule against.
extern "C" int nrt_mclmc_lanes(int dim, int B) {
  return nrt::mclmc_lanes(dim, B);
}

// lanes: the chain's lanes the caller's rule gives (_build.mclmc_lanes);
// a launch whose shapes the C rule gives other lanes is refused.
extern "C" int nrt_mclmc_posterior_launch(
    int dim, int micro, int dynamic, int lanes, int C, int B, int K,
    uint32_t seed, float max_err, float ell, float fsub_ell, float sqrt_n,
    int has_jitter, float jc1, float jc2, int model_id,
    const float* model_params, const float* q, const float* g,
    const float* logp, const float* v, const float* stds, const float* mean,
    const float* logdet, const float* step0, const float* bar, float* draws,
    float* stats, float* q_f, float* g_f, float* logp_f, float* v_f,
    int* iters, void* stream) {
  if (B < 1 || B > nrt::MAX_BLOCK || C % B != 0 ||
      lanes != nrt::mclmc_lanes(dim, B) || B * lanes > nrt::MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const nrt::McPostArgs a{C,    K,      seed,  {max_err, ell, fsub_ell, sqrt_n},
                          has_jitter, jc1, jc2, q, g, logp, v, stds, mean,
                          logdet, step0, bar, draws, stats, q_f, g_f, logp_f,
                          v_f,  iters};
  cudaStream_t s = (cudaStream_t)stream;
#define NRT_LANES(DIM_, T_)                                                \
  if (lanes == T_)                                                         \
    return (int)nrt::launch_mclmc_posterior_lanes<DIM_, T_>(               \
        a, B, micro, dynamic, model_id, model_params, s);
#define NRT_CASE(DIM_)                                                     \
  if (dim == DIM_) {                                                       \
    NRT_LANES(DIM_, 1)                                                     \
    NRT_LANES(DIM_, 4)                                                     \
    NRT_LANES(DIM_, 8)                                                     \
    NRT_LANES(DIM_, 16)                                                    \
  }
  NRT_FOR_EACH_DIM(NRT_CASE)
#undef NRT_CASE
#undef NRT_LANES
  return (int)cudaErrorInvalidValue;
}
