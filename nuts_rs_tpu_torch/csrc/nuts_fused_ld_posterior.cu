// Kernel K1-ld: the fused draw-asynchronous NUTS posterior in the
// dim-on-lanes layout.  The kernel body, with what it replaces, what bounds
// it and what its design does about that, is nuts_fused_ld_posterior.cuh;
// this file instantiates it for the models whose functor has the
// term / finish form and launches it.

#include "nuts_fused_ld_posterior.cuh"

// Dynamic shared memory of one chain block, in bytes (0: posterior kernel,
// 1: warmup kernel), without a model functor's scratch; the launcher refuses
// a d that does not fit.
extern "C" long long nrt_ld_smem_bytes(int warmup, int d, int maxdepth) {
  const int nvec = warmup ? nrt::LD_WARM_NVEC : nrt::LD_POST_NVEC;
  return (long long)(4 * nrt::ld_smem_floats(nvec, d, maxdepth));
}

extern "C" int nrt_ld_posterior_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed, float max_err,
    int has_jitter, float jc1, float jc2, int model_id,
    const float* model_params, const float* q, const float* g,
    const float* logp, const float* stds, const float* mean,
    const float* logdet, const float* step0, const float* bar, float* draws,
    float* stats, float* q_f, float* g_f, float* logp_f, int* iters,
    float* work, void* stream) {
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 ||
      maxdepth < 1 || maxdepth > 30)
    return (int)cudaErrorInvalidValue;
  if (model_id != nrt::MODEL_IID_NORMAL) return (int)cudaErrorInvalidValue;
  const nrt::LdPostArgs a{C,    K,    dim,  maxdepth, seed,   max_err,
                          has_jitter, jc1, jc2, q,    g,      logp,
                          stds, mean, logdet, step0,  bar,    draws,
                          stats, q_f, g_f,  logp_f,   iters,  work};
  return (int)nrt::ld_launch(
      nrt::ld_posterior_kernel<nrt::IidNormal, false, false>, a,
      nrt::IidNormal{model_params[0]}, C, B,
      4 * nrt::ld_smem_floats(nrt::LD_POST_NVEC, dim, maxdepth),
      (cudaStream_t)stream);
}
