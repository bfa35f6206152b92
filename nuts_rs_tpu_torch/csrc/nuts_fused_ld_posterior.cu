// Kernel K1-ld: the fused draw-asynchronous NUTS posterior in the
// dim-on-lanes layout.  The kernel body, with what it replaces, what bounds
// it and what its design does about that, is nuts_fused_ld_posterior.cuh;
// this file instantiates it for the models whose functor has the
// term / finish form and launches it.
//
// Two kernels: the merged leapfrog (nuts_tree_ld.cuh::ld_leap_merged, one
// reduction a leapfrog for the leaves of tzn <= 2, the check rows loaded
// ahead) wherever its layout fits a block's shared memory, and today's
// leapfrog for the d above that (2733..2757 at maxdepth 10), so that the
// sizes served do not shrink (nuts_tree_ld.cuh::ld_kernel_form,
// _build.ld_form); both at LD_MIN_BLOCKS = 1 chain block an SM (two spill
// at 128 registers and measured slower, PERF.md).  Both give the same
// bits.

#include "nuts_fused_ld_posterior.cuh"

namespace {

using Kernel = void (*)(const nrt::LdPostArgs, const nrt::IidNormal);

// The kernel of K1-ld at (d, maxdepth).
Kernel ld_kernel(int d, int maxdepth) {
  return nrt::ld_kernel_form(nrt::LD_POST_NVEC, d, maxdepth)
             ? nrt::ld_posterior_kernel<nrt::IidNormal, false, false, false,
                                        nrt::LD_MIN_BLOCKS, nrt::LD_MERGED>
             : nrt::ld_posterior_kernel<nrt::IidNormal, false, false>;
}

}  // namespace

// Dynamic shared memory of one chain block, in bytes (0: posterior kernel,
// 1: warmup kernel), of the form ld_kernel_form picks, without a model
// functor's scratch; the launcher refuses a d that does not fit.
extern "C" long long nrt_ld_smem_bytes(int warmup, int d, int maxdepth) {
  const int nvec = warmup ? nrt::LD_WARM_NVEC : nrt::LD_POST_NVEC;
  return nrt::ld_form_bytes(nvec, d, maxdepth);
}

// Chain blocks an SM (out[0]) and clusters of B resident at once (out[1])
// of K1-ld's kernel at (d, maxdepth); a CUDA error code, or 0.
extern "C" int nrt_ld_posterior_occupancy(int d, int maxdepth, int B,
                                          int* out) {
  return nrt::ld_occupancy(
      ld_kernel(d, maxdepth),
      nrt::ld_form_bytes(nrt::LD_POST_NVEC, d, maxdepth), B, out);
}

#ifdef NRT_LD_CLOCKS
// The cycles nrt_ld_clocks holds (4 phases, then block iterations), read
// into out and, with reset, zeroed.
extern "C" int nrt_ld_clocks(int reset, unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, nrt::nrt_ld_clocks,
                                         sizeof(nrt::nrt_ld_clocks));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(nrt::nrt_ld_clocks, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

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
  const long long smem =
      nrt::ld_form_bytes(nrt::LD_POST_NVEC, dim, maxdepth);
  if (smem > nrt::LD_SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  const nrt::LdPostArgs a{C,    K,    dim,  maxdepth, seed,   max_err,
                          has_jitter, jc1, jc2, q,    g,      logp,
                          stds, mean, logdet, step0,  bar,    draws,
                          stats, q_f, g_f,  logp_f,   iters,  work};
  return (int)nrt::ld_launch(ld_kernel(dim, maxdepth), a,
                             nrt::IidNormal{model_params[0]}, C, B,
                             (size_t)smem, (cudaStream_t)stream);
}
