// Kernel K2-ld: the fused lock-step NUTS warmup with in-kernel adaptation in
// the dim-on-lanes layout.  The kernel body, with what it replaces, what
// bounds it and what its design does about that, is
// nuts_fused_ld_warmup.cuh; this file instantiates it for the models whose
// functor has the term / finish form and launches it: the merged leapfrog
// where its layout fits a block's shared memory, else today's, as K1-ld
// (nuts_fused_ld_posterior.cu; the warmup's 18 vectors fit the merged
// layout up to d = 3188 at maxdepth 10).
// Its shared memory is nrt_ld_smem_bytes(1, ...) of that library.

#include "nuts_fused_ld_warmup.cuh"

namespace {

using Kernel = void (*)(const nrt::LdWarmArgs, const nrt::IidNormal);

// The kernel of K2-ld at (d, maxdepth).
Kernel ld_kernel(int d, int maxdepth) {
  return nrt::ld_kernel_form(nrt::LD_WARM_NVEC, d, maxdepth)
             ? nrt::ld_warmup_kernel<nrt::IidNormal, false,
                                     nrt::LD_MIN_BLOCKS, nrt::LD_MERGED>
             : nrt::ld_warmup_kernel<nrt::IidNormal, false>;
}

}  // namespace

// Chain blocks an SM (out[0]) and clusters of B resident at once (out[1])
// of K2-ld's kernel at (d, maxdepth); a CUDA error code, or 0.
extern "C" int nrt_ld_warmup_occupancy(int d, int maxdepth, int B,
                                       int* out) {
  return nrt::ld_occupancy(
      ld_kernel(d, maxdepth),
      nrt::ld_form_bytes(nrt::LD_WARM_NVEC, d, maxdepth), B, out);
}

extern "C" int nrt_ld_warmup_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed,
    float max_err, int has_jitter, float jc1, float jc2,
    int use_grad_based, float target_accept, float da_t0, float da_gamma,
    float da_neg_k, float ls_max, int model_id, const float* model_params,
    const int* flags, const float* logp, const float* stds,
    const float* mean, const float* sca, float* draws, float* stats,
    float* q_f, float* g_f, float* logp_f, float* stds_f, float* mean_f,
    float* est_f, float* sca_f, int* iters, float* work, void* stream) {
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 ||
      maxdepth < 1 || maxdepth > 30)
    return (int)cudaErrorInvalidValue;
  if (model_id != nrt::MODEL_IID_NORMAL) return (int)cudaErrorInvalidValue;
  const long long smem =
      nrt::ld_form_bytes(nrt::LD_WARM_NVEC, dim, maxdepth);
  if (smem > nrt::LD_SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  const nrt::LdWarmArgs a{C,      K,        dim,      maxdepth, seed,
                          max_err, has_jitter, jc1,   jc2,      use_grad_based,
                          target_accept, da_t0, da_gamma, da_neg_k, ls_max,
                          flags,  logp,     stds,     mean,     sca,
                          draws,  stats,    q_f,      g_f,      logp_f,
                          stds_f, mean_f,   est_f,    sca_f,    iters,
                          work};
  return (int)nrt::ld_launch(ld_kernel(dim, maxdepth), a,
                             nrt::IidNormal{model_params[0]}, C, B,
                             (size_t)smem, (cudaStream_t)stream);
}
