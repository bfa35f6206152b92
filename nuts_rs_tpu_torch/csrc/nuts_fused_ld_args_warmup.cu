// Kernel K2-ld-args: the fused lock-step NUTS warmup with in-kernel
// adaptation in the dim-on-lanes layout for a model evaluated in its
// eval_block form, with its data read inside the kernel.
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/nuts_pallas.py::make_warmup_kernel (:942) with
// layout="ld" (:959-986) and n_model_args > 0 (:944,975-979), launched by
// nuts_pallas_warmup_run (:1532, pallas_call :1689) from the JAX warmup
// runner's dim-on-lanes tier for a model with pallas_spec
// (nuts_rs_tpu/chain.py:1017-1044).  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_warmup_run_reference
// with layout="ld" and a model whose functor has no term / finish form.
//
// The body is K2-ld's (nuts_fused_ld_warmup.cuh: lock-step per draw, one
// cluster barrier per draw for the block's longest tree, the adaptation per
// coordinate from diag_adapt.cuh, the dim-on-lanes site index b * d + j)
// with the model evaluated as K2-args evaluates it (EVAL_BLOCK: the new
// position q1 kept whole as a 19th shared-memory vector, the functor's
// scratch after the chain's vectors); its shared memory is
// nrt_ld_args_smem_bytes(1, ...) (nuts_fused_ld_args_posterior.cu).  What
// bounds it: as K2-ld, the latency of a leapfrog's dependent steps and the
// wait for the longest tree of a block's chains in every draw.  The design
// is K1-ld-args' (nuts_fused_ld_args_posterior.cu): two chain blocks an SM,
// the order of every operation unchanged.

#include "nuts_fused_ld_warmup.cuh"

namespace {

// The kernel that a functor's launch takes.
template <class Model>
auto ld_args_warmup_kernel() {
  return nrt::ld_warmup_kernel<Model, true, nrt::LD_ARGS_MIN_BLOCKS>;
}

}  // namespace

// Chain blocks one SM holds of the warmup kernel for `model_id` at `smem`
// bytes of shared memory each (as nrt_ld_args_posterior_blocks_per_sm).
extern "C" int nrt_ld_args_warmup_blocks_per_sm(int model_id,
                                                const int* model_ints,
                                                long long smem) {
  int n = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  nrt::with_block_model(model_id, no_params, no_ptrs, model_ints,
                        [&](auto model) {
                          n = nrt::blocks_per_sm(
                              ld_args_warmup_kernel<decltype(model)>(), smem);
                          return cudaSuccess;
                        });
  return n;
}

extern "C" int nrt_ld_args_warmup_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed,
    float max_err, int has_jitter, float jc1, float jc2,
    int use_grad_based, float target_accept, float da_t0, float da_gamma,
    float da_neg_k, float ls_max, int model_id, const float* model_params,
    const void* const* model_ptrs, const int* model_ints, const int* flags,
    const float* logp, const float* stds, const float* mean,
    const float* sca, float* draws, float* stats, float* q_f, float* g_f,
    float* logp_f, float* stds_f, float* mean_f, float* est_f, float* sca_f,
    int* iters, float* work, void* stream) {
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 ||
      maxdepth < 1 || maxdepth > 30)
    return (int)cudaErrorInvalidValue;
  const nrt::LdWarmArgs a{C,      K,        dim,      maxdepth, seed,
                          max_err, has_jitter, jc1,   jc2,      use_grad_based,
                          target_accept, da_t0, da_gamma, da_neg_k, ls_max,
                          flags,  logp,     stds,     mean,     sca,
                          draws,  stats,    q_f,      g_f,      logp_f,
                          stds_f, mean_f,   est_f,    sca_f,    iters,
                          work};
  return (int)nrt::with_block_model(
      model_id, model_params, model_ptrs, model_ints, [&](auto model) {
        return nrt::ld_launch(
            ld_args_warmup_kernel<decltype(model)>(), a, model, C, B,
            4 * (nrt::ld_smem_floats(nrt::LD_WARM_NVEC + 1, dim, maxdepth) +
                 model.scratch_floats()),
            (cudaStream_t)stream);
      });
}
