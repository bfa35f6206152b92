// Kernel K1-ld-args: the fused draw-asynchronous NUTS posterior in the
// dim-on-lanes layout for a model evaluated in its eval_block form, with its
// data read inside the kernel.
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// (:82) with layout="ld" (:123-136) and n_model_args > 0 (:84,159-166),
// launched by nuts_pallas_run (:718, pallas_call :863) from the JAX
// posterior runner's dim-on-lanes tier for a model with pallas_spec
// (nuts_rs_tpu/chain.py:773-801: jax.value_and_grad of the model's density
// in [B, d] orientation).  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference with
// layout="ld" and a model whose functor has no term / finish form.
//
// The body is K1-ld's (nuts_fused_ld_posterior.cuh: 256 threads a chain,
// the live vectors in shared memory, the stacks in a global workspace, the
// dim-on-lanes site index b * d + j) with the model evaluated as K1-args
// evaluates it (EVAL_BLOCK: the functor sees the whole new position in
// shared memory between the leapfrog's two passes, its scratch after the
// chain's vectors).  So a chain block's shared memory is K1-args' layout,
// ld_smem_floats(21, d, D) + scratch_floats().  The model the slice runs is
// stochastic volatility at T = 1000 (d = 1002; models.cuh::
// StochasticVolatility: two scans over the 1000 innovations, lgamma,
// digamma and log1p out of basic operations); every functor of
// with_block_model is instantiated.  What bounds it: as K1-ld, the latency
// of one block iteration's dependent steps (the evaluation adds two
// block-wide scans and one reduction to the leapfrog's), not bytes or FP32
// peak.

#include "nuts_fused_ld_posterior.cuh"

// Dynamic shared memory of one chain block of the ld_args kernels, in bytes
// (0: posterior kernel, 1: warmup kernel; nrt::block_smem_bytes).
extern "C" long long nrt_ld_args_smem_bytes(int warmup, int d, int maxdepth,
                                            int model_id,
                                            const int* model_ints) {
  return nrt::block_smem_bytes(warmup, d, maxdepth, model_id, model_ints);
}

extern "C" int nrt_ld_args_posterior_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed, float max_err,
    int has_jitter, float jc1, float jc2, int model_id,
    const float* model_params, const void* const* model_ptrs,
    const int* model_ints, const float* q, const float* g, const float* logp,
    const float* stds, const float* mean, const float* logdet,
    const float* step0, const float* bar, float* draws, float* stats,
    float* q_f, float* g_f, float* logp_f, int* iters, float* work,
    void* stream) {
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 ||
      maxdepth < 1 || maxdepth > 30)
    return (int)cudaErrorInvalidValue;
  const nrt::LdPostArgs a{C,    K,    dim,  maxdepth, seed,   max_err,
                          has_jitter, jc1, jc2, q,    g,      logp,
                          stds, mean, logdet, step0,  bar,    draws,
                          stats, q_f, g_f,  logp_f,   iters,  work};
  return (int)nrt::with_block_model(
      model_id, model_params, model_ptrs, model_ints, [&](auto model) {
        return nrt::ld_launch(
            nrt::ld_posterior_kernel<decltype(model), false, true>, a, model,
            C, B,
            4 * (nrt::ld_smem_floats(nrt::LD_POST_NVEC, dim, maxdepth) +
                 model.scratch_floats()),
            (cudaStream_t)stream);
      });
}
