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
// with_block_model is instantiated.
//
// What bounds it: as K1-ld, the latency of one block iteration's dependent
// steps, not bytes or FP32 peak: at d = 1002 a thread owns 4 coordinates,
// and a leapfrog is a few passes over them between block barriers (the
// first pass, SV's two scans and its reduction, the leapfrog's reduction,
// one more a U-turn level).  On the SV path's own states, with every tree
// forced to maxdepth 7 (profile_main_path.py item 12, PERF.md; an H100 at
// 700 W), one chain alone on an SM takes 8.05 us a leapfrog: the tree 3.69
// us (K1-ld on the
// iid normal from the same states), SV's scans and their barriers 1.05 us,
// SV's arithmetic the rest.  What the design does about it: two chain
// blocks an SM (__launch_bounds__(LD_T, LD_ARGS_MIN_BLOCKS = 2): at most
// 128 registers a thread; 89 KB of shared memory a chain block at d = 1002
// fits twice), so 264 chains are resident, not 132, and one chain's
// barriers and dependent steps overlap the other's; an SM then spends 7.10
// us on a leapfrog where one chain alone takes 8.05.  The order of every
// operation is K1-ld's and the functor's, so the bits do not depend on
// the blocks an SM.  SV's scans over the leapfrog's own coordinates with
// its reduction merged into the leapfrog's (4 barriers a leapfrog, not 5)
// measured slower than this at one block an SM and at two (PERF.md), so
// the functor keeps its eval_block form.

#include "nuts_fused_ld_posterior.cuh"

namespace {

// The kernel that a functor's launch takes.
template <class Model>
auto ld_args_posterior_kernel() {
  return nrt::ld_posterior_kernel<Model, false, true, false,
                                  nrt::LD_ARGS_MIN_BLOCKS>;
}

}  // namespace

// Dynamic shared memory of one chain block of the ld_args kernels, in bytes
// (0: posterior kernel, 1: warmup kernel; nrt::block_smem_bytes).
extern "C" long long nrt_ld_args_smem_bytes(int warmup, int d, int maxdepth,
                                            int model_id,
                                            const int* model_ints) {
  return nrt::block_smem_bytes(warmup, d, maxdepth, model_id, model_ints);
}

// Chain blocks one SM holds of the posterior kernel for `model_id` at
// `smem` bytes of shared memory each (minus a CUDA error code where the
// query fails; -1 for an unknown model id).
extern "C" int nrt_ld_args_posterior_blocks_per_sm(int model_id,
                                                   const int* model_ints,
                                                   long long smem) {
  int n = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  nrt::with_block_model(model_id, no_params, no_ptrs, model_ints,
                        [&](auto model) {
                          n = nrt::blocks_per_sm(
                              ld_args_posterior_kernel<decltype(model)>(),
                              smem);
                          return cudaSuccess;
                        });
  return n;
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
            ld_args_posterior_kernel<decltype(model)>(), a, model, C, B,
            4 * (nrt::ld_smem_floats(nrt::LD_POST_NVEC, dim, maxdepth) +
                 model.scratch_floats()),
            (cudaStream_t)stream);
      });
}
