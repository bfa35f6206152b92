// Fused lock-step NUTS warmup with in-kernel adaptation for data-carrying
// models and mid d, chains-on-lanes random stream (kernel K2-args).
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/nuts_pallas.py::make_warmup_kernel (:942) with
// n_model_args > 0 (:944,975-979,1038), launched by nuts_pallas_warmup_run
// (:1532; model_args :1545,1621-1624,1686,1697): K lock-step tuning draws
// with the fg/bg estimators, the diagonal rule and dual averaging in the
// kernel, the model evaluated as logp_grad_batched(q, *model_args).  The
// launch of one chain group per pallas_call (:1564-1579) works around a
// Mosaic fault and has no counterpart here: one launch takes every block.
// Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_warmup_run_reference
// with layout="cl" and a model the mid-d kernel serves
// (nuts_fused.cl_kernel).  d, maxdepth and the data sizes are launch
// arguments.
//
// The design is the one of K1-args (nuts_fused_mid_posterior.cu, points 1-6:
// 256 threads a chain on the tree code of the dim-on-lanes kernels, the
// chains-on-lanes site index j * B + b, the model in its eval_block form with
// the data read through L2, every sum in ops.dsum's or ops.tsum's order, the
// JAX body's spellings), with the kernel body of K2-ld
// (nuts_fused_ld_warmup.cuh): lock-step per draw, one cluster barrier per
// draw for the block's longest tree, the adaptation per coordinate from
// diag_adapt.cuh, the current q and g and the estimator planes in global
// memory.  It keeps the new position q1 as a 19th shared-memory vector, which
// the model reads whole.  What bounds it: as K1-args, the L2 traffic and
// issue rate of the two products of every evaluation, plus the wait for the
// longest tree among the B chains of a block in every draw.

#include "nuts_fused_ld_warmup.cuh"

extern "C" int nrt_mid_warmup_launch(
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
            nrt::ld_warmup_kernel<decltype(model), true, true>, a, model, C, B,
            4 * (nrt::ld_smem_floats(nrt::LD_WARM_NVEC + 1, dim, maxdepth) +
                 model.scratch_floats()),
            (cudaStream_t)stream);
      });
}
