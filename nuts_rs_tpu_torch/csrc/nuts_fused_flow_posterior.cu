// Fused draw-asynchronous NUTS posterior through a frozen normalizing flow
// (kernel K1-flow).
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// with flow=(pallas_forward, n) (:106-113,152-155,202-216,272-282,705-710),
// launched by nuts_pallas_run (:751-755,788-798, pallas_call :863) from the
// flow branch of chain.make_pallas_posterior_runner
// (nuts_rs_tpu/chain.py:694-727,816-835): K draws per chain of NUTS in the
// z-space of a coupling flow whose parameters every chain shares (the
// pooled flow of the warmup's last refit).  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference with
// flow=PackedFlow.  d, maxdepth, the flow's layers and hidden units are
// launch arguments.
//
// What was chosen, and why:
//
// 1. Body.  The dim-on-lanes posterior body with the chains-on-lanes site
//    index (nuts_fused_ld_posterior.cuh with CL_SITE and EVAL_BLOCK): one
//    CUDA block of LD_T = 256 threads a chain, the 21
//    live vectors in shared memory, the stacks in a global workspace, a
//    cluster of B <= 8 blocks a logical chain block (default 1).  Flows are
//    chains-on-lanes only in the JAX package (nuts_pallas.py:125-126), so
//    the random stream is the cl one (vector site j * B + b) with the salts
//    of every fused NUTS posterior: the flow's evaluation draws nothing.
// 2. The flow.  With FLOW the body's leapfrog sends z1 through the frozen
//    flow (coupling_flow.cuh): the layers' forward pass, the diagonal base,
//    the model's functor at q in its eval_block form, and a hand-written
//    backward pass for zg = d/dz [logp(F(z)) + logdet(z)] (the JAX kernel
//    gets it from jax.value_and_grad through pallas_forward).  The
//    activations of the backward pass stay in shared memory (L x (4 d + H)
//    floats), not registers; the parameters, shared by all chains, are
//    copied into each block's shared memory where they fit (16 KB at d = 10
//    and the default 4 layers of 32), else read through L2.
// 3. The logdet depends on the position: the selected points carry their
//    own (dm_ld, ds_ld), and its sum over the coordinates rides in the
//    leapfrog's one block reduction (no extra barrier).
// 4. The position input is z0 (the runner keeps the chains' z), the g
//    output the final z; the runner rebuilds q, g and zg from it through
//    FlowOps.eval_from_z, as the JAX runner does.
// 5. Arithmetic as the plain version's: tanh from expf (ftanh), IEEE
//    divisions, -fmad=false, every sum in a stated order
//    (coupling_flow.cuh).

#include "coupling_flow.cuh"
#include "nuts_fused_ld_posterior.cuh"

namespace {

template <class Fn>
cudaError_t with_flow_model(int model_id, const float* params,
                            const void* const* ptrs, const int* ints,
                            const float* flow, int d, int L, int H, float S,
                            float T, int in_smem, Fn&& fn) {
  return nrt::with_block_model(
      model_id, params, ptrs, ints, [&](auto model) {
        return fn(nrt::CouplingFlowModel<decltype(model)>{
            model, flow, d, H, L, S, T, in_smem});
      });
}

}  // namespace

// Dynamic shared memory of one chain block of K1-flow, in bytes; -1 for a
// model id no functor of the library has.
extern "C" long long nrt_flow_smem_bytes(int d, int maxdepth, int model_id,
                                         const int* model_ints, int n_layers,
                                         int hidden, int weights_in_smem) {
  long long bytes = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  with_flow_model(model_id, no_params, no_ptrs, model_ints, nullptr, d,
                  n_layers, hidden, 1.0f, 1.0f, weights_in_smem,
                  [&](auto model) {
                    bytes = 4 * (long long)(nrt::ld_smem_floats(
                                                nrt::LD_POST_NVEC, d,
                                                maxdepth) +
                                            model.scratch_floats());
                    return cudaSuccess;
                  });
  return bytes;
}

extern "C" int nrt_flow_posterior_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed, float max_err,
    int has_jitter, float jc1, float jc2, int model_id, int n_layers,
    int hidden, float max_scale, float max_shift, int weights_in_smem,
    const float* model_params, const void* const* model_ptrs,
    const int* model_ints, const float* flow, const float* z, const float* g,
    const float* logp, const float* stds, const float* mean,
    const float* logdet, const float* step0, const float* bar, float* draws,
    float* stats, float* q_f, float* z_f, float* logp_f, int* iters,
    float* work, void* stream) {
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 ||
      maxdepth < 1 || maxdepth > 30 || n_layers < 0 || hidden < 1)
    return (int)cudaErrorInvalidValue;
  const nrt::LdPostArgs a{C,    K,    dim,  maxdepth, seed,   max_err,
                          has_jitter, jc1, jc2, z,    g,      logp,
                          stds, mean, logdet, step0,  bar,    draws,
                          stats, q_f, z_f,  logp_f,   iters,  work};
  return (int)with_flow_model(
      model_id, model_params, model_ptrs, model_ints, flow, dim, n_layers,
      hidden, max_scale, max_shift, weights_in_smem, [&](auto model) {
        return nrt::ld_launch(
            nrt::ld_posterior_kernel<decltype(model), true, true, true>,
            a, model, C, B,
            4 * (nrt::ld_smem_floats(nrt::LD_POST_NVEC, dim, maxdepth) +
                 model.scratch_floats()),
            (cudaStream_t)stream);
      });
}
