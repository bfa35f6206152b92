// Fused draw-asynchronous NUTS posterior through a frozen normalizing flow
// (kernel K1-flow): the body and C interface of its two libraries,
// nuts_fused_flow_posterior.cu (today's form of the flow) and
// nuts_fused_flow_warp_posterior.cu (the warp form), each of which
// defines NRT_FLOW_LIB_WARP (0 or 1) and instantiates the kernel of its
// form alone, so that the two build in parallel.
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
// 6. Two forms of the flow's passes, by a rule on shapes (flow_kernel_form,
//    _build.flow_form), the same bits: at d <= 32 and H <= 32 (the default
//    4 x 32 flow at the flow benchmark's d = 10) the warp form, both passes
//    on warp 0 with no block barrier inside them, every dot product unrolled
//    in registers over a conflict-free layout of the parameters.  What
//    bounds the flow there is latency, not bytes or operations: in today's
//    form its passes took 14.4 of a block iteration's 18.0 us on an H100
//    (every tree at 15 leapfrogs), nearly all of it dot products whose
//    every term waited on its own shared-memory load (7.9 us) and bank
//    conflicts (2.5 us), the block barriers nothing measurable; the warp
//    form takes 6.5 of 10.1 us (profile_main_path.py item 16, PERF.md).
//    Today's form (every thread, loops of run-time length, the parameters
//    in shared memory or through L2) serves the rest.
//    FLOW_WARP_MIN_BLOCKS = 2 chain blocks an SM for the warp form (at most
//    128 registers; 264 chains resident, so 256 run in one wave: 1.8x
//    faster than one block an SM there), one for today's.  Both libraries
//    hold the rule and the byte counts of both forms; a launch, or an
//    occupancy query, in the form of the other library returns
//    cudaErrorInvalidValue.

#pragma once

#include "coupling_flow.cuh"
#include "nuts_fused_ld_posterior.cuh"

#ifndef NRT_FLOW_LIB_WARP
#error "define NRT_FLOW_LIB_WARP (1: the warp form's library, 0: today's)"
#endif

namespace nrt {

// Chain blocks an SM of the warp form (NRT_FLOW_MIN_BLOCKS=n changes it for
// timing ablations).
#ifdef NRT_FLOW_MIN_BLOCKS
constexpr int FLOW_WARP_MIN_BLOCKS = NRT_FLOW_MIN_BLOCKS;
#else
constexpr int FLOW_WARP_MIN_BLOCKS = 2;
#endif

}  // namespace nrt

namespace {

// The model functor `model_id` through the flow in `form` (1: warp, 0:
// today's), handed to fn.
template <class Fn>
cudaError_t with_flow_model(int model_id, const float* params,
                            const void* const* ptrs, const int* ints,
                            const float* flow, int d, int L, int H, float S,
                            float T, int form, int in_smem, Fn&& fn) {
  return nrt::with_block_model(
      model_id, params, ptrs, ints, [&](auto model) {
        using M = decltype(model);
        if (form)
          return fn(nrt::CouplingFlowModel<M, true>{model, flow, d, H, L, S,
                                                    T, 0});
        return fn(nrt::CouplingFlowModel<M, false>{model, flow, d, H, L, S, T,
                                                   in_smem});
      });
}

// Dynamic shared memory of one chain block in `form`; -1 for a model id no
// functor of the library has.
long long flow_bytes(int d, int maxdepth, int model_id, const int* ints,
                     int L, int H, int form, int in_smem) {
  long long bytes = -1;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  with_flow_model(model_id, no_params, no_ptrs, ints, nullptr, d, L, H, 1.0f,
                  1.0f, form, in_smem, [&](auto model) {
                    bytes = 4 * (long long)(nrt::ld_smem_floats(
                                                nrt::LD_POST_NVEC, d,
                                                maxdepth) +
                                            model.scratch_floats());
                    return cudaSuccess;
                  });
  return bytes;
}

// The form nrt::flow_kernel_form picks for this chain block.
int flow_form(int d, int maxdepth, int model_id, const int* ints, int L,
              int H) {
  return nrt::flow_kernel_form(
      d, H, flow_bytes(d, maxdepth, model_id, ints, L, H, 1, 0),
      nrt::LD_SMEM_OPT_IN);
}

template <class M>
constexpr int flow_min_blocks() {
  return M::WARP_FORM ? nrt::FLOW_WARP_MIN_BLOCKS : 1;
}

// Whether this library instantiates the kernel of M's form.
template <class M>
constexpr bool flow_in_library() {
  return M::WARP_FORM == (NRT_FLOW_LIB_WARP != 0);
}

}  // namespace

// Dynamic shared memory of one chain block of K1-flow in `form` (1: the warp
// form; 0: today's, with the parameters in shared memory or not), in bytes;
// -1 for a model id no functor of the library has.
extern "C" long long nrt_flow_smem_bytes(int d, int maxdepth, int model_id,
                                         const int* model_ints, int n_layers,
                                         int hidden, int form,
                                         int weights_in_smem) {
  return flow_bytes(d, maxdepth, model_id, model_ints, n_layers, hidden, form,
                    weights_in_smem);
}

// The form of K1-flow the kernel library's rule picks (1: warp, 0: today's).
extern "C" int nrt_flow_form(int d, int maxdepth, int model_id,
                             const int* model_ints, int n_layers, int hidden) {
  return flow_form(d, maxdepth, model_id, model_ints, n_layers, hidden);
}

// Chain blocks of K1-flow one SM holds in `form` at `smem` bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); minus a CUDA error code
// (cudaErrorInvalidValue for the other library's form).
extern "C" int nrt_flow_blocks_per_sm(int form, int model_id,
                                      const int* model_ints, long long smem) {
  int n = -(int)cudaErrorInvalidValue;
  const float no_params[nrt::MAX_MODEL_PARAMS] = {};
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  with_flow_model(model_id, no_params, no_ptrs, model_ints, nullptr, 1, 0, 1,
                  1.0f, 1.0f, form, 0, [&](auto model) {
                    using M = decltype(model);
                    if constexpr (flow_in_library<M>())
                      n = nrt::blocks_per_sm(
                          nrt::ld_posterior_kernel<M, true, true, true,
                                                   flow_min_blocks<M>()>,
                          smem);
                    return cudaSuccess;
                  });
  return n;
}

#ifdef NRT_FLOW_CLOCKS
// The cycles nrt_flow_clocks holds (the phases of coupling_flow.cuh's
// FLOW_CLOCKS, then evaluations: 11 values), read into out and, with reset,
// zeroed.
extern "C" int nrt_flow_clocks(int reset, unsigned long long* out) {
  unsigned long long all[nrt::FLOW_CLOCKS];
  cudaError_t err =
      cudaMemcpyFromSymbol(all, nrt::nrt_flow_clocks, sizeof(all));
  for (int k = 0; k < nrt::FLOW_CLOCKS - 1; ++k) out[k] = all[k];
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[nrt::FLOW_CLOCKS] = {};
    err = cudaMemcpyToSymbol(nrt::nrt_flow_clocks, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

extern "C" int nrt_flow_posterior_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed, float max_err,
    int has_jitter, float jc1, float jc2, int model_id, int n_layers,
    int hidden, float max_scale, float max_shift, int form,
    int weights_in_smem, const float* model_params,
    const void* const* model_ptrs, const int* model_ints, const float* flow,
    const float* z, const float* g, const float* logp, const float* stds,
    const float* mean, const float* logdet, const float* step0,
    const float* bar, float* draws, float* stats, float* q_f, float* z_f,
    float* logp_f, int* iters, float* work, void* stream) {
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 ||
      maxdepth < 1 || maxdepth > 30 || n_layers < 0 || hidden < 1 ||
      form != flow_form(dim, maxdepth, model_id, model_ints, n_layers,
                        hidden))
    return (int)cudaErrorInvalidValue;
  const nrt::LdPostArgs a{C,    K,    dim,  maxdepth, seed,   max_err,
                          has_jitter, jc1, jc2, z,    g,      logp,
                          stds, mean, logdet, step0,  bar,    draws,
                          stats, q_f, z_f,  logp_f,   iters,  work};
  return (int)with_flow_model(
      model_id, model_params, model_ptrs, model_ints, flow, dim, n_layers,
      hidden, max_scale, max_shift, form, weights_in_smem, [&](auto model) {
        using M = decltype(model);
        if constexpr (flow_in_library<M>())
          return nrt::ld_launch(
              nrt::ld_posterior_kernel<M, true, true, true,
                                       flow_min_blocks<M>()>,
              a, model, C, B,
              4 * (nrt::ld_smem_floats(nrt::LD_POST_NVEC, dim, maxdepth) +
                   model.scratch_floats()),
              (cudaStream_t)stream);
        else
          return cudaErrorInvalidValue;
      });
}
