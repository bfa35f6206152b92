// Fused draw-asynchronous NUTS posterior for data-carrying models and mid d,
// chains-on-lanes random stream (kernel K1-args).
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// (:82) with n_model_args > 0 (:84,159-166,260), launched by nuts_pallas_run
// (:718; model_args :734,812-817,861,872): K draw-asynchronous NUTS draws per
// chain with the model evaluated as logp_grad_batched(q, *model_args) on
// arrays that every block sees; for the Bernoulli GLM
// (models/gaussian.py:171-180) two [N, d] x [d] products, logaddexp and a
// sigmoid per chain and leapfrog.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference with
// layout="cl" and a model the mid-d kernel serves (nuts_fused.cl_kernel).
// d, maxdepth and the data sizes are launch arguments.
//
// What was chosen, and why:
//
// 1. Threads.  At d = 100 one thread cannot hold a chain (15 vectors and
//    four (D + 1) x d stacks are 26 KB, and a leapfrog's products 200 000
//    multiply-adds), so the kernel body is the one of K1-ld
//    (nuts_fused_ld_posterior.cuh, nuts_tree_ld.cuh): one CUDA block of
//    LD_T = 256 threads per chain, thread t owning the coordinates
//    t, t + 256, ... of every vector, the 21 live vectors in dynamic shared
//    memory, the stacks in a global workspace, one thread block cluster of
//    B <= 8 blocks per logical chain block (the wrapper's default is 1: a
//    chain needs its block mates only for the counter, and alone it waits
//    for nobody).  It serves every chains-on-lanes size that has no
//    instantiated thread-per-chain kernel (d = 11..chain.cl_max_dim) and
//    every model with data.
// 2. Random stream.  The layout of a configuration is the JAX runners'
//    (chain.fused_layout), and these sizes are "cl" there, so a vector site
//    is element j * B + b of the block's (d, B) shape (block_site<true>),
//    not the dim-on-lanes b * d + j; scalar sites, salts and the block seed
//    seed + 0x51ED2701 * pid are those of every fused NUTS kernel.  With
//    that the plain version replays interpret-mode Pallas draw for draw.
// 3. The model is a functor in its eval_block form (models.cuh): the
//    block's threads evaluate their chain together from the whole position
//    vector in shared memory, between the leapfrog's two passes over the
//    coordinates.  LogisticRegression holds device pointers to the data.
// 4. Sums.  Every sum has one order, shared with the plain version: a
//    logit's 100 terms in ascending j by one thread (ops.dsum); the
//    log-likelihood's and each gradient column's 1000 terms over n, the
//    prior's terms over j and every dot product of the tree in the block
//    order (ops.tsum: a thread's terms ascending, the warp butterfly, the 8
//    warp sums halved).  No atomics.
// 5. Spellings are the JAX body's: y logits - logaddexp(0, logits),
//    p = 1 / (1 + exp(-logits)), grad = x^T (y - p) - q, in IEEE f32 with
//    -fmad=false.
// 6. The data, x transposed [d, N] so that the threads of a warp (rows
//    n, n + 1, ...) read neighbouring addresses in both products, stays in
//    global memory and is read through L2 (400 KB at N = 1000, d = 100; a
//    block's shared memory would not hold it).  A block serves one chain, so
//    every chain rereads x for every evaluation: about 0.8 MB of L2 traffic
//    per chain and leapfrog, no reuse across chains.  That traffic bounds
//    the kernel, not device memory or FP32 peak: an evaluation takes about
//    24 us of a 27 us iteration with one chain block an SM (209-234
//    registers), 132 SMs then ask L2 for 4.4 TB/s, and the products' loops
//    keep 16-32 loads a thread in flight to get there (models.cuh).
//    Sharing a row of x across the chains of a block (what the MXU products
//    of the TPU kernel do) is a later redesign.
// 7. Draw-asynchronous on the block counter `it` as K1-ld: a chain runs
//    alone to its K draws, one cluster barrier gives the block's last
//    iteration, and the final q/g/logp are the selected point there.

#include "nuts_fused_ld_posterior.cuh"

// Dynamic shared memory of one chain block of the mid-d kernels, in bytes
// (0: posterior kernel, 1: warmup kernel; nrt::block_smem_bytes).
extern "C" long long nrt_mid_smem_bytes(int warmup, int d, int maxdepth,
                                        int model_id, const int* model_ints) {
  return nrt::block_smem_bytes(warmup, d, maxdepth, model_id, model_ints);
}

extern "C" int nrt_mid_posterior_launch(
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
            nrt::ld_posterior_kernel<decltype(model), true, true>, a, model, C, B,
            4 * (nrt::ld_smem_floats(nrt::LD_POST_NVEC, dim, maxdepth) +
                 model.scratch_floats()),
            (cudaStream_t)stream);
      });
}
