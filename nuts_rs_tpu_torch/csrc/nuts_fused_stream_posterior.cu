// Fused draw-asynchronous NUTS posterior with the model's data streamed from
// device memory in row tiles, chains-on-lanes random stream (kernel
// K1-stream).
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// (:82) with stream= (:115-121,156-165,217-254), launched by nuts_pallas_run
// (:718, pallas_call :863): K draw-asynchronous NUTS draws per chain whose
// every evaluation passes once over likelihood data too large to sit beside
// a chain: per leapfrog, for tile t = 0..T-1 of tile_rows rows, the two
// products logits = tile q and grad += tile^T (y - p), the partial
// (logp, grad) added tile after tile, then the prior.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference with
// stream=True.  d, maxdepth, the rows and the tile are launch arguments.
//
// What was chosen, and why:
//
// 1. The tree.  The body is K1-args' (nuts_fused_ld_posterior.cuh with
//    CL_SITE and EVAL_BLOCK, nuts_tree_ld.cuh): one CUDA block of LD_T = 256 threads per chain, the
//    21 live vectors in shared memory, the checkpoint stacks in a global
//    workspace, a thread block cluster of B chains as the logical chain
//    block, the chains-on-lanes site index j * B + b, the block seed by
//    program id, every dot product in ops.tsum's order.
// 2. Why not K1-args itself.  Its functor keeps a residual per row in shared
//    memory, N + 8 d floats: 512 KB at N = 131072 against the 227 KB a block
//    may have.  LogisticRegressionStream (models.cuh) walks the rows in tiles
//    and keeps one tile's residuals and two buffers of warp partials,
//    whatever N is.
// 3. Chains share a pass over the data.  One chain a block that walks all
//    the data on its own reads chains x evaluations x 2 x 52 MB a launch
//    (B = 1 here: 3.4 ms an evaluation on an NVIDIA H100 80GB HBM3 at 700 W
//    for a block alone and the same for 128 blocks, which read 3.8 TB/s
//    between them; PERF.md section 5).  The TPU kernel's B chains step in
//    lock step and one tile serves all of them.
//    Here the B <= 8 chains of a cluster do the same (LOCKSTEP in the
//    body): every iteration each block takes its chain's half step, then
//    block b walks range b of the tiles for all B chains at once, so that a
//    loaded x[n][j] serves B products, and the chains collect their sums
//    from the blocks through distributed shared memory: two cluster
//    barriers an evaluation, one more an iteration for the loop's end.
//    Chains that have their K draws keep stepping to the block's last
//    iteration, as they do in the TPU kernel.
// 4. Sum order (the contract with the plain version): a logit's terms in
//    ascending j; inside a tile every sum over rows in ops.tsum's order;
//    the tiles of a range added in ascending order, then the B ranges in
//    ascending order; the prior last.  B = 1 is tiles ascending, and one
//    tile that holds all rows gives K1-args' bits.
// 5. The products are loops in this kernel's body, in IEEE f32 with
//    -fmad=false; the data, x transposed [d, N] so that a warp's threads
//    (rows n, n + 1, ...) read neighbouring addresses, is read from device
//    memory through L2 once per product, tile by tile; the second product's
//    reads of a tile find what the first one brought in.  The sixteen sums
//    of a pass of the second product are halved over the warp together
//    (block_sum.cuh::warp_sum16).

#include "nuts_fused_ld_posterior.cuh"

// Dynamic shared memory of one chain block in a cluster of B, in bytes, with
// the streamed functor's scratch; -1 for a model without a streamed functor
// or a B that is not 1, 2, 4 or 8.
extern "C" long long nrt_stream_smem_bytes(int d, int maxdepth, int B,
                                           int model_id,
                                           const int* model_ints) {
  long long bytes = -1;
  const void* no_ptrs[nrt::MAX_MODEL_PTRS] = {};
  nrt::with_stream_model(model_id, no_ptrs, model_ints, B, [&](auto model) {
    bytes = 4 * (long long)(nrt::ld_smem_floats(nrt::LD_POST_NVEC, d,
                                                maxdepth) +
                            model.scratch_floats());
    return cudaSuccess;
  });
  return bytes;
}

extern "C" int nrt_stream_posterior_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed, float max_err,
    int has_jitter, float jc1, float jc2, int model_id,
    const float* model_params, const void* const* model_ptrs,
    const int* model_ints, const float* q, const float* g, const float* logp,
    const float* stds, const float* mean, const float* logdet,
    const float* step0, const float* bar, float* draws, float* stats,
    float* q_f, float* g_f, float* logp_f, int* iters, float* work,
    void* stream) {
  (void)model_params;
  if (B < 1 || B > nrt::LD_MAX_CLUSTER || C % B != 0 || dim < 1 ||
      maxdepth < 1 || maxdepth > 30)
    return (int)cudaErrorInvalidValue;
  const nrt::LdPostArgs a{C,    K,    dim,  maxdepth, seed,   max_err,
                          has_jitter, jc1, jc2, q,    g,      logp,
                          stds, mean, logdet, step0,  bar,    draws,
                          stats, q_f, g_f,  logp_f,   iters,  work};
  return (int)nrt::with_stream_model(
      model_id, model_ptrs, model_ints, B, [&](auto model) {
        return nrt::ld_launch(
            nrt::ld_posterior_kernel<decltype(model), true, true, true>, a,
            model, C, B,
            4 * (nrt::ld_smem_floats(nrt::LD_POST_NVEC, dim, maxdepth) +
                 model.scratch_floats()),
            (cudaStream_t)stream);
      });
}
