// Fused draw-asynchronous NUTS posterior with the model's data streamed from
// device memory, chains-on-lanes random stream (kernel K1-stream).
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// (:82) with stream= (:115-121,156-165,217-254), launched by nuts_pallas_run
// (:718, pallas_call :863): K draw-asynchronous NUTS draws per chain whose
// every evaluation passes once over likelihood data too large to sit beside
// a chain.  The TPU kernel's logical block of B chains (the JAX runner's
// pick, up to 256: nuts_rs_tpu/chain.py:740-765, the port's
// chain.stream_block) steps in lock step, and every tile it streams serves
// all B chains in two MXU products.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference with
// stream=True.  d, maxdepth, the rows, the tile, the ranges R and the block
// are launch arguments.
//
// What bounds it on this card: the two products of an evaluation,
// 2 B N d multiply-adds for the block (6.7 G at B = 256, N = 131072,
// d = 100), which IEEE f32 without contraction (-fmad=false, so that the
// plain version's bits come out) issues as twice as many instructions; at
// the 128 lanes of 132 SMs that is 0.40 ms a round of evaluations.  The
// tree (a few us a leapfrog and chain) and the 52 MB of x a round (16 us at
// the device's 3.35 TB/s) are small beside it; a design that lets few
// chains share a pass over the data pays the bytes or the L2 traffic many
// times over, and one that leaves SMs idle pays the products' time.
//
// What the design does about it:
//
// 1. The logical block is the JAX runner's, B = min(tier, C) chains, and
//    it is the whole grid of a cooperative launch: one CUDA block of
//    LD_T = 256 threads per chain (the body of K1-args,
//    nuts_fused_ld_posterior.cuh with the cl site index, unchanged in its
//    order of operations), all B resident at once (two an SM:
//    __launch_bounds__(256, 2), so at most 128 registers a thread; the
//    tree's state spills around the data phase, which is where the time
//    is).  The launch checks residency with
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor first and returns
//    cudaErrorCooperativeLaunchTooLarge rather than launch what could not
//    be resident; the wrapper raises on it.  The wrapper's sub-tile S
//    (_build.stream_tiling) keeps a block's shared memory within what each
//    of the ceil(B / SMs) blocks an SM may use, (SM's shared memory) / k
//    minus the card's reservation a block (115,712 bytes at two an SM),
//    which the launch checks too; nrt_stream_resident_blocks lets a
//    sampler check residency before its warmup.  C = m B chains run as m
//    logical blocks one after another in the same launch.
// 2. Every iteration has three phases, with the block's chains in lock
//    step (grid_sync.cuh::GridBlock, the Pallas loop's "any chain of the
//    block still lacks draws" as a flag a chain and a grid barrier): the
//    tree phase, each chain's tree logic and the leapfrog's half steps in
//    its own CUDA block; the data phase, in which every CUDA block walks
//    its ranges of rows for all B chains at once
//    (models.cuh::LogisticRegressionStream: register tiles over x staged in
//    shared memory, each staged x value serving 8 chains and each position
//    value 4 rows, the ranges' partial sums written to a global workspace
//    [R][B][d + 1]); and, after a grid barrier, the reduction, in which
//    each chain adds its R partials in ascending order, then the prior.
//    So one pass over each tile serves every chain of the block, and with
//    B = 256 the rows of a data phase are split over all 132 SMs.  The
//    data phase is a call of its own (not inlined), so that the products'
//    register tiles do not compete with the tree's state for the 128
//    registers; the staged rows come by cp.async.  At B = 256 a group of
//    64 chains takes one pass over a range's rows, so x is read 4 times a
//    round (210 MB, from L2 or device memory), still a small part of it.
// 3. R is the wrapper's (the tiles, at most 256: gaussian.stream_ranges),
//    not the card's, so the plain version repeats the split; the
//    sub-tile S and the chain group CG (_build.stream_tiling) only tile
//    the work and change no bit.
// 4. Sum order (the contract with the plain version, models.cuh): a
//    logit's terms in ascending j; a range's rows in quads of 4, each
//    quad's terms left to right, the quads left to right; the ranges in
//    ascending order; the prior last.
// 5. FP32 on the CUDA cores only, no tensor cores: a TF32 product rounds
//    inside the unit in a way no plain PyTorch version repeats.

#include "grid_sync.cuh"
#include "nuts_fused_ld_posterior.cuh"

namespace {

// The B chains of a logical block as the B CUDA blocks of a cooperative
// grid; the C / B logical blocks one after another.
__global__ void __launch_bounds__(nrt::LD_T, 2)
    stream_posterior_kernel(const nrt::LdPostArgs a,
                            const nrt::LogisticRegressionStream model,
                            unsigned* flags) {
  extern __shared__ float smem[];
  const int B = (int)gridDim.x, b = (int)blockIdx.x;
  for (int pid = 0; pid < a.C / B; ++pid) {
    nrt::GridBlock grp{B, b, pid * B + b, pid, model.bar, flags};
    nrt::ld_posterior_chain<nrt::LogisticRegressionStream, true, true,
                            false>(a, model, grp, smem);
  }
}

// The functor of a launch, after the checks of its sizes: ints are
// (N, d, tile rows, R, S, CG); sync holds the barrier's count and
// generation, then B flags.
cudaError_t stream_model(int model_id, const void* const* ptrs,
                         const int* ints, int d, int B, float* pos,
                         float* part, unsigned* sync,
                         nrt::LogisticRegressionStream* out) {
  using M = nrt::LogisticRegressionStream;
  const int N = ints[0], TR = ints[2], R = ints[3], S = ints[4],
            CG = ints[5];
  const bool pow2_s = S >= 4 && S <= M::MAX_S && (S & (S - 1)) == 0;
  const bool pow2_cg = CG >= 8 && CG <= M::MAX_CG && (CG & (CG - 1)) == 0;
  if (model_id != nrt::MODEL_LOGISTIC_REGRESSION_STREAM || N < 1 ||
      ints[1] != d || d < 1 || TR < 1 || R < 1 || R > (N + TR - 1) / TR ||
      !pow2_s || !pow2_cg || (CG / 8) * ((d + 3) / 4) > nrt::LD_T || B < 1)
    return cudaErrorInvalidValue;
  *out = M{static_cast<const float*>(ptrs[0]),
           static_cast<const float*>(ptrs[1]),
           N, d, TR, R, S, CG, B, pos, part,
           nrt::GridBarrier{sync, sync + 1, (unsigned)B}};
  return cudaSuccess;
}

}  // namespace

// Dynamic shared memory of one chain's CUDA block, in bytes: the mid-d
// posterior layout, then the streamed functor's scratch; -1 for sizes the
// kernel does not take.
extern "C" long long nrt_stream_smem_bytes(int d, int maxdepth, int model_id,
                                           const int* model_ints) {
  const void* no_ptrs[2] = {};
  nrt::LogisticRegressionStream m;
  if (maxdepth < 1 || maxdepth > 30 ||
      stream_model(model_id, no_ptrs, model_ints, d, 1, nullptr, nullptr,
                   nullptr, &m) != cudaSuccess)
    return -1;
  return 4 * (long long)(nrt::ld_smem_floats(nrt::LD_POST_NVEC, d,
                                             maxdepth) +
                         m.scratch_floats());
}

// The card's SMs and how many blocks of the kernel one SM holds at
// `smem` bytes of dynamic shared memory each.
static cudaError_t stream_occupancy(size_t smem, int* sms, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      stream_posterior_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, stream_posterior_kernel, nrt::LD_T, smem);
  return err;
}

// How many blocks of the kernel the card holds at once at `smem` bytes of
// dynamic shared memory each (a logical block of more chains cannot run);
// minus a CUDA error code where the query fails.
extern "C" int nrt_stream_resident_blocks(long long smem) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = stream_occupancy((size_t)smem, &sms, &per_sm);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

extern "C" int nrt_stream_posterior_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed, float max_err,
    int has_jitter, float jc1, float jc2, int model_id,
    const void* const* model_ptrs, const int* model_ints, const float* q,
    const float* g, const float* logp, const float* stds, const float* mean,
    const float* logdet, const float* step0, const float* bar, float* draws,
    float* stats, float* q_f, float* g_f, float* logp_f, int* iters,
    float* work, float* pos, float* part, unsigned* sync, void* stream) {
  nrt::LogisticRegressionStream model;
  cudaError_t err = stream_model(model_id, model_ptrs, model_ints, dim, B,
                                 pos, part, sync, &model);
  if (err != cudaSuccess || C % B != 0 || maxdepth < 1 || maxdepth > 30)
    return (int)cudaErrorInvalidValue;
  const nrt::LdPostArgs a{C,    K,    dim,  maxdepth, seed,   max_err,
                          has_jitter, jc1, jc2, q,    g,      logp,
                          stds, mean, logdet, step0,  bar,    draws,
                          stats, q_f, g_f,  logp_f,   iters,  work};
  const size_t smem =
      4 * (nrt::ld_smem_floats(nrt::LD_POST_NVEC, dim, maxdepth) +
           model.scratch_floats());
  // every chain of a block must be resident at once: ceil(B / SMs) blocks
  // an SM, each within its share of the SM's shared memory
  // (_build.stream_block_smem_limit), and as many as the occupancy allows
  int sms = 0, per_sm = 0, sm_smem = 0, reserved = 0, device = 0;
  err = stream_occupancy(smem, &sms, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err != cudaSuccess) return (int)err;
  const int k = (B + sms - 1) / sms;
  if ((long long)per_sm * sms < B ||
      (long long)smem > (long long)(sm_smem / k - reserved))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B);
  cfg.blockDim = dim3(nrt::LD_T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stream_posterior_kernel, a, model,
                           sync + 2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
