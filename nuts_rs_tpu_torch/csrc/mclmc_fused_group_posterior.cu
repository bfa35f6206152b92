// Fused draw-asynchronous MCLMC posterior for the logistic regression, G
// chains a CUDA block: the group form of kernel K3-args.
//
// Replaces the TPU kernel
// nuts_rs_tpu/kernels/mclmc_pallas.py::make_mclmc_kernel (:59) with
// n_model_args > 0 (:61,82-85,124), launched by mclmc_pallas_run (:372;
// model_args :389,409-412,436-449), for the Bernoulli GLM
// (models/gaussian.py:171-180) under the microcanonical dynamics: K
// draw-asynchronous MCLMC draws per chain, two [N, d] x [d] products,
// logaddexp and a sigmoid per chain and leapfrog.  Plain PyTorch version:
// nuts_rs_tpu_torch/kernels/mclmc_fused.py::mclmc_fused_run_reference on a
// model the mid-d kernels serve (nuts_fused.cl_kernel).  The other functors,
// and the Euclidean dynamics, take the 256-threads-a-chain form of K3-args
// (mclmc_fused_mid_posterior.cu): _build.MCLMC_MID_FORMS holds the choice
// and the measurement behind it.  d, the constants of the dynamics and the
// data sizes are launch arguments.
//
// What bounds it on this card.  The evaluation's two products, as in
// K1-args.  The TPU kernel evaluates logp_grad_batched over its whole lane
// block of chains (mclmc_pallas.py:124), so one read of the data serves the
// block; a CUDA block that serves one chain rereads all of x (400 KB at
// N = 1000, d = 100) twice a leapfrog through L2, and the evaluation is then
// seven eighths of an iteration.  Around it, a microcanonical iteration is a
// chain of 8 dependent sums over d.
//
// What was chosen, and why:
//
// 1. Chains a block.  A CUDA block of LD_T = 256 threads serves G <= 8
//    chains, chain cb's trajectory on warp cb (mclmc_step_group.cuh): lane
//    l owns the coordinates j = l (mod 32) of the chain's 15 live vectors in
//    dynamic shared memory and stands for tsum's virtual threads l + 32 w,
//    so the bits are those of the plain version.  G is the most chains, a
//    power of two, whose vectors, the group form's scratch and the parked
//    scalars fit a block's opt-in shared memory (_build.mclmc_mid_group;
//    mg_chains here, checked at launch): 8 at d = 100, so 1024 chains are
//    128 blocks, one wave on 132 SMs.  No checkpoint stacks, so no global
//    workspace.
// 2. Sums.  A sum over d is one warp's: the 8 slots' butterflies at once and
//    three halvings across lanes (lane_sums), 12 shuffles and no barrier, in
//    ops.tsum's order; the 256-threads-a-chain form spends a block barrier
//    on each.
// 3. The model.  The regression's group form (models.cuh::
//    LogisticRegression::eval_group) is evaluated by all 256 threads for the
//    G chains between two block barriers, one load of x serving every chain
//    (a register tile of 4 rows x 8 chains), with the chains' scalars parked
//    in shared memory around it so that its tiles have the registers.  Every
//    iteration of every chain is one leapfrog try and one evaluation, so the
//    G chains of a block need the model at the same point of their
//    iteration; a chain that has its draws leaves its staged position as it
//    was, and its results are not read.
// 4. Random stream and chain blocks.  A logical chain block of B <= 8 chains
//    (the Pallas lane block, default 1; B divides G, so it never spans CUDA
//    blocks, and no thread block cluster is needed) shares the seed
//    seed + 0x51ED2701 * (c / B) and numbers a vector site j * B + b.  The
//    Pallas loop runs until every chain of the block has K draws, chains
//    past K keep iterating (new draws, nothing emitted), and the final
//    q / g / logp / v are each chain's state at the block's last iteration.
//    The chains of a CUDA block iterate in step (one block iteration, one
//    try of every chain that still iterates), so a chain stops at the first
//    iteration at which every chain of its logical block has K draws: at
//    B = 1 at its own K-th draw; at B > 1 the warps tell each other between
//    iterations (one barrier).
// 5. Draws are written coalesced along d, [K, C, d], so the trace needs no
//    transpose.  No atomics, no tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mclmc_step_group.cuh"
#include "models.cuh"

namespace nrt {

struct McGroupPostArgs {
  int C, K, d;
  int H;  // the halving stack's depth (0: no dynamic step size)
  uint32_t seed;
  McConst k;
  int has_jitter;
  float jc1, jc2;  // jitter factor = jc1 + jc2 * u
  const float *q, *g, *logp, *v, *stds, *mean, *logdet, *step0, *bar;
  float *draws, *stats, *q_f, *g_f, *logp_f, *v_f;
  int* iters;
};

// A chain's loop-carried scalars and its vectors' base pointer, which wait
// in shared memory while the block evaluates the regression's group form.
struct MgPostParked {
  MgChain ch;
  MgTraj s;
  MgHalf h;
  float step, e_init, lpi, ld, bar;
  int nsd, dc;
  uint32_t it;
};
static_assert(sizeof(MgPostParked) <= 4 * GR_SCALAR_FLOATS,
              "a chain's slot of parked scalars");

__global__ void __launch_bounds__(LD_T, 1)
    mclmc_group_posterior_kernel(const McGroupPostArgs a,
                                 const LogisticRegression model, int B,
                                 int G) {
  extern __shared__ float4 mg_smem[];  // 16-byte aligned
  const MgBlock blk = mg_block(reinterpret_cast<float*>(mg_smem), model, G);
  const int lane = gr_lane(), cb = threadIdx.x >> 5;
  const int C = a.C, K = a.K, d = a.d;
  const int c = blockIdx.x * G + cb;
  const bool present = cb < G && c < C;
  const int b = c % B;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)(c / B);
  const McConst& k = a.k;
  MgPostParked* parked = reinterpret_cast<MgPostParked*>(blk.parked);
  MgChain ch{blk.chains + (size_t)cb * mg_chain_floats(d), d};
  // the staged positions of absent chains stay 0.0: finite logits
  for (int j = threadIdx.x; j < GR_MAX * d; j += LD_T) blk.gs[j] = 0.0f;

  MgTraj s;
  s.logp = s.ke = 0.0f;
  float ld = 0.0f, bar = 0.0f, step = 0.0f, e_init = 0.0f, lpi = 0.0f;
  int nsd = 1, dc = 0;
  if (present) {
    ld = a.logdet[c];
    bar = a.bar[c];
    step = a.step0[c];
    s.logp = a.logp[c];
    for (int j = lane; j < d; j += 32) {
      const size_t gj = (size_t)c * d + j;
      const float sd = a.stds[gj], mn = a.mean[gj];
      const float z0 = (a.q[gj] - mn) / sd;
      const float zg0 = a.g[gj] * sd;
      ch.stds()[j] = sd;
      ch.mean()[j] = mn;
      ch.z()[j] = ch.z0()[j] = z0;
      ch.zg()[j] = ch.zg0()[j] = zg0;
      ch.v()[j] = a.v[gj];
      ch.noise()[j] = normal(seed, 0u, 1u, 2u, mg_site(j, b, B));
    }
    s.ke = 0.0f;
    nsd = mg_num_steps(step, k);
    mg_start(s, nsd);
    e_init = s.ke - (s.logp + ld);
    lpi = s.logp;  // with z0 / zg0 the give-up target (mclmc.rs:361-384)
  }

  bool run = present;
  uint32_t it = 1;
  MgHalf h{0.0f, 0.0f};
  while (true) {
    if (run) h = mg_leap_first(ch, s, model, blk.gs, cb, step, ld, k);
    // every warp parks and reloads, so that no path keeps them live
    if (lane == 0) {
      MgPostParked& p = parked[cb];
      p.ch = ch, p.s = s, p.h = h, p.step = step, p.e_init = e_init;
      p.lpi = lpi, p.ld = ld, p.bar = bar, p.nsd = nsd, p.dc = dc;
      p.it = it;
    }
    // the staged positions (and the parked scalars) are whole
    if (!__syncthreads_or(run)) break;
#ifndef NRT_ABLATE_EVAL
    model.eval_group(G, blk.gs);
#else
    __syncthreads();
#endif
    {
      const MgPostParked& p = parked[cb];
      ch = p.ch, s = p.s, h = p.h, step = p.step, e_init = p.e_init;
      lpi = p.lpi, ld = p.ld, bar = p.bar, nsd = p.nsd, dc = p.dc;
      it = p.it;
    }
    __syncwarp();  // every lane has its scalars before lane 0 parks again
    if (run) {
      const int r = mg_leap_second(a.H, ch, s, h, model, blk.gs, G, cb, step,
                                   nsd, ld, k, seed, it, 3u, b, B);
      if (r != MC_CONTINUE) {
        // energy_change uses the loop-exit point, as mclmc_draw does
        const float e_change = (s.ke - (s.logp + ld)) - e_init;
        if (r == MC_GAVE_UP) {
          // the draw start with fresh momentum; the next noise as on success
          mg_give_up_momentum(ch, seed, it, 7u, b, B);
          for (int j = lane; j < d; j += 32) {
            ch.z()[j] = ch.z0()[j];
            ch.zg()[j] = ch.zg0()[j];
            ch.noise()[j] = normal(seed, it, 5u, 6u, mg_site(j, b, B));
          }
          s.logp = lpi;
        }
        // the microcanonical draw emits its kinetic energy, 0 on a give-up
        const float em_ke = r == MC_GAVE_UP ? 0.0f : s.ke;
        if (dc < K) {
          float* out = a.draws + ((size_t)dc * C + c) * d;
          float fs[1];
          lane_sums(d, [&](int j, float (&t)[1]) {
            const float e = ch.z()[j] + ch.zg()[j];
            t[0] = e * e;
            out[j] = ch.z()[j] * ch.stds()[j] + ch.mean()[j];
          }, fs);
          if (lane == 0) {
            const float row[NSTATS_M] = {
                r == MC_GAVE_UP ? 1.0f : 0.0f, (float)s.steps, e_change,
                s.ttime / (float)max(s.steps, 1), step, s.logp,
                em_ke - (s.logp + ld), fs[0]};
            float* st = a.stats + ((size_t)dc * C + c) * NSTATS_M;
#pragma unroll
            for (int i = 0; i < NSTATS_M; ++i) st[i] = row[i];
          }
        }
        // the next draw starts at the emitted point
        s.ke = 0.0f;
        e_init = s.ke - (s.logp + ld);
        step = a.has_jitter ? bar * (a.jc1 + a.jc2 * uniform(seed, it, 9u,
                                                             (uint32_t)b))
                            : bar;
        nsd = mg_num_steps(step, k);
        mg_start(s, nsd);
        for (int j = lane; j < d; j += 32) {
          ch.z0()[j] = ch.z()[j];
          ch.zg0()[j] = ch.zg()[j];
        }
        lpi = s.logp;
        dc += 1;
      }
      it += 1;
    }
    // a chain iterates on while a chain of its logical block lacks draws
    // (every thread takes the barrier of mg_block_any)
    const bool more =
        B > 1 ? mg_block_any(blk.flag, cb, G, B, run && dc < K) : dc < K;
    run = run && more;
  }

  if (present) {
    for (int j = lane; j < d; j += 32) {
      const size_t gj = (size_t)c * d + j;
      a.q_f[gj] = ch.z()[j] * ch.stds()[j] + ch.mean()[j];
      a.g_f[gj] = ch.zg()[j] / ch.stds()[j];
      a.v_f[gj] = ch.v()[j];
    }
    if (lane == 0) {
      a.logp_f[c] = s.logp;
      a.iters[c] = (int)it;
    }
  }
}

}  // namespace nrt

// Shared memory of a block of G chains of the group-form MCLMC kernels (both
// lay it out alike) for the regression with `model_ints` (N, d), in bytes.
extern "C" long long nrt_mclmc_group_bytes(int d, const int* model_ints,
                                           int G) {
  return nrt::mg_block_bytes(nrt::group_model(model_ints), d, G);
}

// The rule's G (nrt::mg_chains).
extern "C" int nrt_mclmc_group(int d, const int* model_ints) {
  return nrt::mg_chains(nrt::group_model(model_ints), d);
}

// Blocks one SM holds of the posterior kernel at `smem` bytes (minus a CUDA
// error code where the query fails).
extern "C" int nrt_mclmc_group_posterior_blocks_per_sm(long long smem) {
  return nrt::blocks_per_sm(nrt::mclmc_group_posterior_kernel, smem);
}

extern "C" int nrt_mclmc_group_posterior_launch(
    int dim, int dynamic, int C, int B, int G, int K, uint32_t seed,
    float max_err, float ell, float fsub_ell, float sqrt_n, int has_jitter,
    float jc1, float jc2, const void* const* model_ptrs,
    const int* model_ints, const float* q, const float* g, const float* logp,
    const float* v, const float* stds, const float* mean, const float* logdet,
    const float* step0, const float* bar, float* draws, float* stats,
    float* q_f, float* g_f, float* logp_f, float* v_f, int* iters,
    void* stream) {
  const nrt::LogisticRegression model =
      nrt::group_model(model_ints, model_ptrs);
  if (C % B != 0 || dim < 1 || K < 1 || model.d != dim ||
      !nrt::mg_valid(model, dim, B, G))
    return (int)cudaErrorInvalidValue;
  const nrt::McGroupPostArgs a{C,    K,      dim,
                               dynamic ? nrt::MAX_HALVINGS : 0,
                               seed, {max_err, ell, fsub_ell, sqrt_n},
                               has_jitter, jc1, jc2, q,      g,      logp,
                               v,    stds,   mean,   logdet, step0,  bar,
                               draws, stats, q_f,    g_f,    logp_f, v_f,
                               iters};
  return (int)nrt::gr_launch(nrt::mclmc_group_posterior_kernel, a, model, C,
                             B, G, nrt::mg_block_bytes(model, dim, G),
                             (cudaStream_t)stream);
}
