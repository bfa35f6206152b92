// Fused draw-asynchronous NUTS posterior (kernel K1).
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// (:82), launched by nuts_pallas_run (:718, pallas_call :863), in the
// chains-on-lanes layout with the plain diagonal evaluation.  Plain PyTorch
// version: nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference.
//
// What bounds it on this card: latency-bound scalar work per chain: a
// leapfrog with the model functor, the U-turn ladder over up to maxdepth
// rows of dot products, and the bookkeeping, with the four (D+1) x d
// checkpoint stacks.  There is no data reuse across chains and next to no
// device-memory traffic: draws and stats are written once per finished draw.
//
// What the design does about it: a chain's coordinates lie on a group of
// T = 4 lanes (nuts_tree.cuh::nuts_lanes), so every step on one coordinate
// runs on its own lane: the leapfrog's updates, the model's term, the
// stack-row writes and select copies, the fresh momentum's Box-Muller
// normals at site j * B + b, the draw's stores.  Every sum over d (ke, d1,
// the U-turn dots, fisher) is lanes.cuh's ordered gather, added in
// coordinate order on every lane, so the bits are the one-thread sums'; a
// level's independent gathers are issued together.  The scalars (uniforms,
// energies, the multinomial weights, the tree's bookkeeping) are computed
// alike on every lane of a group; a block of 32 chains is 4 warps, one on
// each of its SM's schedulers.  A logical chain block of B chains is one
// CUDA block of B * T threads, so the loop condition is a __syncthreads_or
// and the random sites keep the Pallas block layout.  Each lane indexes its
// own stack rows directly (the Pallas body needed one-hot masked writes and
// masked-sum gathers), evaluates only the active U-turn levels and the top
// checks only at a merge, and draws the fresh momentum only when its tree
// finished (the counter hash makes skipping unused draws free of side
// effects).  Sizes and lanes are template parameters so loops over a
// lane's slots unroll.

// Semantics kept from the Pallas kernel: a finished tree restarts in the
// same iteration; the block loops until every chain has K draws, chains
// past K keep iterating and emit nothing; final q/g/logp are each chain's
// selected point at the block's last iteration; iters is the block's count.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lanes.cuh"
#include "models.cuh"
#include "nuts_tree.cuh"
#include "rng.cuh"
#include "nrt_sizes.h"  // NRT_FOR_EACH_SIZE(X), generated by _build.py

namespace nrt {

struct PostArgs {
  int C, K;
  uint32_t seed;
  float max_err;
  int has_jitter;
  float jc1, jc2;  // jitter factor = jc1 + jc2 * u
  const float *q, *g, *logp, *stds, *mean, *logdet, *step0, *bar;
  float *draws, *stats, *q_f, *g_f, *logp_f;
  int* iters;
};

template <int DIM, int D, int T, bool SMEM, class Model>
__global__ void __launch_bounds__(nuts_block_threads(T))
    posterior_kernel(const PostArgs a, const Model model) {
  constexpr int NC = slots<DIM, T>();
  const Lane<T> ln;
  const int B = blockDim.x / T;
  const int b = threadIdx.x / T;
  const int pid = blockIdx.x;
  const int c = pid * B + b;
  const int C = a.C;
  const int K = a.K;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)pid;

  float stds[NC], mean[NC];
  float e_z[NC], e_v[NC], e_zg[NC];
  float m_z[NC], m_v[NC], m_zg[NC];
  float p_z[NC], p_v[NC], p_zg[NC];
  float dm_z[NC], dm_zg[NC], dm_q[NC];
  float ds_z[NC], ds_zg[NC], ds_q[NC];
  LaneStacks<NC, D, SMEM> st;
  if constexpr (SMEM) {
    extern __shared__ float stack_smem[];
    st.base = stack_smem + threadIdx.x;
    st.stride = blockDim.x;
  }
  float bl[D + 1], bm[D + 1];

  const float logdet = a.logdet[c];
  const float bar = a.bar[c];
  float step = a.step0[c];
  const float logp0 = a.logp[c];
  nuts_lane_normals<DIM, T>(e_v, seed, 0u, 1u, 2u, b, B, ln);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int j = ln.lane + T * i;
    const bool own = j < DIM;
    stds[i] = own ? a.stds[c * DIM + j] : 1.0f;
    mean[i] = own ? a.mean[c * DIM + j] : 0.0f;
    const float q0 = own ? a.q[c * DIM + j] : 0.0f;
    const float z0 = (q0 - mean[i]) / stds[i];
    const float zg0 = (own ? a.g[c * DIM + j] : 0.0f) * stds[i];
    e_z[i] = m_z[i] = p_z[i] = dm_z[i] = ds_z[i] = z0;
    e_zg[i] = m_zg[i] = p_zg[i] = dm_zg[i] = ds_zg[i] = zg0;
    m_v[i] = p_v[i] = e_v[i];
    dm_q[i] = ds_q[i] = q0;
  }
  for (int r = 0; r <= D; ++r) {
    bl[r] = bm[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int p = 0; p < NSTACKS; ++p) st.at(p, r, i) = 0.0f;
  }
  const float ke0 = 0.5f * ordered_dot<DIM, T>(e_v, e_v, ln);
  float e_init = ke0 - (logp0 + logdet);
  int dc = 0;
  int e_idx = 0, m_idx = 0, p_idx = 0, dm_idx = 0, ds_idx = 0;
  float dm_logp = logp0, dm_ke = ke0, ds_logp = logp0, ds_ke = ke0;
  float logw_m = 0.0f, logw_s = -INFINITY;
  int depth = 0, leaf = 0, n_steps = 0;
  float s_acc = 0.0f, s_sym = 0.0f, mx_err = 0.0f;
  float direction = uniform(seed, 0u, 3u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;

  uint32_t it = 1;
  while (__syncthreads_or(dc < K)) {
    // the iteration's uniforms' logs first, beside the leapfrog (the counter
    // hash makes a draw that goes unused free of side effects)
    const float log_r_sel = logf(uniform(seed, it, 4u, (uint32_t)b));
    const float log_r_acc = logf(uniform(seed, it, 5u, (uint32_t)b));
    const float dirf = direction;
    const float eps = dirf * step;
    const float half = eps / 2.0f;

    // ---- leapfrog, each lane on its own coordinates ----
    float v1[NC], z1[NC], q1[NC], zg1[NC], v2[NC], sq[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      v1[i] = e_v[i] + half * e_zg[i];
      z1[i] = e_z[i] + eps * v1[i];
      q1[i] = z1[i] * stds[i] + mean[i];
      sq[i] = model.term(q1[i], zg1[i]);
      zg1[i] = zg1[i] * stds[i];
      v2[i] = v1[i] + half * zg1[i];
    }
    const float logp1 = model.finish(ordered_sum<DIM, T>(sq, ln));
    const float ke1 = 0.5f * ordered_dot<DIM, T>(v2, v2, ln);
    const float d1 = ordered_dot<DIM, T>(z1, v2, ln);
    const float err = (ke1 - (logp1 + logdet)) - e_init;
    const bool diverged = (err > a.max_err) || !isfinite(err);
    const int idx1 = e_idx + (int)dirf;

    // ---- accept stats ----
    const float diff = -err;
    const float acc = expf(min0(diff));
    n_steps += 1;
    s_acc = s_acc + (diverged ? 0.0f : acc);
    s_sym = s_sym + (diverged ? 0.0f : 2.0f * acc / (1.0f + expf(diff)));
    mx_err = diverged ? -INFINITY
                      : (fabsf(diff) > fabsf(mx_err) ? diff : mx_err);

    // ---- progressive multinomial within the subtree ----
    const float logw_leaf = -err;
    const bool first = leaf == 0;
    logw_s = first ? logw_leaf : logaddexp(logw_s, logw_leaf);
    if (first || (log_r_sel < logw_leaf - logw_s)) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        ds_z[i] = z1[i];
        ds_zg[i] = zg1[i];
        ds_q[i] = q1[i];
      }
      ds_logp = logp1;
      ds_ke = ke1;
      ds_idx = idx1;
    }

    // ---- checkpoint stacks and U-turn checks ----
    const int row_l = min(tz(leaf, D), D);
    const int tzn = tz(leaf + 1, D);
    const int row_m = min(tzn + 1, D);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      st.at(ST_LZ, row_l, i) = z1[i];
      st.at(ST_LV, row_l, i) = v2[i];
      st.at(ST_MZ, row_m, i) = z1[i];
      st.at(ST_MV, row_m, i) = v2[i];
    }
    bl[row_l] = d1;
    bm[row_m] = d1;
    const bool turning_int = uturn_internal_lanes<DIM, D, T>(
        leaf, tzn, dirf, z1, v2, d1, st, bl, bm, ln);

    // ---- top-level merge (biased acceptance) ----
    const bool subtree_done = (leaf + 1) == (1 << depth);
    const bool do_merge = subtree_done && !diverged && !turning_int;
    const bool fwd = dirf > 0.0f;
    bool turning_top = false;
    if (do_merge) {
      // the top checks see the ends before the merge; only a merge reads
      // them
      float far_z[NC], far_v[NC], near_z[NC], near_v[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        far_z[i] = fwd ? m_z[i] : p_z[i];
        far_v[i] = fwd ? m_v[i] : p_v[i];
        near_z[i] = fwd ? p_z[i] : m_z[i];
        near_v[i] = fwd ? p_v[i] : m_v[i];
      }
      turning_top = uturn_top_lanes<DIM, D, T>(depth, dirf, z1, v2, d1, far_z,
                                               far_v, near_z, near_v, st,
                                               bl[D], ln);
      if ((logw_s >= logw_m) || (log_r_acc < logw_s - logw_m)) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          dm_z[i] = ds_z[i];
          dm_zg[i] = ds_zg[i];
          dm_q[i] = ds_q[i];
        }
        dm_logp = ds_logp;
        dm_ke = ds_ke;
        dm_idx = ds_idx;
      }
      logw_m = logaddexp(logw_m, logw_s);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (fwd) {
          p_z[i] = z1[i];
          p_v[i] = v2[i];
          p_zg[i] = zg1[i];
        } else {
          m_z[i] = z1[i];
          m_v[i] = v2[i];
          m_zg[i] = zg1[i];
        }
      }
      if (fwd)
        p_idx = idx1;
      else
        m_idx = idx1;
      depth += 1;
    }
    const bool turned = turning_int || turning_top;
    const bool fin = diverged || turned || depth >= D;

    // ---- emit the draw where the tree finished ----
    if (fin && dc < K) {
      const float energy_m = dm_ke - (dm_logp + logdet);
      float e[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        e[i] = dm_z[i] + dm_zg[i];
        const int j = ln.lane + T * i;
        if (j < DIM) a.draws[((size_t)dc * DIM + j) * C + c] = dm_q[i];
      }
      const float fisher = ordered_dot<DIM, T>(e, e, ln);
      const float row[NSTATS] = {
          (float)depth, diverged ? 1.0f : 0.0f, (float)n_steps, s_acc, s_sym,
          mx_err, dm_logp, energy_m, energy_m - e_init, (float)dm_idx, fisher,
          step, (depth >= D && !turned && !diverged) ? 1.0f : 0.0f};
#pragma unroll
      for (int s = 0; s < NSTATS; ++s)
        if (s % T == ln.lane)
          a.stats[((size_t)dc * NSTATS + s) * C + c] = row[s];
    }

    // ---- next state: fresh draw / new doubling / same subtree ----
    const float new_dir =
        uniform(seed, it, 6u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;
    const bool new_doub = do_merge && !fin;
    if (fin) {
      float v_new[NC];
      nuts_lane_normals<DIM, T>(v_new, seed, it, 7u, 8u, b, B, ln);
      const float ke_new = 0.5f * ordered_dot<DIM, T>(v_new, v_new, ln);
      if (a.has_jitter)
        step = bar * (a.jc1 + a.jc2 * uniform(seed, it, 9u, (uint32_t)b));
      else
        step = bar;
      e_init = ke_new - (dm_logp + logdet);
      dc += 1;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        e_z[i] = m_z[i] = p_z[i] = dm_z[i];
        e_v[i] = m_v[i] = p_v[i] = v_new[i];
        e_zg[i] = m_zg[i] = p_zg[i] = dm_zg[i];
      }
      e_idx = m_idx = p_idx = dm_idx = 0;
      dm_ke = ke_new;
      logw_m = 0.0f;
      depth = 0;
      n_steps = 0;
      s_acc = s_sym = mx_err = 0.0f;
    } else if (new_doub) {
      const bool jump_p = new_dir > 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        e_z[i] = jump_p ? p_z[i] : m_z[i];
        e_v[i] = jump_p ? p_v[i] : m_v[i];
        e_zg[i] = jump_p ? p_zg[i] : m_zg[i];
      }
      e_idx = jump_p ? p_idx : m_idx;
    } else {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        e_z[i] = z1[i];
        e_v[i] = v2[i];
        e_zg[i] = zg1[i];
      }
      e_idx = idx1;
    }
    if (fin || new_doub) {
      leaf = 0;
      direction = new_dir;
    } else {
      leaf += 1;
    }
    it += 1;
  }

#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int j = ln.lane + T * i;
    if (j < DIM) {
      a.q_f[c * DIM + j] = dm_q[i];
      a.g_f[c * DIM + j] = dm_zg[i] / stds[i];
    }
  }
  if (ln.lane == 0) {
    a.logp_f[c] = dm_logp;
    a.iters[c] = (int)it;
  }
}

template <int DIM, int D, int T, bool SMEM>
cudaError_t launch_posterior(const PostArgs& a, int B, int model_id,
                             const float* params, cudaStream_t stream) {
  if (model_id != MODEL_IID_NORMAL) return cudaErrorInvalidValue;
  auto kernel = posterior_kernel<DIM, D, T, SMEM, IidNormal>;
  const size_t smem = SMEM ? stack_smem_bytes<DIM, D, T>(B) : 0;
  if (SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.C / B, B * T, smem, stream>>>(a, IidNormal{params[0]});
  return cudaGetLastError();
}

// The instantiation of (DIM, D, T); an error for lanes the rule never gives
// at DIM (none is built).
template <int DIM, int D, int T>
cudaError_t launch_posterior_lanes(const PostArgs& a, int B, int model_id,
                                   const float* params, cudaStream_t stream) {
  if constexpr (nuts_lanes_taken(DIM, T)) {
#ifdef NRT_NUTS_SMEM_STACKS
    return launch_posterior<DIM, D, T, true>(a, B, model_id, params, stream);
#else
    return launch_posterior<DIM, D, T, false>(a, B, model_id, params, stream);
#endif
  }
  return cudaErrorInvalidValue;
}

}  // namespace nrt

// The lanes K1 / K2 take for d and B (nuts_lanes), for the wrapper to check
// its own rule against.
extern "C" int nrt_nuts_lanes(int dim, int B) {
  return nrt::nuts_lanes(dim, B);
}

// lanes: the chain's lanes the caller's rule gives (_build.nuts_lanes); a
// launch whose shapes the C rule gives other lanes is refused.
extern "C" int nrt_posterior_launch(
    int dim, int maxdepth, int lanes, int C, int B, int K, uint32_t seed,
    float max_err, int has_jitter, float jc1, float jc2, int model_id,
    const float* model_params, const float* q, const float* g,
    const float* logp, const float* stds, const float* mean,
    const float* logdet, const float* step0, const float* bar, float* draws,
    float* stats, float* q_f, float* g_f, float* logp_f, int* iters,
    void* stream) {
  if (B < 1 || B > nrt::MAX_BLOCK || C % B != 0 ||
      lanes != nrt::nuts_lanes(dim, B) ||
      B * lanes > nrt::nuts_block_threads(lanes))
    return (int)cudaErrorInvalidValue;
  const nrt::PostArgs a{C,    K,     seed,  max_err, has_jitter, jc1,
                        jc2,  q,     g,     logp,    stds,       mean,
                        logdet, step0, bar, draws,   stats,      q_f,
                        g_f,  logp_f, iters};
  cudaStream_t s = (cudaStream_t)stream;
#define NRT_LANES(DIM_, D_, T_)                                            \
  if (lanes == T_)                                                         \
    return (int)nrt::launch_posterior_lanes<DIM_, D_, T_>(                 \
        a, B, model_id, model_params, s);
#define NRT_CASE(DIM_, D_)                                                 \
  if (dim == DIM_ && maxdepth == D_) {                                     \
    NRT_LANES(DIM_, D_, 1)                                                 \
    NRT_LANES(DIM_, D_, 2)                                                 \
    NRT_LANES(DIM_, D_, 4)                                                 \
    NRT_LANES(DIM_, D_, 8)                                                 \
    NRT_LANES(DIM_, D_, 16)                                                \
  }
  NRT_FOR_EACH_SIZE(NRT_CASE)
#undef NRT_CASE
#undef NRT_LANES
  return (int)cudaErrorInvalidValue;
}
