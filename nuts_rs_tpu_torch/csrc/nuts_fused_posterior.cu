// Fused draw-asynchronous NUTS posterior (kernel K1).
//
// Replaces the TPU kernel nuts_rs_tpu/kernels/nuts_pallas.py::make_kernel
// (:82), launched by nuts_pallas_run (:718, pallas_call :863), in the
// chains-on-lanes layout with the plain diagonal evaluation.  Plain PyTorch
// version: nuts_rs_tpu_torch/kernels/nuts_fused.py::nuts_fused_run_reference.
//
// What bounds it on this card: latency-bound scalar work per thread.  One
// thread runs one chain's whole tree: a leapfrog with the model functor, the
// U-turn ladder over up to maxdepth rows of dot products, and the
// bookkeeping, with the four (D+1) x d checkpoint stacks in local memory
// (about 2.7 KB per chain at d=10, maxdepth 10).  There is no data reuse
// across threads and next to no device-memory traffic: draws and stats are
// written once per finished draw.
//
// What the design does about it: one CUDA block per logical chain block of
// B chains (B = 32, one warp, by default), so the loop condition is a cheap
// __syncthreads_or and the random sites keep the Pallas block layout.  Each
// thread indexes its own stacks directly (the Pallas body needed one-hot
// masked writes and masked-sum gathers), evaluates only the active U-turn
// levels, and draws the fresh momentum only when its tree finished (the
// counter hash makes skipping unused draws free of side effects).  Sizes are
// template parameters so loops over d unroll.  Occupancy is low at 1024
// chains (32 blocks on 132 SMs); raising it is later work.
//
// Semantics kept from the Pallas kernel: a finished tree restarts in the
// same iteration; the block loops until every chain has K draws, chains
// past K keep iterating and emit nothing; final q/g/logp are each chain's
// selected point at the block's last iteration; iters is the block's count.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int DIM, int D, class Model>
__global__ void __launch_bounds__(MAX_BLOCK)
    posterior_kernel(const PostArgs a, const Model model) {
  const int B = blockDim.x;
  const int b = threadIdx.x;
  const int pid = blockIdx.x;
  const int c = pid * B + b;
  const int C = a.C;
  const int K = a.K;
  const uint32_t seed = a.seed + 0x51ED2701u * (uint32_t)pid;

  float stds[DIM], mean[DIM];
  float e_z[DIM], e_v[DIM], e_zg[DIM];
  float m_z[DIM], m_v[DIM], m_zg[DIM];
  float p_z[DIM], p_v[DIM], p_zg[DIM];
  float dm_z[DIM], dm_zg[DIM], dm_q[DIM];
  float ds_z[DIM], ds_zg[DIM], ds_q[DIM];
  float lz[D + 1][DIM], lv[D + 1][DIM], mz[D + 1][DIM], mv[D + 1][DIM];
  float bl[D + 1], bm[D + 1];

  const float logdet = a.logdet[c];
  const float bar = a.bar[c];
  float step = a.step0[c];
  const float logp0 = a.logp[c];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    stds[j] = a.stds[c * DIM + j];
    mean[j] = a.mean[c * DIM + j];
    const float q0 = a.q[c * DIM + j];
    const float z0 = (q0 - mean[j]) / stds[j];
    const float zg0 = a.g[c * DIM + j] * stds[j];
    const float v0 = normal(seed, 0u, 1u, 2u, (uint32_t)(j * B + b));
    e_z[j] = m_z[j] = p_z[j] = dm_z[j] = ds_z[j] = z0;
    e_zg[j] = m_zg[j] = p_zg[j] = dm_zg[j] = ds_zg[j] = zg0;
    e_v[j] = m_v[j] = p_v[j] = v0;
    dm_q[j] = ds_q[j] = q0;
  }
  for (int r = 0; r <= D; ++r) {
    bl[r] = bm[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < DIM; ++j) lz[r][j] = lv[r][j] = mz[r][j] = mv[r][j] = 0.0f;
  }
  const float ke0 = 0.5f * dot<DIM>(e_v, e_v);
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
    const float r_sel = uniform(seed, it, 4u, (uint32_t)b);
    const float r_acc = uniform(seed, it, 5u, (uint32_t)b);
    const float dirf = direction;
    const float eps = dirf * step;
    const float half = eps / 2.0f;

    // ---- leapfrog ----
    float v1[DIM], z1[DIM], q1[DIM], zg1[DIM], v2[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      v1[j] = e_v[j] + half * e_zg[j];
      z1[j] = e_z[j] + eps * v1[j];
      q1[j] = z1[j] * stds[j] + mean[j];
    }
    const float logp1 = model.template eval<DIM>(q1, zg1);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      zg1[j] = zg1[j] * stds[j];
      v2[j] = v1[j] + half * zg1[j];
    }
    const float ke1 = 0.5f * dot<DIM>(v2, v2);
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
    if (first || (logf(r_sel) < logw_leaf - logw_s)) {
      copy<DIM>(ds_z, z1);
      copy<DIM>(ds_zg, zg1);
      copy<DIM>(ds_q, q1);
      ds_logp = logp1;
      ds_ke = ke1;
      ds_idx = idx1;
    }

    // ---- checkpoint stacks and U-turn checks ----
    const float d1 = dot<DIM>(z1, v2);
    const int row_l = min(tz(leaf, D), D);
    const int tzn = tz(leaf + 1, D);
    const int row_m = min(tzn + 1, D);
    copy<DIM>(lz[row_l], z1);
    copy<DIM>(lv[row_l], v2);
    bl[row_l] = d1;
    copy<DIM>(mz[row_m], z1);
    copy<DIM>(mv[row_m], v2);
    bm[row_m] = d1;
    const bool turning_int = uturn_internal<DIM, D>(leaf, tzn, dirf, z1, v2,
                                                    d1, lz, lv, bl, mz, mv, bm);
    const bool fwd = dirf > 0.0f;
    const bool turning_top = uturn_top<DIM>(
        depth, dirf, z1, v2, d1, fwd ? m_z : p_z, fwd ? m_v : p_v,
        fwd ? p_z : m_z, fwd ? p_v : m_v, lz[D], lv[D], bl[D]);

    // ---- top-level merge (biased acceptance) ----
    const bool subtree_done = (leaf + 1) == (1 << depth);
    const bool do_merge = subtree_done && !diverged && !turning_int;
    if (do_merge) {
      if ((logw_s >= logw_m) || (logf(r_acc) < logw_s - logw_m)) {
        copy<DIM>(dm_z, ds_z);
        copy<DIM>(dm_zg, ds_zg);
        copy<DIM>(dm_q, ds_q);
        dm_logp = ds_logp;
        dm_ke = ds_ke;
        dm_idx = ds_idx;
      }
      logw_m = logaddexp(logw_m, logw_s);
      if (fwd) {
        copy<DIM>(p_z, z1);
        copy<DIM>(p_v, v2);
        copy<DIM>(p_zg, zg1);
        p_idx = idx1;
      } else {
        copy<DIM>(m_z, z1);
        copy<DIM>(m_v, v2);
        copy<DIM>(m_zg, zg1);
        m_idx = idx1;
      }
      depth += 1;
    }
    const bool turned = turning_int || (do_merge && turning_top);
    const bool fin = diverged || turned || depth >= D;

    // ---- emit the draw where the tree finished ----
    if (fin && dc < K) {
      const float energy_m = dm_ke - (dm_logp + logdet);
      float fisher = 0.0f;
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        const float s = dm_z[j] + dm_zg[j];
        fisher = (j == 0) ? s * s : fisher + s * s;
        a.draws[((size_t)dc * DIM + j) * C + c] = dm_q[j];
      }
      const float row[NSTATS] = {
          (float)depth, diverged ? 1.0f : 0.0f, (float)n_steps, s_acc, s_sym,
          mx_err, dm_logp, energy_m, energy_m - e_init, (float)dm_idx, fisher,
          step, (depth >= D && !turned && !diverged) ? 1.0f : 0.0f};
#pragma unroll
      for (int s = 0; s < NSTATS; ++s)
        a.stats[((size_t)dc * NSTATS + s) * C + c] = row[s];
    }

    // ---- next state: fresh draw / new doubling / same subtree ----
    const float new_dir =
        uniform(seed, it, 6u, (uint32_t)b) < 0.5f ? 1.0f : -1.0f;
    const bool new_doub = do_merge && !fin;
    if (fin) {
      float v_new[DIM];
#pragma unroll
      for (int j = 0; j < DIM; ++j)
        v_new[j] = normal(seed, it, 7u, 8u, (uint32_t)(j * B + b));
      const float ke_new = 0.5f * dot<DIM>(v_new, v_new);
      if (a.has_jitter)
        step = bar * (a.jc1 + a.jc2 * uniform(seed, it, 9u, (uint32_t)b));
      else
        step = bar;
      e_init = ke_new - (dm_logp + logdet);
      dc += 1;
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        e_z[j] = m_z[j] = p_z[j] = dm_z[j];
        e_v[j] = m_v[j] = p_v[j] = v_new[j];
        e_zg[j] = m_zg[j] = p_zg[j] = dm_zg[j];
      }
      e_idx = m_idx = p_idx = dm_idx = 0;
      dm_ke = ke_new;
      logw_m = 0.0f;
      depth = 0;
      n_steps = 0;
      s_acc = s_sym = mx_err = 0.0f;
    } else if (new_doub) {
      const bool jump_p = new_dir > 0.0f;
      copy<DIM>(e_z, jump_p ? p_z : m_z);
      copy<DIM>(e_v, jump_p ? p_v : m_v);
      copy<DIM>(e_zg, jump_p ? p_zg : m_zg);
      e_idx = jump_p ? p_idx : m_idx;
    } else {
      copy<DIM>(e_z, z1);
      copy<DIM>(e_v, v2);
      copy<DIM>(e_zg, zg1);
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
  for (int j = 0; j < DIM; ++j) {
    a.q_f[c * DIM + j] = dm_q[j];
    a.g_f[c * DIM + j] = dm_zg[j] / stds[j];
  }
  a.logp_f[c] = dm_logp;
  a.iters[c] = (int)it;
}

template <int DIM, int D>
cudaError_t launch_posterior(const PostArgs& a, int B, int model_id,
                   const float* params, cudaStream_t stream) {
  if (model_id != MODEL_IID_NORMAL) return cudaErrorInvalidValue;
  posterior_kernel<DIM, D, IidNormal>
      <<<a.C / B, B, 0, stream>>>(a, IidNormal{params[0]});
  return cudaGetLastError();
}

}  // namespace nrt

extern "C" int nrt_posterior_launch(
    int dim, int maxdepth, int C, int B, int K, uint32_t seed, float max_err,
    int has_jitter, float jc1, float jc2, int model_id,
    const float* model_params, const float* q, const float* g,
    const float* logp, const float* stds, const float* mean,
    const float* logdet, const float* step0, const float* bar, float* draws,
    float* stats, float* q_f, float* g_f, float* logp_f, int* iters,
    void* stream) {
  if (B < 1 || B > nrt::MAX_BLOCK || C % B != 0)
    return (int)cudaErrorInvalidValue;
  const nrt::PostArgs a{C,    K,     seed,  max_err, has_jitter, jc1,
                        jc2,  q,     g,     logp,    stds,       mean,
                        logdet, step0, bar, draws,   stats,      q_f,
                        g_f,  logp_f, iters};
  cudaStream_t s = (cudaStream_t)stream;
#define NRT_CASE(DIM_, D_)                                                 \
  if (dim == DIM_ && maxdepth == D_)                                       \
    return (int)nrt::launch_posterior<DIM_, D_>(a, B, model_id, model_params, s);
  NRT_FOR_EACH_SIZE(NRT_CASE)
#undef NRT_CASE
  return (int)cudaErrorInvalidValue;
}
