// Tree pieces of the dim-on-lanes (ld) fused NUTS kernels: several threads
// share one chain.
//
// Counterpart of the layout="ld" switch of
// nuts_rs_tpu/kernels/nuts_pallas.py (make_kernel :123-136,167-173, the
// U-turn ladder :405-576 with its cross-dot matrix :337-339,450-474;
// make_warmup_kernel :959-986).  One CUDA block of LD_T threads runs one
// chain; thread t owns the coordinates j = t, t + LD_T, t + 2 LD_T, ... of
// every vector of its chain, in shared memory (the live state) and in a
// global-memory workspace (the four checkpoint stacks), and never touches
// another thread's coordinates, so the only synchronisation is inside a
// sum.  Scalars (energies, weights, tree counters, the random scalar sites)
// are computed redundantly by every thread of the block from the same
// inputs, so control flow is uniform within a block.  One thread block
// cluster is one logical chain block of the Pallas kernel: its B chains
// share the random seed and the iteration counter and number their vector
// sites b * d + j.  A chain's tree does not depend on its block mates; only
// the counter at which the block stops (posterior) or starts its next draw
// (warmup) does, and the chains agree on it through distributed shared
// memory and one cluster barrier (ClusterMax), not once per iteration.
//
// Two template choices make the kernels of these pieces.  CL_SITE: the
// chains-on-lanes kernel K1-flow (nuts_fused_flow_posterior.cu) keeps the
// chains-on-lanes numbering of a vector site, j * B + b, so that a
// configuration whose layout is "cl" in the JAX runners takes the cl random
// stream; the dim-on-lanes kernels number it b * d + j.  EVAL_BLOCK: the
// model is evaluated through its eval_block form (models.cuh), in which the
// block's threads see the whole position vector and the model's data
// (K1-flow and the dim-on-lanes kernels with data,
// nuts_fused_ld_args_*.cu), or through its term / finish form, one
// coordinate at a time (the dim-on-lanes kernels of IidNormal).  The mid-d
// kernels K1-args and K2-args run several chains a block, a warp each, on
// nuts_tree_group.cuh.
//
// Every per-chain contraction goes through Reducer::sum (block_sum.cuh),
// whose order is the one of nuts_rs_tpu_torch/ops.py::tsum.  The Pallas
// body's cross-dot matrix caches these same dots; here the few rows a
// leapfrog's checks need are read from the stacks directly, which gives the
// same values.
//
// NRT_ABLATE_FIXED_TREES, a build-time switch for timing ablations only
// (profile_main_path.py item 12; it changes results), keeps every U-turn
// check and the divergence test but ignores their outcome, so every tree
// runs to maxdepth whatever the model: the same leapfrog count for any
// functor.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "nuts_tree.cuh"
#include "rng.cuh"

namespace nrt {

namespace cg = cooperative_groups;

#ifdef NRT_ABLATE_FIXED_TREES
__device__ int nrt_ablate_keep;  // 0: outcomes ignored (read at run time)
__device__ __forceinline__ bool ablate_keep(bool x) {
  return x && *(volatile int*)&nrt_ablate_keep != 0;
}
#else
__device__ __forceinline__ bool ablate_keep(bool x) { return x; }
#endif

// Chain blocks an SM of the dim-on-lanes kernels with data (K1-ld-args,
// K2-ld-args): two, so at most 128 registers a thread and 264 chains
// resident (NRT_LD_ARGS_MIN_BLOCKS=n changes it for timing ablations).
#ifdef NRT_LD_ARGS_MIN_BLOCKS
constexpr int LD_ARGS_MIN_BLOCKS = NRT_LD_ARGS_MIN_BLOCKS;
#else
constexpr int LD_ARGS_MIN_BLOCKS = 2;
#endif

constexpr int LD_MAX_CLUSTER = 8;  // chains per logical block (portable size)
// live vectors of a chain in shared memory (LdChain's 18; the posterior
// kernel adds dm_q, ds_q, q1)
constexpr int LD_WARM_NVEC = 18;
constexpr int LD_POST_NVEC = 21;

// Index of a vector site's element for lane b of a logical block of B
// chains and coordinate j: the flat position in the block's (B, d) shape in
// the dim-on-lanes layout, in its (d, B) shape in the chains-on-lanes one.
template <bool CL_SITE>
__device__ __forceinline__ uint32_t block_site(int b, int B, int d, int j) {
  return CL_SITE ? (uint32_t)j * (uint32_t)B + (uint32_t)b
                 : ld_site(b, d, j);
}

// max(value) over the blocks of the cluster (the chains of a logical block).
// Every block writes its value into every block's slots, then one
// cluster-wide barrier; the slots alternate as the Reducer's buffers do.
// The cluster's blocks are co-scheduled, so the wait cannot deadlock.
struct ClusterMax {
  uint32_t* slots;  // shared memory, [2][LD_MAX_CLUSTER]
  int parity;

  __device__ __forceinline__ uint32_t max(uint32_t value) {
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned n = cluster.num_blocks();
    uint32_t* mine = slots + parity * LD_MAX_CLUSTER;
    parity ^= 1;
    if (threadIdx.x < n)
      cluster.map_shared_rank(mine, threadIdx.x)[cluster.block_rank()] =
          value;
    cluster.sync();
    uint32_t r = 0;
    for (unsigned b = 0; b < n; ++b) r = mine[b] > r ? mine[b] : r;
    return r;
  }
};

// The logical chain block of a posterior body (nuts_fused_ld_posterior.cuh)
// as a thread block cluster: B = the cluster's size, this chain's lane b in
// it, its chain c = blockIdx.x and its block's program id.  The chains run
// draw-asynchronously and agree on the block's last iteration once
// (ClusterMax over their own last ones).  The streamed kernel's block is a
// cooperative grid instead (grid_sync.cuh::GridBlock).
struct ClusterBlock {
  static constexpr bool LOCKSTEP = false;
  int B, b, c, pid;
  ClusterMax last;

  __device__ ClusterBlock() {
    cg::cluster_group cluster = cg::this_cluster();
    B = (int)cluster.num_blocks();
    b = (int)cluster.block_rank();
    c = blockIdx.x;
    pid = c / B;
    last = ClusterMax{nullptr, 0};
  }
  // the [2][LD_MAX_CLUSTER] slots of shared memory that max() takes
  __device__ void bind(uint32_t* slots) { last.slots = slots; }
  __device__ void sync() { cg::this_cluster().sync(); }
  __device__ uint32_t max(uint32_t value) { return last.max(value); }
};

// One chain's vectors.  The live ones are shared memory, d floats each; the
// checkpoint stacks are global memory, [D + 1][d] each.
struct LdChain {
  int d, D, n;  // n = ceil(d / LD_T): coordinates a thread may own
  float *stds, *mean;
  float *e_z, *e_v, *e_zg;           // moving edge
  float *m_z, *m_v, *m_zg;           // minus end
  float *p_z, *p_v, *p_zg;           // plus end
  float *dm_z, *dm_zg, *ds_z, *ds_zg;  // selected draws (main tree, subtree)
  float *z1, *v2, *zg1;              // this leapfrog's new point
  float *lz, *lv, *mz, *mv;          // checkpoint stacks
  float *bl, *bm;                    // cached z.v of the stack rows [D + 1]
};

__device__ __forceinline__ void ld_copy(const LdChain& c, float* dst,
                                        const float* src) {
  for (int j = threadIdx.x; j < c.d; j += LD_T) dst[j] = src[j];
}

// Dots a.b of up to N pairs of vectors of one chain, in one Reducer call.
template <int N>
__device__ __forceinline__ void ld_dots(const LdChain& c, Reducer& red,
                                        const float* const (&a)[N],
                                        const float* const (&b)[N],
                                        float (&out)[N]) {
#pragma unroll 4
  for (int i = 0; i < c.n; ++i) {
    const int j = threadIdx.x + i * LD_T;
    const bool in = j < c.d;
#pragma unroll
    for (int k = 0; k < N; ++k) acc(out[k], i, in ? a[k][j] * b[k][j] : 0.0f);
  }
  red.sum(out);
}

struct LdLeap {
  float logp1, ke1, d1;
  float ld1;  // the new point's logdet under FLOW (unset otherwise)
  bool turning_int, turning_top;
};

// One leapfrog from the moving edge with the model, the checkpoint-stack
// writes and every U-turn check of the new leaf (nuts_pallas.py:348-576).
// Writes z1, v2, zg1 (and q1 where the caller keeps it) and the stack rows.
// With EVAL_BLOCK the model is evaluated in its eval_block form between two
// passes over the coordinates: q1_keep must be given, and `scratch` is the
// functor's shared memory.  With FLOW (and EVAL_BLOCK) the model is a
// CouplingFlowModel (coupling_flow.cuh): z1 goes through the frozen flow to
// q1_keep, the functor's gradient comes back through the flow's backward
// pass as zg1 (no diagonal scaling), and the first sum of the second pass
// is the flow's logdet over the coordinates.
template <bool EVAL_BLOCK, class Model, bool FLOW = false>
__device__ __forceinline__ LdLeap ld_leapfrog(const LdChain& c, Reducer& red,
                                              const Model& model, float dirf,
                                              float step, int leaf, int depth,
                                              float* q1_keep, float* scratch) {
  const int d = c.d, D = c.D;
  const float eps = dirf * step;
  const float half = eps / 2.0f;
  const int row_l = min(tz(leaf, D), D);
  const int tzn = tz(leaf + 1, D);
  const int row_m = min(tzn + 1, D);
  const bool fwd = dirf > 0.0f;
  const float* far_z = fwd ? c.m_z : c.p_z;
  const float* far_v = fwd ? c.m_v : c.p_v;
  const float* near_z = fwd ? c.p_z : c.m_z;
  const float* near_v = fwd ? c.p_v : c.m_v;
  float* lz_l = c.lz + (size_t)row_l * d;
  float* lv_l = c.lv + (size_t)row_l * d;
  float* mz_m = c.mz + (size_t)row_m * d;
  float* mv_m = c.mv + (size_t)row_m * d;
  const float* b0_z = c.lz + (size_t)D * d;
  const float* b0_v = c.lv + (size_t)D * d;

  float logp_block = 0.0f;
  if constexpr (FLOW) {
    static_assert(EVAL_BLOCK, "the flow evaluates its model in eval_block");
    for (int j = threadIdx.x; j < d; j += LD_T) {
      const float v1 = c.e_v[j] + half * c.e_zg[j];
      c.z1[j] = c.e_z[j] + eps * v1;
      c.v2[j] = v1;
    }
    __syncthreads();
    logp_block = model.eval_flow(c.z1, q1_keep, c.zg1, d, red, scratch);
  } else if constexpr (EVAL_BLOCK) {
    // first pass: the half step and the new position; v2 holds v1 and zg1
    // the model's gradient until the second pass
    for (int j = threadIdx.x; j < d; j += LD_T) {
      const float v1 = c.e_v[j] + half * c.e_zg[j];
      const float z1 = c.e_z[j] + eps * v1;
      c.z1[j] = z1;
      c.v2[j] = v1;
      q1_keep[j] = z1 * c.stds[j] + c.mean[j];
    }
    __syncthreads();
    logp_block = model.eval_block(q1_keep, c.zg1, d, red, scratch);
  }

  // sums: model term (0 with EVAL_BLOCK), v2.v2, z1.v2, then the top-level
  // dots far_z.far_v, z1.far_v, far_z.v2, near_z.near_v, z1.near_v,
  // near_z.v2, b0_z.far_v, far_z.b0_v (the last five only matter at
  // depth > 0)
  float s[LD_NRED];
  for (int i = 0; i < c.n; ++i) {
    const int j = threadIdx.x + i * LD_T;
    float t[LD_NRED];
    if (j < d) {
      const float sd = c.stds[j];
      float v1, z1, g1;
      if constexpr (FLOW) {
        v1 = c.v2[j];
        z1 = c.z1[j];
        g1 = c.zg1[j];
        t[0] = model.ld_term(scratch, j);
      } else if constexpr (EVAL_BLOCK) {
        v1 = c.v2[j];
        z1 = c.z1[j];
        g1 = c.zg1[j];
        t[0] = 0.0f;
      } else {
        v1 = c.e_v[j] + half * c.e_zg[j];
        z1 = c.e_z[j] + eps * v1;
        const float q1 = z1 * sd + c.mean[j];
        t[0] = model.term(q1, g1);
        c.z1[j] = z1;
        if (q1_keep != nullptr) q1_keep[j] = q1;
      }
      const float zg1 = FLOW ? g1 : g1 * sd;
      const float v2 = v1 + half * zg1;
      c.v2[j] = v2;
      c.zg1[j] = zg1;
      lz_l[j] = z1;
      lv_l[j] = v2;
      mz_m[j] = z1;
      mv_m[j] = v2;
      t[1] = v2 * v2;
      t[2] = z1 * v2;
      const float fz = far_z[j], fv = far_v[j];
      t[3] = fz * fv;
      t[4] = z1 * fv;
      t[5] = fz * v2;
      if (depth > 0) {
        const float nz = near_z[j], nv = near_v[j];
        t[6] = nz * nv;
        t[7] = z1 * nv;
        t[8] = nz * v2;
        t[9] = b0_z[j] * fv;   // row D holds this leaf when leaf == 0
        t[10] = fz * b0_v[j];
      } else {
        t[6] = t[7] = t[8] = t[9] = t[10] = 0.0f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < LD_NRED; ++k) t[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < LD_NRED; ++k) acc(s[k], i, t[k]);
  }
  red.sum(s);

  LdLeap out;
  if constexpr (EVAL_BLOCK)
    out.logp1 = logp_block;
  else
    out.logp1 = model.finish(s[0]);
  if constexpr (FLOW) out.ld1 = s[0];
  out.ke1 = 0.5f * s[1];
  out.d1 = s[2];
  const float d1 = out.d1;
  // Every thread writes the same value and reads these two rows only after
  // its own write; the other rows were written before the barrier in sum().
  c.bl[row_l] = d1;
  c.bm[row_m] = d1;

  const bool t_out = turn2(dirf, s[4], s[3], d1, s[5]);
  out.turning_top =
      t_out || (depth > 0 && (turn2(dirf, s[7], s[6], d1, s[8]) ||
                              turn2(dirf, s[9], s[3], c.bl[D], s[10])));

  // internal checks: static levels 1 <= j < tzn, then the boundary level
  bool turning = false;
  for (int lev = 1; lev < tzn; ++lev) {
    const float* lzj = c.lz + (size_t)lev * d;
    const float* lvj = c.lv + (size_t)lev * d;
    const float* lzk = c.lz + (size_t)(lev - 1) * d;
    const float* lvk = c.lv + (size_t)(lev - 1) * d;
    if (lev >= 2) {
      const float* mzj = c.mz + (size_t)lev * d;
      const float* mvj = c.mv + (size_t)lev * d;
      const float* const a[6] = {c.z1, lzj, c.z1, mzj, lzk, lzj};
      const float* const b[6] = {lvj, c.v2, mvj, c.v2, lvj, lvk};
      float r[6];
      ld_dots<6>(c, red, a, b, r);
      turning = turning || turn2(dirf, r[0], c.bl[lev], d1, r[1]) ||
                turn2(dirf, r[2], c.bm[lev], d1, r[3]) ||
                turn2(dirf, r[4], c.bl[lev], c.bl[lev - 1], r[5]);
    } else {
      const float* const a[2] = {c.z1, lzj};
      const float* const b[2] = {lvj, c.v2};
      float r[2];
      ld_dots<2>(c, red, a, b, r);
      turning = turning || turn2(dirf, r[0], c.bl[lev], d1, r[1]);
    }
  }
  if (tzn >= 1) {
    const int ra = min(tz(leaf + 1 - (1 << tzn), D), D);
    const float a_b = c.bl[ra];
    const float* lza = c.lz + (size_t)ra * d;
    const float* lva = c.lv + (size_t)ra * d;
    if (tzn >= 2) {
      const int rb = tzn - 1;
      const float* mzt = c.mz + (size_t)tzn * d;
      const float* mvt = c.mv + (size_t)tzn * d;
      const float* lzb = c.lz + (size_t)rb * d;
      const float* lvb = c.lv + (size_t)rb * d;
      const float* const a[6] = {c.z1, lza, c.z1, mzt, lzb, lza};
      const float* const b[6] = {lva, c.v2, mvt, c.v2, lva, lvb};
      float r[6];
      ld_dots<6>(c, red, a, b, r);
      turning = turning || turn2(dirf, r[0], a_b, d1, r[1]) ||
                turn2(dirf, r[2], c.bm[tzn], d1, r[3]) ||
                turn2(dirf, r[4], a_b, c.bl[rb], r[5]);
    } else {
      const float* const a[2] = {c.z1, lza};
      const float* const b[2] = {lva, c.v2};
      float r[2];
      ld_dots<2>(c, red, a, b, r);
      turning = turning || turn2(dirf, r[0], a_b, d1, r[1]);
    }
  }
  out.turning_int = ablate_keep(turning);
  out.turning_top = ablate_keep(out.turning_top);
  return out;
}

// Shared-memory floats of a chain block with `nvec` live vectors; a model
// functor's scratch (the eval_block form) follows them.
__host__ __device__ inline size_t ld_smem_floats(int nvec, int d, int D) {
  return (size_t)nvec * d + 2 * (D + 1) + 2 * LD_NRED * LD_W +
         2 * LD_MAX_CLUSTER;
}

// Blocks of `kernel` one SM holds at `smem` bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); minus a CUDA error code
// where the query fails.
template <class Kernel>
inline int blocks_per_sm(Kernel kernel, long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, LD_T,
                                                        (size_t)smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Launch one block of LD_T threads per chain in clusters of B blocks, with
// `smem_bytes` of dynamic shared memory (above 48 KB: opt in first).
template <class Kernel, class Args, class Model>
cudaError_t ld_launch(Kernel kernel, const Args& a, const Model& model,
                      int C, int B, size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3(LD_T);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)B;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, model);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace nrt
