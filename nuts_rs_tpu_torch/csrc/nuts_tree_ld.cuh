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
// Every per-chain contraction goes through Reducer::sum (block_sum.cuh), or
// in the merged leapfrog of K1-ld / K2-ld through WideReducer::sum, whose
// order is the same, the one of nuts_rs_tpu_torch/ops.py::tsum.  The Pallas
// body's cross-dot matrix caches these same dots; here the few rows a
// leapfrog's checks need are read from the stacks directly, which gives the
// same values.
//
// NRT_ABLATE_FIXED_TREES, a build-time switch for timing ablations only
// (profile_main_path.py items 12 and 15; it changes results), keeps every
// U-turn check and the divergence test but ignores their outcome, so every
// tree runs to maxdepth whatever the model: the same leapfrog count for any
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

// NRT_LD_CLOCKS, a build-time switch for timing ablations only
// (profile_main_path.py item 15): thread 0 of chain 0 adds the SM cycles of
// each phase of a block iteration (the pass, the leapfrog's reduction, the
// U-turn checks after it, the scalar tree between two leapfrogs) to
// nrt_ld_clocks, which nrt_ld_clocks() (nuts_fused_ld_posterior.cu) reads.
struct LdClocks {
  long long t;
  long long acc[4];
};
#ifdef NRT_LD_CLOCKS
__device__ unsigned long long nrt_ld_clocks[5];  // 4 phases, leapfrogs
#define NRT_LD_TICK(c, phase)                      \
  do {                                             \
    const long long now_ = clock64();              \
    (c).clk->acc[phase] += now_ - (c).clk->t;      \
    (c).clk->t = now_;                             \
  } while (0)
#else
#define NRT_LD_TICK(c, phase) \
  do {                        \
  } while (0)
#endif

// Chain blocks an SM of the dim-on-lanes kernels with data (K1-ld-args,
// K2-ld-args): two, so at most 128 registers a thread and 264 chains
// resident (NRT_LD_ARGS_MIN_BLOCKS=n changes it for timing ablations).
#ifdef NRT_LD_ARGS_MIN_BLOCKS
constexpr int LD_ARGS_MIN_BLOCKS = NRT_LD_ARGS_MIN_BLOCKS;
#else
constexpr int LD_ARGS_MIN_BLOCKS = 2;
#endif

// K1-ld and K2-ld (the dim-on-lanes kernels of a term / finish functor)
// take the merged leapfrog (ld_leap_merged below) where its shared memory
// fits a block (ld_kernel_form), else today's.  Both at one chain block an
// SM: at two (at most 128 registers a thread) the merged body spills 1148
// bytes and a leapfrog of an SM took 4.67 us against 2.69 at one
// (profile_main_path.py item 15, PERF.md).  Build-time switches for timing
// ablations only (item 15; none changes results): NRT_LD_MIN_BLOCKS=n,
// NRT_LD_TODAY (today's leapfrog in the merged form's kernel, at
// LD_MIN_BLOCKS) and NRT_LD_EARLY=n (0: the merged pass loads a
// coordinate's inputs with its own arithmetic, after the stores of the
// coordinates before it).
#ifdef NRT_LD_MIN_BLOCKS
constexpr int LD_MIN_BLOCKS = NRT_LD_MIN_BLOCKS;
#else
constexpr int LD_MIN_BLOCKS = 1;
#endif
#ifdef NRT_LD_TODAY
constexpr bool LD_MERGED = false;
#else
constexpr bool LD_MERGED = true;
#endif
// coordinates a thread loads its check rows and live values for ahead of
// their arithmetic (2: four at d = 1000 spill at 255 registers)
#ifdef NRT_LD_EARLY
constexpr int LD_EARLY = NRT_LD_EARLY;
#else
constexpr int LD_EARLY = 2;
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
#ifdef NRT_LD_CLOCKS
  LdClocks* clk;
#endif
};

__device__ __forceinline__ void ld_copy(const LdChain& c, float* dst,
                                        const float* src) {
  for (int j = threadIdx.x; j < c.d; j += LD_T) dst[j] = src[j];
}

// dst[k] = src[k] for K vectors of one chain, in K1-ld and K2-ld (the
// other kernels of these bodies copy one vector at a time, ld_copy): a
// thread loads all of its values of a run of 4 coordinates before it
// stores any (the vectors differ, so no store can change a load behind it,
// but the compiler cannot know that and would wait for each store).
template <int K>
__device__ __forceinline__ void ld_copy_n(const LdChain& c,
                                          float* const (&dst)[K],
                                          const float* const (&src)[K]) {
  for (int i0 = 0; i0 < c.n; i0 += 4) {
    float x[4][K];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = threadIdx.x + (i0 + u) * LD_T;
      if (i0 + u < c.n && j < c.d) {
#pragma unroll
        for (int k = 0; k < K; ++k) x[u][k] = src[k][j];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = threadIdx.x + (i0 + u) * LD_T;
      if (i0 + u < c.n && j < c.d) {
#pragma unroll
        for (int k = 0; k < K; ++k) dst[k][j] = x[u][k];
      }
    }
  }
}

// The moving edge takes the new point in K1-ld and K2-ld by swapping the
// two sets of buffers (the new point's are written whole by the next
// leapfrog before they are read), not by copying.
__device__ __forceinline__ void ld_swap_edge(LdChain& c) {
  float* t;
  t = c.e_z, c.e_z = c.z1, c.z1 = t;
  t = c.e_v, c.e_v = c.v2, c.v2 = t;
  t = c.e_zg, c.e_zg = c.zg1, c.zg1 = t;
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

// The U-turn levels 2 .. tzn - 1 of a leaf with tzn >= 3 (one in eight
// leaves): their six dots each in one more reduction, five levels a
// reduction (one for tzn <= 7), and their tests in ascending level, as
// today's loop runs them (ld_leapfrog's levels lev >= 2).  The pass reads
// rows the leapfrog's pass wrote before its reduction's barrier: z1 and v2
// of its own coordinates, and stack rows lev and lev - 1 >= 1, which that
// pass did not write (it wrote row 0 of lz / lv and row tzn + 1 of mz / mv).
__device__ __forceinline__ bool ld_deep_levels(const LdChain& c,
                                               WideReducer& wide, float dirf,
                                               float d1, int tzn) {
  constexpr int LEVELS = 5;  // 6 dots each: 30 of LD_WIDE
  const int d = c.d;
  bool turning = false;
  for (int lev0 = 2; lev0 < tzn; lev0 += LEVELS) {
    const int nl = min(LEVELS, tzn - lev0);
    float r[6 * LEVELS];
    for (int i = 0; i < c.n; ++i) {
      const int j = threadIdx.x + i * LD_T;
      const bool in = j < d;
      const float z1 = in ? c.z1[j] : 0.0f, v2 = in ? c.v2[j] : 0.0f;
#pragma unroll
      for (int u = 0; u < LEVELS; ++u) {
        float t[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (in && u < nl) {
          const size_t lev = (size_t)(lev0 + u);
          const float lzj = c.lz[lev * d + j], lvj = c.lv[lev * d + j];
          const float mzj = c.mz[lev * d + j], mvj = c.mv[lev * d + j];
          const float lzk = c.lz[(lev - 1) * d + j];
          const float lvk = c.lv[(lev - 1) * d + j];
          t[0] = z1 * lvj;
          t[1] = lzj * v2;
          t[2] = z1 * mvj;
          t[3] = mzj * v2;
          t[4] = lzk * lvj;
          t[5] = lzj * lvk;
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) acc(r[6 * u + k], i, t[k]);
      }
    }
    wide.sum(r);
#pragma unroll
    for (int u = 0; u < LEVELS; ++u) {
      const int lev = lev0 + u;
      if (u < nl)
        turning = turning ||
                  turn2(dirf, r[6 * u], c.bl[lev], d1, r[6 * u + 1]) ||
                  turn2(dirf, r[6 * u + 2], c.bm[lev], d1, r[6 * u + 3]) ||
                  turn2(dirf, r[6 * u + 4], c.bl[lev], c.bl[lev - 1],
                        r[6 * u + 5]);
    }
  }
  return turning;
}

// The merged leapfrog of K1-ld / K2-ld (a term / finish functor): the pass
// that computes z1, v2 and zg1 and writes the stack rows also forms the dots
// of the U-turn checks that this leaf completes, so one reduction (the wide
// one, block_sum.cuh) gives the leapfrog's 11 sums and, after them, the
// checks' dots: NL = 0 (tzn == 0, half the leaves) none; NL = 1 (tzn == 1)
// the boundary level's two; NL = 2 (tzn == 2) level 1's two and the
// boundary level's six; NL = 3 (tzn >= 3) the same, with levels 2 .. tzn - 1
// in ld_deep_levels.  Every sum is one of today's (ld_leapfrog's s[], its
// ld_dots calls), in tsum's order, and the tests run on them in today's
// order: the top level, then the static levels ascending, then the boundary
// level.
//
// Which rows the pass reads after writing them.  Today's checks read the
// stacks after the leapfrog's reduction, so they see its writes: lz / lv row
// row_l = min(tz(leaf), D) and mz / mv row row_m = tzn + 1 (tzn <= D - 1
// for every leaf < 2^D).  The checks read lz / lv rows D (the top level's
// b0, at depth > 0), ra, 1 and rb = tzn - 1, and mz / mv row tzn.  Row D is
// written only at leaf 0 (row_l == D; tzn == 0 there, so no other check
// row is read): its values are this pass's z1 and v2, which the pass uses in
// place of a load.  At tzn >= 1 the leaf is odd and row_l == 0, below every
// row read (ra > tzn >= 1, rb >= 1); row tzn is not row tzn + 1.  So every
// other row read is one that no write of this pass touches, and it may be
// loaded before the pass's stores: at the top of each run of LD_EARLY
// coordinates, all in flight together, their L2 latency under the pass's
// arithmetic.  A thread reads and writes only its own coordinates, so no
// other thread's write is involved (tests/test_torch_ld_checks.py holds a
// model of these indices against today's loops for every leaf < 2^D,
// D <= 10).
template <class Model, int NL>
__device__ __forceinline__ LdLeap ld_leap_merged(const LdChain& c,
                                                 WideReducer& wide,
                                                 const Model& model,
                                                 float dirf, float step,
                                                 int leaf, int depth, int tzn,
                                                 float* q1_keep) {
  constexpr int N = NL == 0 ? LD_NRED : NL == 1 ? LD_NRED + 2 : LD_NRED + 8;
  // stack rows a coordinate reads: row D's z and v (b0), row ra's, row 1's,
  // mz / mv row tzn, row rb's
  constexpr int NG = NL == 0 ? 2 : NL == 1 ? 4 : NL == 2 ? 8 : 10;
  constexpr int E = LD_EARLY > 0 ? LD_EARLY : 1;
  const int d = c.d, D = c.D;
  const float eps = dirf * step;
  const float half = eps / 2.0f;
  const int row_l = min(tz(leaf, D), D);
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
  // row D is this leaf's own at leaf 0 (see above): read where it is not
  const bool top2 = depth > 0;
  const bool read_b0 = top2 && leaf != 0;
  const int ra = NL >= 1 ? min(tz(leaf + 1 - (1 << tzn), D), D) : 0;
  const int rb = NL == 3 ? tzn - 1 : 1;
  // the rows as offsets into the chain's four stacks, [4][D + 1][d] from
  // c.lz (32-bit: at most 4 x 31 x 2757 floats)
  const int stack = (D + 1) * d;
  int rows[NG];
  rows[0] = D * d;
  rows[1] = stack + D * d;
  if constexpr (NL >= 1) {
    rows[2] = ra * d;
    rows[3] = stack + ra * d;
  }
  if constexpr (NL >= 2) {
    rows[4] = d;
    rows[5] = stack + d;
    rows[6] = 2 * stack + tzn * d;
    rows[7] = 3 * stack + tzn * d;
  }
  if constexpr (NL == 3) {
    rows[8] = rb * d;
    rows[9] = stack + rb * d;
  }

  // A coordinate's inputs: the check rows (g) and its live values (x:
  // stds, e_v, e_zg, e_z, mean, far z / v, near z / v), loaded for LD_EARLY
  // coordinates before any of their stores, so that the loads do not wait
  // for the stores of the coordinates before them (which they could alias
  // as far as the compiler knows).
  auto load_rows = [&](float (&g)[NG], int j) {
#pragma unroll
    for (int r = 0; r < NG; ++r)
      g[r] = (r >= 2 || read_b0) ? c.lz[rows[r] + j] : 0.0f;
  };
  auto load_live = [&](float (&x)[9], int j) {
    x[0] = c.stds[j];
    x[1] = c.e_v[j];
    x[2] = c.e_zg[j];
    x[3] = c.e_z[j];
    x[4] = c.mean[j];
    x[5] = far_z[j];
    x[6] = far_v[j];
    x[7] = top2 ? near_z[j] : 0.0f;
    x[8] = top2 ? near_v[j] : 0.0f;
  };
  float s[N];
  for (int i0 = 0; i0 < c.n; i0 += E) {
    float g[E][NG], x[E][9];
    if constexpr (LD_EARLY > 0) {
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const int j = threadIdx.x + (i0 + u) * LD_T;
        if (i0 + u < c.n && j < d) {
          load_rows(g[u], j);
          load_live(x[u], j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const int i = i0 + u;
      if (i >= c.n) break;
      const int j = threadIdx.x + i * LD_T;
      float t[N];
#pragma unroll
      for (int k = 0; k < N; ++k) t[k] = 0.0f;
      if (j < d) {
        if constexpr (LD_EARLY == 0) {
          load_rows(g[u], j);
          load_live(x[u], j);
        }
        const float sd = x[u][0];
        const float v1 = x[u][1] + half * x[u][2];
        const float z1 = x[u][3] + eps * v1;
        const float q1 = z1 * sd + x[u][4];
        float g1;
        t[0] = model.term(q1, g1);
        c.z1[j] = z1;
        if (q1_keep != nullptr) q1_keep[j] = q1;
        const float zg1 = g1 * sd;
        const float v2 = v1 + half * zg1;
        c.v2[j] = v2;
        c.zg1[j] = zg1;
        lz_l[j] = z1;
        lv_l[j] = v2;
        mz_m[j] = z1;
        mv_m[j] = v2;
        t[1] = v2 * v2;
        t[2] = z1 * v2;
        const float fz = x[u][5], fv = x[u][6];
        t[3] = fz * fv;
        t[4] = z1 * fv;
        t[5] = fz * v2;
        if (top2) {
          const float nz = x[u][7], nv = x[u][8];
          const float bz = read_b0 ? g[u][0] : z1;  // row D: this leaf's at 0
          const float bv = read_b0 ? g[u][1] : v2;
          t[6] = nz * nv;
          t[7] = z1 * nv;
          t[8] = nz * v2;
          t[9] = bz * fv;
          t[10] = fz * bv;
        }
        if constexpr (NL == 1) {
          t[11] = z1 * g[u][3];  // boundary level: z1.lv[ra], lz[ra].v2
          t[12] = g[u][2] * v2;
        }
        if constexpr (NL >= 2) {
          // row rb is row 1 at tzn == 2
          const float lzb = g[u][NL == 3 ? 8 : 4], lvb = g[u][NL == 3 ? 9 : 5];
          t[11] = z1 * g[u][5];  // level 1: z1.lv[1], lz[1].v2
          t[12] = g[u][4] * v2;
          t[13] = z1 * g[u][3];  // boundary: z1.lv[ra], lz[ra].v2,
          t[14] = g[u][2] * v2;
          t[15] = z1 * g[u][7];  // z1.mv[tzn], mz[tzn].v2,
          t[16] = g[u][6] * v2;
          t[17] = lzb * g[u][3];  // lz[rb].lv[ra], lz[ra].lv[rb]
          t[18] = g[u][2] * lvb;
        }
      }
#pragma unroll
      for (int k = 0; k < N; ++k) acc(s[k], i, t[k]);
    }
  }
  NRT_LD_TICK(c, 0);
  wide.sum(s);
  NRT_LD_TICK(c, 1);

  LdLeap out;
  out.logp1 = model.finish(s[0]);
  out.ke1 = 0.5f * s[1];
  out.d1 = s[2];
  const float d1 = out.d1;
  // as in ld_leapfrog: every thread writes the same value, then reads
  c.bl[row_l] = d1;
  c.bm[row_m] = d1;
  const bool t_out = turn2(dirf, s[4], s[3], d1, s[5]);
  out.turning_top =
      t_out || (top2 && (turn2(dirf, s[7], s[6], d1, s[8]) ||
                         turn2(dirf, s[9], s[3], c.bl[D], s[10])));
  bool turning = false;
  if constexpr (NL >= 2) turning = turn2(dirf, s[11], c.bl[1], d1, s[12]);
  if constexpr (NL == 3)
    turning = ld_deep_levels(c, wide, dirf, d1, tzn) || turning;
  if constexpr (NL == 1) turning = turn2(dirf, s[11], c.bl[ra], d1, s[12]);
  if constexpr (NL >= 2) {
    const float a_b = c.bl[ra];
    turning = turning || turn2(dirf, s[13], a_b, d1, s[14]) ||
              turn2(dirf, s[15], c.bm[tzn], d1, s[16]) ||
              turn2(dirf, s[17], a_b, c.bl[rb], s[18]);
  }
  out.turning_int = turning;
  return out;
}

// One leapfrog from the moving edge with the model, the checkpoint-stack
// writes and every U-turn check of the new leaf (nuts_pallas.py:348-576).
// Writes z1, v2, zg1 (and q1 where the caller keeps it) and the stack rows.
// With EVAL_BLOCK the model is evaluated in its eval_block form between two
// passes over the coordinates: q1_keep must be given, and `scratch` is the
// functor's shared memory.  With FLOW (and EVAL_BLOCK) the model is a
// CouplingFlowModel (coupling_flow.cuh): z1 goes through the frozen flow to
// q1_keep, the functor's gradient comes back through the flow's backward
// pass as zg1 (no diagonal scaling), and the first sum of the second pass
// is the flow's logdet over the coordinates.  With MERGED (K1-ld and K2-ld)
// it is ld_leap_merged: one pass and one reduction for the leapfrog and the
// checks of tzn <= 2, the same sums and tests.
template <bool EVAL_BLOCK, class Model, bool FLOW, bool MERGED>
__device__ __forceinline__ LdLeap ld_leapfrog(const LdChain& c, Reducer& red,
                                              WideReducer& wide,
                                              const Model& model, float dirf,
                                              float step, int leaf, int depth,
                                              float* q1_keep, float* scratch) {
  NRT_LD_TICK(c, 3);
  if constexpr (MERGED) {
    static_assert(!EVAL_BLOCK && !FLOW, "the merged pass is term / finish's");
    const int tzn = tz(leaf + 1, c.D);
    LdLeap out;
    if (tzn == 0)
      out = ld_leap_merged<Model, 0>(c, wide, model, dirf, step, leaf, depth,
                                     tzn, q1_keep);
    else if (tzn == 1)
      out = ld_leap_merged<Model, 1>(c, wide, model, dirf, step, leaf, depth,
                                     tzn, q1_keep);
    else if (tzn == 2)
      out = ld_leap_merged<Model, 2>(c, wide, model, dirf, step, leaf, depth,
                                     tzn, q1_keep);
    else
      out = ld_leap_merged<Model, 3>(c, wide, model, dirf, step, leaf, depth,
                                     tzn, q1_keep);
    out.turning_int = ablate_keep(out.turning_int);
    out.turning_top = ablate_keep(out.turning_top);
    NRT_LD_TICK(c, 2);
    return out;
  }
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
    // the flow's warp form reads z1 on the warp that wrote it (d <= 32)
    if constexpr (Model::WARP_FORM)
      __syncwarp();
    else
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
  NRT_LD_TICK(c, 0);
  red.sum(s);
  NRT_LD_TICK(c, 1);

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
  NRT_LD_TICK(c, 2);
  return out;
}

// Shared-memory floats of a chain block with `nvec` live vectors; a model
// functor's scratch (the eval_block form) follows them.
__host__ __device__ inline size_t ld_smem_floats(int nvec, int d, int D,
                                                 bool merged = false) {
  return (size_t)nvec * d + 2 * (D + 1) + 2 * LD_NRED * LD_W +
         2 * LD_MAX_CLUSTER + (merged ? LD_WIDE_FLOATS : 0);
}

// Dynamic shared memory a block may opt in to on sm_90
// (_build.SMEM_OPT_IN_BYTES).
constexpr long long LD_SMEM_OPT_IN = 232448;

// Whether K1-ld / K2-ld (`nvec` live vectors) take their merged-form kernel
// at (d, D): where its layout, with the wide reduction's scratch, fits a
// block's shared memory; else today's form at one block an SM serves d up
// to _build.ld_max_dim (_build.ld_form is the same rule).
inline bool ld_kernel_form(int nvec, int d, int D) {
  return 4 * (long long)ld_smem_floats(nvec, d, D, LD_MERGED) <=
         LD_SMEM_OPT_IN;
}

// Bytes of dynamic shared memory of the kernel that ld_kernel_form picks.
inline long long ld_form_bytes(int nvec, int d, int D) {
  return 4 * (long long)ld_smem_floats(nvec, d, D,
                                       LD_MERGED && ld_kernel_form(nvec, d, D));
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

// Blocks of `kernel` one SM holds (out[0]) and clusters of B of its blocks
// the card holds at once (out[1], cudaOccupancyMaxActiveClusters) at `smem`
// bytes of dynamic shared memory a block; a CUDA error code, or 0.
template <class Kernel>
inline int ld_occupancy(Kernel kernel, long long smem, int B, int* out) {
  out[0] = blocks_per_sm(kernel, smem);
  if (out[0] < 0) return -out[0];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B);
  cfg.blockDim = dim3(LD_T);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)B;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&out[1], kernel, &cfg);
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
