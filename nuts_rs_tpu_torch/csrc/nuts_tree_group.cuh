// Tree pieces of the mid-d chains-on-lanes NUTS kernels K1-args and K2-args
// (nuts_fused_mid_posterior.cu, nuts_fused_mid_warmup.cu): G <= GR_MAX
// chains a CUDA block of LD_T threads, one warp a chain.
//
// Counterpart of the same Pallas pieces as nuts_tree_ld.cuh (the leapfrog,
// the U-turn ladder and the top-level checks of nuts_pallas.py :337-576),
// in the order of operations of that header's ld_leapfrog, so that the bits
// are those of the 256-threads-a-chain body and of the plain versions
// (nuts_fused.py with layout="cl" and a mid-d model):
// - lane l of a chain's warp stands for the LD_T / 32 virtual threads
//   l + 32 w of tsum's order (its slots, block_sum.cuh): it owns the
//   coordinates j = l + 32 w + LD_T i, that is every j with j % 32 == l,
//   in every live vector (shared memory) and stack row (global memory), and
//   touches no other lane's coordinates outside the model's evaluation;
// - a sum over the coordinates adds each slot's terms in ascending i and
//   goes through slot_sums: each slot's butterfly, then the 8 warp sums
//   halved, the additions of Reducer::sum in its tree.  No barrier: a
//   chain's tree needs only its warp, and the warps of a block run their
//   chains side by side;
// - scalars are computed alike by every lane of the warp, so control flow is
//   uniform within a chain.
// The model's evaluation is the only step that crosses chains: a functor's
// eval_team runs on the chain's warp, the regression's group form on the
// whole block between two barriers (models.cuh).
#pragma once

#include "nuts_tree_ld.cuh"

namespace nrt {

// Shared memory of the opt-in limit of one block on sm_90, in bytes
// (_build.SMEM_OPT_IN_BYTES).
constexpr long long GR_SMEM_OPT_IN = 233472 - 1024;
// the block's chain flags, [2][GR_MAX] ints: with B > 1, what the chains of
// a logical block tell each other between iterations
constexpr int GR_FLAG_FLOATS = 2 * GR_MAX;

__device__ __forceinline__ int gr_lane() { return threadIdx.x & 31; }

// The live vectors of a chain, in this order after its two cached-dot rows;
// the posterior keeps all GR_POST_NVEC, the warmup the first GR_WARM_NVEC.
enum GrVec {
  V_STDS, V_MEAN, V_EZ, V_EV, V_EZG, V_MZ, V_MV, V_MZG, V_PZ, V_PV, V_PZG,
  V_DMZ, V_DMZG, V_DSZ, V_DSZG, V_Z1, V_V2, V_ZG1, V_Q1, V_DMQ, V_DSQ,
  GR_POST_NVEC
};
constexpr int GR_WARM_NVEC = V_DMQ;
static_assert(GR_POST_NVEC == LD_POST_NVEC && GR_WARM_NVEC == LD_WARM_NVEC + 1,
              "the ld bodies' vector counts");

// One chain's vectors from two base pointers, so that the registers hold two
// addresses and not 27: shared memory sm (bl, bm [D + 1], then the live
// vectors of d floats) and the global checkpoint stacks (lz, lv, mz, mv,
// [D + 1][d] each).
struct GrChain {
  float* sm;
  float* stack;
  int d, D, n;  // n = ceil(d / LD_T): rounds of a slot

  __device__ __forceinline__ float* v(int k) const {
    return sm + 2 * (D + 1) + k * d;
  }
  __device__ __forceinline__ float* stds() const { return v(V_STDS); }
  __device__ __forceinline__ float* mean() const { return v(V_MEAN); }
  __device__ __forceinline__ float* e_z() const { return v(V_EZ); }
  __device__ __forceinline__ float* e_v() const { return v(V_EV); }
  __device__ __forceinline__ float* e_zg() const { return v(V_EZG); }
  __device__ __forceinline__ float* m_z() const { return v(V_MZ); }
  __device__ __forceinline__ float* m_v() const { return v(V_MV); }
  __device__ __forceinline__ float* m_zg() const { return v(V_MZG); }
  __device__ __forceinline__ float* p_z() const { return v(V_PZ); }
  __device__ __forceinline__ float* p_v() const { return v(V_PV); }
  __device__ __forceinline__ float* p_zg() const { return v(V_PZG); }
  __device__ __forceinline__ float* dm_z() const { return v(V_DMZ); }
  __device__ __forceinline__ float* dm_zg() const { return v(V_DMZG); }
  __device__ __forceinline__ float* ds_z() const { return v(V_DSZ); }
  __device__ __forceinline__ float* ds_zg() const { return v(V_DSZG); }
  __device__ __forceinline__ float* z1() const { return v(V_Z1); }
  __device__ __forceinline__ float* v2() const { return v(V_V2); }
  __device__ __forceinline__ float* zg1() const { return v(V_ZG1); }
  __device__ __forceinline__ float* q1() const { return v(V_Q1); }
  __device__ __forceinline__ float* dm_q() const { return v(V_DMQ); }
  __device__ __forceinline__ float* ds_q() const { return v(V_DSQ); }
  __device__ __forceinline__ float* bl() const { return sm; }
  __device__ __forceinline__ float* bm() const { return sm + (D + 1); }
  __device__ __forceinline__ float* lz() const { return stack; }
  __device__ __forceinline__ float* lv() const {
    return stack + (size_t)(D + 1) * d;
  }
  __device__ __forceinline__ float* mz() const {
    return stack + 2 * (size_t)(D + 1) * d;
  }
  __device__ __forceinline__ float* mv() const {
    return stack + 3 * (size_t)(D + 1) * d;
  }
};

__device__ __forceinline__ GrChain gr_chain(float* sm, float* work, int c,
                                            int d, int D) {
  GrChain ch;
  ch.sm = sm;
  ch.stack = work + (size_t)c * 4 * (size_t)(D + 1) * d;
  ch.d = d;
  ch.D = D;
  ch.n = (d + LD_T - 1) / LD_T;
  return ch;
}

__device__ __forceinline__ void gr_copy(const GrChain& c, float* dst,
                                        const float* src) {
  for (int j = gr_lane(); j < c.d; j += 32) dst[j] = src[j];
}

// Dots a.b of N pairs of vectors of one chain (tsum's order).
template <int N>
__device__ __forceinline__ void gr_dots(const GrChain& c,
                                        const float* const (&a)[N],
                                        const float* const (&b)[N],
                                        float (&out)[N]) {
  slot_sums(
      c.d,
      [&](int j, float (&t)[N]) {
#pragma unroll
        for (int k = 0; k < N; ++k) t[k] = a[k][j] * b[k][j];
      },
      out);
}

// The first pass of a leapfrog from the moving edge: the half step and the
// new position, z1, v2 (holding v1 until the second pass) and q1 (and the
// group form's staged copy, `qg` a column of it, stride GR_MAX).
__device__ __forceinline__ void gr_leap_first(const GrChain& c, float dirf,
                                              float step, float* q1,
                                              float* qg) {
  const float eps = dirf * step;
  const float half = eps / 2.0f;
  for (int j = gr_lane(); j < c.d; j += 32) {
    const float v1 = c.e_v()[j] + half * c.e_zg()[j];
    const float z1 = c.e_z()[j] + eps * v1;
    c.z1()[j] = z1;
    c.v2()[j] = v1;
    const float q = z1 * c.stds()[j] + c.mean()[j];
    q1[j] = q;
    if (qg != nullptr) qg[j * GR_MAX] = q;
  }
}

// The second pass of the leapfrog after the model's evaluation, the stack
// writes and every U-turn check of the new leaf: ld_leapfrog's EVAL_BLOCK
// steps on one warp.  A team functor's gradient is in zg1 and its logp is
// `logp_team`; the group form's are read from its sums in `gs` (chain cb of
// G), the prior's terms joining the leapfrog's reduction as its sum 0.
template <class Model>
__device__ __forceinline__ LdLeap gr_leap_second(
    const GrChain& c, const Model& model, const float* gs, int G, int cb,
    float logp_team, float dirf, float step, int leaf, int depth,
    const float* q1) {
  const int d = c.d, D = c.D;
  const float eps = dirf * step;
  const float half = eps / 2.0f;
  const int row_l = min(tz(leaf, D), D);
  const int tzn = tz(leaf + 1, D);
  const int row_m = min(tzn + 1, D);
  const bool fwd = dirf > 0.0f;
  const float* far_z = fwd ? c.m_z() : c.p_z();
  const float* far_v = fwd ? c.m_v() : c.p_v();
  const float* near_z = fwd ? c.p_z() : c.m_z();
  const float* near_v = fwd ? c.p_v() : c.m_v();
  float* lz_l = c.lz() + (size_t)row_l * d;
  float* lv_l = c.lv() + (size_t)row_l * d;
  float* mz_m = c.mz() + (size_t)row_m * d;
  float* mv_m = c.mv() + (size_t)row_m * d;
  const float* b0_z = c.lz() + (size_t)D * d;
  const float* b0_v = c.lv() + (size_t)D * d;

  // sums: the prior (the group form; 0 otherwise), v2.v2, z1.v2, then the
  // top-level dots as ld_leapfrog's
  float s[LD_NRED];
  slot_sums(
      d,
      [&](int j, float (&t)[LD_NRED]) {
        const float sd = c.stds()[j];
        const float v1 = c.v2()[j];
        const float z1 = c.z1()[j];
        float g1;
        if constexpr (Model::GROUP) {
          const float q = q1[j];
          g1 = model.grad(gs, cb, j, q);
          t[0] = model.prior_term(q);
        } else {
          g1 = c.zg1()[j];
          t[0] = 0.0f;
        }
        const float zg1 = g1 * sd;
        const float v2 = v1 + half * zg1;
        c.v2()[j] = v2;
        c.zg1()[j] = zg1;
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
          t[9] = b0_z[j] * fv;  // row D holds this leaf when leaf == 0
          t[10] = fz * b0_v[j];
        } else {
          t[6] = t[7] = t[8] = t[9] = t[10] = 0.0f;
        }
      },
      s);

  LdLeap out;
  if constexpr (Model::GROUP)
    out.logp1 = model.finish(gs, G, cb, s[0]);
  else
    out.logp1 = logp_team;
  out.ke1 = 0.5f * s[1];
  out.d1 = s[2];
  const float d1 = out.d1;
  // every lane writes the same value and reads only its own writes
  c.bl()[row_l] = d1;
  c.bm()[row_m] = d1;

  const bool t_out = turn2(dirf, s[4], s[3], d1, s[5]);
  out.turning_top =
      t_out || (depth > 0 && (turn2(dirf, s[7], s[6], d1, s[8]) ||
                              turn2(dirf, s[9], s[3], c.bl()[D], s[10])));

  // internal checks: static levels 1 <= j < tzn, then the boundary level
  bool turning = false;
  for (int lev = 1; lev < tzn; ++lev) {
    const float* lzj = c.lz() + (size_t)lev * d;
    const float* lvj = c.lv() + (size_t)lev * d;
    const float* lzk = c.lz() + (size_t)(lev - 1) * d;
    const float* lvk = c.lv() + (size_t)(lev - 1) * d;
    if (lev >= 2) {
      const float* mzj = c.mz() + (size_t)lev * d;
      const float* mvj = c.mv() + (size_t)lev * d;
      const float* const a[6] = {c.z1(), lzj, c.z1(), mzj, lzk, lzj};
      const float* const b[6] = {lvj, c.v2(), mvj, c.v2(), lvj, lvk};
      float r[6];
      gr_dots<6>(c, a, b, r);
      turning = turning || turn2(dirf, r[0], c.bl()[lev], d1, r[1]) ||
                turn2(dirf, r[2], c.bm()[lev], d1, r[3]) ||
                turn2(dirf, r[4], c.bl()[lev], c.bl()[lev - 1], r[5]);
    } else {
      const float* const a[2] = {c.z1(), lzj};
      const float* const b[2] = {lvj, c.v2()};
      float r[2];
      gr_dots<2>(c, a, b, r);
      turning = turning || turn2(dirf, r[0], c.bl()[lev], d1, r[1]);
    }
  }
  if (tzn >= 1) {
    const int ra = min(tz(leaf + 1 - (1 << tzn), D), D);
    const float a_b = c.bl()[ra];
    const float* lza = c.lz() + (size_t)ra * d;
    const float* lva = c.lv() + (size_t)ra * d;
    if (tzn >= 2) {
      const int rb = tzn - 1;
      const float* mzt = c.mz() + (size_t)tzn * d;
      const float* mvt = c.mv() + (size_t)tzn * d;
      const float* lzb = c.lz() + (size_t)rb * d;
      const float* lvb = c.lv() + (size_t)rb * d;
      const float* const a[6] = {c.z1(), lza, c.z1(), mzt, lzb, lza};
      const float* const b[6] = {lva, c.v2(), mvt, c.v2(), lva, lvb};
      float r[6];
      gr_dots<6>(c, a, b, r);
      turning = turning || turn2(dirf, r[0], a_b, d1, r[1]) ||
                turn2(dirf, r[2], c.bm()[tzn], d1, r[3]) ||
                turn2(dirf, r[4], a_b, c.bl()[rb], r[5]);
    } else {
      const float* const a[2] = {c.z1(), lza};
      const float* const b[2] = {lva, c.v2()};
      float r[2];
      gr_dots<2>(c, a, b, r);
      turning = turning || turn2(dirf, r[0], a_b, d1, r[1]);
    }
  }
  out.turning_int = ablate_keep(turning);
  out.turning_top = ablate_keep(out.turning_top);
  return out;
}

// The shared memory of a block of G chains, in floats: the group form's
// scratch, the chain flags, the chains' parked scalars (the group form),
// then G chain parts of `nvec` live vectors, the two cached-dot rows and a
// team functor's scratch, each part a multiple of 4 floats (16-byte
// aligned for the group form's loads).
template <class Model>
__host__ __device__ size_t gr_group_floats(const Model& m, int G) {
  if constexpr (Model::GROUP)
    return (m.group_floats(G) + 3) & ~(size_t)3;
  else
    return 0;
}

template <class Model>
__host__ __device__ size_t gr_chain_floats(const Model& m, int nvec, int d,
                                           int D) {
  size_t f = (size_t)nvec * d + 2 * (size_t)(D + 1);
  if constexpr (!Model::GROUP) f += m.scratch_floats();
  return (f + 3) & ~(size_t)3;
}

// the chains' loop-carried scalars while the group form runs: GR_MAX slots
// of GR_SCALAR_FLOATS floats (the larger of the two kernels' sets)
constexpr int GR_SCALAR_FLOATS = 64;

template <class Model>
__host__ __device__ size_t gr_scalar_floats(const Model&) {
  if constexpr (Model::GROUP)
    return (size_t)GR_MAX * GR_SCALAR_FLOATS;
  else
    return 0;
}

template <class Model>
__host__ __device__ long long gr_block_bytes(const Model& m, int nvec, int d,
                                             int D, int G) {
  return 4 * (long long)(gr_group_floats(m, G) + GR_FLAG_FLOATS +
                         gr_scalar_floats(m) +
                         (size_t)G * gr_chain_floats(m, nvec, d, D));
}

// The rule for G: the most chains a block, a power of two up to GR_MAX,
// whose shared memory fits the opt-in; 0 where one chain does not fit
// (_build.mid_group).
template <class Model>
__host__ __device__ int gr_chains(const Model& m, int nvec, int d, int D) {
  for (int G = GR_MAX; G >= 1; G /= 2)
    if (gr_block_bytes(m, nvec, d, D, G) <= GR_SMEM_OPT_IN) return G;
  return 0;
}

// A launch's G is the rule's or smaller, a power of two, a multiple of B.
template <class Model>
inline bool gr_valid(const Model& m, int nvec, int d, int D, int B, int G) {
  return G >= 1 && G <= GR_MAX && (G & (G - 1)) == 0 && B >= 1 &&
         G % B == 0 && gr_block_bytes(m, nvec, d, D, G) <= GR_SMEM_OPT_IN;
}

// Launch ceil(C / G) blocks of LD_T threads, no cluster.
template <class Kernel, class Args, class Model>
cudaError_t gr_launch(Kernel kernel, const Args& a, const Model& model, int C,
                      int B, int G, long long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(C + G - 1) / G, LD_T, (size_t)smem, stream>>>(a, model, B, G);
  return cudaGetLastError();
}

}  // namespace nrt
