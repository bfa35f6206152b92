// MCLMC pieces of the group form of the mid-d fused kernels K3-args and
// K4-args (mclmc_fused_group_posterior.cu, mclmc_fused_group_warmup.cu): G <=
// GR_MAX chains a CUDA block of LD_T threads, chain cb's microcanonical
// trajectory on warp cb, the regression evaluated by the whole block for
// its G chains.
//
// Counterpart of the ESH half step, the partial momentum refresh and the
// step-halving stack of nuts_rs_tpu/kernels/mclmc_pallas.py (:132-169,
// :202-282, repeated in make_mclmc_warmup_kernel :577-746) with the model
// evaluated as logp_grad_batched(q, *model_args) (:122-125); the 256
// threads-a-chain form is mclmc_step_block.cuh, the plain PyTorch version
// nuts_rs_tpu_torch/kernels/mclmc_fused.py (_esh, _refresh, _leapfrog_try)
// with the "mid" evaluators.
//
// - Lane l of a chain's warp stands for the LD_T / 32 virtual threads
//   l + 32 w of ops.tsum's order: it owns the coordinates j = l + 32 w +
//   LD_T i, that is every j with j % 32 == l, of the chain's MC_MID_NVEC
//   vectors in shared memory, and touches no other lane's coordinates
//   outside the model's evaluation.
// - A sum over the coordinates is lane_sums: each slot's terms in ascending
//   i, the 8 slots' warp butterflies at once (block_sum.cuh::warp_sums),
//   then the 8 slot sums halved across the lanes that hold them, in
//   halve_warps' tree: the bits of Reducer::sum in 12 shuffles and no
//   barrier.
// - Scalars (energies, the step factor, the halving stack, the counters,
//   the scalar random sites) are computed alike by every lane, so control
//   flow is uniform within a chain; every expression keeps the Pallas
//   grouping: gh = zg / gn before alpha = sum(v * gh),
//   log((1 + a) + (1 - a) z^2) for log1p, exp(x) - 1 for expm1, divisions by
//   float(d - 1) and float(d).
// A leapfrog try is split at the model's evaluation, the only step that
// crosses chains: mg_leap_first (the pre-step refresh, the first ESH half
// step, the new position, staged for the group form) and mg_leap_second
// (the gradient, the second half step, the energy check, the post-step
// refresh); between them the block evaluates the regression's group form
// (models.cuh::LogisticRegression::eval_group) for its G chains.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "mclmc_step.cuh"       // McConst, num_steps_for, MAX_HALVINGS, MC_*
#include "models.cuh"           // LogisticRegression
#include "nuts_tree_group.cuh"  // GR_MAX, gr_group_floats, gr_launch, ...
#include "rng.cuh"

namespace nrt {

// live vectors of a chain in shared memory
constexpr int MC_MID_NVEC = 15;

// NRT_ABLATE_FIXED_STEPS, a build-time switch for timing ablations only
// (profile_main_path.py item 14; it changes results): every draw takes
// MG_ABLATE_STEPS leapfrogs and no energy check halves the step.
// NRT_ABLATE_EVAL leaves the model's evaluation out.
#ifdef NRT_ABLATE_FIXED_STEPS
constexpr int MG_ABLATE_STEPS = 6;
__device__ __forceinline__ int mg_num_steps(float, const McConst&) {
  return MG_ABLATE_STEPS;
}
#else
__device__ __forceinline__ int mg_num_steps(float step, const McConst& k) {
  return num_steps_for(step, k);
}
#endif

// tsum of N values over a chain's d coordinates on its warp: term(j, t)
// gives the N terms of coordinate j < d, each called once.  Lane l's slot w
// adds the terms of j = l + 32 w + LD_T i in ascending i (0.0 past d);
// warp_sums butterflies the 8 slots at once and leaves in lane L the warp
// sum of slot ((L >> 2) & 7) with its bits reversed, w = 4 b4 + 2 b3 + b2
// of L; the shuffles across lane bits 4, 3 and 2 then add slot w to w + 4,
// w to w + 2 and w to w + 1, as halve_warps does (IEEE addition commutes).
// Every lane gets every sum.
template <int N, class F>
__device__ __forceinline__ void lane_sums(int d, F&& term, float (&out)[N]) {
  static_assert(GR_SLOTS == 8, "the halvings below are LD_W = 8's");
  const int lane = threadIdx.x & 31;
  const int n = (d + LD_T - 1) / LD_T;
  float p[N][GR_SLOTS];
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int w = 0; w < GR_SLOTS; ++w) {
      const int j = lane + 32 * w + LD_T * i;
      float t[N];
      if (j < d) {
        term(j, t);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) t[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) acc(p[k][w], i, t[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    warp_sums(p[k]);
    float x = p[k][0];
    x = x + __shfl_xor_sync(0xffffffffu, x, 16);
    x = x + __shfl_xor_sync(0xffffffffu, x, 8);
    x = x + __shfl_xor_sync(0xffffffffu, x, 4);
    out[k] = x;
  }
}

// One chain's vectors from one base pointer, so that the registers hold one
// address and not 15: MC_MID_NVEC vectors of d floats in shared memory.
struct MgChain {
  float* sm;
  int d;

  __device__ __forceinline__ float* vec(int k) const { return sm + k * d; }
  __device__ __forceinline__ float* stds() const { return vec(0); }
  __device__ __forceinline__ float* mean() const { return vec(1); }
  __device__ __forceinline__ float* z() const { return vec(2); }
  __device__ __forceinline__ float* v() const { return vec(3); }
  __device__ __forceinline__ float* zg() const { return vec(4); }
  __device__ __forceinline__ float* noise() const { return vec(5); }
  __device__ __forceinline__ float* z0() const { return vec(6); }
  __device__ __forceinline__ float* zg0() const { return vec(7); }
  __device__ __forceinline__ float* vr() const { return vec(8); }
  __device__ __forceinline__ float* v1() const { return vec(9); }
  __device__ __forceinline__ float* z1() const { return vec(10); }
  __device__ __forceinline__ float* q1() const { return vec(11); }
  __device__ __forceinline__ float* zg1() const { return vec(12); }
  __device__ __forceinline__ float* v2() const { return vec(13); }
  __device__ __forceinline__ float* gh() const { return vec(14); }
};

// One chain's trajectory scalars, the same in every lane of its warp.
struct MgTraj {
  float logp, ke;
  int rem;       // steps left at the current factor
  float factor;  // step factor, a power of 2
  int ssize;     // halving-stack depth
  int stack[MAX_HALVINGS];
  int steps;     // successful leapfrogs of the draw
  float ttime;   // integrated time of the draw
};

// What a leapfrog try carries across the evaluation.
struct MgHalf {
  float base;  // the pre-step energy, ke_r - (logp + logdet)
  float ke1;   // the kinetic energy after the first ESH half step
};

__device__ __forceinline__ void mg_start(MgTraj& s, int nsd) {
  s.rem = nsd;
  s.factor = 1.0f;
  s.ssize = 0;
  s.steps = 0;
  s.ttime = 0.0f;
}

// a[j] = a[j] / x on the lane's coordinates.
__device__ __forceinline__ void mg_divide(const MgChain& c, float* a,
                                          float x) {
  for (int j = gr_lane(); j < c.d; j += 32) a[j] = a[j] / x;
}

// the vector random site of coordinate j of chain b of a logical block of B
__device__ __forceinline__ uint32_t mg_site(int j, int b, int B) {
  return (uint32_t)j * (uint32_t)B + (uint32_t)b;
}

// ESH momentum half-step (math.rs:188-204) with gn2 = sum(zg * zg) given:
// writes the new unit momentum to out and returns the kinetic-energy change.
__device__ __forceinline__ float mg_esh(const MgChain& c, const float* zg,
                                        const float* v, float gn2, float step,
                                        float* out) {
  const float dm1 = (float)(c.d - 1);
  const float gn = sqrtf(gn2);
  float* gh = c.gh();
  float a[1];
  lane_sums(c.d, [&](int j, float (&t)[1]) {
    const float g = zg[j] / gn;
    gh[j] = g;
    t[0] = v[j] * g;
  }, a);
  const float alpha = a[0];
  const float delta = step * gn / dm1;
  const float zeta = expf(-delta);
  const float cg = (1.0f - zeta) * (1.0f + zeta + alpha * (1.0f - zeta));
  const float tz2 = 2.0f * zeta;
  float n2[1];
  lane_sums(c.d, [&](int j, float (&t)[1]) {
    const float vr = cg * gh[j] + tz2 * v[j];
    out[j] = vr;
    t[0] = vr * vr;
  }, n2);
  mg_divide(c, out, sqrtf(n2[0]));
  return (delta - (float)0.69314718055994530942 +
          logf((1.0f + alpha) + (1.0f - alpha) * zeta * zeta)) *
         dm1;
}

// The first part of a leapfrog try (mclmc.rs:274-359) up to the model's
// evaluation: the pre-step refresh with the carried noise into vr, the
// first ESH half step, z1 and the new position q1 with its staged copy in
// chain cb's slot of gs.
template <class Model>
__device__ __forceinline__ MgHalf mg_leap_first(const MgChain& c,
                                                const MgTraj& s,
                                                const Model& model, float* gs,
                                                int cb, float step, float ld,
                                                const McConst& k) {
  const int d = c.d;
  const float eps = step * s.factor;
  const float half = eps / 2.0f;
  float* vr = c.vr();
  const float nu = sqrtf((expf(2.0f * half / k.ell) - 1.0f) / (float)d);
  float r[2];  // |vr|^2, |zg|^2 (the first ESH half step's)
  lane_sums(d, [&](int j, float (&t)[2]) {
    const float x = c.v()[j] + nu * c.noise()[j];
    vr[j] = x;
    t[0] = x * x;
    t[1] = c.zg()[j] * c.zg()[j];
  }, r);
  mg_divide(c, vr, sqrtf(r[0]));
  MgHalf h;
  h.base = s.ke - (s.logp + ld);
  h.ke1 = s.ke + mg_esh(c, c.zg(), vr, r[1], k.sqrt_n * eps / 2.0f, c.v1());
  const float es = eps * k.sqrt_n;
  for (int j = gr_lane(); j < d; j += 32) {
    const float z1 = c.z()[j] + es * c.v1()[j];
    c.z1()[j] = z1;
    const float q = z1 * c.stds()[j] + c.mean()[j];
    c.q1()[j] = q;
    model.stage(gs, cb, j, q);
  }
  return h;
}

// The rest of the try after the evaluation: the gradient and logp are read
// from the group form's sums in gs (chain cb of G), the prior's terms
// joining the first reduction.  Then the energy check with the halving
// stack of depth H (0 without the dynamic step size); on success the
// post-step refresh (noise at salts salt, salt+1) and the next noise
// (salt+2, salt+3) at (seed, it), and the stack unwinds; on a divergence
// the state stays at its pre-refresh values, the factor halves and the
// remaining count is pushed, or, with the stack full, the draw gives up.
// Returns MC_CONTINUE, MC_DONE (remaining count reached 0) or MC_GAVE_UP,
// the same in every lane.
template <class Model>
__device__ __forceinline__ int mg_leap_second(
    int H, const MgChain& c, MgTraj& s, const MgHalf& h, const Model& model,
    const float* gs, int G, int cb, float step, int nsd, float ld,
    const McConst& k, uint32_t seed, uint32_t it, uint32_t salt, int b,
    int B) {
  const int d = c.d;
  const float f = s.factor;
  const float eps = step * f;
  const float half = eps / 2.0f;
  float* zg1 = c.zg1();

  float r[2];  // |zg1|^2, the prior's q.q
  lane_sums(d, [&](int j, float (&t)[2]) {
    const float q = c.q1()[j];
    const float x = model.grad(gs, cb, j, q) * c.stds()[j];
    zg1[j] = x;
    t[0] = x * x;
    t[1] = model.prior_term(q);
  }, r);
  const float logp1 = model.finish(gs, G, cb, r[1]);
  const float ke2 = h.ke1 + mg_esh(c, zg1, c.v1(), r[0],
                                   k.sqrt_n * eps / 2.0f, c.v2());
  const float err = (ke2 - (logp1 + ld)) - h.base;
  const float max_err_step = (k.max_err / (float)nsd) * f;
  bool bad = fabsf(err) >= max_err_step || !isfinite(err);
#ifdef NRT_ABLATE_FIXED_STEPS
  bad = false;
#endif
  if (bad) {
    if (s.ssize >= H) return MC_GAVE_UP;
    s.stack[s.ssize] = s.rem;
    s.rem = 2;
    s.factor = f * 0.5f;
    s.ssize += 1;
    return MC_CONTINUE;
  }

  // ---- success: the post-step refresh into v, the new point, next noise ----
  const float nu = sqrtf((expf(2.0f * half / k.ell) - 1.0f) / (float)d);
  float r3[1];
  lane_sums(d, [&](int j, float (&t)[1]) {
    const uint32_t site = mg_site(j, b, B);
    const float x = c.v2()[j] + nu * normal(seed, it, salt, salt + 1u, site);
    c.v()[j] = x;
    t[0] = x * x;
    c.z()[j] = c.z1()[j];
    c.zg()[j] = zg1[j];
    c.noise()[j] = normal(seed, it, salt + 2u, salt + 3u, site);
  }, r3);
  mg_divide(c, c.v(), sqrtf(r3[0]));
  s.ke = ke2;
  s.logp = logp1;
  s.rem -= 1;
  s.steps += 1;
  s.ttime = s.ttime + f * step;
  while (s.rem == 0 && s.ssize > 0) {
    s.rem = s.stack[s.ssize - 1] - 1;
    s.factor = s.factor * 2.0f;
    s.ssize -= 1;
  }
  return s.rem == 0 ? MC_DONE : MC_CONTINUE;
}

// The momentum a give-up draw emits, into v: fresh normals at (salt,
// salt+1) on the unit sphere.
__device__ __forceinline__ void mg_give_up_momentum(const MgChain& c,
                                                    uint32_t seed,
                                                    uint32_t it,
                                                    uint32_t salt, int b,
                                                    int B) {
  float s2[1];
  lane_sums(c.d, [&](int j, float (&t)[1]) {
    const float x = normal(seed, it, salt, salt + 1u, mg_site(j, b, B));
    c.v()[j] = x;
    t[0] = x * x;
  }, s2);
  mg_divide(c, c.v(), sqrtf(s2[0]));
}

// The shared memory of a block of G chains, in floats, as the kernels lay
// it out: the group form's scratch (gr_group_floats), the chain flags, the
// chains' parked scalars while the group form runs (gr_scalar_floats), then
// G chain parts of MC_MID_NVEC vectors, each a multiple of 4 floats.
__host__ __device__ inline size_t mg_chain_floats(int d) {
  return ((size_t)MC_MID_NVEC * d + 3) & ~(size_t)3;
}

template <class Model>
__host__ __device__ long long mg_block_bytes(const Model& m, int d, int G) {
  static_assert(Model::GROUP, "the group form's functor");
  return 4 * (long long)(gr_group_floats(m, G) + GR_FLAG_FLOATS +
                         gr_scalar_floats(m) + (size_t)G * mg_chain_floats(d));
}

// The rule for G: the most chains a block, a power of two up to GR_MAX,
// whose shared memory fits the opt-in; 0 where one chain does not fit
// (_build.mclmc_mid_group).
template <class Model>
__host__ __device__ int mg_chains(const Model& m, int d) {
  for (int G = GR_MAX; G >= 1; G /= 2)
    if (mg_block_bytes(m, d, G) <= GR_SMEM_OPT_IN) return G;
  return 0;
}

// The regression's functor from the kernel hook's sizes (N, d) and device
// pointers (xt [d, N], y [N]; none for a layout query).
inline LogisticRegression group_model(const int* ints,
                                      const void* const* ptrs = nullptr) {
  return LogisticRegression{
      ptrs ? static_cast<const float*>(ptrs[0]) : nullptr,
      ptrs ? static_cast<const float*>(ptrs[1]) : nullptr, ints[0], ints[1]};
}

// A launch's G is the rule's or smaller, a power of two, a multiple of B.
template <class Model>
inline bool mg_valid(const Model& m, int d, int B, int G) {
  return G >= 1 && G <= GR_MAX && (G & (G - 1)) == 0 && B >= 1 &&
         G % B == 0 && mg_block_bytes(m, d, G) <= GR_SMEM_OPT_IN;
}

// The parts of one block's shared memory.
struct MgBlock {
  float* gs;      // the group form's
  int* flag;      // [GR_MAX]: with B > 1, what the chains of a logical
                  // block tell each other between iterations
  void* parked;   // [GR_MAX] slots of GR_SCALAR_FLOATS
  float* chains;  // G chain parts
};

template <class Model>
__device__ __forceinline__ MgBlock mg_block(float* smem, const Model& m,
                                            int G) {
  MgBlock o;
  o.gs = smem;
  o.flag = reinterpret_cast<int*>(smem + gr_group_floats(m, G));
  o.parked = smem + gr_group_floats(m, G) + GR_FLAG_FLOATS;
  o.chains =
      smem + gr_group_floats(m, G) + GR_FLAG_FLOATS + gr_scalar_floats(m);
  return o;
}

// True while a chain of the logical block of B chains that holds warp cb
// reports `mine` (flag slots of the G warps; one block barrier).
__device__ __forceinline__ bool mg_block_any(int* flag, int cb, int G, int B,
                                             bool mine) {
  if ((threadIdx.x & 31) == 0 && cb < G) flag[cb] = mine;
  __syncthreads();
  bool any = false;
  if (cb < G)
    for (int m = cb - cb % B; m < cb - cb % B + B; ++m)
      any = any || flag[m] != 0;
  return any;
}

}  // namespace nrt
