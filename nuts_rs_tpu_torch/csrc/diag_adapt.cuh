// Per-draw diagonal adaptation of the fused warmup kernels (K2 and K4).
//
// Device twin of nuts_rs_tpu_torch/kernels/diag_adapt.py::adapt_draw: the
// fg/bg Welford estimators, the window switch and the diagonal mass-matrix
// rule that the Pallas warmup bodies inline
// (nuts_rs_tpu/kernels/nuts_pallas.py:1399-1450, mclmc_pallas.py:785-842),
// with the plain version's order of operations.  The *_coord functions handle
// one coordinate; the chains-on-lanes kernels (one thread per chain) loop
// them over d in adapt_draw, the dim-on-lanes warmup kernel
// (nuts_fused_ld_warmup.cu) calls them on each thread's own coordinates and
// sums logdet through its block reduction.
#pragma once

#include <math.h>

namespace nrt {

constexpr int NEST = 8;  // fg draw mean/var, fg grad mean/var, bg x4

// mass_matrix.py::add_sample on one coordinate of a plane pair; the caller
// gates on `inc`.  cnt is the count after the sample.
__device__ __forceinline__ void add2_coord(float& mean_p, float& var_p,
                                           float cnt, float value) {
  const bool first1 = cnt == 1.0f;
  const float diffv = value - mean_p;
  const float meann = first1 ? value : mean_p + diffv / fmaxf(cnt, 1.0f);
  var_p = var_p + (first1 ? 0.0f : diffv * diffv);
  mean_p = meann;
}

// The diagonal rule on one coordinate (adapt_diag + set_diag): fg draw
// mean/var dm/dv, fg grad mean/var gm/gv after the draw (and the switch).
__device__ __forceinline__ void diag_rule_coord(float dm, float dv, float gm,
                                                float gv, float cnt_fg,
                                                bool use_grad_based,
                                                float& stds, float& mean) {
  const float val = use_grad_based ? sqrtf(dv / gv)
                                   : dv * (1.0f / fmaxf(cnt_fg, 1.0f));
  const bool invalid = !isfinite(val) || val == 0.0f;
  float var = fminf(fmaxf(val, 1e-20f), 1e20f);
  if (invalid) var = stds * stds;
  const float new_mean = use_grad_based ? dm + var * gm : dm;
  stds = sqrtf(var);
  mean = new_mean;
}

// add_sample on one plane pair of one chain, gated on `inc`.
template <int DIM>
__device__ __forceinline__ void add2(float* mean_p, float* var_p,
                                     float cnt_old, bool inc,
                                     const float* value) {
  if (!inc) return;
  const float cnt = cnt_old + 1.0f;
#pragma unroll
  for (int j = 0; j < DIM; ++j) add2_coord(mean_p[j], var_p[j], cnt, value[j]);
}

// One draw: feed (q, g) to fg and bg where `inc`, switch windows, apply the
// diagonal rule (adapt_diag + set_diag).  Updates est, the counts, stds,
// mean and tid in place; returns the new logdet = -sum log stds.
template <int DIM>
__device__ __forceinline__ float adapt_draw(
    float (*est)[DIM], float& cnt_fg, float& cnt_bg, float& tid, float* stds,
    float* mean, const float* q, const float* g, bool inc, bool do_switch,
    bool do_update, bool use_grad_based) {
  add2<DIM>(est[0], est[1], cnt_fg, inc, q);
  add2<DIM>(est[2], est[3], cnt_fg, inc, g);
  add2<DIM>(est[4], est[5], cnt_bg, inc, q);
  add2<DIM>(est[6], est[7], cnt_bg, inc, g);
  cnt_fg = cnt_fg + (inc ? 1.0f : 0.0f);
  cnt_bg = cnt_bg + (inc ? 1.0f : 0.0f);
  if (do_switch) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        est[p][j] = est[p + 4][j];
        est[p + 4][j] = 0.0f;
      }
    cnt_fg = cnt_bg;
    cnt_bg = 0.0f;
  }

  const bool enough = do_update && cnt_fg >= 3.0f;
  float logdet = 0.0f;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    if (enough)
      diag_rule_coord(est[0][j], est[1][j], est[2][j], est[3][j], cnt_fg,
                      use_grad_based, stds[j], mean[j]);
    const float l = logf(stds[j]);
    logdet = (j == 0) ? l : logdet + l;
  }
  tid = tid + (enough ? 1.0f : 0.0f);
  return -logdet;
}

}  // namespace nrt
