// Per-draw diagonal adaptation of the fused warmup kernels (K2 and K4).
//
// Device twin of nuts_rs_tpu_torch/kernels/diag_adapt.py::adapt_draw: the
// fg/bg Welford estimators, the window switch and the diagonal mass-matrix
// rule that the Pallas warmup bodies inline
// (nuts_rs_tpu/kernels/nuts_pallas.py:1399-1450, mclmc_pallas.py:785-842),
// with the plain version's order of operations.  The *_coord functions handle
// one coordinate; the chains-on-lanes kernels K2 and K4 (a chain's
// coordinates on a group of lanes) call them on each lane's slots in
// adapt_draw_lanes, the dim-on-lanes and mid-d warmup kernels on each
// thread's own coordinates, with logdet summed by their block reductions.
#pragma once

#include <math.h>

#include "lanes.cuh"

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

// One draw of one chain whose coordinates lie on a group of T lanes
// (lanes.cuh), each lane with its slots of est, stds and mean: feed (q, g)
// to fg and bg where `inc`, switch windows, apply the diagonal rule
// (adapt_diag + set_diag); the new logdet = -sum log stds by the ordered
// gather.  Updates est, the counts, stds, mean and tid in place; T = 1 is
// one thread a chain.
template <int DIM, int T>
__device__ __forceinline__ float adapt_draw_lanes(
    float (*est)[slots<DIM, T>()], float& cnt_fg, float& cnt_bg, float& tid,
    float* stds, float* mean, const float* q, const float* g, bool inc,
    bool do_switch, bool do_update, bool use_grad_based, const Lane<T>& ln) {
  constexpr int NC = slots<DIM, T>();
  if (inc) {
    const float fg = cnt_fg + 1.0f, bg = cnt_bg + 1.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      add2_coord(est[0][i], est[1][i], fg, q[i]);
      add2_coord(est[2][i], est[3][i], fg, g[i]);
      add2_coord(est[4][i], est[5][i], bg, q[i]);
      add2_coord(est[6][i], est[7][i], bg, g[i]);
    }
  }
  cnt_fg = cnt_fg + (inc ? 1.0f : 0.0f);
  cnt_bg = cnt_bg + (inc ? 1.0f : 0.0f);
  if (do_switch) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        est[p][i] = est[p + 4][i];
        est[p + 4][i] = 0.0f;
      }
    cnt_fg = cnt_bg;
    cnt_bg = 0.0f;
  }

  const bool enough = do_update && cnt_fg >= 3.0f;
  float l[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (enough)
      diag_rule_coord(est[0][i], est[1][i], est[2][i], est[3][i], cnt_fg,
                      use_grad_based, stds[i], mean[i]);
    l[i] = logf(stds[i]);
  }
  tid = tid + (enough ? 1.0f : 0.0f);
  return -ordered_sum<DIM, T>(l, ln);
}

}  // namespace nrt
