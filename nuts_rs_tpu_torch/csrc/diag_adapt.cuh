// Per-draw diagonal adaptation of the fused warmup kernels (K2 and K4).
//
// Device twin of nuts_rs_tpu_torch/kernels/diag_adapt.py::adapt_draw: the
// fg/bg Welford estimators, the window switch and the diagonal mass-matrix
// rule that the Pallas warmup bodies inline
// (nuts_rs_tpu/kernels/nuts_pallas.py:1399-1450, mclmc_pallas.py:785-842),
// one thread per chain, with the plain version's order of operations.
#pragma once

#include <math.h>

namespace nrt {

constexpr int NEST = 8;  // fg draw mean/var, fg grad mean/var, bg x4

// mass_matrix.py::add_sample on one plane pair, gated on `inc`.
template <int DIM>
__device__ __forceinline__ void add2(float* mean_p, float* var_p,
                                     float cnt_old, bool inc,
                                     const float* value) {
  if (!inc) return;
  const float cnt = cnt_old + 1.0f;
  const bool first1 = cnt == 1.0f;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    const float diffv = value[j] - mean_p[j];
    const float meann = first1 ? value[j] : mean_p[j] + diffv / fmaxf(cnt, 1.0f);
    var_p[j] = var_p[j] + (first1 ? 0.0f : diffv * diffv);
    mean_p[j] = meann;
  }
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
    if (enough) {
      const float val = use_grad_based
                            ? sqrtf(est[1][j] / est[3][j])
                            : est[1][j] * (1.0f / fmaxf(cnt_fg, 1.0f));
      const bool invalid = !isfinite(val) || val == 0.0f;
      float var = fminf(fmaxf(val, 1e-20f), 1e20f);
      if (invalid) var = stds[j] * stds[j];
      const float new_mean =
          use_grad_based ? est[0][j] + var * est[2][j] : est[0][j];
      stds[j] = sqrtf(var);
      mean[j] = new_mean;
    }
    const float l = logf(stds[j]);
    logdet = (j == 0) ? l : logdet + l;
  }
  tid = tid + (enough ? 1.0f : 0.0f);
  return -logdet;
}

}  // namespace nrt
