// Model functors compiled into the fused kernels (Model.kernel_hook).
//
// Counterpart of the batched logp/grad that the Pallas kernels trace in
// (nuts_rs_tpu/chain.py:677-690); here one thread evaluates one chain.
// A functor computes logp at q and writes the gradient into g.  Sums run in
// coordinate order, as the plain versions' closed forms do
// (nuts_rs_tpu_torch/models/gaussian.py).
#pragma once

namespace nrt {

// Model ids, as _build.MODEL_IDS names them.
enum ModelId { MODEL_IID_NORMAL = 0 };

// iid Normal(mu, 1): logp = -0.5 sum (q - mu)^2, grad = -(q - mu).
struct IidNormal {
  float mu;

  template <int DIM>
  __device__ __forceinline__ float eval(const float* q, float* g) const {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float diff = q[j] - mu;
      const float sq = diff * diff;
      s = (j == 0) ? sq : s + sq;
      g[j] = -diff;
    }
    return -0.5f * s;
  }
};

}  // namespace nrt
