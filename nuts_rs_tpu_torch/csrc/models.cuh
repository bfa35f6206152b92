// Model functors compiled into the fused kernels (Model.kernel_hook).
//
// Counterpart of the batched logp/grad that the Pallas kernels trace in
// (nuts_rs_tpu/chain.py:677-690).  A functor has two forms.  eval: one
// thread evaluates one chain (the chains-on-lanes kernels); it computes
// logp at q and writes the gradient into g, summing in coordinate order.
// term / finish: the threads of a block share one chain (the dim-on-lanes
// kernels, chain.py:805-807); term gives one coordinate's gradient and its
// summand of logp, the block sums the summands in its fixed order
// (nuts_tree_ld.cuh::Reducer), and finish turns the sum into logp.  The
// plain versions' closed forms take the same orders
// (nuts_rs_tpu_torch/models/gaussian.py with ops.dsum / ops.tsum).
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

  __device__ __forceinline__ float term(float q, float& g) const {
    const float diff = q - mu;
    g = -diff;
    return diff * diff;
  }

  __device__ __forceinline__ float finish(float s) const { return -0.5f * s; }
};

}  // namespace nrt
