// Model functors compiled into the fused kernels (Model.kernel_hook).
//
// Counterpart of the batched logp/grad that the Pallas kernels trace in
// (nuts_rs_tpu/chain.py:677-690), and of the arrays their model_args
// channel replicates to every block (nuts_pallas.py:84,159-166).  A functor
// has up to three forms.
//
// eval: one thread evaluates one chain (the thread-per-chain
// chains-on-lanes kernels); it computes logp at q and writes the gradient
// into g, summing in coordinate order.
//
// term / finish: the threads of a block share one chain and every gradient
// coordinate depends on its own position coordinate alone (the dim-on-lanes
// kernels, chain.py:805-807); term gives one coordinate's gradient and its
// summand of logp, the block sums the summands in its fixed order
// (block_sum.cuh::Reducer), and finish turns the sum into logp.
//
// eval_block: the LD_T threads of a block evaluate one chain
// together from the whole position vector in shared memory; a gradient
// coordinate may need all of q, and the functor may hold device pointers to
// the model's data (the mid-d chains-on-lanes kernels, nuts_fused_mid_*.cu,
// take only this form).  q and g are d floats of shared memory; the caller has
// put a __syncthreads between the last write of q and the call; thread t
// writes g[j] for its own coordinates j = t, t + LD_T, ... and reads only
// those after the call; every thread returns logp.  `scratch` is
// scratch_floats() floats of shared memory that belong to the functor from
// one call to the next.
//
// The plain versions' closed forms take the same orders
// (nuts_rs_tpu_torch/models/gaussian.py with ops.dsum / ops.tsum).
#pragma once

#include <stddef.h>

#include "block_sum.cuh"
#include "nuts_tree.cuh"

namespace nrt {

// Model ids, as _build.MODEL_IDS names them.
enum ModelId { MODEL_IID_NORMAL = 0, MODEL_LOGISTIC_REGRESSION = 1 };

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

  __host__ __device__ size_t scratch_floats() const { return 0; }

  __device__ __forceinline__ float eval_block(const float* q, float* g, int d,
                                              Reducer& red, float*) const {
    float s[1];
    const int n = (d + LD_T - 1) / LD_T;
    for (int i = 0; i < n; ++i) {
      const int j = threadIdx.x + i * LD_T;
      float sq = 0.0f;
      if (j < d) {
        const float diff = q[j] - mu;
        g[j] = -diff;
        sq = diff * diff;
      }
      acc(s[0], i, sq);
    }
    red.sum(s);
    return -0.5f * s[0];
  }
};

// Bayesian logistic regression with a standard-normal prior
// (nuts_rs_tpu/models/gaussian.py:149-180), the data x [N, d] and y [N] in
// device memory:
//   logits = x q,  logp = sum_n (y logits - logaddexp(0, logits)) - 0.5 q.q,
//   p = 1 / (1 + exp(-logits)),  grad = x^T (y - p) - q.
// x is held transposed, xt [d, N], so that a thread that owns rows n reads
// neighbouring addresses with its warp mates in both products.
//
// Thread t owns the rows n = t, t + LD_T, ...  First product: a row's logit
// is the sum over j = 0..d-1 in ascending order (ops.dsum), by its one
// thread; the thread keeps its rows' y - p in scratch.  Second product: for
// each column j the rows' terms xt[j][n] (y - p)[n] are summed in the block
// order (ops.tsum over n): the thread's rows in ascending order, the warp's
// butterfly, and the LD_W warp sums halved by the thread that owns
// coordinate j, after the barrier of the one Reducer call that also sums
// the log-likelihood (tsum over n) and the prior (tsum over j).
//
// Both products wait for L2 and not for arithmetic, so a thread keeps many
// loads in flight: GLM_R of its rows advance together through the columns
// of the first product, and GLM_J columns share one pass over its rows and
// one butterfly in the second.  Neither changes the order of any sum.
constexpr int GLM_R = 4;  // rows of a thread in flight in the first product
constexpr int GLM_J = 8;  // columns of one pass over the rows in the second

struct LogisticRegression {
  const float* xt;  // [d, N]
  const float* y;   // [N]
  int N, d;

  // (y - p) per row, then LD_W warp partials per column
  __host__ __device__ size_t scratch_floats() const {
    return (size_t)N + (size_t)LD_W * d;
  }

  __device__ __forceinline__ float eval_block(const float* q, float* g, int,
                                              Reducer& red,
                                              float* scratch) const {
    float* r = scratch;         // [N]; entry n belongs to the row's thread
    float* part = scratch + N;  // [d][LD_W]
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int rows = (N + LD_T - 1) / LD_T;
    float s[2];  // log-likelihood terms, prior terms
    // GLM_R rows of a thread advance together through the columns, so that
    // their loads are in flight at once; a row past the end reads row 0 and
    // its value is dropped.  Each logit still sums its terms in ascending j.
    for (int i0 = 0; i0 < rows; i0 += GLM_R) {
      int nc[GLM_R];
      bool in[GLM_R];
      float logit[GLM_R];
#pragma unroll
      for (int k = 0; k < GLM_R; ++k) {
        const int n = t + (i0 + k) * LD_T;
        in[k] = n < N;
        nc[k] = in[k] ? n : 0;
        logit[k] = xt[nc[k]] * q[0];
      }
#pragma unroll 8
      for (int j = 1; j < d; ++j) {
        const float* col = xt + (size_t)j * N;
        const float qj = q[j];
#pragma unroll
        for (int k = 0; k < GLM_R; ++k) logit[k] = logit[k] + col[nc[k]] * qj;
      }
#pragma unroll
      for (int k = 0; k < GLM_R; ++k) {
        if (i0 + k >= rows) break;
        float term = 0.0f;
        if (in[k]) {
          const float yn = y[nc[k]];
          term = yn * logit[k] - logaddexp(0.0f, logit[k]);
          const float p = 1.0f / (1.0f + expf(-logit[k]));
          r[nc[k]] = yn - p;
        }
        acc(s[0], i0 + k, term);
      }
    }
    const int nd = (d + LD_T - 1) / LD_T;
    for (int i = 0; i < nd; ++i) {
      const int j = t + i * LD_T;
      acc(s[1], i, j < d ? q[j] * q[j] : 0.0f);
    }
    // GLM_J columns share one pass over the thread's rows and one butterfly;
    // a column past the end repeats the last one and is not stored.
    for (int j0 = 0; j0 < d; j0 += GLM_J) {
      const float* col[GLM_J];
#pragma unroll
      for (int k = 0; k < GLM_J; ++k)
        col[k] = xt + (size_t)min(j0 + k, d - 1) * N;
      float c[GLM_J];
      for (int i = 0; i < rows; ++i) {
        const int n = t + i * LD_T;
        const bool in = n < N;
        const int nn = in ? n : 0;
        const float rn = in ? r[nn] : 0.0f;
#pragma unroll
        for (int k = 0; k < GLM_J; ++k)
          acc(c[k], i, in ? col[k][nn] * rn : 0.0f);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < GLM_J; ++k)
          c[k] = c[k] + __shfl_xor_sync(0xffffffffu, c[k], o);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < GLM_J; ++k)
          if (j0 + k < d) part[(j0 + k) * LD_W + warp] = c[k];
      }
    }
    red.sum(s);  // its barrier also publishes `part`
    for (int i = 0; i < nd; ++i) {
      const int j = t + i * LD_T;
      if (j < d) g[j] = halve_warps(part + j * LD_W) - q[j];
    }
    return s[0] - 0.5f * s[1];
  }
};

// Host side of the eval_block form: build the functor `model_id` names from
// the kernel hook's floats, the device pointers of its tensors and their
// sizes (Model.kernel_hook, _build.MODEL_IDS) and hand it to fn.
template <class Fn>
inline cudaError_t with_block_model(int model_id, const float* params,
                                    const void* const* ptrs, const int* ints,
                                    Fn&& fn) {
  switch (model_id) {
    case MODEL_IID_NORMAL:
      return fn(IidNormal{params[0]});
    case MODEL_LOGISTIC_REGRESSION:
      return fn(LogisticRegression{static_cast<const float*>(ptrs[0]),
                                   static_cast<const float*>(ptrs[1]),
                                   ints[0], ints[1]});
  }
  return cudaErrorInvalidValue;
}

}  // namespace nrt
