// The frozen coupling flow of kernel K1-flow: its forward pass, the model at
// the flow's output, and the backward pass that carries the model's gradient
// back to the flow's input, for the LD_T threads of a block that share one
// chain.
//
// Counterpart of the flow mode of nuts_rs_tpu/kernels/nuts_pallas.py::
// make_kernel (:106-113,202-216), whose eval_z differentiates
// flows/coupling.py::pallas_forward (:158-178) and the model with
// jax.value_and_grad.  Plain PyTorch version:
// nuts_rs_tpu_torch/flows/coupling.py::packed_forward / packed_backward.
//
// The packed parameters (PackedFlow, one set shared by every chain), per
// layer: mask [d], w1T [H][d], b1 [H], w2sT [d][H], b2s [d], w2tT [d][H],
// b2t [d]; then log_sigma [d] and mu [d].  Per layer, with S = max_scale,
// T = max_shift and m the mask:
//   h_k = tanh(sum_i w1T[k][i] (z m)_i + b1_k)                 thread k < H
//   s_i = (S tanh(rs_i / S)) (1 - m_i),  rs_i = sum_k w2sT[i][k] h_k + b2s_i
//   t_i = (T tanh(rt_i / T)) (1 - m_i),  rt_i = sum_k w2tT[i][k] h_k + b2t_i
//   z'_i = z_i m_i + (1 - m_i) (z_i e^{s_i} + t_i)             thread of i
// then q = e^{log sigma} z + mu, and the logdet is the sum over the
// coordinates of sacc_i = s_i of layer 0 + ... + s_i of layer L - 1 +
// log sigma_i.  The backward pass from gbar = e^{log sigma} g, layers in
// reverse:
//   gs_i = ((gbar_i z_i e^{s_i}) + 1) (1 - m_i) (1 - tanh_s_i^2)
//   gt_i = (gbar_i (1 - m_i)) (1 - tanh_t_i^2)
//   gpre_k = (sum_i w2sT[i][k] gs_i + sum_i w2tT[i][k] gt_i) (1 - h_k^2)
//   gbar_i <- gbar_i (m_i + (1 - m_i) e^{s_i}) + m_i sum_k w1T[k][i] gpre_k
// which leaves zg = d/dz [logp(F(z)) + logdet(z)].
//
// Sum orders (the plain version repeats them): every dot product by one
// thread, its terms in ascending order of the summed index, the first term
// starting the sum and the bias added after it; a layer's two head sums of
// the backward pass each whole, then added.  The logdet's sum over the
// coordinates is the caller's Reducer sum (ops.tsum's order).  tanh is
// ftanh below, exp is expf, divisions are IEEE (nvcc's default) and the
// kernels build with -fmad=false, so e^s and its product stay two roundings.
//
// Shared memory, after the model functor's scratch: the activations the
// backward pass reads, L x (4 d + H) floats (each layer's input z, e^s,
// tanh_s, tanh_t and h), four d-vectors (z m, gs, gt, sacc) and one
// H-vector (gpre), then, where they fit, the packed parameters (about
// 16 KB at d = 10, L = 4, H = 32); beyond that they are read through L2
// from global memory.  All of a pass's values by one thread, so the
// passes meet at two block barriers a layer each way.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "block_sum.cuh"

namespace nrt {

// tanh(x) = sign(x) (1 - e) / (1 + e), e = exp(-2 |x|): one definition from
// expf and IEEE arithmetic, shared with ops.py::tanh (CUDA's tanhf and
// torch.tanh need not round alike).
__device__ __forceinline__ float ftanh(float x) {
  const float e = expf(-2.0f * fabsf(x));
  return copysignf((1.0f - e) / (1.0f + e), x);
}

// Floats of one packed layer and of the whole packed flow.
__host__ __device__ inline size_t flow_layer_floats(int d, int H) {
  return 3 * (size_t)H * d + H + 3 * (size_t)d;
}
__host__ __device__ inline size_t flow_packed_floats(int d, int H, int L) {
  return L * flow_layer_floats(d, H) + 2 * (size_t)d;
}
// Shared-memory floats of the flow's work space (without the parameters).
__host__ __device__ inline size_t flow_work_floats(int d, int H, int L) {
  return (size_t)L * (4 * d + H) + 4 * (size_t)d + H;
}

// A model functor (its eval_block form) seen through a frozen coupling flow.
template <class Model>
struct CouplingFlowModel {
  Model inner;
  const float* w;  // the packed parameters in global memory
  int d, H, L;
  float max_scale, max_shift;
  int weights_in_smem;  // 1: copied into shared memory by setup()

  __host__ __device__ size_t scratch_floats() const {
    return inner.scratch_floats() + flow_work_floats(d, H, L) +
           (weights_in_smem ? flow_packed_floats(d, H, L) : 0);
  }

  __device__ __forceinline__ float* work(float* scratch) const {
    return scratch + inner.scratch_floats();
  }

  __device__ __forceinline__ const float* params(float* scratch) const {
    return weights_in_smem ? work(scratch) + flow_work_floats(d, H, L) : w;
  }

  // Copy the parameters into the block's shared memory (once a launch).
  __device__ void setup(float* scratch) const {
    if (weights_in_smem) {
      float* dst = work(scratch) + flow_work_floats(d, H, L);
      const int n = (int)flow_packed_floats(d, H, L);
      for (int i = threadIdx.x; i < n; i += LD_T) dst[i] = w[i];
    }
    __syncthreads();
  }

  // This thread's term of the logdet's sum over the coordinates, after
  // eval_flow: coordinate j's sacc.
  __device__ __forceinline__ float ld_term(float* scratch, int j) const {
    return work(scratch)[(size_t)L * (4 * d + H) + 3 * d + j];
  }

  // z (shared memory, read) -> q (written), the model's logp (returned) and
  // zg (written to g): the forward pass, the model's eval_block at q, the
  // backward pass.  Every thread of the block calls it.
  __device__ float eval_flow(const float* z, float* q, float* g, int dd,
                             Reducer& red, float* scratch) const {
    const int t0 = threadIdx.x;
    float* act = work(scratch);
    float* zp = act + (size_t)L * (4 * d + H);
    float* gs = zp + d;
    float* gt = gs + d;
    float* sacc = gt + d;
    float* gpre = sacc + d;
    const float* P = params(scratch);
    const size_t lf = flow_layer_floats(d, H);
    const float* ls = P + L * lf;
    const float* mu = ls + d;

    // q is the working z of the forward pass (each thread its coordinates)
    for (int j = t0; j < d; j += LD_T) q[j] = z[j];
    for (int l = 0; l < L; ++l) {
      const float* m = P + l * lf;
      const float* w1T = m + d;
      const float* b1 = w1T + (size_t)H * d;
      const float* w2sT = b1 + H;
      const float* b2s = w2sT + (size_t)d * H;
      const float* w2tT = b2s + d;
      const float* b2t = w2tT + (size_t)d * H;
      float* zl = act + (size_t)l * (4 * d + H);
      float* es = zl + d;
      float* ts = es + d;
      float* tt = ts + d;
      float* h = tt + d;
      for (int j = t0; j < d; j += LD_T) {
        const float zj = q[j];
        zl[j] = zj;
        zp[j] = zj * m[j];
      }
      __syncthreads();
      for (int k = t0; k < H; k += LD_T) {
        const float* row = w1T + (size_t)k * d;
        float pre = row[0] * zp[0];
        for (int i = 1; i < d; ++i) pre = pre + row[i] * zp[i];
        h[k] = ftanh(pre + b1[k]);
      }
      __syncthreads();
      for (int j = t0; j < d; j += LD_T) {
        const float* rsw = w2sT + (size_t)j * H;
        const float* rtw = w2tT + (size_t)j * H;
        float rs = rsw[0] * h[0], rt = rtw[0] * h[0];
        for (int k = 1; k < H; ++k) {
          rs = rs + rsw[k] * h[k];
          rt = rt + rtw[k] * h[k];
        }
        const float a_s = ftanh((rs + b2s[j]) / max_scale);
        const float a_t = ftanh((rt + b2t[j]) / max_shift);
        const float omm = 1.0f - m[j];
        const float s = (max_scale * a_s) * omm;
        const float t = (max_shift * a_t) * omm;
        const float e = expf(s);
        es[j] = e;
        ts[j] = a_s;
        tt[j] = a_t;
        q[j] = zp[j] + omm * (zl[j] * e + t);
        sacc[j] = l == 0 ? s : sacc[j] + s;
      }
    }
    for (int j = t0; j < d; j += LD_T) {
      q[j] = expf(ls[j]) * q[j] + mu[j];
      sacc[j] = L == 0 ? ls[j] : sacc[j] + ls[j];
    }
    __syncthreads();
    const float logp = inner.eval_block(q, g, dd, red, scratch);
    __syncthreads();

    for (int j = t0; j < d; j += LD_T) g[j] = expf(ls[j]) * g[j];
    for (int l = L - 1; l >= 0; --l) {
      const float* m = P + l * lf;
      const float* w1T = m + d;
      const float* w2sT = w1T + (size_t)H * d + H;
      const float* w2tT = w2sT + (size_t)d * H + d;
      const float* zl = act + (size_t)l * (4 * d + H);
      const float* es = zl + d;
      const float* ts = es + d;
      const float* tt = ts + d;
      const float* h = tt + d;
      for (int j = t0; j < d; j += LD_T) {
        const float gb = g[j];
        const float omm = 1.0f - m[j];
        gs[j] = ((gb * zl[j] * es[j]) + 1.0f) * omm * (1.0f - ts[j] * ts[j]);
        gt[j] = (gb * omm) * (1.0f - tt[j] * tt[j]);
      }
      __syncthreads();
      for (int k = t0; k < H; k += LD_T) {
        float a = w2sT[k] * gs[0];
        for (int i = 1; i < d; ++i) a = a + w2sT[(size_t)i * H + k] * gs[i];
        float b = w2tT[k] * gt[0];
        for (int i = 1; i < d; ++i) b = b + w2tT[(size_t)i * H + k] * gt[i];
        gpre[k] = (a + b) * (1.0f - h[k] * h[k]);
      }
      __syncthreads();
      for (int j = t0; j < d; j += LD_T) {
        float a = w1T[j] * gpre[0];
        for (int k = 1; k < H; ++k) a = a + w1T[(size_t)k * d + j] * gpre[k];
        const float omm = 1.0f - m[j];
        g[j] = g[j] * (m[j] + omm * es[j]) + m[j] * a;
      }
    }
    return logp;
  }
};

}  // namespace nrt
