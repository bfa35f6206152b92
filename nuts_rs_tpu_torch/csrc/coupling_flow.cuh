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
// Two forms, chosen by a rule on shapes (flow_kernel_form below,
// _build.flow_form), with the same arithmetic in the same order, so the
// same bits:
//
// * The warp form (WARP), for d <= 32 and H <= 32 where its layout fits a
//   block's shared memory (the default 4 x 32 flow at d = 10 takes 40 KB):
//   warp 0 runs every phase of both passes, lane j on coordinate j and lane
//   k on hidden unit k, with __syncwarp() between the phases, and the other
//   warps go straight to the block barrier before the model's eval_block
//   (at d <= 32 they own no coordinate: thread t owns t, t + LD_T, ...).
//   The only block barriers of an evaluation are that one and the model's
//   own; after eval_block no barrier is needed, because the block functors
//   write g[j] from the thread that owns coordinate j (the ld_args kernels'
//   second pass relies on the same).  Each dot product runs in registers: a
//   loop of compile-time length (32 for the sums over H, 16 or 32 for the
//   sums over d, by d) whose every load is unconditional and whose terms
//   past d or H are left out by a predicated add (add_if), so no branch
//   splits the loop, its loads issue ahead and only the chain of adds is
//   serial; where a sum has all N terms (H = 32 over H), a uniform branch
//   takes the loop without masks.  setup() copies the parameters once a
//   launch into a layout of the kernel's own: every layer's w1T, w2sT and
//   w2tT rows at a stride of FLOW_ROW = 36 floats, so that the forward
//   pass's lanes read their rows 16 bytes at a time without bank conflicts
//   (36 / 4 is odd) and the backward pass's lanes read a column over
//   consecutive banks; the vectors at 32 floats; after them 32 rows of
//   slack, so that a lane's row or column past d or H reads memory of the
//   block (its terms masked).  Activations a layer (z, e^s, tanh_s, tanh_t,
//   h) and the vectors a phase hands to the next (z m, h, gs, gt, gpre)
//   stay in shared memory, 32 floats each.  What bounds it is one warp's
//   chain of dependent steps (a block iteration with every tree at 15
//   leapfrogs: 10.1 us on an H100, 3.6 of them without the flow's passes,
//   against 18.0 in today's form; profile_main_path.py item 16, PERF.md).
// * Today's form, for every other flow the JAX runner takes (d > 32,
//   H > 32, or a warp layout that does not fit): all LD_T threads, thread j
//   a coordinate and thread k a hidden unit, loops of run-time length, two
//   block barriers a layer each way.  Its shared memory: the activations the
//   backward pass reads, L x (4 d + H) floats (each layer's input z, e^s,
//   tanh_s, tanh_t and h), four d-vectors (z m, gs, gt, sacc) and one
//   H-vector (gpre), then, where they fit, the packed parameters (about
//   16 KB at d = 10, L = 4, H = 32); beyond that they are read through L2
//   from global memory.
//
// Build-time switches for timing ablations only (profile_main_path.py item
// 16): NRT_FLOW_CLOCKS (thread 0 of block 0 adds the SM cycles of each
// phase of an evaluation, kept in registers and stored once at its end, and
// of the rest of the block iteration to nrt_flow_clocks; no change of
// results), NRT_FLOW_NO_PASSES
// (q = z, zg = g, logdet 0: the flow's passes left out; changes results),
// NRT_FLOW_TODAY (today's form for every flow), and in the warp form
// NRT_FLOW_BARRIERS (a block barrier, met by every warp, at each of its warp
// barriers), NRT_FLOW_CONFLICTS (rows at a stride of 32 floats: 8-way bank
// conflicts in the forward pass) and NRT_FLOW_ROLLED (dot products as
// today's: loops of run-time length, one load a term); none of the last four
// changes results.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sum.cuh"

#if defined(NRT_FLOW_NO_PASSES) && defined(NRT_FLOW_BARRIERS)
#error "NRT_FLOW_BARRIERS times the passes that NRT_FLOW_NO_PASSES leaves out"
#endif

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
// Shared-memory floats of today's work space (without the parameters).
__host__ __device__ inline size_t flow_work_floats(int d, int H, int L) {
  return (size_t)L * (4 * d + H) + 4 * (size_t)d + H;
}

// ---- the warp form's layout ----
constexpr int FLOW_WARP_MAX = 32;  // largest d and H of the warp form
constexpr int FLOW_VEC = 32;       // floats of a vector in the warp form
#ifdef NRT_FLOW_CONFLICTS
constexpr int FLOW_ROW = 32;
#else
constexpr int FLOW_ROW = 36;  // a weight row's stride: 36 / 4 odd
#endif
// A layer: m, b1, b2s, b2t [FLOW_VEC] each, then w1T [H][FLOW_ROW],
// w2sT [d][FLOW_ROW], w2tT [d][FLOW_ROW]; after the layers log_sigma and mu
// [FLOW_VEC] each and FLOW_WARP_MAX rows of slack.
__host__ __device__ inline size_t flow_warp_layer_floats(int d, int H) {
  return 4 * FLOW_VEC + (size_t)FLOW_ROW * (H + 2 * d);
}
// Work space: a layer's z, e^s, tanh_s, tanh_t, h, then z m, gs, gt, gpre,
// sacc; all FLOW_VEC floats.
__host__ __device__ inline size_t flow_warp_work_floats(int L) {
  return 5 * (size_t)FLOW_VEC * L + 5 * FLOW_VEC;
}
// All of it, with 3 floats of room to start it on a 16-byte boundary.
__host__ __device__ inline size_t flow_warp_floats(int d, int H, int L) {
  return 3 + flow_warp_work_floats(L) + L * flow_warp_layer_floats(d, H) +
         2 * FLOW_VEC + (size_t)FLOW_WARP_MAX * FLOW_ROW;
}

// The form of K1-flow (1: warp, 0: today's) at (d, H) with `warp_bytes` of
// dynamic shared memory for the chain's block in the warp form
// (_build.flow_form is the same rule).
inline int flow_kernel_form(int d, int H, long long warp_bytes,
                            long long opt_in) {
#ifdef NRT_FLOW_TODAY
  return 0;
#else
  return d <= FLOW_WARP_MAX && H <= FLOW_WARP_MAX && warp_bytes <= opt_in;
#endif
}

// NRT_FLOW_CLOCKS: the phases an evaluation's cycles are added to.  The
// warp form's forward pass: z m (0), h's sums (1), h's tanh (2), the heads'
// sums (3), s, t and z' (4); the model with the barrier before it (5); the
// backward pass: gs and gt (6), gpre's sums (7), w1T's column sums and the
// update (8).  Today's form adds its forward pass to 0 and its backward
// pass to 6.  Then the rest of the block iteration (9, with the stores of
// these clocks), evaluations (10) and the clock at the last one's end (11,
// 0 at a launch's start).
constexpr int FLOW_CLOCKS = 12;
#ifdef NRT_FLOW_CLOCKS
__device__ unsigned long long nrt_flow_clocks[FLOW_CLOCKS];
struct FlowClock {
  long long t_in, t, acc[9];
  __device__ __forceinline__ FlowClock() {
    t_in = t = clock64();
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = 0;
  }
  __device__ __forceinline__ void tick(int phase) {
    const long long now = clock64();
    acc[phase] += now - t;
    t = now;
  }
  // thread 0 of block 0, at the evaluation's end
  __device__ __forceinline__ void store() const {
    if (blockIdx.x != 0 || threadIdx.x != 0) return;
    const unsigned long long last = nrt_flow_clocks[11];
#pragma unroll
    for (int k = 0; k < 9; ++k) nrt_flow_clocks[k] += acc[k];
    if (last != 0) nrt_flow_clocks[9] += t_in - last;
    nrt_flow_clocks[10] += 1;
    nrt_flow_clocks[11] = (unsigned long long)t;
  }
};
#else
struct FlowClock {
  __device__ __forceinline__ void tick(int) {}
  __device__ __forceinline__ void store() const {}
};
#endif

// ---- the warp form's dot products ----
// acc + x where p, else acc: a predicated add (add.rn, one rounding as a
// plain float add under -fmad=false), so a masked term neither branches
// nor adds a select to the chain of adds.
__device__ __forceinline__ float add_if(bool p, float acc, float x) {
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q add.rn.f32 %0, %0, %1;\n}"
      : "+f"(acc)
      : "f"(x), "r"((int)p));
  return acc;
}

// A term of a sum: the first starts it; with MASK a term past n is left out
// by add_if, else every term is added (n == N).
template <bool MASK>
__device__ __forceinline__ float flow_term(int i, int n, float acc, float x) {
  if (i == 0) return x;
  if constexpr (MASK) return add_if(i < n, acc, x);
  return acc + x;
}

// A lane's sum over i < n of w[i] x[i] (its row w, the vector x shared by
// the warp, both 16-byte aligned and readable up to N), i ascending, the
// first term starting the sum; every load unconditional, the terms past n
// masked (MASK) or none past it (n == N).  Two rows at once in rows2.
template <int N, bool MASK>
__device__ __forceinline__ void flow_rows2(const float* w1, const float* w2,
                                           const float* x, int n, float& r1,
                                           float& r2) {
  static_assert(N % 4 == 0 && N <= FLOW_VEC, "N: 4, 8, .. 32");
  float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 u = *reinterpret_cast<const float4*>(w1 + c);
    const float4 v = *reinterpret_cast<const float4*>(w2 + c);
    const float4 xv = *reinterpret_cast<const float4*>(x + c);
    const float p1[4] = {u.x * xv.x, u.y * xv.y, u.z * xv.z, u.w * xv.w};
    const float p2[4] = {v.x * xv.x, v.y * xv.y, v.z * xv.z, v.w * xv.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      a1 = flow_term<MASK>(c + t, n, a1, p1[t]);
      a2 = flow_term<MASK>(c + t, n, a2, p2[t]);
    }
  }
  r1 = a1;
  r2 = a2;
}

template <int N, bool MASK>
__device__ __forceinline__ float flow_row(const float* w, const float* x,
                                          int n) {
  static_assert(N % 4 == 0 && N <= FLOW_VEC, "N: 4, 8, .. 32");
  float a = 0.0f;
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 u = *reinterpret_cast<const float4*>(w + c);
    const float4 xv = *reinterpret_cast<const float4*>(x + c);
    const float p[4] = {u.x * xv.x, u.y * xv.y, u.z * xv.z, u.w * xv.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) a = flow_term<MASK>(c + t, n, a, p[t]);
  }
  return a;
}

// A lane's sum over i < n of w[i FLOW_ROW] x[i] (its column of a weight
// block: the lanes read consecutive banks), i ascending, the first term
// starting the sum; every load unconditional (rows past n lie in the
// layout or its slack), the terms past n masked (MASK) or none past it.
// Two columns of two blocks, each with its own vector, in cols2.
template <int N, bool MASK>
__device__ __forceinline__ void flow_cols2(const float* w1, const float* x1,
                                           const float* w2, const float* x2,
                                           int n, float& r1, float& r2) {
  static_assert(N % 4 == 0 && N <= FLOW_VEC, "N: 4, 8, .. 32");
  float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 xv1 = *reinterpret_cast<const float4*>(x1 + c);
    const float4 xv2 = *reinterpret_cast<const float4*>(x2 + c);
    const float y1[4] = {xv1.x, xv1.y, xv1.z, xv1.w};
    const float y2[4] = {xv2.x, xv2.y, xv2.z, xv2.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = c + t;
      a1 = flow_term<MASK>(i, n, a1, w1[i * FLOW_ROW] * y1[t]);
      a2 = flow_term<MASK>(i, n, a2, w2[i * FLOW_ROW] * y2[t]);
    }
  }
  r1 = a1;
  r2 = a2;
}

template <int N, bool MASK>
__device__ __forceinline__ float flow_col(const float* w, const float* x,
                                          int n) {
  static_assert(N % 4 == 0 && N <= FLOW_VEC, "N: 4, 8, .. 32");
  float a = 0.0f;
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + c);
    const float y[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      a = flow_term<MASK>(c + t, n, a, w[(c + t) * FLOW_ROW] * y[t]);
  }
  return a;
}

// The dot products of the warp form: a uniform branch to the loop without
// masks where n == N (every sum over H at H = 32), else the masked one;
// NRT_FLOW_ROLLED: today's loops (run-time length, one load a term).
template <int N>
__device__ __forceinline__ void flow_dot_rows2(const float* w1, const float* w2,
                                               const float* x, int n,
                                               float& r1, float& r2) {
#ifdef NRT_FLOW_ROLLED
  r1 = w1[0] * x[0];
  r2 = w2[0] * x[0];
#pragma unroll 1
  for (int i = 1; i < n; ++i) {
    r1 = r1 + w1[i] * x[i];
    r2 = r2 + w2[i] * x[i];
  }
#else
  if (n == N)
    flow_rows2<N, false>(w1, w2, x, n, r1, r2);
  else
    flow_rows2<N, true>(w1, w2, x, n, r1, r2);
#endif
}

template <int N>
__device__ __forceinline__ float flow_dot_row(const float* w, const float* x,
                                              int n) {
#ifdef NRT_FLOW_ROLLED
  float r = w[0] * x[0];
#pragma unroll 1
  for (int i = 1; i < n; ++i) r = r + w[i] * x[i];
  return r;
#else
  return n == N ? flow_row<N, false>(w, x, n) : flow_row<N, true>(w, x, n);
#endif
}

template <int N>
__device__ __forceinline__ void flow_dot_cols2(const float* w1, const float* x1,
                                               const float* w2, const float* x2,
                                               int n, float& r1, float& r2) {
#ifdef NRT_FLOW_ROLLED
  r1 = w1[0] * x1[0];
#pragma unroll 1
  for (int i = 1; i < n; ++i) r1 = r1 + w1[i * FLOW_ROW] * x1[i];
  r2 = w2[0] * x2[0];
#pragma unroll 1
  for (int i = 1; i < n; ++i) r2 = r2 + w2[i * FLOW_ROW] * x2[i];
#else
  if (n == N)
    flow_cols2<N, false>(w1, x1, w2, x2, n, r1, r2);
  else
    flow_cols2<N, true>(w1, x1, w2, x2, n, r1, r2);
#endif
}

template <int N>
__device__ __forceinline__ float flow_dot_col(const float* w, const float* x,
                                              int n) {
#ifdef NRT_FLOW_ROLLED
  float r = w[0] * x[0];
#pragma unroll 1
  for (int i = 1; i < n; ++i) r = r + w[i * FLOW_ROW] * x[i];
  return r;
#else
  return n == N ? flow_col<N, false>(w, x, n) : flow_col<N, true>(w, x, n);
#endif
}

// The warp form's barrier between two phases (NRT_FLOW_BARRIERS: the
// block's, which the other warps meet in flow_idle_barriers).
__device__ __forceinline__ void flow_phase_sync() {
#ifdef NRT_FLOW_BARRIERS
  __syncthreads();
#else
  __syncwarp();
#endif
}

__device__ __forceinline__ void flow_idle_barriers(int n) {
#ifdef NRT_FLOW_BARRIERS
  for (int i = 0; i < n; ++i) __syncthreads();
#endif
}

// A model functor (its eval_block form) seen through a frozen coupling flow,
// in the warp form (WARP) or today's.
template <class Model, bool WARP>
struct CouplingFlowModel {
  static constexpr bool WARP_FORM = WARP;
  Model inner;
  const float* w;  // the packed parameters in global memory
  int d, H, L;
  float max_scale, max_shift;
  int weights_in_smem;  // today's form, 1: copied into shared memory

  __host__ __device__ size_t scratch_floats() const {
    if constexpr (WARP) return inner.scratch_floats() + flow_warp_floats(d, H, L);
    return inner.scratch_floats() + flow_work_floats(d, H, L) +
           (weights_in_smem ? flow_packed_floats(d, H, L) : 0);
  }

  __device__ __forceinline__ float* work(float* scratch) const {
    float* p = scratch + inner.scratch_floats();
    // to a 16-byte boundary by pointer arithmetic, so that the compiler
    // still sees a shared-memory pointer
    if constexpr (WARP)
      p += (4 - (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3)) & 3;
    return p;
  }

  __device__ __forceinline__ const float* params(float* scratch) const {
    if constexpr (WARP) return work(scratch) + flow_warp_work_floats(L);
    return weights_in_smem ? work(scratch) + flow_work_floats(d, H, L) : w;
  }

  // Copy the parameters into the block's shared memory (once a launch): the
  // packed layout (today's form, where they fit) or the warp form's.
  __device__ void setup(float* scratch) const {
#ifdef NRT_FLOW_CLOCKS
    if (blockIdx.x == 0 && threadIdx.x == 0) nrt_flow_clocks[11] = 0;
#endif
    if constexpr (WARP) {
      float* dst = const_cast<float*>(params(scratch));
      const size_t lf = flow_layer_floats(d, H);
      const int wlf = (int)flow_warp_layer_floats(d, H);
      const int b1 = d + H * d, b2s = b1 + H + d * H, b2t = b2s + d + d * H;
      for (int l = 0; l < L; ++l) {
        const float* src = w + l * lf;
        float* out = dst + (size_t)l * wlf;
        for (int i = threadIdx.x; i < wlf; i += LD_T) {
          float v = 0.0f;
          if (i < 4 * FLOW_VEC) {
            const int part = i / FLOW_VEC, e = i % FLOW_VEC;
            if (part == 0 && e < d) v = src[e];
            if (part == 1 && e < H) v = src[b1 + e];
            if (part == 2 && e < d) v = src[b2s + e];
            if (part == 3 && e < d) v = src[b2t + e];
          } else {
            const int r = (i - 4 * FLOW_VEC) / FLOW_ROW;
            const int col = (i - 4 * FLOW_VEC) % FLOW_ROW;
            if (r < H) {
              if (col < d) v = src[d + r * d + col];
            } else if (r < H + d) {
              if (col < H) v = src[b1 + H + (r - H) * H + col];
            } else if (col < H) {
              v = src[b2s + d + (r - H - d) * H + col];
            }
          }
          out[i] = v;
        }
      }
      float* tail = dst + (size_t)L * wlf;
      for (int i = threadIdx.x; i < 2 * FLOW_VEC; i += LD_T) {
        const int e = i % FLOW_VEC;
        tail[i] = e < d ? w[L * lf + (i / FLOW_VEC) * d + e] : 0.0f;
      }
    } else if (weights_in_smem) {
      float* dst = work(scratch) + flow_work_floats(d, H, L);
      const int n = (int)flow_packed_floats(d, H, L);
      for (int i = threadIdx.x; i < n; i += LD_T) dst[i] = w[i];
    }
    __syncthreads();
  }

  // This thread's term of the logdet's sum over the coordinates, after
  // eval_flow: coordinate j's sacc.
  __device__ __forceinline__ float ld_term(float* scratch, int j) const {
    if constexpr (WARP)
      return work(scratch)[flow_warp_work_floats(L) - FLOW_VEC + j];
    return work(scratch)[(size_t)L * (4 * d + H) + 3 * d + j];
  }

  // z (shared memory, read) -> q (written), the model's logp (returned) and
  // zg (written to g): the forward pass, the model's eval_block at q, the
  // backward pass.  Every thread of the block calls it.
  __device__ float eval_flow(const float* z, float* q, float* g, int dd,
                             Reducer& red, float* scratch) const {
    if constexpr (WARP) {
      return d <= 16 ? eval_warp<16>(z, q, g, dd, red, scratch)
                     : eval_warp<FLOW_WARP_MAX>(z, q, g, dd, red, scratch);
    } else {
      return eval_today(z, q, g, dd, red, scratch);
    }
  }

  // The warp form; DN (16 or 32) the compile-time length of the sums over d.
  template <int DN>
  __device__ float eval_warp(const float* z, float* q, float* g, int dd,
                             Reducer& red, float* scratch) const {
    const int lane = threadIdx.x;  // warp 0's lanes
    float* act = work(scratch);
    float* zp = act + (size_t)5 * FLOW_VEC * L;
    float* gs = zp + FLOW_VEC;
    float* gt = gs + FLOW_VEC;
    float* gpre = gt + FLOW_VEC;
    float* sacc_v = gpre + FLOW_VEC;
    const float* P = params(scratch);
    const size_t lf = flow_warp_layer_floats(d, H);
    const float* ls = P + L * lf;
    const float* mu = ls + FLOW_VEC;
    FlowClock clk;

    if (lane < 32) {
      const bool cj = lane < d;
#ifdef NRT_FLOW_NO_PASSES
      if (cj) {
        q[lane] = z[lane];
        sacc_v[lane] = 0.0f;
      }
#else
      float zj = cj ? z[lane] : 0.0f;
      float sacc = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float* m = P + l * lf;
        const float* b1 = m + FLOW_VEC;
        const float* b2s = b1 + FLOW_VEC;
        const float* b2t = b2s + FLOW_VEC;
        const float* w1T = b2t + FLOW_VEC;
        const float* w2sT = w1T + (size_t)FLOW_ROW * H;
        const float* w2tT = w2sT + (size_t)FLOW_ROW * d;
        float* zl = act + (size_t)l * 5 * FLOW_VEC;
        float* es = zl + FLOW_VEC;
        float* ts = es + FLOW_VEC;
        float* tt = ts + FLOW_VEC;
        float* h = tt + FLOW_VEC;
        const float mj = m[lane];
        const float zpj = zj * mj;
        zl[lane] = zj;
        zp[lane] = zpj;
        flow_phase_sync();
        clk.tick(0);
        // lane k: h_k over the coordinates (rows past H read the layout)
        const float pre = flow_dot_row<DN>(w1T + lane * FLOW_ROW, zp, d);
        clk.tick(1);
        h[lane] = ftanh(pre + b1[lane]);
        flow_phase_sync();
        clk.tick(2);
        // lane j: both heads over the hidden units
        float rs, rt;
        flow_dot_rows2<FLOW_WARP_MAX>(w2sT + lane * FLOW_ROW,
                                      w2tT + lane * FLOW_ROW, h, H, rs, rt);
        clk.tick(3);
        const float a_s = ftanh((rs + b2s[lane]) / max_scale);
        const float a_t = ftanh((rt + b2t[lane]) / max_shift);
        const float omm = 1.0f - mj;
        const float s = (max_scale * a_s) * omm;
        const float t = (max_shift * a_t) * omm;
        const float e = expf(s);
        es[lane] = e;
        ts[lane] = a_s;
        tt[lane] = a_t;
        zj = zpj + omm * (zj * e + t);
        sacc = l == 0 ? s : sacc + s;
        clk.tick(4);
      }
      if (cj) {
        q[lane] = expf(ls[lane]) * zj + mu[lane];
        sacc_v[lane] = L == 0 ? ls[lane] : sacc + ls[lane];
      }
      clk.tick(4);
#endif
    } else {
      flow_idle_barriers(2 * L);
    }
    __syncthreads();
    const float logp = inner.eval_block(q, g, dd, red, scratch);
    clk.tick(5);

#ifndef NRT_FLOW_NO_PASSES
    if (lane < 32) {
      const bool cj = lane < d;
      float gb = cj ? expf(ls[lane]) * g[lane] : 0.0f;
      for (int l = L - 1; l >= 0; --l) {
        const float* m = P + l * lf;
        const float* w1T = m + 4 * FLOW_VEC;
        const float* w2sT = w1T + (size_t)FLOW_ROW * H;
        const float* w2tT = w2sT + (size_t)FLOW_ROW * d;
        const float* zl = act + (size_t)l * 5 * FLOW_VEC;
        const float* es = zl + FLOW_VEC;
        const float* ts = es + FLOW_VEC;
        const float* tt = ts + FLOW_VEC;
        const float* h = tt + FLOW_VEC;
        const float mj = m[lane];
        const float omm = 1.0f - mj;
        const float e = es[lane];
        const float tsj = ts[lane], ttj = tt[lane];
        gs[lane] = ((gb * zl[lane] * e) + 1.0f) * omm * (1.0f - tsj * tsj);
        gt[lane] = (gb * omm) * (1.0f - ttj * ttj);
        flow_phase_sync();
        clk.tick(6);
        // lane k: both heads' columns over the coordinates
        float a, b;
        flow_dot_cols2<DN>(w2sT + lane, gs, w2tT + lane, gt, d, a, b);
        const float hk = h[lane];
        gpre[lane] = (a + b) * (1.0f - hk * hk);
        flow_phase_sync();
        clk.tick(7);
        // lane j: its column of w1T over the hidden units
        const float c = flow_dot_col<FLOW_WARP_MAX>(w1T + lane, gpre, H);
        gb = gb * (mj + omm * e) + mj * c;
        clk.tick(8);
      }
      if (cj) g[lane] = gb;
    } else {
      flow_idle_barriers(2 * L);
    }
#endif
    clk.tick(8);
    clk.store();
    return logp;
  }

  // Today's form: every thread of the block, loops of run-time length.
  __device__ float eval_today(const float* z, float* q, float* g, int dd,
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
    FlowClock clk;

#ifdef NRT_FLOW_NO_PASSES
    for (int j = t0; j < d; j += LD_T) {
      q[j] = z[j];
      sacc[j] = 0.0f;
    }
#else
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
#endif
    clk.tick(0);
    __syncthreads();
    const float logp = inner.eval_block(q, g, dd, red, scratch);
    __syncthreads();
    clk.tick(5);

#ifndef NRT_FLOW_NO_PASSES
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
#endif
    clk.tick(6);
    clk.store();
    return logp;
  }
};

}  // namespace nrt
