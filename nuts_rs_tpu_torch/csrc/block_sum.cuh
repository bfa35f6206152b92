// Sums in one fixed order, for the kernels in which the LD_T threads of a
// CUDA block share one chain (nuts_tree_ld.cuh), for the kernels in which
// one warp runs a chain in that order (nuts_tree_group.cuh), and for the
// model functors those threads evaluate together (models.cuh).
//
// The order is the one of nuts_rs_tpu_torch/ops.py::tsum: each thread adds
// its terms (elements t, t + LD_T, t + 2 LD_T, ... of the summed axis) in
// ascending order, 0.0 for a missing one; a __shfl_xor_sync butterfly
// (16, 8, 4, 2, 1) halves the 32 partials of a warp; the LD_W warp sums,
// read from shared memory, are halved in turn (4, 2, 1).
#pragma once

#include <cuda_runtime.h>

namespace nrt {

constexpr int LD_T = 256;        // threads per chain; ops.py::TSUM_THREADS
constexpr int LD_W = LD_T / 32;  // warps per chain
constexpr int LD_NRED = 11;      // most sums of one Reducer::sum call

// NRT_MCLMC_CLOCKS, a build-time switch for timing ablations only
// (profile_main_path.py item 22; it changes no result): thread 0 of the
// launch's first CUDA block adds the SM cycles of each phase of the
// block-form MCLMC iteration (mclmc_step_block.cuh: 0 the refresh, 1 the
// model, 2 the step's other sums and check, 3 the success part; in the
// pair's evaluation 4 the first product, 5 the second, 6 the block's
// barrier, 7 the exchange) to nrt_mc_clocks, and its iterations to
// nrt_mc_clocks[8]; nrt_mclmc_block_clocks() reads them.
#ifdef NRT_MCLMC_CLOCKS
__device__ unsigned long long nrt_mc_clocks[9];
__device__ __forceinline__ void mc_mark(int k) {
  __shared__ long long last;
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    const long long now = clock64();
    if (k >= 0) atomicAdd(&nrt_mc_clocks[k], (unsigned long long)(now - last));
    if (k == -1) atomicAdd(&nrt_mc_clocks[8], 1ull);
    last = now;
  }
}
#define MC_MARK(k) mc_mark(k)
#else
#define MC_MARK(k)
#endif

// Accumulate one term into a thread's partial: the first term starts the
// sum, as tsum starts from the first row.
__device__ __forceinline__ void acc(float& s, int i, float term) {
  s = (i == 0) ? term : s + term;
}

// The butterfly of one warp: every lane ends with the warp's sum.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The butterflies of M values at once (M a power of two up to 32), in
// M - 1 + 5 - log2(M) shuffles where M calls of warp_sum take 5 M: at each
// of the first log2(M) halvings (16, 8, ...) a lane keeps the half of its
// values that its side of the halving ends up owning and sends the other
// half, so that the sums of a lane and its partner are formed once; the
// remaining halvings are the plain ones.  Every sum adds the same pairs in
// the same tree as warp_sum (IEEE addition commutes).  Returns the index of
// the value whose warp sum this lane now holds in v[0]: its bits are the
// lane's bits 4, 3, ... from the top, so the lanes that differ in the lower
// bits hold the same one.
template <int M>
__device__ __forceinline__ int warp_sums(float (&v)[M]) {
  static_assert(M >= 1 && M <= 32 && (M & (M - 1)) == 0, "M: 1, 2, .. 32");
  constexpr int S = M >= 32 ? 5 : M >= 16 ? 4 : M >= 8 ? 3 : M >= 4 ? 2
                  : M >= 2 ? 1 : 0;  // log2(M): the halvings that split
  const int lane = threadIdx.x & 31;
  int index = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int h = M >> (s + 1), o = 16 >> s;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (upper) index += h;
  }
#pragma unroll
  for (int s = S; s < 5; ++s)
    v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16 >> s);
  return index;
}

// The LD_W warp sums p[0..LD_W) of one value, halved (4, 2, 1).
__device__ __forceinline__ float halve(float (&p)[LD_W]) {
#pragma unroll
  for (int h = LD_W / 2; h > 0; h >>= 1)
#pragma unroll
    for (int w = 0; w < h; ++w) p[w] = p[w] + p[w + h];
  return p[0];
}

// halve() of the LD_W warp sums at p_in[0..LD_W).
__device__ __forceinline__ float halve_warps(const float* p_in) {
  float p[LD_W];
#pragma unroll
  for (int w = 0; w < LD_W; ++w) p[w] = p_in[w];
  return halve(p);
}

// Chains whose LD_T virtual threads of tsum's order run on one warp (the
// mid-d kernels K1-args and K2-args, nuts_tree_group.cuh): lane l holds the
// LD_W slots of the virtual threads l + 32 w, w = 0 .. LD_W - 1, and slot w
// adds the terms of coordinates l + 32 w + LD_T i in ascending i.
constexpr int GR_SLOTS = LD_W;
constexpr int GR_MAX = LD_W;  // chains a CUDA block of those kernels

// tsum of N values over a chain's d coordinates on its warp: term(j, t)
// gives the N terms of coordinate j < d.  The slots are taken one at a time
// (a loop, not unrolled, so that N partials are live, not LD_W N), each
// slot's partials butterflied by warp_sum, and the LD_W warp sums combined
// as halve_warps combines them, ((p0 + p4) + (p2 + p6)) + ((p1 + p5) +
// (p3 + p7)), in the slot order 0, 4, 2, 6, 1, 5, 3, 7: the bits of
// Reducer::sum.  A slot with no coordinate (32 w >= d) is the warp sum of
// 0.0 terms, +0.0, without its shuffles.  Every lane gets every sum.
template <int N, class F>
__device__ __forceinline__ void slot_sums(int d, F&& term, float (&out)[N]) {
  static_assert(GR_SLOTS == 8, "the combination below is LD_W = 8's");
  const int lane = threadIdx.x & 31;
  const int n = (d + LD_T - 1) / LD_T;
  float first[N], pair[N], half[N];
#pragma unroll 1
  for (int s = 0; s < GR_SLOTS; ++s) {
    const int w = ((s & 1) << 2) | (s & 2) | (s >> 2);
    float p[N];
    if (32 * w < d) {
      for (int i = 0; i < n; ++i) {
        const int j = lane + 32 * w + LD_T * i;
        float t[N];
        if (j < d) {
          term(j, t);
        } else {
#pragma unroll
          for (int k = 0; k < N; ++k) t[k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < N; ++k) acc(p[k], i, t[k]);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) p[k] = warp_sum(p[k]);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) p[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if ((s & 1) == 0) {
        first[k] = p[k];  // p_w of the pair (w, w + 4)
      } else {
        const float q = first[k] + p[k];
        if ((s & 2) == 0)
          pair[k] = q;  // p0 + p4, or p1 + p5
        else if (s == 3)
          half[k] = pair[k] + q;  // (p0 + p4) + (p2 + p6)
        else
          out[k] = half[k] + (pair[k] + q);
      }
    }
  }
}

// tsum of one value from the slots' partials p[w] of every lane, for a
// functor that keeps them in an array (StochasticVolatility::eval_team):
// each slot butterflied by warp_sum, combined as halve_warps does.
__device__ __forceinline__ float slot_sum(float (&p)[GR_SLOTS]) {
#pragma unroll
  for (int w = 0; w < GR_SLOTS; ++w) p[w] = warp_sum(p[w]);
  return halve_warps(p);
}

// Up to LD_NRED sums at once; every thread gets every sum.  Two scratch
// buffers alternate, so one __syncthreads per call is enough: a buffer is
// written again only after every thread has passed the barrier of the call
// in between.
struct Reducer {
  float* scratch;  // shared memory, [2][LD_NRED][LD_W]
  int parity;

  template <int N>
  __device__ __forceinline__ void sum(float (&v)[N]) {
    static_assert(N <= LD_NRED, "scratch too small");
    float* buf = scratch + parity * (LD_NRED * LD_W);
    parity ^= 1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float x = warp_sum(v[k]);
      if (lane == 0) buf[k * LD_W + warp] = x;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = halve_warps(buf + k * LD_W);
  }
};

// Reducer::sum for a chain on T = 128 or 256 threads (the block-form MCLMC
// kernels, mclmc_step_block.cuh): thread t holds the S = LD_T / T slots
// t + T s of tsum's LD_T, so warp u holds the slot warps u + W s (W = T / 32
// warps).  Each slot's partial is butterflied by warp_sum; the thread adds
// its S warp sums as halve() pairs them (slot warps w and w + 4 at S = 2);
// the W results of the warps go through shared memory and one barrier of
// the T threads and are halved in turn.
// So every sum is halve()'s tree over the same 8 warp sums: the bits of
// Reducer::sum, which T = 256 calls as it is (r, shared with the model's
// eval_block).  Scratch and parity are r's; flip is the pair form's
// exchange buffer (LogisticRegression::eval_pair).
template <int T>
struct TeamReducer {
  static_assert(T == 128 || T == LD_T, "T: 128 or 256");
  static constexpr int S = LD_T / T;  // slots a thread
  static constexpr int W = T / 32;    // warps of the chain
  Reducer r;
  int flip;

  template <int N>
  __device__ __forceinline__ void sum(float (&v)[S][N], float (&out)[N]) {
    static_assert(N <= LD_NRED, "scratch too small");
    if constexpr (S == 1) {
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = v[0][k];
      r.sum(out);
    } else {
      float* buf = r.scratch + r.parity * (LD_NRED * LD_W);
      r.parity ^= 1;
      const int lane = threadIdx.x & 31;
      const int warp = threadIdx.x >> 5;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float p[S];
#pragma unroll
        for (int s = 0; s < S; ++s) p[s] = warp_sum(v[s][k]);
#pragma unroll
        for (int h = S / 2; h > 0; h >>= 1)
#pragma unroll
          for (int s = 0; s < h; ++s) p[s] = p[s] + p[s + h];
        if (lane == 0) buf[k * LD_W + warp] = p[0];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float p[W];
#pragma unroll
        for (int w = 0; w < W; ++w) p[w] = buf[k * LD_W + w];
#pragma unroll
        for (int h = W / 2; h > 0; h >>= 1)
#pragma unroll
          for (int w = 0; w < h; ++w) p[w] = p[w] + p[w + h];
        out[k] = p[0];
      }
    }
  }
};

// warp_sums<M> with every index a template constant: the halving at lane
// bit O keeps the half of v that this lane's side owns and adds the
// partner's other half (H = M / 2 values), then halves the kept ones at bit
// O / 2, down to one value and the plain halvings below.  The same pairs in
// the same tree as warp_sums and warp_sum; written as a recursion so that
// no array needs a run-time index (warp_sums' loops left v in local memory
// at M = 8 .. 32 in the dim-on-lanes kernels).  After it v[0] holds the warp
// sum of value lane >> (5 - log2 M).
// p ? a : b by one selp, so that a choice between two elements of an array
// never becomes a run-time index into it.
__device__ __forceinline__ float select(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n"
      " selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)p));
  return r;
}

template <int M, int O = 16>
__device__ __forceinline__ void warp_sums_fixed(float (&v)[M]) {
  static_assert(M >= 1 && (M == 1 || M <= 2 * O) && (M & (M - 1)) == 0,
                "M: 1, 2, .. 32");
  if constexpr (M > 1) {
    constexpr int H = M / 2;
    const bool upper = (threadIdx.x & O) != 0;
    float kept[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = select(upper, v[i], v[i + H]);
      const float keep = select(upper, v[i + H], v[i]);
      kept[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    warp_sums_fixed<H, O / 2>(kept);
    v[0] = kept[0];
  } else {
    if constexpr (O >= 1) {
      v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_sums_fixed<1, O / 2>(v);
    }
  }
}

// Up to LD_WIDE sums at once in tsum's order, for the merged leapfrog of
// K1-ld / K2-ld (nuts_tree_ld.cuh): the N values' warp butterflies in one
// warp_sums_fixed<M> pass (M the power of two at or above N; the values
// past N are 0.0 and their sums unused), one lane a value writes its warp
// sum to [warp][value] of a scratch buffer, one __syncthreads, then lane
// k < N halves the LD_W warp sums of value k as halve_warps does (the same
// pairs in the same tree as Reducer::sum, so the same bits) and every lane
// takes each sum from its lane by a shuffle.  A value's 8 warp sums lie
// LD_WIDE floats apart, so the 32 lanes' reads fall in 32 banks.  Two
// buffers alternate, as Reducer's do.
constexpr int LD_WIDE = 32;
constexpr int LD_WIDE_FLOATS = 2 * LD_W * LD_WIDE;

struct WideReducer {
  float* scratch;  // shared memory, [2][LD_W][LD_WIDE]
  int parity;

  template <int N>
  __device__ __forceinline__ void sum(float (&v)[N]) {
    static_assert(N >= 1 && N <= LD_WIDE, "scratch too small");
    constexpr int M = N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4 : N <= 8 ? 8
                    : N <= 16 ? 16 : 32;
    constexpr int SHIFT = M >= 32 ? 0 : M >= 16 ? 1 : M >= 8 ? 2
                        : M >= 4 ? 3 : M >= 2 ? 4 : 5;  // 5 - log2(M)
    float* buf = scratch + parity * (LD_W * LD_WIDE);
    parity ^= 1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float u[M];
#pragma unroll
    for (int k = 0; k < N; ++k) u[k] = v[k];
#pragma unroll
    for (int k = N; k < M; ++k) u[k] = 0.0f;
    warp_sums_fixed<M>(u);
    const int k = lane >> SHIFT;  // the value whose warp sum u[0] holds
    if ((lane & ((1 << SHIFT) - 1)) == 0 && k < N)
      buf[warp * LD_WIDE + k] = u[0];
    __syncthreads();
    float x = 0.0f;
    if (lane < N) {
      float p[LD_W];
#pragma unroll
      for (int w = 0; w < LD_W; ++w) p[w] = buf[w * LD_WIDE + lane];
      x = halve(p);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __shfl_sync(0xffffffffu, x, i);
  }
};

}  // namespace nrt
