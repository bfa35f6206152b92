// Block-wide sums in one fixed order, for the kernels in which the LD_T
// threads of a CUDA block share one chain (nuts_tree_ld.cuh) and for the
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

// The butterflies of 16 values at once, in 16 shuffles where 16 calls of
// warp_sum take 80: at each of the halvings 16, 8, 4, 2 a lane keeps the half
// of its values that its side of the halving ends up owning and sends the
// other half, so that the sums of a lane and its partner are formed once;
// the last halving is the plain one.  Every sum adds the same pairs in the
// same tree as warp_sum (IEEE addition commutes).  Returns the index of the
// value whose warp sum this lane now holds in v[0] (both lanes of a pair
// l, l ^ 1 hold the same one).
__device__ __forceinline__ int warp_sum16(float (&v)[16]) {
  const int lane = threadIdx.x & 31;
  int index = 0;
#pragma unroll
  for (int h = 8, o = 16; h > 0; h >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (upper) index += h;
  }
  v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
  return index;
}

// The LD_W warp sums p[0..LD_W) of one value, halved (4, 2, 1).
__device__ __forceinline__ float halve_warps(const float* p_in) {
  float p[LD_W];
#pragma unroll
  for (int w = 0; w < LD_W; ++w) p[w] = p_in[w];
#pragma unroll
  for (int h = LD_W / 2; h > 0; h >>= 1)
#pragma unroll
    for (int w = 0; w < h; ++w) p[w] = p[w] + p[w + h];
  return p[0];
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

}  // namespace nrt
