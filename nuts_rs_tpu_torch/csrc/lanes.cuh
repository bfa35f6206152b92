// A chain's coordinates on a group of T lanes, shared by the chains-on-lanes
// kernels K1 / K2 (nuts_fused_posterior.cu, nuts_fused_warmup.cu) and K3 / K4
// (mclmc_fused_posterior.cu, mclmc_fused_warmup.cu).
//
// T is a power of 2 that divides the warp.  Coordinate j of a chain lies on
// lane j mod T of its group, in slot j / T of that lane's arrays; a lane's
// slots past d hold padding that no sum reads and no store writes.  A sum
// over d (ordered_sum) gathers the d terms by __shfl_sync within the group
// and every lane adds them in coordinate order j = 0..d-1, one after
// another, so every lane holds the bits of the one-thread sum
// s = x_0; s = s + x_j and of the plain versions' ops.dsum.  A butterfly or
// a tree would change the bits.  Scalars are computed alike on every lane
// of a group, so no lane broadcasts them and a group's lanes take the same
// branches; a shuffle's mask names the group's lanes alone.
#pragma once

namespace nrt {

constexpr int MAX_THREADS = 1024;  // of a CUDA block

// A lane's place in its chain's group of T lanes: its lane index and the
// mask of the group's lanes in the warp.
template <int T>
struct Lane {
  static_assert(T >= 1 && T <= 32 && (T & (T - 1)) == 0,
                "a group is a power of 2 of lanes within a warp");
  int lane;
  unsigned mask;
  __device__ __forceinline__ Lane()
      : lane((int)(threadIdx.x % T)),
        mask(T == 32 ? 0xffffffffu
                     : ((1u << (T & 31)) - 1u)
                           << (((threadIdx.x & 31) / T) * T)) {}
};

// Coordinate slots a lane holds: coordinate lane + T * i in slot i.
template <int DIM, int T>
__host__ __device__ constexpr int slots() {
  return (DIM + T - 1) / T;
}

// The sum over the d coordinates of x (slot i of each lane its term of
// coordinate lane + T * i), in coordinate order, on every lane.
template <int DIM, int T>
__device__ __forceinline__ float ordered_sum(const float* x,
                                             const Lane<T>& g) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    const float t = __shfl_sync(g.mask, x[j / T], j % T, T);
    s = (j == 0) ? t : s + t;
  }
  return s;
}

// The one-thread dot product a_0 b_0 + ... over the group: each lane's
// products, then ordered_sum.
template <int DIM, int T>
__device__ __forceinline__ float ordered_dot(const float* a, const float* b,
                                             const Lane<T>& g) {
  constexpr int NC = slots<DIM, T>();
  float p[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) p[i] = a[i] * b[i];
  return ordered_sum<DIM, T>(p, g);
}

}  // namespace nrt
