// A barrier across the CUDA blocks of a cooperative launch, and the logical
// chain block it makes: the streamed posterior kernel K1-stream
// (nuts_fused_stream_posterior.cu) runs the B chains of a logical block as B
// co-resident CUDA blocks, one chain each, that step in lock step and share
// every pass over the data (models.cuh::LogisticRegressionStream).
//
// The launch is cooperative (cudaLaunchAttributeCooperative), so every block
// is resident at once or the launch is refused: a block that waits at the
// barrier cannot keep another from being scheduled.  The barrier is the
// one of cooperative groups' grid sync: the block's threads meet at a
// __syncthreads, thread 0 makes the block's writes visible to the device
// (__threadfence), counts itself in with one atomic, and the last to come
// resets the count and advances a generation that the others wait for.
// Data written before a barrier by another block are read after it past L1
// (__ldcg): L1 is not coherent between SMs.  A wait far longer than any
// iteration traps rather than hang the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace nrt {

// A wait this long (about 17 s at 2 GHz) means a block of the launch never
// came: the launch traps, its error reaches the wrapper, and nothing hangs.
constexpr long long BARRIER_TIMEOUT_CYCLES = 1LL << 35;

struct GridBarrier {
  unsigned* count;  // global, 0 between barriers
  unsigned* gen;    // global, the barriers passed so far
  unsigned n;       // CUDA blocks of the launch

  __device__ __forceinline__ void sync() const {
    __syncthreads();
    if (threadIdx.x == 0) {
      volatile unsigned* vgen = gen;
      const unsigned g0 = *vgen;
      __threadfence();
      if (atomicAdd(count, 1u) == n - 1u) {
        atomicExch(count, 0u);
        __threadfence();
        atomicAdd(gen, 1u);
      } else {
        const long long start = clock64();
        while (*vgen == g0) {
          __nanosleep(32);
          if (clock64() - start > BARRIER_TIMEOUT_CYCLES) __trap();
        }
      }
      __threadfence();
    }
    __syncthreads();
  }
};

// The logical chain block of the streamed posterior body
// (nuts_fused_ld_posterior.cuh::ld_posterior_chain) as the whole grid of a
// cooperative launch: B = gridDim.x chains, this chain's lane b = blockIdx.x,
// its chain c = pid * B + b, where pid is the block's program id (the grid
// runs the C / B logical blocks one after another).  Its chains take every
// iteration together (LOCKSTEP); any() is the test at the top of an
// iteration, through a flag a chain in global memory.  A chain writes its
// flag again only after the next barrier of its evaluation (or of the next
// block's start), which every reader of this one has passed by then.
struct GridBlock {
  static constexpr bool LOCKSTEP = true;
  int B, b, c, pid;
  GridBarrier bar;
  unsigned* flags;  // global [B]

  __device__ void bind(uint32_t*) {}
  __device__ void sync() { bar.sync(); }
  // whether any chain of the block passes a true `mine`
  __device__ bool any(bool mine) {
    if (threadIdx.x == 0) flags[b] = mine ? 1u : 0u;
    bar.sync();
    bool found = false;
    for (int i = threadIdx.x; i < B; i += LD_T) found |= __ldcg(flags + i) != 0u;
    return __syncthreads_or(found) != 0;
  }
};

}  // namespace nrt
