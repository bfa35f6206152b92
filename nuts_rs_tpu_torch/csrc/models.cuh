// Model functors compiled into the fused kernels (Model.kernel_hook).
//
// Counterpart of the batched logp/grad that the Pallas kernels trace in
// (nuts_rs_tpu/chain.py:677-690), and of the arrays their model_args
// channel replicates to every block (nuts_pallas.py:84,159-166).  A functor
// has up to two forms.
//
// term / finish: several threads share one chain and every gradient
// coordinate depends on its own position coordinate alone (the dim-on-lanes
// kernels, chain.py:805-807, and the chains-on-lanes kernels K1-K4, a
// chain's coordinates on a group of lanes); term gives one coordinate's
// gradient and its summand of logp, the threads sum the summands in their
// kernel's fixed order (block_sum.cuh::Reducer, lanes.cuh::ordered_sum),
// and finish turns the sum into logp.
//
// eval_block: the LD_T threads of a block evaluate one chain
// together from the whole position vector in shared memory; a gradient
// coordinate may need all of q, and the functor may hold device pointers to
// the model's data (the mid-d MCLMC kernels, mclmc_fused_mid_*.cu, the
// dim-on-lanes kernels with data, nuts_fused_ld_args_*.cu, and K1-flow take
// this form).  q and g are d floats of shared memory; the caller has put a
// __syncthreads between its last access of q and g and the call; after the
// call thread t reads only g[j] for its own coordinates j = t, t + LD_T, ...
// A functor writes those itself, or writes any coordinate of g before a
// __syncthreads of its own (the one inside Reducer::sum), as Radon and
// StochasticVolatility do.  Every thread returns logp.  `scratch` is
// scratch_floats() floats of shared memory that belong to the functor from
// one call to the next.
//
// The mid-d kernels K1-args and K2-args (nuts_fused_mid_*.cu) run G <= 8
// chains a CUDA block, one warp a chain, and take one of two more forms:
//
// eval_team: the warp of one chain evaluates it from the whole position
// vector in shared memory, as eval_block does with the block, in the same
// order: lane l stands for tsum's virtual threads l + 32 w (its slots, w =
// 0 .. LD_W - 1), and a sum over them is block_sum.cuh::slot_sums, the
// bits of Reducer::sum.  The caller puts a __syncwarp before
// and after the call; the functor may write any coordinate of g.  Every
// functor but the regressions has it; `scratch` is the chain's
// scratch_floats().
//
// the group form (GROUP): the block's LD_T threads evaluate all G chains
// together, each read of the model's data serving every chain
// (LogisticRegression alone: stage, eval_group, grad, finish).
//
// Only IidNormal has the eval and term / finish forms; a model of another
// functor takes the mid-d kernels at every chains-on-lanes size
// (nuts_fused.cl_kernel) and the ld_args kernels above.
//
// The plain versions' closed forms take the same orders
// (nuts_rs_tpu_torch/models/gaussian.py with ops.dsum / ops.tsum).
#pragma once

#include <cooperative_groups.h>
#include <stddef.h>

#include "block_sum.cuh"
#include "grid_sync.cuh"
#include "nuts_tree.cuh"

namespace nrt {

namespace cg = cooperative_groups;

// Model ids, as _build.MODEL_IDS names them.
enum ModelId {
  MODEL_IID_NORMAL = 0,
  MODEL_LOGISTIC_REGRESSION = 1,
  MODEL_LOGISTIC_REGRESSION_STREAM = 2,
  MODEL_CORRELATED_NORMAL_RANK1 = 3,
  MODEL_RADON = 4,
  MODEL_STOCHASTIC_VOLATILITY = 5,
  MODEL_FUNNEL = 6,
  MODEL_CORRELATED_NORMAL = 7
};

// iid Normal(mu, 1): logp = -0.5 sum (q - mu)^2, grad = -(q - mu).
struct IidNormal {
  float mu;

  __device__ __forceinline__ float term(float q, float& g) const {
    const float diff = q - mu;
    g = -diff;
    return diff * diff;
  }

  __device__ __forceinline__ float finish(float s) const { return -0.5f * s; }

  static constexpr bool GROUP = false;

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

  __device__ __forceinline__ float eval_team(const float* q, float* g, int d,
                                             float*) const {
    float s[1];
    slot_sums(
        d,
        [&](int j, float (&t)[1]) {
          const float diff = q[j] - mu;
          g[j] = -diff;
          t[0] = diff * diff;
        },
        s);
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
// Both products wait for their loads and not for arithmetic, so a thread
// keeps many loads in flight, issued together in explicit batches (left to
// the compiler, the block-form MCLMC kernels issued them one column at a
// time): GLM_R of its rows advance together through the columns of the
// first product, GLM_BJ columns' loads at a time, and 32 columns share one
// pass over its rows and one butterfly (warp_sums_fixed) in the second.
// Neither changes the order of any sum.
constexpr int GLM_R = 4;   // rows of a thread in flight in the first product
constexpr int GLM_BJ = 8;  // columns of one batch of loads in the first
// the group form (K1-args / K2-args): columns of x in flight a thread in the
// first product, and columns of one pass over the rows in the second
constexpr int GLM_PJ = 4;
constexpr int GLM_GJ = 4;
// row stride of a warp's transposition buffer: 16-byte rows whose 8 lanes of
// a quarter warp meet in distinct banks, and columns read without conflict
constexpr int GLM_TS = GLM_GJ * GR_MAX + 4;

// The regression's shared memory in the pair form (eval_pair), in floats:
// a block's rows of x (128 a round of 256 rows), their y and residuals, the
// column partials of its 4 warps, the two exchange buffers the other block
// writes, its own half sums and its warps' log-likelihoods.
__host__ __device__ inline size_t glm_pair_floats(int d, int N) {
  const size_t rows = 128 * (size_t)((N + LD_T - 1) / LD_T);
  return (size_t)d * rows + 2 * rows + 4 * (size_t)d + 3 * ((size_t)d + 1) +
         4;
}

// The first product's logits of GLM_R rows (x's column j at col + j *
// stride, the rows at offsets m): logit[k] starts as x[0] q[0] and adds
// x[j] q[j] in ascending j, GLM_BJ columns' loads issued before their
// terms are added.
__device__ __forceinline__ void first_product(const float* x, size_t stride,
                                              const float* q, int d,
                                              const int (&m)[GLM_R],
                                              float (&logit)[GLM_R]) {
#pragma unroll
  for (int k = 0; k < GLM_R; ++k) logit[k] = x[m[k]] * q[0];
  int j = 1;
  for (; j + GLM_BJ <= d; j += GLM_BJ) {
    float xv[GLM_BJ][GLM_R], qv[GLM_BJ];
#pragma unroll
    for (int jj = 0; jj < GLM_BJ; ++jj) {
      const float* col = x + (size_t)(j + jj) * stride;
      qv[jj] = q[j + jj];
#pragma unroll
      for (int k = 0; k < GLM_R; ++k) xv[jj][k] = col[m[k]];
    }
#pragma unroll
    for (int jj = 0; jj < GLM_BJ; ++jj)
#pragma unroll
      for (int k = 0; k < GLM_R; ++k)
        logit[k] = logit[k] + xv[jj][k] * qv[jj];
  }
  for (; j < d; ++j) {
    const float* col = x + (size_t)j * stride;
    const float qj = q[j];
#pragma unroll
    for (int k = 0; k < GLM_R; ++k) logit[k] = logit[k] + col[m[k]] * qj;
  }
}

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
      }
      first_product(xt, (size_t)N, q, d, nc, logit);
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
    // 32 columns share one pass over the thread's rows and one butterfly
    // (lane l ends with column j0 + l's warp sum); a column past the end
    // repeats the last one and is not stored.
    for (int j0 = 0; j0 < d; j0 += 32) {
      float c[32];
      for (int i = 0; i < rows; ++i) {
        const int n = t + i * LD_T;
        const bool in = n < N;
        const int nn = in ? n : 0;
        const float rn = in ? r[nn] : 0.0f;
        float x[32];
#pragma unroll
        for (int k = 0; k < 32; ++k)
          x[k] = xt[(size_t)min(j0 + k, d - 1) * N + nn];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc(c[k], i, in ? x[k] * rn : 0.0f);
      }
      warp_sums_fixed<32>(c);
      if (j0 + lane < d) part[(j0 + lane) * LD_W + warp] = c[0];
    }
    red.sum(s);  // its barrier also publishes `part`
    for (int i = 0; i < nd; ++i) {
      const int j = t + i * LD_T;
      if (j < d) g[j] = halve_warps(part + j * LD_W) - q[j];
    }
    return s[0] - 0.5f * s[1];
  }

  // The pair form (the block-form MCLMC kernels' pair, mclmc_step_block.cuh):
  // one chain on a thread block cluster of two blocks of 128 threads, each
  // holding the rows of half of tsum's 256 slots in its shared memory,
  // staged once a launch (stage_pair), so that both products read x from
  // shared memory and not from L2.  Block `rank` r holds the slot warps r,
  // r + 2, r + 4, r + 6: its warp u is slot warp r + 2 u, and its lane l
  // owns eval_block's rows n = 32 (r + 2 u) + l + 256 i, kept as local row
  // m = 32 u + l + 128 i (so n = 64 (m >> 5) + 32 r + (m & 31)).  Each
  // thread forms its rows' logits in ascending j and adds its rows' terms in
  // ascending i, as eval_block's thread does; a warp's butterfly
  // (warp_sums_fixed, 32 columns at once) gives its slot warp's sum; the
  // block adds its four as halve() pairs them ((w, w + 4) then (w, w + 2):
  // ((p0 + p4) + (p2 + p6)) in block 0, ((p1 + p5) + (p3 + p7)) in block 1)
  // and the last halving adds the two blocks' halves after one exchange
  // through distributed shared memory and the cluster's barrier.  The prior
  // (tsum over j) is summed in full in both blocks by their slots, whose
  // one barrier also publishes the column partials.  So every bit is
  // eval_block's.  The two blocks run the same trajectory, so both return
  // the same logp and the full gradient at their own coordinates.
  static constexpr bool PAIR = true;

  __device__ __forceinline__ int pair_rows() const {
    return 128 * ((N + LD_T - 1) / LD_T);
  }

  // global row of block `rank`'s local row m
  __device__ __forceinline__ static int pair_row(int m, int rank) {
    return 64 * (m >> 5) + 32 * rank + (m & 31);
  }

  // Copy the block's rows of x (row-major by column: xs[j][m]) and y into
  // shared memory; 0.0 past the data's end.  Ends with a barrier.
  __device__ __forceinline__ void stage_pair(float* scratch,
                                             int rank) const {
    const int rows = pair_rows();
    float* xs = scratch;
    float* ys = xs + (size_t)d * rows;
    for (int j = 0; j < d; ++j) {
      const float* col = xt + (size_t)j * N;
      for (int m = threadIdx.x; m < rows; m += 128) {
        const int n = pair_row(m, rank);
        xs[(size_t)j * rows + m] = n < N ? col[n] : 0.0f;
      }
    }
    for (int m = threadIdx.x; m < rows; m += 128) {
      const int n = pair_row(m, rank);
      ys[m] = n < N ? y[n] : 0.0f;
    }
    __syncthreads();
  }

  __device__ __forceinline__ float eval_pair(const float* q, float* g, int,
                                             TeamReducer<128>& red,
                                             float* scratch) const {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank() & 1;
    const int rows = pair_rows();
    const int R = rows / 128;  // a thread's rows, eval_block's `rows`
    float* xs = scratch;                   // [d][rows]
    float* ys = xs + (size_t)d * rows;     // [rows]
    float* rs = ys + rows;                 // [rows], the thread's own rows
    float* part = rs + rows;               // [d][4]
    float* xch = part + 4 * d;             // [2][d + 1], the other block's
    float* mine = xch + 2 * (d + 1);       // [d + 1]
    float* llw = mine + d + 1;             // [4]
    const int t = threadIdx.x;
    const int lane = t & 31, u = t >> 5;
    const int m0 = 32 * u + lane;
    float ll = 0.0f;
    for (int i0 = 0; i0 < R; i0 += GLM_R) {
      int m[GLM_R];
      float logit[GLM_R];
#pragma unroll
      for (int k = 0; k < GLM_R; ++k) m[k] = m0 + 128 * min(i0 + k, R - 1);
      first_product(xs, (size_t)rows, q, d, m, logit);
#pragma unroll
      for (int k = 0; k < GLM_R; ++k) {
        if (i0 + k >= R) break;
        float term = 0.0f, res = 0.0f;  // rows past the data: no term
        if (pair_row(m[k], rank) < N) {
          const float yn = ys[m[k]];
          term = yn * logit[k] - logaddexp(0.0f, logit[k]);
          const float p = 1.0f / (1.0f + expf(-logit[k]));
          res = yn - p;
        }
        rs[m[k]] = res;
        acc(ll, i0 + k, term);
      }
    }
    MC_MARK(4);
    float prior[LD_T / 128][1], sums[1];
    const int nd = (d + LD_T - 1) / LD_T;
#pragma unroll
    for (int s = 0; s < LD_T / 128; ++s)
      for (int i = 0; i < nd; ++i) {
        const int j = t + 128 * s + LD_T * i;
        acc(prior[s][0], i, j < d ? q[j] * q[j] : 0.0f);
      }
    // 32 columns share one pass over the thread's rows, their loads issued
    // together, and one butterfly (warp_sums_fixed: lane l ends with column
    // j0 + l's warp sum); a column past the end repeats the last one and is
    // not stored.  A row past the data is x = 0 and residual 0, so its term
    // is +0.0, eval_block's 0.0.
    for (int j0 = 0; j0 < d; j0 += 32) {
      float c[32];
      for (int i = 0; i < R; ++i) {
        const int mi = m0 + 128 * i;
        const float rn = rs[mi];
        float x[32];
#pragma unroll
        for (int k = 0; k < 32; ++k)
          x[k] = xs[(size_t)min(j0 + k, d - 1) * rows + mi];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc(c[k], i, x[k] * rn);
      }
      warp_sums_fixed<32>(c);
      if (j0 + lane < d) part[(j0 + lane) * 4 + u] = c[0];
    }
    ll = warp_sum(ll);
    if (lane == 0) llw[u] = ll;
    MC_MARK(5);
    red.sum(prior, sums);  // its barrier also publishes part and llw
    MC_MARK(6);
    // the other block's halves arrive in `other`; ours go to its copy of
    // the same buffer (two alternate, as Reducer's do)
    float* other = xch + red.flip * (d + 1);
    red.flip ^= 1;
    float* peer = cluster.map_shared_rank(other, rank ^ 1);
    for (int j = t; j < d; j += 128) {
      const float* pj = part + 4 * j;
      const float half = (pj[0] + pj[2]) + (pj[1] + pj[3]);
      mine[j] = half;
      peer[j] = half;
    }
    if (t == 0) {
      const float half = (llw[0] + llw[2]) + (llw[1] + llw[3]);
      mine[d] = half;
      peer[d] = half;
    }
    cluster.sync();
    for (int j = t; j < d; j += 128) g[j] = (mine[j] + other[j]) - q[j];
    MC_MARK(7);
    return (mine[d] + other[d]) - 0.5f * sums[0];
  }

  // The group form (K1-args / K2-args, G <= GR_MAX chains a CUDA block).
  // The block's thread t keeps its rows n = t + LD_T i, as eval_block does,
  // and forms their logits for all G chains: each load of xt[j][n] serves
  // every chain, and the G positions at j are one 32-byte row of qg (two
  // 16-byte loads).  A logit still sums ascending j (ops.dsum).  Over rows,
  // each chain's log-likelihood and each gradient column take eval_block's
  // order: the thread's rows ascending, the warp's butterfly (warp_sums, 8
  // chains' log-likelihoods or 2 columns x 8 chains at once), the LD_W warp
  // partials halved by the chain's own lane (grad, finish); the prior's
  // terms join the caller's reduction (prior_term, tsum over j).  So the
  // bits are eval_block's, and the L2 traffic of x per chain and
  // evaluation falls by G.  The residuals of a thread's rows stay in
  // registers where it has at most GLM_R rows (N <= LD_T GLM_R), else they
  // go through shared memory (rs).  No tensor cores: TF32 would round the
  // products' inputs, and the port keeps TF32 off.
  static constexpr bool GROUP = true;

  __host__ __device__ bool rows_in_registers() const {
    return N <= LD_T * GLM_R;
  }

  // qg [d][GR_MAX], part [G][d][LD_W], llp [G][LD_W], a warp's
  // [32][GLM_TS] of the second product's butterflies each, then rs [G][N]
  // where the residuals do not stay in registers
  __host__ __device__ size_t group_floats(int G) const {
    return (size_t)GR_MAX * d + (size_t)G * LD_W * (d + 1) +
           (size_t)LD_W * 32 * GLM_TS +
           (rows_in_registers() ? 0 : (size_t)G * N);
  }

  // chain cb's new position at coordinate j, for eval_group
  __device__ __forceinline__ void stage(float* gs, int cb, int j,
                                        float qj) const {
    gs[j * GR_MAX + cb] = qj;
  }

  // x at columns j .. j + U - 1 (past the end: the last column) of the R
  // rows nc, 0.0 where a row is not `in`
  template <int U, int R>
  __device__ __forceinline__ void fetch_cols(int j, const int (&nc)[R],
                                             const bool (&in)[R],
                                             float (&x)[U][R]) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* col = xt + (size_t)min(j + u, d - 1) * N;
#pragma unroll
      for (int k = 0; k < R; ++k) x[u][k] = in[k] ? col[nc[k]] : 0.0f;
    }
  }

  // Every thread of the block, the G chains' positions staged; ends with a
  // barrier after which grad and finish read the sums.  Inlined, with the
  // chains' trees parked in shared memory around it (the kernels' GrPost /
  // GrWarmScalars), so that its tiles have the registers.  Both products
  // keep the next GLM_PJ (first) or GLM_GJ (second) columns of the thread's
  // rows in flight while the current ones are used: an SM runs 8 warps, so
  // each must hide the latency of L2 itself.  The second product's warp
  // butterflies go through shared memory (a [32][GLM_TS] buffer a warp),
  // which costs fewer issue slots than 31 shuffles and their selects for 32
  // values.
  __device__ __forceinline__ void eval_group(int G, float* gs) const {
    const float* qg = gs;
    float* part = gs + (size_t)GR_MAX * d;
    float* llp = part + (size_t)G * d * LD_W;
    float* tb = llp + G * LD_W;
    float* rs = tb + LD_W * 32 * GLM_TS;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int rows = (N + LD_T - 1) / LD_T;
    const bool regs = rows_in_registers();
    float ll[GR_MAX];
    float r[GLM_R][GR_MAX];
    for (int i0 = 0; i0 < rows; i0 += GLM_R) {
      int nc[GLM_R];
      bool in[GLM_R];
#pragma unroll
      for (int k = 0; k < GLM_R; ++k) {
        const int n = t + (i0 + k) * LD_T;
        in[k] = n < N;
        nc[k] = in[k] ? n : 0;
      }
      // column 0 starts every logit; a row past the end has logits of 0.0
      float logit[GLM_R][GR_MAX];
      {
        float x[1][GLM_R];
        fetch_cols(0, nc, in, x);
        const float4 qa = *reinterpret_cast<const float4*>(qg);
        const float4 qb = *reinterpret_cast<const float4*>(qg + 4);
        const float qv[GR_MAX] = {qa.x, qa.y, qa.z, qa.w,
                                  qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int k = 0; k < GLM_R; ++k)
#pragma unroll
          for (int c = 0; c < GR_MAX; ++c) logit[k][c] = x[0][k] * qv[c];
      }
      float xb[GLM_PJ][GLM_R];
      fetch_cols(1, nc, in, xb);
      for (int j0 = 1; j0 < d; j0 += GLM_PJ) {
        float xc[GLM_PJ][GLM_R];
#pragma unroll
        for (int u = 0; u < GLM_PJ; ++u)
#pragma unroll
          for (int k = 0; k < GLM_R; ++k) xc[u][k] = xb[u][k];
        if (j0 + GLM_PJ < d) fetch_cols(j0 + GLM_PJ, nc, in, xb);
#pragma unroll
        for (int u = 0; u < GLM_PJ; ++u) {
          const int j = j0 + u;
          if (j >= d) break;
          const float4 qa =
              *reinterpret_cast<const float4*>(qg + j * GR_MAX);
          const float4 qb =
              *reinterpret_cast<const float4*>(qg + j * GR_MAX + 4);
          const float qv[GR_MAX] = {qa.x, qa.y, qa.z, qa.w,
                                    qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int k = 0; k < GLM_R; ++k)
#pragma unroll
            for (int c = 0; c < GR_MAX; ++c)
              logit[k][c] = logit[k][c] + xc[u][k] * qv[c];
        }
      }
#pragma unroll
      for (int k = 0; k < GLM_R; ++k) {
        if (i0 + k >= rows) break;
        const float yn = y[nc[k]];
#pragma unroll
        for (int c = 0; c < GR_MAX; ++c) {
          float term = 0.0f, res = 0.0f;
          if (in[k] && c < G) {
            term = yn * logit[k][c] - logaddexp(0.0f, logit[k][c]);
            const float p = 1.0f / (1.0f + expf(-logit[k][c]));
            res = yn - p;
          }
          acc(ll[c], i0 + k, term);
          if (regs)
            r[k][c] = res;
          else if (in[k] && c < G)
            rs[(size_t)c * N + nc[k]] = res;
        }
      }
    }
    {
      const int c = warp_sums(ll);
      if ((lane & 3) == 0 && c < G) llp[c * LD_W + warp] = ll[0];
    }
    // GLM_GJ columns x GR_MAX chains share one pass over the thread's rows
    // and one warp_sums (32 values: lane l ends with column l / 8, chain
    // l % 8); a column past the end repeats the last one and is not
    // stored.  A row past the data's end is the term 0.0 (x and r 0.0).
    int nc[GLM_R];
    bool in[GLM_R];
#pragma unroll
    for (int i = 0; i < GLM_R; ++i) {
      const int n = t + i * LD_T;
      in[i] = n < N;
      nc[i] = in[i] ? n : 0;
    }
    float xb[GLM_GJ][GLM_R];
    if (regs) fetch_cols(0, nc, in, xb);
    for (int j0 = 0; j0 < d; j0 += GLM_GJ) {
      float v[GLM_GJ * GR_MAX];  // [column][chain]
      if (regs) {
        float xc[GLM_GJ][GLM_R];
#pragma unroll
        for (int jj = 0; jj < GLM_GJ; ++jj)
#pragma unroll
          for (int i = 0; i < GLM_R; ++i) xc[jj][i] = xb[jj][i];
        if (j0 + GLM_GJ < d) fetch_cols(j0 + GLM_GJ, nc, in, xb);
#pragma unroll
        for (int i = 0; i < GLM_R; ++i) {
          if (i >= rows) break;
#pragma unroll
          for (int jj = 0; jj < GLM_GJ; ++jj)
#pragma unroll
            for (int c = 0; c < GR_MAX; ++c)
              acc(v[jj * GR_MAX + c], i, xc[jj][i] * r[i][c]);
        }
      } else {
        for (int i = 0; i < rows; ++i) {
          const int n = t + i * LD_T;
          const bool row_in = n < N;
          float x[GLM_GJ];
#pragma unroll
          for (int jj = 0; jj < GLM_GJ; ++jj)
            x[jj] = row_in ? xt[(size_t)min(j0 + jj, d - 1) * N + n] : 0.0f;
#pragma unroll
          for (int c = 0; c < GR_MAX; ++c) {
            const float rn =
                (row_in && c < G) ? rs[(size_t)c * N + n] : 0.0f;
#pragma unroll
            for (int jj = 0; jj < GLM_GJ; ++jj)
              acc(v[jj * GR_MAX + c], i, x[jj] * rn);
          }
        }
      }
      // the warp's butterfly of each of the 32 values, in its tree, through
      // shared memory: the lanes' values out, then lane L adds value L of
      // every lane in warp_sum's tree (lane 0's side of each pair first;
      // IEEE addition commutes), reading the lanes in bit-reversed order so
      // that a stack of 5 partial sums holds the tree's open nodes
      float* tw = tb + (size_t)warp * 32 * GLM_TS;  // this warp's
      __syncwarp();
#pragma unroll
      for (int k = 0; k < GLM_GJ * GR_MAX; k += 4)
        *reinterpret_cast<float4*>(tw + lane * GLM_TS + k) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      __syncwarp();
      float st[5];
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const int m = ((s & 1) << 4) | ((s & 2) << 2) | (s & 4) |
                      ((s & 8) >> 2) | ((s & 16) >> 4);
        float x = tw[m * GLM_TS + lane];
#pragma unroll
        for (int L = 0; L < 5; ++L) {
          if ((s >> L) & 1) {
            x = st[L] + x;
          } else {
            st[L] = x;
            break;
          }
        }
        if (s == 31) sum = x;
      }
      const int jj = lane / GR_MAX, c = lane % GR_MAX;
      if (c < G && j0 + jj < d)
        part[((size_t)c * d + j0 + jj) * LD_W + warp] = sum;
    }
    __syncthreads();  // publishes part and llp
  }

  // chain cb's gradient at its coordinate j, from the column's warp partials
  __device__ __forceinline__ float grad(const float* gs, int cb, int j,
                                        float qj) const {
    return halve_warps(gs + (size_t)GR_MAX * d +
                       ((size_t)cb * d + j) * LD_W) - qj;
  }

  // a coordinate's term of the prior, summed in the caller's reduction
  __device__ __forceinline__ float prior_term(float qj) const {
    return qj * qj;
  }

  // chain cb's logp from the prior's sum
  __device__ __forceinline__ float finish(const float* gs, int G, int cb,
                                          float prior) const {
    return halve_warps(gs + (size_t)GR_MAX * d + (size_t)G * d * LD_W +
                       cb * LD_W) - 0.5f * prior;
  }
};

// The same regression with its rows streamed from device memory (the
// stream= mode of the TPU kernel, nuts_rs_tpu/kernels/nuts_pallas.py:217-254,
// with the model's tile_eval and finalize, models/gaussian.py:202-228): the
// functor of kernel K1-stream (nuts_fused_stream_posterior.cu), whose B
// chains are the CUDA blocks of one cooperative grid (grid_sync.cuh).
//
// An evaluation is the whole block's, in three phases:
// (a) each chain writes its position into pos [d][B]; a grid barrier;
// (b) the data phase: the tiles of TR rows fall into R ranges, range r the
//     tiles [r T / R, (r + 1) T / R), and CUDA block k takes the ranges
//     k, k + B, ...  For a range and each group of CG chains it walks the
//     rows in sub-tiles of S rows: it stages the sub-tile's rows of x
//     (xs [S][XS], XS = d + 1 rounded up to odd, so that neither product's
//     reads meet in a bank; by cp.async, every copy of a thread in flight
//     at once) and the group's positions (qs [d][CG]) in shared
//     memory, forms the logits as register tiles of 4 rows x 8 chains (a
//     staged x value serves 8 chains, a position value 4 rows), turns them
//     into residuals (rs [S][CG], in the place of qs) and quad sums of the
//     log-likelihood terms (llp [S / 4][CG]), then the gradient as register
//     tiles of 8 chains x 4 columns that run over the range's rows, and
//     writes the range's (grad [d], loglik) of every chain into part
//     [R][B][d + 1]; a grid barrier;
// (c) each chain adds its R partials, then the prior.
// S and CG are the wrapper's choice (_build.stream_tiling) and change no
// bit; R and TR are the sum order's.
//
// Sum order, shared with the plain version
// (gaussian.py::logistic_regression_stream_logp_grad).  A logit's terms in
// ascending j.  Over rows, for the log-likelihood and each gradient column
// alike: a range's rows in quads of 4 from its first row (the last quad
// short), a quad's terms added left to right; the range's quads left to
// right; the R ranges in ascending order; the prior last, logp = ll - 0.5
// tsum_j(q q) and g = grad - q.  A row past the data's end is no term.
// 4 bytes from global to shared memory without a register (cp.async, through
// L1), and the wait for every such copy of the thread.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct LogisticRegressionStream {
  static constexpr int MAX_S = 128;   // rows of a sub-tile
  static constexpr int MAX_CG = 64;   // chains of a group
  const float* xt;  // [d, N]
  const float* y;   // [N]
  int N, d, TR, R, S, CG;
  int B;         // chains of the logical block: the grid's CUDA blocks
  float* pos;    // [d][B]
  float* part;   // [R][B][d + 1]
  GridBarrier bar;

  // row stride of the staged rows: odd, so that the 8 rows (quads apart)
  // that a warp's logit tiles read at one column lie in 8 banks
  __host__ __device__ int xs() const { return (d + 1) | 1; }

  // 4 floats of slack for the 16-byte alignment, the staged rows, the
  // positions or residuals, the quad sums
  __host__ __device__ size_t scratch_floats() const {
    return 4 + (size_t)S * xs() + (size_t)(d > S ? d : S) * CG +
           (size_t)(S / 4) * CG;
  }

  // Not inlined: the chain's tree state, live across the evaluation, is
  // saved once around the call instead of taking the registers of the
  // products' tiles (the kernel has 128 a thread, two blocks an SM).
  __device__ __noinline__ void data_phase(float* base) const {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int XS = xs(), T = (N + TR - 1) / TR;
    float* xsm = base;                            // [S][XS]
    float* qs = base + (size_t)S * XS;            // [d][CG], then
    float* rs = qs;                               // [S][CG]
    float* llp = qs + (size_t)(d > S ? d : S) * CG;  // [S / 4][CG]
    // logit tiles: a warp holds 8 row quads x 4 chain octets
    const int nrq = S / 4, nco = CG / 8, njq = (d + 3) / 4;
    const int wr = nrq > 8 ? nrq / 8 : 1;
    const int rq = (lane & 7) + 8 * (warp % wr);
    const int co = (lane >> 3) + 4 * (warp / wr);
    const bool lact = rq < nrq && co < nco;
    // gradient tiles: chain octet gco, column quad gjq
    const int gco = t % nco, gjq = t / nco;
    const bool gact = gjq < njq;
    for (int r = blockIdx.x; r < R; r += gridDim.x) {
      const int lo = (int)((long long)r * T / R) * TR;
      const int hi = min((int)((long long)(r + 1) * T / R) * TR, N);
      for (int c0 = 0; c0 < B; c0 += CG) {
        const int ncg = min(CG, B - c0);
        float ga[8][4];
        float la = 0.0f;
        for (int row0 = lo; row0 < hi; row0 += S) {
          const int rows = min(S, hi - row0);
          const bool first = row0 == lo;
          __syncthreads();  // the last sub-tile's readers are done
          {
            // the rows by asynchronous copies, all in flight at once (x is
            // constant over the launch: through L1), the positions past L1
            const int n = t % S, step = LD_T / S;
            if (n < rows) {
              for (int j = t / S; j < d; j += step)
                copy_async4(xsm + n * XS + j, xt + (size_t)j * N + row0 + n);
            }
            const int cc = t % CG, cstep = LD_T / CG;
#pragma unroll 8
            for (int j = t / CG; j < d; j += cstep)
              qs[j * CG + cc] =
                  cc < ncg ? __ldcg(pos + (size_t)j * B + c0 + cc) : 0.0f;
            copy_async_wait();
          }
          __syncthreads();
          float lg[4][8];
          if (lact) {
            const float* xr = xsm + 4 * rq * XS;
            const float* qc = qs + 8 * co;
            float xv[4], qv[8];
            auto load = [&](int j) {
#pragma unroll
              for (int k = 0; k < 4; ++k) xv[k] = xr[k * XS + j];
              const float4 qa = *reinterpret_cast<const float4*>(qc + j * CG);
              const float4 qb =
                  *reinterpret_cast<const float4*>(qc + j * CG + 4);
              qv[0] = qa.x, qv[1] = qa.y, qv[2] = qa.z, qv[3] = qa.w;
              qv[4] = qb.x, qv[5] = qb.y, qv[6] = qb.z, qv[7] = qb.w;
            };
            load(0);
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int c = 0; c < 8; ++c) lg[k][c] = xv[k] * qv[c];
#pragma unroll 2
            for (int j = 1; j < d; ++j) {
              load(j);
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int c = 0; c < 8; ++c) lg[k][c] = lg[k][c] + xv[k] * qv[c];
            }
          }
          __syncthreads();  // the positions are read: residuals replace them
          if (lact) {
            float lq[8];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int n = 4 * rq + k;
              const bool in = n < rows;
              const float yn = in ? y[row0 + n] : 0.0f;
              float rv[8];
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                const float logit = lg[k][c];
                float term = 0.0f, res = 0.0f;
                if (in) {
                  term = yn * logit - logaddexp(0.0f, logit);
                  res = yn - 1.0f / (1.0f + expf(-logit));
                }
                rv[c] = res;
                lq[c] = k == 0 ? term : (in ? lq[c] + term : lq[c]);
              }
              float4* dst = reinterpret_cast<float4*>(rs + n * CG + 8 * co);
              dst[0] = make_float4(rv[0], rv[1], rv[2], rv[3]);
              dst[1] = make_float4(rv[4], rv[5], rv[6], rv[7]);
            }
            if (4 * rq < rows) {
              float4* dst = reinterpret_cast<float4*>(llp + rq * CG + 8 * co);
              dst[0] = make_float4(lq[0], lq[1], lq[2], lq[3]);
              dst[1] = make_float4(lq[4], lq[5], lq[6], lq[7]);
            }
          }
          __syncthreads();
          const int nq = (rows + 3) / 4;
          if (t < ncg) {
            for (int i = 0; i < nq; ++i) {
              const float v = llp[i * CG + t];
              la = (first && i == 0) ? v : la + v;
            }
          }
          if (gact) {
            const float* xc = xsm + 4 * gjq;
            const float* rc = rs + 8 * gco;
            for (int i = 0; i < nq; ++i) {
              float s[8][4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int n = 4 * i + k;
                if (k > 0 && n >= rows) break;
                float xv[4], rv[8];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) xv[jj] = xc[n * XS + jj];
                const float4 ra = *reinterpret_cast<const float4*>(rc + n * CG);
                const float4 rb =
                    *reinterpret_cast<const float4*>(rc + n * CG + 4);
                rv[0] = ra.x, rv[1] = ra.y, rv[2] = ra.z, rv[3] = ra.w;
                rv[4] = rb.x, rv[5] = rb.y, rv[6] = rb.z, rv[7] = rb.w;
#pragma unroll
                for (int c = 0; c < 8; ++c)
#pragma unroll
                  for (int jj = 0; jj < 4; ++jj)
                    s[c][jj] = k == 0 ? xv[jj] * rv[c]
                                      : s[c][jj] + xv[jj] * rv[c];
              }
              const bool start = first && i == 0;
#pragma unroll
              for (int c = 0; c < 8; ++c)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                  ga[c][jj] = start ? s[c][jj] : ga[c][jj] + s[c][jj];
            }
          }
        }
        // the range's sums of the group's chains
        if (gact) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int ch = 8 * gco + c;
            if (ch >= ncg) continue;
            float* dst = part + ((size_t)r * B + c0 + ch) * (d + 1);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (4 * gjq + jj < d) dst[4 * gjq + jj] = ga[c][jj];
          }
        }
        if (t < ncg) part[((size_t)r * B + c0 + t) * (d + 1) + d] = la;
      }
    }
  }

  __device__ __forceinline__ float eval_block(const float* q, float* g, int,
                                              Reducer& red,
                                              float* scratch) const {
    const int t = threadIdx.x, b = blockIdx.x;
    for (int j = t; j < d; j += LD_T) pos[(size_t)j * B + b] = q[j];
    bar.sync();  // every chain's position is written
    float* base = reinterpret_cast<float*>(
        (reinterpret_cast<size_t>(scratch) + 15) & ~(size_t)15);
    data_phase(base);
    bar.sync();  // every range's sums are written
    // this chain's sums: the ranges in ascending order, then the prior
    float* total_ll = base + (size_t)S * xs();  // free after the data phase
    const size_t stride = (size_t)B * (d + 1);
    for (int j = t; j <= d; j += LD_T) {
      const float* w = part + (size_t)b * (d + 1) + j;
      float s = __ldcg(w);
#pragma unroll 8
      for (int r = 1; r < R; ++r) s = s + __ldcg(w + r * stride);
      if (j < d)
        g[j] = s - q[j];
      else
        *total_ll = s;
    }
    const int nd = (d + LD_T - 1) / LD_T;
    float s2[1];
    for (int i = 0; i < nd; ++i) {
      const int j = t + i * LD_T;
      acc(s2[0], i, j < d ? q[j] * q[j] : 0.0f);
    }
    red.sum(s2);  // its barrier also publishes total_ll
    return *total_ll - 0.5f * s2[0];
  }
};

// The rank-1 correlated normal (nuts_rs_tpu/models/gaussian.py:45-76), its
// data u [d] and the scale diagonal s [d] in device memory:
//   y = q / sqrt(s),  logp = -0.5 (y.y + coef (u.y) (u.y)),
//   grad = -(y + coef (u.y) u) / sqrt(s)
// (the JAX body's spelling, dividing by sqrt(s)).  The two dots in one
// Reducer call (ops.tsum's order), then the gradient from them.
struct CorrelatedNormalRank1 {
  static constexpr bool GROUP = false;
  const float* u;  // [d]
  const float* s;  // [d]
  float coef;      // 1 / eig - 1

  __host__ __device__ size_t scratch_floats() const { return 0; }

  __device__ __forceinline__ float eval_block(const float* q, float* g, int d,
                                              Reducer& red, float*) const {
    float v[2];  // y.y, u.y
    const int n = (d + LD_T - 1) / LD_T;
    for (int i = 0; i < n; ++i) {
      const int j = threadIdx.x + i * LD_T;
      float yy = 0.0f, uy = 0.0f;
      if (j < d) {
        const float y = q[j] / sqrtf(s[j]);
        yy = y * y;
        uy = u[j] * y;
      }
      acc(v[0], i, yy);
      acc(v[1], i, uy);
    }
    red.sum(v);
    const float cu = coef * v[1];
    for (int j = threadIdx.x; j < d; j += LD_T) {
      const float root = sqrtf(s[j]);
      const float y = q[j] / root;
      g[j] = -(y + cu * u[j]) / root;
    }
    return -0.5f * (v[0] + cu * v[1]);
  }

  __device__ __forceinline__ float eval_team(const float* q, float* g, int d,
                                             float*) const {
    float v[2];  // y.y, u.y
    slot_sums(
        d,
        [&](int j, float (&t)[2]) {
          const float y = q[j] / sqrtf(s[j]);
          t[0] = y * y;
          t[1] = u[j] * y;
        },
        v);
    const float yy = v[0], uy = v[1];
    const float cu = coef * uy;
    for (int j = threadIdx.x & 31; j < d; j += 32) {
      const float root = sqrtf(s[j]);
      const float y = q[j] / root;
      g[j] = -(y + cu * u[j]) / root;
    }
    return -0.5f * (yy + cu * uy);
  }
};

// The correlated normal with covariance I + r 1 1^T
// (nuts_rs_tpu/models/gaussian.py:79-101), no data: with s = sum q,
// logp = -0.5 q.q + 0.5 c s s and grad = c s - q, c = r / (1 + r d).
struct CorrelatedNormal {
  static constexpr bool GROUP = false;
  float c;

  __host__ __device__ size_t scratch_floats() const { return 0; }

  __device__ __forceinline__ float eval_block(const float* q, float* g, int d,
                                              Reducer& red, float*) const {
    float v[2];  // sum q, q.q
    const int n = (d + LD_T - 1) / LD_T;
    for (int i = 0; i < n; ++i) {
      const int j = threadIdx.x + i * LD_T;
      const float qj = j < d ? q[j] : 0.0f;
      acc(v[0], i, qj);
      acc(v[1], i, qj * qj);
    }
    red.sum(v);
    const float cs = c * v[0];
    for (int j = threadIdx.x; j < d; j += LD_T) g[j] = cs - q[j];
    return -0.5f * v[1] + 0.5f * c * v[0] * v[0];
  }

  __device__ __forceinline__ float eval_team(const float* q, float* g, int d,
                                             float*) const {
    float v[2];  // sum q, q.q
    slot_sums(
        d,
        [&](int j, float (&t)[2]) {
          t[0] = q[j];
          t[1] = q[j] * q[j];
        },
        v);
    const float sq = v[0], qq = v[1];
    const float cs = c * sq;
    for (int j = threadIdx.x & 31; j < d; j += 32) g[j] = cs - q[j];
    return -0.5f * qq + 0.5f * c * sq * sq;
  }
};

// Neal's funnel (nuts_rs_tpu/models/gaussian.py:104-114), no data: with
// v = q0, t = v / 3, e = exp(-v), h = 0.5 (d - 1) and S the sum of
// x x e over x = q[1:] (tsum over all d coordinates, coordinate 0's term
// 0.0): logp = -0.5 t t + (-0.5 S - h v), grad (0.5 S - t / 3) - h for v and
// -(x e) for x.
struct Funnel {
  static constexpr bool GROUP = false;
  __host__ __device__ size_t scratch_floats() const { return 0; }

  __device__ __forceinline__ float eval_block(const float* q, float* g, int d,
                                              Reducer& red, float*) const {
    const float v = q[0];
    const float t = v / 3.0f;
    const float e = expf(-v);
    float S[1];
    const int n = (d + LD_T - 1) / LD_T;
    for (int i = 0; i < n; ++i) {
      const int j = threadIdx.x + i * LD_T;
      acc(S[0], i, (j >= 1 && j < d) ? q[j] * q[j] * e : 0.0f);
    }
    red.sum(S);
    const float h = 0.5f * (float)(d - 1);
    for (int j = threadIdx.x; j < d; j += LD_T)
      g[j] = j == 0 ? (0.5f * S[0] - t / 3.0f) - h : -(q[j] * e);
    return -0.5f * (t * t) + (-0.5f * S[0] - h * v);
  }

  __device__ __forceinline__ float eval_team(const float* q, float* g, int d,
                                             float*) const {
    const float v = q[0];
    const float t = v / 3.0f;
    const float e = expf(-v);
    float p[1];
    slot_sums(
        d,
        [&](int j, float (&t)[1]) { t[0] = j >= 1 ? q[j] * q[j] * e : 0.0f; },
        p);
    const float S = p[0];
    const float h = 0.5f * (float)(d - 1);
    for (int j = threadIdx.x & 31; j < d; j += 32)
      g[j] = j == 0 ? (0.5f * S - t / 3.0f) - h : -(q[j] * e);
    return -0.5f * (t * t) + (-0.5f * S - h * v);
  }
};

constexpr float HALF_LOG_2PI = 0.918938533204672742f;  // 0.5 log(2 pi)

// The radon varying-intercept regression
// (nuts_rs_tpu/models/hierarchical.py:53-127) over
// q = [mu_a, beta, log_sigma, log_sigma_a, z_0..z_{J-1}], d = J + 4:
//   a_j = mu_a + sigma_a z_j,  r_i = (a_{g_i} + beta x_i) - y_i,
//   logp = -0.5 (mu_a / 10)^2 - 0.5 (beta / 10)^2 + (-0.5 sigma^2 + ls)
//          + (-0.5 sigma_a^2 + lsa) + -0.5 z.z
//          + (-0.5 sum (r / sigma)^2 - N (ls + 0.5 log 2 pi))
// (the JAX body's order of terms).  The rows are held stably sorted by
// group, x [N] and y [N], with the groups' row offsets off [J + 1].  The
// gradient needs each group's sum of the residuals' derivatives: thread t
// walks the rows of its groups j = t, t + LD_T, ... in ascending order, each
// sum from 0.0, with u = r / sigma and e = u / sigma:
//   Q_j = sum u u,  E_j = sum e,  X_j = sum e x  (no atomics);
// Q, E, X, z.z and sum z_j E_j are then sums over the groups in one Reducer
// call (tsum's order over j), and
//   g_mu_a = -(mu_a / 10) / 10 - E,  g_beta = -(beta / 10) / 10 - X,
//   g_ls = ((1 - sigma^2) + Q) - N,  g_lsa = (1 - sigma_a^2) - sigma_a z.E,
//   g_z_j = -z_j - sigma_a E_j,
// g_z_j written by group j's thread before the Reducer's barrier.  The plain
// version (models/hierarchical.py::radon_logp_grad) pads the groups to
// [J, n_max] and adds their rows column by column in the same order.
struct Radon {
  static constexpr bool GROUP = false;
  const float* x;    // [N], rows sorted by group
  const float* y;    // [N]
  const int* off;    // [J + 1]
  int N, J;

  __host__ __device__ size_t scratch_floats() const { return 0; }

  __device__ __forceinline__ float eval_block(const float* q, float* g, int,
                                              Reducer& red, float*) const {
    const float mu_a = q[0], beta = q[1], ls = q[2], lsa = q[3];
    const float sigma = expf(ls), sa = expf(lsa);
    float v[5];  // Q, E, X, z.z, z.E
    const int n = (J + LD_T - 1) / LD_T;
    for (int i = 0; i < n; ++i) {
      const int j = threadIdx.x + i * LD_T;
      float qs = 0.0f, es = 0.0f, xs = 0.0f, zz = 0.0f, ze = 0.0f;
      if (j < J) {
        const float z = q[4 + j];
        const float a = mu_a + sa * z;
        const int end = off[j + 1];
        for (int k = off[j]; k < end; ++k) {
          const float xk = x[k];
          const float r = (a + beta * xk) - y[k];
          const float u = r / sigma;
          const float e = u / sigma;
          qs = qs + u * u;
          es = es + e;
          xs = xs + e * xk;
        }
        zz = z * z;
        ze = z * es;
        g[4 + j] = -z - sa * es;
      }
      acc(v[0], i, qs);
      acc(v[1], i, es);
      acc(v[2], i, xs);
      acc(v[3], i, zz);
      acc(v[4], i, ze);
    }
    red.sum(v);  // its barrier also publishes g[4 + j]
    const float t1 = mu_a / 10.0f, t2 = beta / 10.0f;
    const float nf = (float)N;
    switch (threadIdx.x) {
      case 0: g[0] = -(t1 / 10.0f) - v[1]; break;
      case 1: g[1] = -(t2 / 10.0f) - v[2]; break;
      case 2: g[2] = ((1.0f - sigma * sigma) + v[0]) - nf; break;
      case 3: g[3] = (1.0f - sa * sa) - sa * v[4]; break;
    }
    float lp = -0.5f * (t1 * t1) - 0.5f * (t2 * t2);
    lp = lp + (-0.5f * (sigma * sigma) + ls);
    lp = lp + (-0.5f * (sa * sa) + lsa);
    lp = lp + -0.5f * v[3];
    return lp + (-0.5f * v[0] - nf * (ls + HALF_LOG_2PI));
  }

  // The warp of one chain: lane l walks the groups of its slots, j = l +
  // 32 w + LD_T i, each group's rows in row order, as eval_block's thread
  // j does; the five sums over groups are slot_sum's (tsum's order).  A
  // group's rows sit in L1 for the block's other chains.
  __device__ __forceinline__ float eval_team(const float* q, float* g, int,
                                             float*) const {
    const float mu_a = q[0], beta = q[1], ls = q[2], lsa = q[3];
    const float sigma = expf(ls), sa = expf(lsa);
    float S[5];  // Q, E, X, z.z, z.E
    slot_sums(
        J,
        [&](int j, float (&t)[5]) {
          const float z = q[4 + j];
          const float a = mu_a + sa * z;
          const int end = off[j + 1];
          float qs = 0.0f, es = 0.0f, xs = 0.0f;
          for (int k = off[j]; k < end; ++k) {
            const float xk = x[k];
            const float r = (a + beta * xk) - y[k];
            const float u = r / sigma;
            const float e = u / sigma;
            qs = qs + u * u;
            es = es + e;
            xs = xs + e * xk;
          }
          g[4 + j] = -z - sa * es;
          t[0] = qs;
          t[1] = es;
          t[2] = xs;
          t[3] = z * z;
          t[4] = z * es;
        },
        S);
    const float t1 = mu_a / 10.0f, t2 = beta / 10.0f;
    const float nf = (float)N;
    switch (threadIdx.x & 31) {
      case 0: g[0] = -(t1 / 10.0f) - S[1]; break;
      case 1: g[1] = -(t2 / 10.0f) - S[2]; break;
      case 2: g[2] = ((1.0f - sigma * sigma) + S[0]) - nf; break;
      case 3: g[3] = (1.0f - sa * sa) - sa * S[4]; break;
    }
    float lp = -0.5f * (t1 * t1) - 0.5f * (t2 * t2);
    lp = lp + (-0.5f * (sigma * sigma) + ls);
    lp = lp + (-0.5f * (sa * sa) + lsa);
    lp = lp + -0.5f * S[3];
    return lp + (-0.5f * S[0] - nf * (ls + HALF_LOG_2PI));
  }
};

// Special functions of the stochastic-volatility model out of basic
// operations, one definition shared with the plain version
// (models/stochastic_volatility.py: lgamma, digamma, log1p), so that both
// round alike on the card.  x >= 0; the recurrences shift x up to 6 in at
// most 6 steps.
constexpr float SV_PI = 3.14159265358979323846f;

// p *= x, x += 1 while x < 6; Stirling's series to 1/x^13; minus log p
__device__ __forceinline__ float sv_lgamma(float x) {
  float p = 1.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (x < 6.0f) {
      p = p * x;
      x = x + 1.0f;
    }
  }
  const float s = 1.0f / x;
  const float s2 = s * s;
  float ser = (float)(1.0 / 156.0);
  ser = (float)(-691.0 / 360360.0) + s2 * ser;
  ser = (float)(1.0 / 1188.0) + s2 * ser;
  ser = (float)(-1.0 / 1680.0) + s2 * ser;
  ser = (float)(1.0 / 1260.0) + s2 * ser;
  ser = (float)(-1.0 / 360.0) + s2 * ser;
  ser = (float)(1.0 / 12.0) + s2 * ser;
  ser = s * ser;
  return (((x - 0.5f) * logf(x) - x) + HALF_LOG_2PI) + ser - logf(p);
}

// acc += 1 / x, x += 1 while x < 6; the asymptotic series to 1/x^14
__device__ __forceinline__ float sv_digamma(float x) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (x < 6.0f) {
      acc = acc + 1.0f / x;
      x = x + 1.0f;
    }
  }
  const float s = 1.0f / x;
  const float s2 = s * s;
  float ser = (float)(1.0 / 12.0);
  ser = (float)(691.0 / 32760.0) - s2 * ser;
  ser = (float)(1.0 / 132.0) - s2 * ser;
  ser = (float)(1.0 / 240.0) - s2 * ser;
  ser = (float)(1.0 / 252.0) - s2 * ser;
  ser = (float)(1.0 / 120.0) - s2 * ser;
  ser = (float)(1.0 / 12.0) - s2 * ser;
  ser = s2 * ser;
  return ((logf(x) - 0.5f * s) - ser) - acc;
}

// log(1 + w): w where 1 + w rounds to 1, else log(u) (w / (u - 1))
__device__ __forceinline__ float sv_log1p(float w) {
  const float u = 1.0f + w;
  return u == 1.0f ? w : logf(u) * (w / (u - 1.0f));
}

// Exclusive prefix sum of one value per thread over the LD_T threads (REV:
// the suffix sum, threads and lanes taken in reverse): an inclusive
// Hillis-Steele scan inside each warp (offsets 1, 2, 4, 8, 16:
// x_i + x_{i-o}), the same over the LD_W warp totals (1, 2, 4), then
// warp prefix + lane prefix (0.0 where there is none).  wt: LD_W floats of
// shared memory; one __syncthreads.
template <bool REV>
__device__ __forceinline__ float sv_scan_exclusive(float x, float* wt) {
#ifdef NRT_ABLATE_SV_SCANS
  return 0.0f;  // timing ablations only: no scan, no barrier
#endif
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lp = REV ? 31 - lane : lane;
  const int wp = REV ? LD_W - 1 - warp : warp;
  float incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = REV ? __shfl_down_sync(0xffffffffu, incl, o)
                        : __shfl_up_sync(0xffffffffu, incl, o);
    if (lp >= o) incl = incl + y;
  }
  float lane_ex = REV ? __shfl_down_sync(0xffffffffu, incl, 1)
                      : __shfl_up_sync(0xffffffffu, incl, 1);
  if (lp == 0) lane_ex = 0.0f;
  if (lp == 31) wt[wp] = incl;
#ifndef NRT_ABLATE_SV_BARRIERS  // (the scan without its barrier)
  __syncthreads();
#endif
  float W[LD_W];
#pragma unroll
  for (int w = 0; w < LD_W; ++w) W[w] = wt[w];
#pragma unroll
  for (int o = 1; o < LD_W; o <<= 1)
#pragma unroll
    for (int i = LD_W - 1; i >= o; --i) W[i] = W[i] + W[i - o];
  float wex = 0.0f;
#pragma unroll
  for (int w = 1; w < LD_W; ++w)
    if (w == wp) wex = W[w - 1];
  return wex + lane_ex;
}

// sv_scan_exclusive for the LD_W virtual warps of one real warp (the mid-d
// kernels' eval_team): x[w] is virtual thread lane + 32 w's value, out[w]
// its exclusive prefix (REV: suffix) sum, with the same additions: each
// virtual warp's Hillis-Steele scan over the lanes, the LD_W warp totals
// (read from lane 31, REV: lane 0) scanned in registers, then warp prefix
// + lane prefix.
template <bool REV>
__device__ __forceinline__ void sv_scan_team(const float (&x)[GR_SLOTS],
                                             float (&out)[GR_SLOTS]) {
  const int lane = threadIdx.x & 31;
  const int lp = REV ? 31 - lane : lane;
  float W[LD_W];
#pragma unroll
  for (int w = 0; w < GR_SLOTS; ++w) {
    float incl = x[w];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = REV ? __shfl_down_sync(0xffffffffu, incl, o)
                          : __shfl_up_sync(0xffffffffu, incl, o);
      if (lp >= o) incl = incl + y;
    }
    float lane_ex = REV ? __shfl_down_sync(0xffffffffu, incl, 1)
                        : __shfl_up_sync(0xffffffffu, incl, 1);
    if (lp == 0) lane_ex = 0.0f;
    out[w] = lane_ex;
    W[REV ? LD_W - 1 - w : w] =
        __shfl_sync(0xffffffffu, incl, REV ? 0 : 31);
  }
#pragma unroll
  for (int o = 1; o < LD_W; o <<= 1)
#pragma unroll
    for (int i = LD_W - 1; i >= o; --i) W[i] = W[i] + W[i - o];
#pragma unroll
  for (int w = 0; w < GR_SLOTS; ++w) {
    const int wp = REV ? LD_W - 1 - w : w;
    float wex = 0.0f;
#pragma unroll
    for (int k = 1; k < LD_W; ++k)
      if (k == wp) wex = W[k - 1];
    out[w] = wex + out[w];
  }
}

// The non-centered Student-t stochastic-volatility model
// (nuts_rs_tpu/models/stochastic_volatility.py:48-99) over
// q = [log_sigma, log_nu, eps_0..eps_{T-1}], d = T + 2, the returns r [T]
// in device memory.  With sigma = exp(q0), nu = exp(q1), k = (nu + 1) 0.5,
// c the cumulative sum of eps and, per t, h = sigma c, scale = exp(h 0.5),
// z = r / scale, w = z z / nu, L = log1p(w):
//   term = (A - log(scale)) - k L,
//   A = (lgamma(k) - lgamma(nu 0.5)) - 0.5 log(nu pi)
// (the JAX body's spelling), b = (k w) / (1 + w), a = b - 0.5 = dterm/dh;
//   logp = ((-lam_s sigma + q0) + (-lam_nu nu + q1)) + -0.5 sum eps^2
//          + sum term,
//   g0 = (1 - lam_s sigma) + sum a h,
//   g1 = ((1 - lam_nu nu) + T (0.5 nu (digamma(k) - digamma(nu 0.5)) - 0.5))
//        + sum (b - 0.5 nu L),
//   g_eps_t = sigma rs_t - eps_t,  rs the reverse cumulative sum of a.
// The scalars of a chain (sigma, nu, A and the digammas) every thread
// computes alike.
//
// Order, shared with the plain version
// (stochastic_volatility.py::stochastic_volatility_logp_grad).  Inside the
// functor thread t owns the contiguous run of R = ceil(T / LD_T) coordinates
// t R .. t R + R - 1 (a position past T counts 0.0); g is still written for
// the caller's strided coordinates after the Reducer's barrier.  The
// cumulative sum: the run's inclusive sums in ascending order, the exclusive
// scan of the LD_T run totals (sv_scan_exclusive), then prefix + local.  The
// reverse cumulative sum: the same with the run taken from its end and the
// suffix scan.  The four sums (term, a h, b - 0.5 nu L, eps^2): the run's
// terms in ascending order, then the Reducer (tsum's order over the LD_T run
// sums).  The run's values pass through `scratch` ([LD_T R]), which only
// their thread touches, the two scans' warp totals through 2 LD_W floats.
struct StochasticVolatility {
  static constexpr bool GROUP = false;
  const float* r;  // [T]
  float lam_s, lam_nu;
  int T;

  __host__ __device__ int run() const {
    return T > LD_T ? (T + LD_T - 1) / LD_T : 1;
  }

  __host__ __device__ size_t scratch_floats() const {
    return (size_t)LD_T * run() + 2 * LD_W;
  }

  __device__ __forceinline__ float eval_block(const float* q, float* g, int,
                                              Reducer& red,
                                              float* scratch) const {
    const int R = run();
    float* cs = scratch;  // [LD_T R]: the run's sums, then its a, then rs
    float* wt = scratch + (size_t)LD_T * R;  // [2][LD_W]
    const int base = threadIdx.x * R;
    const float ls = q[0], lnu = q[1];
    const float sigma = expf(ls), nu = expf(lnu);
    const float k = (nu + 1.0f) * 0.5f, nuh = nu * 0.5f;
    const float A = (sv_lgamma(k) - sv_lgamma(nuh)) - 0.5f * logf(nu * SV_PI);

    float cur = 0.0f;
    for (int i = 0; i < R; ++i) {
      const int s = base + i;
      const float e = s < T ? q[2 + s] : 0.0f;
      cur = i == 0 ? e : cur + e;
      cs[s] = cur;
    }
    const float pre = sv_scan_exclusive<false>(cur, wt);

    float part[4];  // term, a h, b - 0.5 nu L, eps^2
    for (int i = 0; i < R; ++i) {
      const int s = base + i;
      float term = 0.0f, ah = 0.0f, tn = 0.0f, ee = 0.0f, a = 0.0f;
      if (s < T) {
        const float e = q[2 + s];
        const float h = sigma * (pre + cs[s]);
        const float scale = expf(h * 0.5f);
        const float z = r[s] / scale;
        const float w = (z * z) / nu;
        const float L = sv_log1p(w);
        term = (A - logf(scale)) - k * L;
        const float b = (k * w) / (1.0f + w);
        a = b - 0.5f;
        ah = a * h;
        tn = b - nuh * L;
        ee = e * e;
      }
      acc(part[0], i, term);
      acc(part[1], i, ah);
      acc(part[2], i, tn);
      acc(part[3], i, ee);
      cs[s] = a;
    }
    float rc = 0.0f;
    for (int i = R - 1; i >= 0; --i) {
      const int s = base + i;
      rc = i == R - 1 ? cs[s] : rc + cs[s];
      cs[s] = rc;
    }
    const float suf = sv_scan_exclusive<true>(rc, wt + LD_W);
    for (int i = 0; i < R; ++i) {
      const int s = base + i;
      if (s < T) g[2 + s] = sigma * (suf + cs[s]) - q[2 + s];
    }
#if defined(NRT_ABLATE_SV_SCANS)
#elif defined(NRT_ABLATE_SV_BARRIERS)  // (the warps' sums alone)
#pragma unroll
    for (int k = 0; k < 4; ++k) part[k] = warp_sum(part[k]);
#else
    red.sum(part);  // its barrier also publishes g[2 + s]
#endif
    if (threadIdx.x == 0) g[0] = (1.0f - lam_s * sigma) + part[1];
    if (threadIdx.x == 1)
      g[1] = ((1.0f - lam_nu * nu) +
              (float)T * (nuh * (sv_digamma(k) - sv_digamma(nuh)) - 0.5f)) +
             part[2];
    float lp = (-lam_s * sigma + ls) + (-lam_nu * nu + lnu);
    lp = lp + -0.5f * part[3];
    return lp + part[0];
  }

  // The warp of one chain, eval_block's order: lane l runs the runs of its
  // virtual threads l + 32 w (sv_scan_team, slot_sum); the warp totals'
  // floats of the scratch are not used.
  __device__ __forceinline__ float eval_team(const float* q, float* g, int,
                                             float* scratch) const {
    const int R = run();
    float* cs = scratch;  // [LD_T R]: the runs' sums, then their a, then rs
    const int lane = threadIdx.x & 31;
    const float ls = q[0], lnu = q[1];
    const float sigma = expf(ls), nu = expf(lnu);
    const float k = (nu + 1.0f) * 0.5f, nuh = nu * 0.5f;
    const float A = (sv_lgamma(k) - sv_lgamma(nuh)) - 0.5f * logf(nu * SV_PI);

    float cur[GR_SLOTS];
#pragma unroll
    for (int w = 0; w < GR_SLOTS; ++w) {
      const int base = (lane + 32 * w) * R;
      for (int i = 0; i < R; ++i) {
        const int s = base + i;
        const float e = s < T ? q[2 + s] : 0.0f;
        cur[w] = i == 0 ? e : cur[w] + e;
        cs[s] = cur[w];
      }
    }
    float pre[GR_SLOTS];
    sv_scan_team<false>(cur, pre);

    float part[4][GR_SLOTS];  // term, a h, b - 0.5 nu L, eps^2
#pragma unroll
    for (int w = 0; w < GR_SLOTS; ++w) {
      const int base = (lane + 32 * w) * R;
      for (int i = 0; i < R; ++i) {
        const int s = base + i;
        float term = 0.0f, ah = 0.0f, tn = 0.0f, ee = 0.0f, a = 0.0f;
        if (s < T) {
          const float e = q[2 + s];
          const float h = sigma * (pre[w] + cs[s]);
          const float scale = expf(h * 0.5f);
          const float z = r[s] / scale;
          const float wv = (z * z) / nu;
          const float L = sv_log1p(wv);
          term = (A - logf(scale)) - k * L;
          const float b = (k * wv) / (1.0f + wv);
          a = b - 0.5f;
          ah = a * h;
          tn = b - nuh * L;
          ee = e * e;
        }
        acc(part[0][w], i, term);
        acc(part[1][w], i, ah);
        acc(part[2][w], i, tn);
        acc(part[3][w], i, ee);
        cs[s] = a;
      }
    }
    float rc[GR_SLOTS];
#pragma unroll
    for (int w = 0; w < GR_SLOTS; ++w) {
      const int base = (lane + 32 * w) * R;
      for (int i = R - 1; i >= 0; --i) {
        const int s = base + i;
        rc[w] = i == R - 1 ? cs[s] : rc[w] + cs[s];
        cs[s] = rc[w];
      }
    }
    float suf[GR_SLOTS];
    sv_scan_team<true>(rc, suf);
#pragma unroll
    for (int w = 0; w < GR_SLOTS; ++w) {
      const int base = (lane + 32 * w) * R;
      for (int i = 0; i < R; ++i) {
        const int s = base + i;
        if (s < T) g[2 + s] = sigma * (suf[w] + cs[s]) - q[2 + s];
      }
    }
    float tot[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[j] = slot_sum(part[j]);
    if (lane == 0) g[0] = (1.0f - lam_s * sigma) + tot[1];
    if (lane == 1)
      g[1] = ((1.0f - lam_nu * nu) +
              (float)T * (nuh * (sv_digamma(k) - sv_digamma(nuh)) - 0.5f)) +
             tot[2];
    float lp = (-lam_s * sigma + ls) + (-lam_nu * nu + lnu);
    lp = lp + -0.5f * tot[3];
    return lp + tot[0];
  }
};

// Most floats and tensors of a kernel hook: a shared-memory probe hands
// with_block_model this many placeholders.
constexpr int MAX_MODEL_PARAMS = 4;
constexpr int MAX_MODEL_PTRS = 4;

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
    case MODEL_CORRELATED_NORMAL_RANK1:
      return fn(CorrelatedNormalRank1{static_cast<const float*>(ptrs[0]),
                                      static_cast<const float*>(ptrs[1]),
                                      params[0]});
    case MODEL_RADON:
      return fn(Radon{static_cast<const float*>(ptrs[0]),
                      static_cast<const float*>(ptrs[1]),
                      static_cast<const int*>(ptrs[2]), ints[0], ints[1]});
    case MODEL_STOCHASTIC_VOLATILITY:
      return fn(StochasticVolatility{static_cast<const float*>(ptrs[0]),
                                     params[0], params[1], ints[0]});
    case MODEL_FUNNEL:
      return fn(Funnel{});
    case MODEL_CORRELATED_NORMAL:
      return fn(CorrelatedNormal{params[0]});
  }
  return cudaErrorInvalidValue;
}

}  // namespace nrt

// Every kernel library exports the text of a launch's return code.
extern "C" const char* nrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
