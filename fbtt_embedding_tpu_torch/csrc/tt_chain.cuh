// Per-lookup TT chain in shared memory, for Hopper (sm_90a). Shared by the
// chain passes of tt_fwd.cu (kernel B4) and tt_bwd.cu (kernel B5), which
// run where the pivot passes cannot stage a middle core (the pivot passes
// share each span's slab instead, see there), and the sub-chains those
// pivot passes run at tt_ndim 4; see those files for what each replaces.
//
// A lookup's row is the chain G_0[i_0] G_1[i_1] ... G_{n-1}[i_{n-1}]
// (tt_ndim n = 2..4). With m_t = q_0 * ... * q_t, the running state before
// core t is z_{t-1} viewed as [m_{t-1}, r_t]; core t's slab is
// [r_t, q_t * r_{t+1}] and
//
//     z_t = z_{t-1} @ G_t[i_t]    ([m_{t-1}, q_t r_{t+1}] = [m_t, r_{t+1}])
//
// so the last state, [m_{n-1}] = [D], is the row with its d-index in the
// canonical (a_0, a_1, ...) digit order of tt_matrix_to_full. Back through
// one core, for the cotangent dz_t of z_t:
//
//     dz_{t-1} = dz_t @ G_t[i_t]^T      dG_t[i_t] += z_{t-1}^T @ dz_t
//
// A CTA runs the chain for a chunk of `lc` lookups at once: every state of
// the chunk lives in shared memory, `zs` floats per lookup (the largest
// m_t * r_{t+1}). In one step each thread computes a column of kRowBlock
// rows of one lookup's output in registers, so every slab element it
// reads from global memory (the cores are a few MB and stay in L2) feeds
// kRowBlock multiply-adds; neighbouring threads take neighbouring
// columns, so a warp's slab reads are coalesced. The backward step reads
// a transposed copy of the core (gt, made by the wrapper) for the same
// reason. Float32 throughout, on the CUDA cores. Bound: each slab element
// read from L2 feeds only kRowBlock multiply-adds, ~3 FLOP a byte at the
// headline shape: such a pass runs far from the CUDA cores' 67 TFLOP/s,
// which is why every config the pivot passes can stage takes them (root
// PERF.md for the times of both).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fbtt_chain {

constexpr int kThreads = 256;
constexpr int kMaxDim = 4;
constexpr int kMaxChunk = 32;  // lookups per chunk (lc <= kMaxChunk)
constexpr int kRowBlock = 4;   // rows of a thread's register column

struct Chain {
  int ndim;
  int nnz;
  int q[kMaxDim];
  int r[kMaxDim + 1];  // boundary ranks, r[0] = r[ndim] = 1
  int m[kMaxDim];      // m[t] = q[0] * ... * q[t]
  int rows[kMaxDim];   // core rows T * p_t
  const float* g[kMaxDim];   // core t, row i: [r_t, q_t r_{t+1}] floats
  const float* gt[kMaxDim];  // transposed: [q_t r_{t+1}, r_t] (t >= 1; may be null)
  const int* idx;            // [ndim, nnz] core rows of every lookup
  int src[kMaxDim];  // the row of idx that holds core t's rows; -1: core t is
                     // a per-lookup buffer, read at the lookup's id (sub_chain)
};

// The chain of a C entry point's arguments: q[0..ndim), the inner ranks
// r_1 .. r_{ndim-1} in rin, the kernel-layout cores g[0..ndim).
inline Chain make_chain(int ndim, int nnz, const int* q, const int* rin,
                        const int* rows, const void* const* g, const void* const* gt,
                        const int* idx) {
  Chain c{};
  c.ndim = ndim;
  c.nnz = nnz;
  c.idx = idx;
  c.r[0] = 1;
  int m = 1;
  for (int t = 0; t < ndim; ++t) {
    c.q[t] = q[t];
    c.r[t + 1] = t + 1 < ndim ? rin[t] : 1;
    m *= q[t];
    c.m[t] = m;
    c.rows[t] = rows[t];
    c.g[t] = static_cast<const float*>(g[t]);
    c.gt[t] = gt ? static_cast<const float*>(gt[t]) : nullptr;
    c.src[t] = t;
  }
  return c;
}

// Cores t0 .. t1 of c as a chain of their own, for the pivot passes of a
// tt_ndim-4 chain (tt_fwd.cu, tt_bwd.cu). Where t0 > 0 its core 0 is the
// per-lookup buffer z of z_{t0-1} ([m_{t0-1}, r_{t0}] floats a lookup, at
// the lookup's id), with q_0 = m_{t0-1}; where t1 < ndim - 1 its last core
// is core t1 with its q_{t1} r_{t1+1} columns as its q, so that its row is
// z_{t1}. The head (0, 1) and the tail (2, 3) of a tt_ndim-4 chain are
// tt_ndim-2 and tt_ndim-3 chains whose rows are z_1 and the lookup's row.
inline Chain sub_chain(const Chain& c, int t0, int t1, const float* z) {
  Chain s{};
  s.nnz = c.nnz;
  s.idx = c.idx;
  s.r[0] = 1;
  int n = 0;
  if (t0 > 0) {
    s.q[0] = c.m[t0 - 1];
    s.r[1] = c.r[t0];
    s.g[0] = z;
    s.src[0] = -1;
    n = 1;
  }
  for (int t = t0; t <= t1; ++t, ++n) {
    s.q[n] = c.q[t];
    s.r[n + 1] = c.r[t + 1];
    s.g[n] = c.g[t];
    s.rows[n] = c.rows[t];
    s.src[n] = t;
  }
  if (t1 < c.ndim - 1) {
    s.q[n - 1] *= c.r[t1 + 1];
    s.r[n] = 1;
  }
  s.ndim = n;
  int m = 1;
  for (int t = 0; t < n; ++t) {
    m *= s.q[t];
    s.m[t] = m;
  }
  return s;
}

// The row of core t that lookup lk reads (a sub-chain's buffer core: lk).
__device__ __forceinline__ int core_row(const Chain& c, int t, int lk) {
  return c.src[t] < 0 ? lk : c.idx[static_cast<size_t>(c.src[t]) * c.nnz + lk];
}

// The chunk's core rows, per core, staged by the caller in shared memory.
struct ChunkIdx {
  int core[kMaxDim][kMaxChunk];
};

__host__ __device__ __forceinline__ int slab_size(const Chain& c, int t) {
  return c.r[t] * c.q[t] * c.r[t + 1];
}

// out[l] = G_0[i_0 of lookup l], [m_0 * r_1] floats each
__device__ void gather_first(const Chain& c, const ChunkIdx& ci, int n,
                             float* out, int zs) {
  const int w = slab_size(c, 0);
  for (int e = threadIdx.x; e < n * w; e += kThreads) {
    const int l = e / w;
    const int k = e - l * w;
    out[l * zs + k] = c.g[0][static_cast<size_t>(ci.core[0][l]) * w + k];
  }
}

// out[l][i][col] = sum_k in[l][i][k] * b[k * nc + col] for rows i < mi,
// k < kd and columns col < nc of every lookup l < n, with b = base +
// rows[l] * kd * nc the lookup's [kd, nc] slab. Each thread holds a column
// of kRowBlock rows in registers; rows past mi repeat the last row
// (computed, never stored).
__device__ void rows_times_slab(const float* __restrict__ base, const int* rows, int n,
                                int mi, int kd, int nc, const float* in, float* out,
                                int zs) {
  const int blocks = (mi + kRowBlock - 1) / kRowBlock;
  const int per = blocks * nc;
  for (int e = threadIdx.x; e < n * per; e += kThreads) {
    const int l = e / per;
    const int rem = e - l * per;
    const int ib = rem / nc;
    const int col = rem - ib * nc;
    const int i0 = ib * kRowBlock;
    const int ni = min(kRowBlock, mi - i0);
    const float* a[kRowBlock];
#pragma unroll
    for (int u = 0; u < kRowBlock; ++u) a[u] = in + l * zs + (i0 + min(u, ni - 1)) * kd;
    const float* b = base + static_cast<size_t>(rows[l]) * kd * nc + col;
    float acc[kRowBlock];
#pragma unroll
    for (int u = 0; u < kRowBlock; ++u) acc[u] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kd; ++k) {
      const float bv = b[static_cast<size_t>(k) * nc];
#pragma unroll
      for (int u = 0; u < kRowBlock; ++u) acc[u] = fmaf(a[u][k], bv, acc[u]);
    }
    float* o = out + l * zs + i0 * nc + col;
#pragma unroll
    for (int u = 0; u < kRowBlock; ++u) {
      if (u < ni) o[u * nc] = acc[u];
    }
  }
}

// One forward step through core t >= 1: out[l] = in[l] @ G_t[i_t of l],
// [m_{t-1}, r_t] @ [r_t, w] with w = q_t r_{t+1}.
__device__ void forward_step(const Chain& c, const ChunkIdx& ci, int t, int n,
                             const float* in, float* out, int zs) {
  rows_times_slab(c.g[t], ci.core[t], n, c.m[t - 1], c.r[t], c.q[t] * c.r[t + 1], in,
                  out, zs);
}

// One backward step through core t >= 1: out[l] = in[l] @ G_t[i_t of l]^T,
// [m_{t-1}, w] @ [w, r_t], reading the transposed core.
__device__ void backward_step(const Chain& c, const ChunkIdx& ci, int t, int n,
                              const float* in, float* out, int zs) {
  rows_times_slab(c.gt[t], ci.core[t], n, c.m[t - 1], c.q[t] * c.r[t + 1], c.r[t], in,
                  out, zs);
}

// z_{last} for the chunk, from the staged core rows: the gather and the
// forward steps 1 .. last, ping-ponging between `a` and `b` so that the
// result lands in `dst` (which is `a` or `b`). Ends with a barrier.
__device__ void forward_chain(const Chain& c, const ChunkIdx& ci, int last,
                              int n, float* a, float* b, float* dst, int zs) {
  // `last` steps after the gather: start where an even count ends in dst
  float* cur = (last % 2 == 0) ? dst : (dst == a ? b : a);
  float* nxt = (cur == a) ? b : a;
  gather_first(c, ci, n, cur, zs);
  __syncthreads();
  for (int t = 1; t <= last; ++t) {
    forward_step(c, ci, t, n, cur, nxt, zs);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

}  // namespace fbtt_chain
