// Per-lookup TT core gradients for Hopper (sm_90a): kernel B5.
//
// Replaces the Pallas TPU kernel fbtt_embedding_tpu/ops/pallas/tt_kernel.py
// :: _make_bwd_call (through tt_backward_pallas). For every lookup l with
// pooled row b_l and weight w_l, the cotangent of its row is
// w_l * d_output[b_l]; pushed back through the chain (tt_chain.cuh) it
// gives, for every core t,
//
//     dG_t[i_t of l] += z_{t-1}^T @ dz_t        ([r_t, q_t r_{t+1}], float32)
//
// with z_{t-1} the forward state before core t ([m_{t-1}, r_t]; 1 for
// t = 0) and dz_t the cotangent of the state after it. Padding and dead
// lookups add nothing.
//
// Design. The TPU kernel reduces per-lookup slabs with one-hot products in
// one sequential grid. On Hopper a core row's lookups are spread over the
// batch, and float atomics would make the gradients depend on the
// schedule, so the scheme of seg_span.cuh (kernels B2, B3) is carried
// over: for each core t the host sorts the lookups stably by i_t (dead and
// padding get the sentinel key rows_t), and kernel 1 runs one CTA per
// (seg-row segment of that order, core t). The CTA walks the spans that
// meet its segment; for each live span it runs the span's lookups in
// chunks of `lc` (z_{t-1} by the forward steps 0 .. t-1, dz_t by the
// backward steps from the last core down to t+1: the chain is linear, so
// neither needs the other) and adds z^T dz into a float32 tile, each
// element owned by one thread, in lookup order. The tile goes to slot
// s + j of the core's partial buffer (unique, as in seg_span.cuh), and
// kernel 2 (one CTA per core row j and core t) adds row j's tiles in
// segment order. No atomics: bitwise repeatable. Segments are balanced
// whatever the skew: under Zipf(1.05) one i0 row owns about half the
// lookups, and one CTA per core row would serialise them.
//
// Each lookup's chain runs once per core it updates, in pieces that add
// up to one forward and one backward at tt_ndim 3 (core 0: the whole
// backward; core 1: the last backward step; core 2: the forward), so no
// work is repeated there; at tt_ndim 4 the middle steps run twice.
//
// Bound: operations. At the headline shape a lookup costs ~106 kFLOP
// (forward ~37k; back through G2 and G1 and the dG1, dG2 products ~74k),
// ~1.09 GFLOP at nnz 10240: ~16 us at 67 TFLOP/s on the CUDA cores,
// against ~7.7 MB moved. Two launches per call.

#include "tt_chain.cuh"

using namespace fbtt_chain;

// acc[k][col] += sum over the chunk's lookups l and rows i of
// x[l][i][k] * y[l][i][col] (x [mi, rk], y [mi, w] per lookup), in lookup
// order. Each thread owns a column of KB rows of the tile: the same
// elements for every chunk, so the sums need no barrier between chunks.
template <int KB>
__device__ void accumulate_tile(float* acc, const float* xa, const float* ya, int n,
                                int mi, int rk, int w, int zs) {
  const int blocks = (rk + KB - 1) / KB;
  for (int e = threadIdx.x; e < blocks * w; e += kThreads) {
    const int kb = e / w;
    const int col = e - kb * w;
    const int k0 = kb * KB;
    const int nk = min(KB, rk - k0);
    float a[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u) a[u] = u < nk ? acc[(k0 + u) * w + col] : 0.f;
    for (int l = 0; l < n; ++l) {
      const float* xl = xa + l * zs + k0;
      const float* yl = ya + l * zs + col;
      for (int i = 0; i < mi; ++i) {
        const float yv = yl[i * w];
#pragma unroll
        for (int u = 0; u < KB; ++u) a[u] = fmaf(xl[i * rk + min(u, nk - 1)], yv, a[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      if (u < nk) acc[(k0 + u) * w + col] = a[u];
    }
  }
}

struct Offsets {
  size_t part[kMaxDim];  // core t's partial tiles in `partial`
  size_t grad[kMaxDim];  // core t's gradient rows in `grads`
};

__global__ void __launch_bounds__(kThreads)
tt_bwd_kernel(Chain c, const float* __restrict__ weights, const int* __restrict__ rowv,
              const float* __restrict__ dout, const int* __restrict__ orders,
              const int* __restrict__ runs, const int* __restrict__ first,
              const int* __restrict__ cnt, float* __restrict__ partial, Offsets off,
              int nza, int nseg, int seg, int rstride, int lc, int zs) {
  extern __shared__ float smem[];
  __shared__ ChunkIdx ci;
  __shared__ float cw[kMaxChunk];
  __shared__ int crow[kMaxChunk];
  const int t = blockIdx.y;
  const int s = blockIdx.x;
  float* xa = smem;          // z_{t-1} of the chunk
  float* ya = xa + lc * zs;  // dz_t of the chunk
  float* wk = ya + lc * zs;  // scratch of both chains
  float* acc = wk + lc * zs; // [r_t, w], each element owned by one thread
  const int rk = c.r[t];
  const int w = c.q[t] * c.r[t + 1];
  const int mi = t > 0 ? c.m[t - 1] : 1;
  const int tile = rk * w;
  const int d = c.m[c.ndim - 1];
  const int* ord = orders + static_cast<size_t>(t) * nza;
  const int* rn = runs + static_cast<size_t>(t) * rstride;
  const int base = s * seg;
  const int j0 = first[t * nseg + s];
  const int nspan = cnt[t * nseg + s];
  const int nb = c.ndim - 1 - t;  // backward steps down to core t
  // a tile with enough columns of kRowBlock rows for every thread
  const bool wide = rk >= kRowBlock && tile >= kRowBlock * kThreads;

  for (int k = 0; k < nspan; ++k) {
    const int j = j0 + k;
    // CTA-uniform: every __syncthreads() below is reached by all or none
    const int st = max(rn[j], base);
    const int en = min(rn[j + 1], base + seg);
    if (en <= st || j >= c.rows[t]) continue;  // empty, or the sentinel span
    for (int e = threadIdx.x; e < tile; e += kThreads) acc[e] = 0.f;
    for (int cb = st; cb < en; cb += lc) {
      const int n = min(lc, en - cb);
      __syncthreads();  // the previous chunk's states and ids are no longer read
      if (threadIdx.x < n) {
        const int lk = ord[cb + threadIdx.x];
        for (int u = 0; u < c.ndim; ++u) {
          ci.core[u][threadIdx.x] = c.idx[static_cast<size_t>(u) * c.nnz + lk];
        }
        const int row = rowv[lk];
        crow[threadIdx.x] = max(row, 0);
        cw[threadIdx.x] = row < 0 ? 0.f : (weights ? weights[lk] : 1.f);
      }
      __syncthreads();
      if (t == 0) {
        if (threadIdx.x < n) xa[threadIdx.x * zs] = 1.f;
      } else {
        forward_chain(c, ci, t - 1, n, xa, wk, xa, zs);
      }
      // dz_{last} = w * d_output[row], then back to dz_t, landing in ya
      float* cur = (nb % 2 == 0) ? ya : wk;
      float* nxt = (cur == ya) ? wk : ya;
      for (int e = threadIdx.x; e < n * d; e += kThreads) {
        const int l = e / d;
        const int k2 = e - l * d;
        cur[l * zs + k2] = cw[l] * dout[static_cast<size_t>(crow[l]) * d + k2];
      }
      __syncthreads();
      for (int u = c.ndim - 1; u > t; --u) {
        backward_step(c, ci, u, n, cur, nxt, zs);
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
      if (wide) {
        accumulate_tile<kRowBlock>(acc, xa, ya, n, mi, rk, w, zs);
      } else {
        accumulate_tile<1>(acc, xa, ya, n, mi, rk, w, zs);
      }
    }
    __syncthreads();  // acc was written column-wise; it is read out linearly
    float* dst = partial + off.part[t] + static_cast<size_t>(s + j) * tile;
    for (int e = threadIdx.x; e < tile; e += kThreads) dst[e] = acc[e];
  }
}

// One CTA per (core row j, core t): dG_t[j] = row j's partial tiles added
// in segment order (zero for a row no lookup touched).
__global__ void __launch_bounds__(kThreads)
tt_bwd_reduce_kernel(Chain c, const int* __restrict__ runs,
                     const float* __restrict__ partial, float* __restrict__ grads,
                     Offsets off, int seg, int rstride) {
  const int t = blockIdx.y;
  const int j = blockIdx.x;
  if (j >= c.rows[t]) return;
  const int tile = slab_size(c, t);
  const int* rn = runs + static_cast<size_t>(t) * rstride;
  const int st = rn[j];
  const int en = rn[j + 1];
  float* out = grads + off.grad[t] + static_cast<size_t>(j) * tile;
  if (en <= st) {
    for (int e = threadIdx.x; e < tile; e += kThreads) out[e] = 0.f;
    return;
  }
  const int s_lo = st / seg;
  const int s_hi = (en - 1) / seg;
  const float* p = partial + off.part[t];
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    float sum = p[static_cast<size_t>(s_lo + j) * tile + e];
    for (int s = s_lo + 1; s <= s_hi; ++s) sum += p[static_cast<size_t>(s + j) * tile + e];
    out[e] = sum;
  }
}

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 on success). g0..g3: the kernel core layouts (float32;
// unused ones null), gt1..gt3 the transposes [T*p_t, q_t r_{t+1}, r_t] of
// g1..g3; idx [ndim, nnz] int32 core rows; weights [nnz] or
// null; rowv [nnz] pooled rows (-1: no row); dout [T*B, D]; per core t:
// orders [ndim, nza] the lookups sorted stably by their core-t row,
// runs [ndim, rstride] span starts, first / cnt [ndim, nseg] the spans of
// each segment. partial holds sum_t (nseg + rows_t) tiles and grads
// sum_t rows_t tiles of r_t q_t r_{t+1} floats, core after core. lc and
// zs as the wrapper sized the shared memory.
int fbtt_tt_bwd(const void* g0, const void* g1, const void* g2, const void* g3,
                const void* gt1, const void* gt2, const void* gt3, const int* idx, const float* weights, const int* rowv,
                const float* dout, const int* orders, const int* runs,
                const int* first, const int* cnt, float* partial, float* grads,
                int ndim, int nnz, int nza, int nseg, int seg, int rstride, int q0,
                int q1, int q2, int q3, int r1, int r2, int r3, int rows0, int rows1,
                int rows2, int rows3, int lc, int zs, void* stream) {
  const int q[kMaxDim] = {q0, q1, q2, q3};
  const int rin[kMaxDim - 1] = {r1, r2, r3};
  const int rows[kMaxDim] = {rows0, rows1, rows2, rows3};
  const void* g[kMaxDim] = {g0, g1, g2, g3};
  const void* gt[kMaxDim] = {nullptr, gt1, gt2, gt3};
  const Chain c = make_chain(ndim, nnz, q, rin, rows, g, gt, idx);
  Offsets off{};
  size_t part = 0, grad = 0;
  int tile_max = 0, rows_max = 0;
  for (int t = 0; t < ndim; ++t) {
    const int tile = c.r[t] * c.q[t] * c.r[t + 1];
    off.part[t] = part;
    off.grad[t] = grad;
    part += static_cast<size_t>(nseg + rows[t]) * tile;
    grad += static_cast<size_t>(rows[t]) * tile;
    tile_max = tile > tile_max ? tile : tile_max;
    rows_max = rows[t] > rows_max ? rows[t] : rows_max;
  }
  const size_t smem = (3 * static_cast<size_t>(lc) * zs + tile_max) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      tt_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nseg > 0) {
    tt_bwd_kernel<<<dim3(nseg, ndim), kThreads, smem, st>>>(
        c, weights, rowv, dout, orders, runs, first, cnt, partial, off, nza, nseg, seg,
        rstride, lc, zs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows_max > 0) {
    tt_bwd_reduce_kernel<<<dim3(rows_max, ndim), kThreads, 0, st>>>(
        c, runs, partial, grads, off, seg, rstride);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
