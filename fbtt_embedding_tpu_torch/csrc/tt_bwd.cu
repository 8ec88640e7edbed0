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
// Schedule. The TPU kernel reduces per-lookup slabs with one-hot products
// in one sequential grid. On Hopper a core row's lookups are spread over
// the batch, and float atomics would make the gradients depend on the
// schedule, so the host sorts the lookups stably by each core's row i_t
// (dead and padding get the sentinel key rows_t) and every sum runs in a
// fixed order: each core's sorted order is cut into chunks of rows, a
// chunk's float32 sum of span j (the lookups of core row j) is written as
// partial tile c + j (unique: a later chunk only meets later spans), and
// the reduce kernel adds row j's tiles in chunk order. No atomics: bitwise
// repeatable. Chunks of rows, not of spans, keep the work balanced whatever
// the skew: under Zipf(1.05) one core row owns about half the lookups.
//
// Two paths (fbtt_tt_bwd_path; the wrapper asks it which one runs).
//
// The pivot path (wherever the middle cores' slabs stage). At tt_ndim 2
// and 3 one pivot pass, the end sums and the reduce: three launches. At
// the headline shape (q=[4,4,4], ranks [32,32]) 92% of
// a lookup's 53 k multiply-adds are products with core 1's slab G_1[i_1]
// (32 x 128 floats, 16 KB): z_1 = z_0 G_1, dG_1 = z_0^T dz_1 and dz_0 =
// dz_1 G_1^T, 16 k each, which the chain pass read per lookup from L2 (~3
// FLOP a byte). Here one kernel runs over core 1's sorted order (tt_ndim 2:
// the last core), one CTA per even share of it (two CTAs an SM, one wave),
// and for each span j that meets its chunk stages G_1[j] once in shared
// memory and runs the span's lookups through it in sub-chunks of lc: z_0 =
// G_0[i_0] is gathered, dz_1 formed per lookup (tt_ndim 3: w * d_output[b]
// through the last core's [r_2, q_2] slab; tt_ndim 2: w * d_output[b]
// itself), and the three products run as GEMMs of lc q_0 rows on the
// staged slab on the tensor cores, as 3xTF32 mma.sync.m16n8k8 (each
// float32 operand split into a TF32 part and the TF32 rest; float32
// accuracy). dG_1[j] stays in the warps' mma tiles across the span's
// sub-chunks. The end cores' contributions (dz_0 for core 0, z_1^T dz_2 for
// the last core) leave per lookup as float32 slabs in a scratch buffer; a
// second kernel adds them per span in 32-row chunks of that core's own
// order, and the reduce kernel adds the chunks.
//
// At tt_ndim 4 (five launches) both middle cores' gradients take tiles
// kept across spans, and no one order stages both slabs; the other middle
// core's per-lookup slab through scratch (as the end cores') would be
// 32 x 128 or 32 x 64 floats a lookup, 84-168 MB at nnz 10240 for the
// billion-row model (q = [2,4,2,4], ranks 32). So the path runs one pivot
// pass per middle core, each the pass above on a sub-chain (tt_chain.cuh),
// with the states that cross between them by lookup in two buffers of
// [nnz, q_0 q_1 r_2] floats (10.5 MB each at that model; in L2): (1) the
// forward's head pass (tt_fwd_pivot.cuh, cores 0-1, weight 1) writes z_1
// over core 1's order; (2) the tail pass (a tt_ndim-3 chain: z_1 read at
// the lookup's id, cores 2 and 3) over core 2's order keeps dG_2[j] in
// tiles, writes dz_1 = dz_2 G_2^T to the second buffer and z_2^T dz_3 (the
// last core's slab) to scratch; (3) the head pass (a tt_ndim-2 chain,
// cores 0-1) over core 1's order, with dz_1 read at the lookup's id for its
// row cotangent, keeps dG_1[j] in tiles and writes dz_0 to scratch; then
// the end sums (cores 0 and 3) and the reduce.
//
// The chain pass (configs the pivot path cannot stage; two launches): one CTA
// per (seg-row segment of core t's order, core t) runs each of its lookups'
// chains in chunks of lc (z_{t-1} by the forward steps 0 .. t-1, dz_t by the
// backward steps from the last core down to t+1) on the CUDA cores and adds
// z^T dz into a float32 tile. Each lookup's chain runs once per core it
// updates; every slab but core t's is read per lookup from L2.
//
// Bound: operations. At the headline shape a lookup costs ~106 kFLOP (forward
// ~37k; back through G2 and G1 and the dG1, dG2 products ~74k), ~1.09 GFLOP
// at nnz 10240: ~16 us at 67 TFLOP/s on the CUDA cores (the chain pass), ~6.6
// us as three TF32 products at 495 TFLOP/s on the tensor cores (the pivot
// pass), against ~7.7 MB moved (~2.3 us at 3.35 TB/s; the pivot pass adds ~10
// MB of scratch and ~8 MB of partial tiles, mostly in L2). At the tt_ndim-4
// model ~156 kFLOP a lookup: ~23.8 us on the CUDA cores, ~9.7 us as 3xTF32,
// against ~10.4 MB (~3.1 us; the path adds ~29 MB of buffers and scratch,
// written and read once).

#include "tt_chain.cuh"
#include "tt_fwd_pivot.cuh"
#include "tt_mma.cuh"

using namespace fbtt_chain;
using namespace fbtt_mma;

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
  int chunk[kMaxDim];    // rows of core t's order per chunk: tile c + j is chunk
                         // c's sum of span j
  int cta[kMaxDim + 1];  // the reduce kernel's first work block of core t, then
                         // their count (reduce_blocks)
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

// ---------------------------------------------------------------------------
// The pivot pass

constexpr int kPivotChunkMax = 16;          // lookups per sub-chunk (lc <= this)
constexpr int kPivotSmemPref = 100 * 1024;  // take the largest lc within this
constexpr int kPivotSmemMax = 200 * 1024;   // else lc = 4 within this
constexpr int kWarps = kThreads / 32;
constexpr int kTilesMax = 16;               // 16 x 8 tiles of dG_1 per warp
constexpr int kEndChunk = 32;               // rows per chunk of the end cores' sums
constexpr int kRedFloats = kWarps * 128;    // the K-split warps' dG_1 tiles
constexpr int kIdWindow = 64;               // rows whose ids a pivot CTA stages

// Pivot CTAs an SM holds at once with TPW tiles of dG_1 a warp.
__host__ __device__ constexpr int pivot_ctas_per_sm(int tpw) { return tpw <= 4 ? 2 : 1; }

// The pivot core's shapes (core 1; at tt_ndim 2 also the last core).
struct Pivot {
  int m0;   // q_0: rows of z_0 (and of dz_0, dz_1) per lookup
  int R;    // r_1: rows of the pivot slab
  int W;    // q_1 r_2: its columns
  int gs;   // W + 4: padded row stride of the staged slab and of dz_1 / z_1
  int zs;   // R + 4: padded row stride of z_0
  int d;    // floats of a pooled row
  int r2, q2, q1, m1;    // tt_ndim 3: the last core's slab [r2, q2]; m1 = q0 q1
  int tile0, tile_last;  // per-lookup slabs of core 0 and of the last core
  int tiles;             // 16 x 8 tiles of dG_1
  int tpw;               // of them per warp (1: split K among warps)
  FastDiv f_m0, f_m1, f_q1, f_R4, f_W4, f_d4, f_r2, f_q2, f_r24, f_q24, f_r2q2, f_W8, f_R16;
};

inline Pivot make_pivot(const Chain& c) {
  Pivot p{};
  p.m0 = c.q[0];
  p.R = c.r[1];
  p.W = c.q[1] * c.r[2];
  p.gs = p.W + 4;
  p.zs = p.R + 4;
  p.d = c.m[c.ndim - 1];
  p.q1 = c.q[1];
  p.r2 = c.ndim == 3 ? c.r[2] : 1;
  p.q2 = c.ndim == 3 ? c.q[2] : 1;
  p.m1 = c.m[1];
  p.tile0 = c.q[0] * c.r[1];
  p.tile_last = c.ndim == 3 ? p.r2 * p.q2 : 0;
  p.tiles = (p.R / 16) * (p.W / 8);
  p.tpw = 1;
  while (p.tpw * kWarps < p.tiles) p.tpw *= 2;
  auto fd = [](int x) { return fast_div(x > 0 ? x : 1); };
  p.f_m0 = fd(p.m0);
  p.f_m1 = fd(p.m1);
  p.f_q1 = fd(p.q1);
  p.f_R4 = fd(p.R / 4);
  p.f_W4 = fd(p.W / 4);
  p.f_d4 = fd(p.d / 4);
  p.f_r2 = fd(p.r2);
  p.f_q2 = fd(p.q2);
  p.f_r24 = fd(p.r2 / 4);
  p.f_q24 = fd((p.q2 + 3) / 4);
  p.f_r2q2 = fd(p.r2 * p.q2);
  p.f_W8 = fd(p.W / 8);
  p.f_R16 = fd(p.R / 16);
  return p;
}

// Rows of a sub-chunk's products: lc q_0 rounded up to whole 16-row tiles.
__host__ __device__ inline int pivot_rows(const Pivot& p, int lc) {
  return (lc * p.m0 + 15) / 16 * 16;
}

// Shared memory of a pivot CTA with sub-chunks of lc lookups: the slab
// [R][gs], z_0 [rows][zs], dz_1 / z_1 [rows][gs], at tt_ndim 3 the
// sub-chunk's w * d_output rows [lc][d] and last-core slabs [lc][r2 q2],
// and the K-split warps' dG_1 tiles.
inline size_t pivot_smem_bytes(const Chain& c, const Pivot& p, int lc) {
  size_t f = static_cast<size_t>(p.R) * p.gs +
             static_cast<size_t>(pivot_rows(p, lc)) * (p.zs + p.gs) + kRedFloats;
  if (c.ndim == 3) f += static_cast<size_t>(lc) * (p.d + p.r2 * p.q2);
  return f * sizeof(float);
}

// lc of the pivot path, or 0 where it does not take the config: tt_ndim 2
// or 3, the tensor-core tiles (r_1 a multiple of 16, q_1 r_2 of 8), float4
// rows (D and, at tt_ndim 3, r_2 multiples of 4), dG_1 within kTilesMax
// tiles a warp, all in one row of tiles, the slab and a sub-chunk of 4
// lookups within kPivotSmemMax bytes of shared memory, and every index of
// a sub-chunk's loops within FastDiv's range; at tt_ndim 4 the same of
// both its passes (the head's and the tail's, see fbtt_tt_bwd), at the
// least of their lc, and the forward's rule of the head pass.
inline int pivot_chunk(const Chain& c) {
  if (c.ndim == 4) {
    // the head's forward pass writes z_1; the tail (core 2) and the head
    // (core 1) then run this rule's passes, at the least of their lc
    const Chain head = sub_chain(c, 0, 1, nullptr), tail = sub_chain(c, 2, 3, nullptr);
    if (!fbtt_fwd::fwd_pivot_chunk(head)) return 0;
    const int a = pivot_chunk(head), b = pivot_chunk(tail);
    return a && b ? std::min(a, b) : 0;
  }
  if (c.ndim != 2 && c.ndim != 3) return 0;
  const Pivot p = make_pivot(c);
  if (p.R % 16 || p.W % 8 || p.d % 4 || (c.ndim == 3 && p.r2 % 4)) return 0;
  if (p.tpw > kTilesMax || (p.W / 8) % p.tpw || p.R * p.gs >= kIndexMax) return 0;
  auto fits = [&](int lc, size_t smem) {
    return pivot_smem_bytes(c, p, lc) <= smem && pivot_rows(p, lc) * p.gs < kIndexMax &&
           lc * (p.d + p.r2 * p.q2) < kIndexMax;
  };
  for (int lc = kPivotChunkMax; lc >= 4; lc -= 4) {
    if (fits(lc, kPivotSmemPref)) return lc;
  }
  return fits(4, kPivotSmemMax) ? 4 : 0;
}

// 16 x 8 tiles of dG a warp holds on the pivot path: the most of its passes.
inline int pivot_tpw(const Chain& c) {
  if (c.ndim != 4) return make_pivot(c).tpw;
  return std::max(make_pivot(sub_chain(c, 0, 1, nullptr)).tpw,
                  make_pivot(sub_chain(c, 2, 3, nullptr)).tpw);
}

// Threads per chunk of the end-core sums: a power of two up to kThreads,
// at least the slab's floats.
__host__ __device__ inline int end_lanes(int tile) {
  int lanes = 32;
  while (lanes < kThreads && lanes < tile) lanes *= 2;
  return lanes;
}

// The span (core-t row) of lookup lk, as core_orders keyed it: rows_t
// (the sentinel) for a dead or padding lookup.
__device__ __forceinline__ int span_key(const Chain& c, const int* __restrict__ rowv, int t,
                                        int lk) {
  return lk < c.nnz && rowv[lk] >= 0 ? core_row(c, t, lk) : c.rows[t];
}

// The pivot pass of chain c (tt_ndim NDIM: a whole chain, or a sub_chain
// of a tt_ndim-4 one): one CTA per chunk c of `sub` rows of the order of
// c's core 1 (ord, span starts rn); its tiles of dG_1 to part (c + j: the
// chunk's sum of span j). TPW: 16 x 8 tiles of dG_1[j] per warp, in
// registers across the span. The row cotangent (dz_1 at tt_ndim 2, dz_2 at
// 3) is w * dout[rowv[lookup]], or with dz_by_lookup dout[lookup] (a
// buffer by lookup id, weights null).
template <int NDIM, int TPW>
__global__ void __launch_bounds__(kThreads, pivot_ctas_per_sm(TPW))
tt_bwd_pivot_kernel(Chain c, Pivot p, const float* __restrict__ weights,
                    const int* __restrict__ rowv, const float* __restrict__ dout,
                    int dz_by_lookup, const int* __restrict__ ord, const int* __restrict__ rn,
                    float* __restrict__ part, float* __restrict__ scratch0,
                    float* __restrict__ scratch_last, int nza, int sub, int lc) {
  extern __shared__ float4 smem4[];
  // the ids of up to kIdWindow rows of the chunk from row wb: lookup, core-0
  // and core-2 rows, pooled row, weight
  __shared__ int w_lk[kIdWindow], w_i0[kIdWindow], w_i2[kIdWindow], w_row[kIdWindow];
  __shared__ float w_w[kIdWindow];
  const int m0 = p.m0, R = p.R, W = p.W, gs = p.gs, zs = p.zs, d = p.d;
  const int rows_max = pivot_rows(p, lc);
  float* g_s = reinterpret_cast<float*>(smem4);  // [R][gs]
  float* z0_s = g_s + R * gs;                     // [rows][zs]
  float* big = z0_s + rows_max * zs;              // [rows][gs]: dz_1, then z_1
  float* red_s = big + rows_max * gs;             // [kWarps][128]
  float* dz2_s = red_s + kRedFloats;              // [lc][d] (NDIM 3)
  float* g2_s = dz2_s + lc * d;                   // [lc][q2][r2] (NDIM 3)
  const int r2 = p.r2, q2 = p.q2, q1 = p.q1;
  const int r2q2 = r2 * q2;
  const int lo = blockIdx.x * sub;
  const int hi = min(lo + sub, nza);
  const int rows1 = c.rows[1];
  const float* g1 = c.g[1];
  const float* g0 = c.g[0];
  const int tile1 = R * W;
  const int R4 = R / 4, W4 = W / 4, d4 = d / 4, W8 = W / 8, R8 = R / 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // dG_1's tiles: warps split K where there are fewer tiles than warps
  int kw = 1;
  while (kw * 2 * p.tiles <= kWarps) kw *= 2;
  const int tile0_w = warp / kw;  // this warp's tiles: TPW from tile0_w TPW
  const int kslice = warp - tile0_w * kw;
  int wb = 0, we = 0;  // the rows whose ids are staged

  // the span of the chunk's first row, then the next ones; not the sentinel
  for (int j = lo < hi ? span_key(c, rowv, 1, ord[lo]) : rows1; j < rows1; ++j) {
    // CTA-uniform: every __syncthreads() below is reached by all or none
    const int st = max(rn[j], lo);
    const int en = min(rn[j + 1], hi);
    if (st >= hi) break;
    if (en <= st) continue;  // an empty span
    __syncthreads();  // the previous span's slab is no longer read
    const float* gj = g1 + static_cast<size_t>(j) * tile1;
    for (int e = threadIdx.x; e < tile1 / 4; e += kThreads) {
      const int row = e / p.f_W4;
      *reinterpret_cast<float4*>(g_s + row * gs + (e - row * W4) * 4) = ld4(gj + e * 4);
    }
    float acc[TPW][4] = {};

    for (int cb = st; cb < en; cb += lc) {
      const int n = min(lc, en - cb);
      const int mr = (n * m0 + 15) / 16 * 16;  // rows of the products, zero past n m0
      __syncthreads();  // the previous sub-chunk's rows and ids are no longer read
      if (cb + n > we) {  // CTA-uniform: stage the ids of the next rows
        wb = cb;
        // live rows only: the sentinel span's may be padding past nnz
        we = min(min(hi, rn[rows1]), cb + kIdWindow);
        if (threadIdx.x < we - wb) {
          const int lk = ord[wb + threadIdx.x];
          const int row = rowv[lk];
          w_lk[threadIdx.x] = lk;
          w_i0[threadIdx.x] = core_row(c, 0, lk);
          if (NDIM == 3) w_i2[threadIdx.x] = core_row(c, 2, lk);
          w_row[threadIdx.x] = dz_by_lookup ? lk : row;
          // a dead lookup is in no span j < rows1; weight 0 guards the rest
          w_w[threadIdx.x] = row < 0 ? 0.f : (weights ? weights[lk] : 1.f);
        }
        __syncthreads();
      }
      const int* c_lk = w_lk + (cb - wb);
      const int* c_i0 = w_i0 + (cb - wb);
      const int* c_i2 = w_i2 + (cb - wb);
      const int* c_row = w_row + (cb - wb);
      const float* c_w = w_w + (cb - wb);
      // z_0 = G_0[i_0] (zero rows past the sub-chunk)
      for (int e = threadIdx.x; e < mr * R4; e += kThreads) {
        const int row = e / p.f_R4;
        const int c4 = e - row * R4;
        const int u = row / p.f_m0;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (u < n) {
          v = ld4(g0 + static_cast<size_t>(c_i0[u]) * p.tile0 + (row - u * m0) * R + c4 * 4);
        }
        *reinterpret_cast<float4*>(z0_s + row * zs + c4 * 4) = v;
      }
      if (NDIM == 3) {
        // the rows' cotangents w * d_output[b] and the last core's slabs
        for (int e = threadIdx.x; e < n * d4; e += kThreads) {
          const int u = e / p.f_d4;
          const int c4 = e - u * d4;
          const float4 v = ld4(dout + static_cast<size_t>(c_row[u]) * d + c4 * 4);
          const float wv = c_w[u];
          *reinterpret_cast<float4*>(dz2_s + u * d + c4 * 4) =
              make_float4(wv * v.x, wv * v.y, wv * v.z, wv * v.w);
        }
        // G_2[i_2] transposed, [q2][r2]: neighbouring lanes read
        // neighbouring columns below
        for (int e = threadIdx.x; e < n * r2q2; e += kThreads) {
          const int u = e / p.f_r2q2;
          const int rem = e - u * r2q2;
          const int kk = rem / p.f_q2;
          g2_s[u * r2q2 + (rem - kk * q2) * r2 + kk] =
              c.g[2][static_cast<size_t>(c_i2[u]) * r2q2 + rem];
        }
      } else {
        // dz_1 = w * d_output[b], [m0][W] per lookup
        for (int e = threadIdx.x; e < mr * W4; e += kThreads) {
          const int row = e / p.f_W4;
          const int c4 = e - row * W4;
          const int u = row / p.f_m0;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (u < n) {
            const float4 o =
                ld4(dout + static_cast<size_t>(c_row[u]) * d + (row - u * m0) * W + c4 * 4);
            const float wv = c_w[u];
            v = make_float4(wv * o.x, wv * o.y, wv * o.z, wv * o.w);
          }
          *reinterpret_cast<float4*>(big + row * gs + c4 * 4) = v;
        }
      }
      __syncthreads();
      if (NDIM == 3) {
        // dz_1 = dz_2 G_2[i_2]^T per lookup: [m1][q2] x [q2][r2] = [m1][r2],
        // stored as [m0][W] (row a0, column a1 r2 + k of item i = a0 q1 +
        // a1), four columns a thread; rows past the sub-chunk zero
        const int r24 = r2 / 4;
        for (int e = threadIdx.x; e < n * p.m1 * r24; e += kThreads) {
          const int ui = e / p.f_r24;
          const int k4 = e - ui * r24;
          const int u = ui / p.f_m1;
          const int i = ui - u * p.m1;
          const int a0 = i / p.f_q1;
          const float* x = dz2_s + u * d + i * q2;
          const float* y = g2_s + u * r2q2 + k4 * 4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int c2 = 0; c2 < q2; ++c2) {
            const float xv = x[c2];
            const float4 yv = ld4(y + c2 * r2);
            v.x = fmaf(xv, yv.x, v.x);
            v.y = fmaf(xv, yv.y, v.y);
            v.z = fmaf(xv, yv.z, v.z);
            v.w = fmaf(xv, yv.w, v.w);
          }
          *reinterpret_cast<float4*>(big + (u * m0 + a0) * gs + (i - a0 * q1) * r2 + k4 * 4) =
              v;
        }
        for (int e = threadIdx.x; e < (mr - n * m0) * W4; e += kThreads) {
          const int row = e / p.f_W4;
          *reinterpret_cast<float4*>(big + (n * m0 + row) * gs + (e - row * W4) * 4) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();
      }
      // dG_1[j] += z_0^T dz_1 over the sub-chunk's rows: this warp's TPW
      // tiles (one row of tiles), k-steps kslice, kslice + kw, ..
      if (tile0_w * TPW < p.tiles) {
        const int rt = (tile0_w * TPW) / p.f_W8;
        const int wt = tile0_w * TPW - rt * W8;
        mma_3xtf32<TPW>(acc, z0_s + rt * 16, 1, zs, big + wt * 8, gs, 1, kslice * 8, mr,
                        8 * kw);
      }
      // dz_0 = dz_1 G^T: [mr][W] x [W][R] in pairs of tiles, each lookup's
      // [m0][R] to scratch0
      for (int tl = warp; tl < (mr / 16) * (R8 / 2); tl += kWarps) {
        const int mt = tl / p.f_R16;
        const int rt = (tl - mt * (R8 / 2)) * 2;
        float o[2][4] = {};
        mma_3xtf32<2>(o, big + mt * 16 * gs, gs, 1, g_s + rt * 8 * gs, 1, gs, 0, W, 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + g + 8 * h;
            const int u = row / p.f_m0;
            if (u < n) {
              float* out = scratch0 + static_cast<size_t>(c_lk[u]) * p.tile0 +
                           (row - u * m0) * R + (rt + i) * 8 + 2 * t4;
              *reinterpret_cast<float2*>(out) = make_float2(o[i][2 * h], o[i][2 * h + 1]);
            }
          }
      }
      if (NDIM == 3) {
        __syncthreads();  // dz_1 is no longer read
        // z_1 = z_0 G: [mr][R] x [R][W] in groups of nt tiles
        auto z1_tiles = [&](auto nt_tag) {
          constexpr int NT = decltype(nt_tag)::value;
          const int groups = W8 / NT;
          for (int tl = warp; tl < (mr / 16) * groups; tl += kWarps) {
            const int mt = tl / groups;
            const int wt = (tl - mt * groups) * NT;
            float o[NT][4] = {};
            mma_3xtf32<NT>(o, z0_s + mt * 16 * zs, zs, 1, g_s + wt * 8, gs, 1, 0, R, 8);
#pragma unroll
            for (int i = 0; i < NT; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                *reinterpret_cast<float2*>(big + (mt * 16 + g + 8 * h) * gs + (wt + i) * 8 +
                                           2 * t4) = make_float2(o[i][2 * h], o[i][2 * h + 1]);
              }
          }
        };
        if (W8 % 4 == 0) {
          z1_tiles(IntC<4>{});
        } else if (W8 % 2 == 0) {
          z1_tiles(IntC<2>{});
        } else {
          z1_tiles(IntC<1>{});
        }
        __syncthreads();
        // the last core's slab z_1^T dz_2 per lookup: [r2][m1] x [m1][q2],
        // z_1 viewed as [m1][r2] (item i = a0 q1 + a1 at row a0, column
        // a1 r2 of [m0][W]); four columns of q2 a thread
        const int q24 = (q2 + 3) / 4;
        for (int e = threadIdx.x; e < n * r2 * q24; e += kThreads) {
          const int uk = e / p.f_q24;
          const int c4 = e - uk * q24;
          const int u = uk / p.f_r2;
          const int kk = uk - u * r2;
          const int nc = min(4, q2 - c4 * 4);
          const float* z1 = big + u * m0 * gs + kk;
          const float* y = dz2_s + u * d + c4 * 4;
          float v[4] = {};
          int a1 = 0;
#pragma unroll 4
          for (int i = 0; i < p.m1; ++i) {  // item i = a0 q1 + a1
            const float z = z1[a1 * r2];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) v[cc] = fmaf(z, y[min(cc, nc - 1)], v[cc]);
            y += q2;
            if (++a1 == q1) {
              a1 = 0;
              z1 += gs;
            }
          }
          float* out = scratch_last + static_cast<size_t>(c_lk[u]) * r2q2 + kk * q2 + c4 * 4;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            if (cc < nc) out[cc] = v[cc];
          }
        }
      }
    }
    // the span's tile: the K-split warps' sums added in warp order, then
    // written once
    float* dst = part + static_cast<size_t>(blockIdx.x + j) * tile1;
    if (kw > 1) {  // CTA-uniform; one tile per warp
      __syncthreads();
#pragma unroll
      for (int v = 0; v < 4; ++v) red_s[warp * 128 + v * 32 + lane] = acc[0][v];
      __syncthreads();
      if (kslice == 0) {
        for (int w2 = 1; w2 < kw; ++w2) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[0][v] += red_s[(warp + w2) * 128 + v * 32 + lane];
        }
      }
    }
    if (kslice == 0 && tile0_w * TPW < p.tiles) {
      const int rt = (tile0_w * TPW) / p.f_W8;
      const int wt = tile0_w * TPW - rt * W8;
#pragma unroll
      for (int i = 0; i < TPW; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(dst + (rt * 16 + g + 8 * h) * W + (wt + i) * 8 + 2 * t4) =
              make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
        }
    }
  }
}

// The end cores' per-lookup slabs (core 0, and the last core at tt_ndim 3),
// added per span in each chunk of kEndChunk rows of that core's own order
// into the partial tile c + j: one CTA per (group of chunks, end core).
// The chunk's lookups and their spans are staged first; then each thread
// loads one column of every row of its chunk at once and adds them in row
// order, writing a tile where the span changes.
__global__ void __launch_bounds__(kThreads)
tt_bwd_end_kernel(Chain c, const int* __restrict__ rowv, const int* __restrict__ orders,
                  const float* __restrict__ scratch0, const float* __restrict__ scratch_last,
                  float* __restrict__ partial, Offsets off, int nza, int tile0, int tile_last,
                  int nblocks) {
  constexpr int kPer = kThreads / 32;  // chunks per CTA at most
  __shared__ int lk_s[kPer][kEndChunk], key_s[kPer][kEndChunk];
  const int t = blockIdx.y == 0 ? 0 : c.ndim - 1;
  const int tile = t == 0 ? tile0 : tile_last;
  const float* scr = t == 0 ? scratch0 : scratch_last;
  const int lanes = end_lanes(tile);
  const int cl = threadIdx.x / lanes;  // this thread's chunk in the CTA
  const int per = kThreads / lanes;
  const int lane = threadIdx.x - cl * lanes;
  const int* ord = orders + static_cast<size_t>(t) * nza;
  float* part = partial + off.part[t];
  for (int blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {  // CTA-uniform
    const int ch = blk * per + cl;
    const int lo = ch * kEndChunk;
    __syncthreads();  // the previous chunks' ids are no longer read
    if (lane < kEndChunk) {
      const int r = lo + lane;
      const int lk = r < nza ? ord[r] : c.nnz;
      lk_s[cl][lane] = lk;
      key_s[cl][lane] = span_key(c, rowv, t, lk);
    }
    __syncthreads();
    if (lo >= nza) continue;
    for (int e = lane; e < tile; e += lanes) {
      float v[kEndChunk];
#pragma unroll
      for (int r = 0; r < kEndChunk; ++r) {
        v[r] = key_s[cl][r] < c.rows[t] ? scr[static_cast<size_t>(lk_s[cl][r]) * tile + e]
                                        : 0.f;
      }
      int key = key_s[cl][0];
      float sum = v[0];
#pragma unroll
      for (int r = 1; r < kEndChunk; ++r) {
        if (key_s[cl][r] == key) {
          sum += v[r];
        } else {
          if (key < c.rows[t]) part[static_cast<size_t>(ch + key) * tile + e] = sum;
          key = key_s[cl][r];
          sum = v[r];
        }
      }
      if (key < c.rows[t]) part[static_cast<size_t>(ch + key) * tile + e] = sum;
    }
  }
}

// Work blocks of the reduce kernel: G = kThreads / lanes core rows of core t
// by `lanes` float4 (or float) columns (lanes <= kSlice), the cores' blocks
// one after the other (off.cta), dealt to the CTAs in turn. dG_t[j] = row
// j's partial tiles c + j added in chunk order (zero for a row no lookup
// touched). Where no row of a block has more than kStreams chunks, each
// group of lanes adds its own row's chunks in kStreams independent sums;
// else (a hot row, under skewed traffic) the G groups add each row's
// chunks together, group g every G-th chunk, and group 0 adds their sums
// in group order. Either way the order is fixed by the data.
constexpr int kStreams = 16;
constexpr int kSlice = 64;

__host__ __device__ inline bool reduce_vec(const Offsets& off, int t, int tile) {
  return tile % 4 == 0 && off.part[t] % 4 == 0 && off.grad[t] % 4 == 0;
}

// Columns of a work block (a power of two up to kSlice, at least the
// row's where that is less).
__host__ __device__ inline int reduce_lanes(int units) {
  int lanes = 1;
  while (lanes < kSlice && lanes < units) lanes *= 2;
  return lanes;
}

// Work blocks of core t's rows.
__host__ __device__ inline int reduce_blocks(const Offsets& off, int t, int tile, int rows) {
  const int units = reduce_vec(off, t, tile) ? tile / 4 : tile;
  const int lanes = reduce_lanes(units);
  const int groups = kThreads / lanes;
  return (rows + groups - 1) / groups * ((units + lanes - 1) / lanes);
}

// The sum of chunks c0, c0 + step, .. <= c1 of one column of row j, in
// kStreams independent sums added pairwise.
__device__ __forceinline__ float4 chunk_sum(const float* p, int tile, bool vec, int j, int c0,
                                            int c1, int step) {
  float4 acc[kStreams];
#pragma unroll
  for (int k = 0; k < kStreams; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int ch = c0; ch <= c1; ch += kStreams * step) {
#pragma unroll
    for (int k = 0; k < kStreams; ++k) {
      const int c2 = ch + k * step;
      if (c2 <= c1) {
        const float* src = p + static_cast<size_t>(c2 + j) * tile;
        if (vec) {
          const float4 v = ld4(src);
          acc[k].x += v.x;
          acc[k].y += v.y;
          acc[k].z += v.z;
          acc[k].w += v.w;
        } else {
          acc[k].x += *src;
        }
      }
    }
  }
#pragma unroll
  for (int w = 1; w < kStreams; w *= 2) {
#pragma unroll
    for (int k = 0; k < kStreams; k += 2 * w) {
      acc[k].x += acc[k + w].x;
      acc[k].y += acc[k + w].y;
      acc[k].z += acc[k + w].z;
      acc[k].w += acc[k + w].w;
    }
  }
  return acc[0];
}

__global__ void __launch_bounds__(kThreads)
tt_bwd_reduce_kernel(Chain c, const int* __restrict__ runs,
                     const float* __restrict__ partial, float* __restrict__ grads,
                     Offsets off, int rstride) {
  __shared__ float4 red[kThreads];
  __shared__ int most;
  for (int blk = blockIdx.x; blk < off.cta[kMaxDim]; blk += gridDim.x) {  // CTA-uniform
    int t = 0;
    while (t + 1 < c.ndim && blk >= off.cta[t + 1]) ++t;
    const int tile = slab_size(c, t);
    const bool vec = reduce_vec(off, t, tile);
    const int units = vec ? tile / 4 : tile;
    const int lanes = reduce_lanes(units);
    const int groups = kThreads / lanes;
    const int slices = (units + lanes - 1) / lanes;
    const int b = blk - off.cta[t];
    const int rb = b / slices;
    const int g = threadIdx.x / lanes;
    const int u = (b - rb * slices) * lanes + (threadIdx.x & (lanes - 1));
    const int* rn = runs + static_cast<size_t>(t) * rstride;
    const int cs = off.chunk[t];
    const float* p = partial + off.part[t] + (vec ? 4 * u : u);
    // this group's row and its chunks c_lo .. c_hi (none: c_hi < c_lo)
    const int j = rb * groups + g;
    int c_lo = 0, c_hi = -1;
    if (j < c.rows[t] && rn[j + 1] > rn[j]) {
      c_lo = rn[j] / cs;
      c_hi = (rn[j + 1] - 1) / cs;
    }
    __syncthreads();  // the previous block's sums are no longer read
    if (threadIdx.x == 0) most = 0;
    __syncthreads();
    if ((threadIdx.x & (lanes - 1)) == 0 && c_hi - c_lo + 1 > most) {
      atomicMax(&most, c_hi - c_lo + 1);
    }
    __syncthreads();
    if (most <= kStreams) {  // CTA-uniform: each group its own row
      if (j < c.rows[t] && u < units) {
        const float4 sum = chunk_sum(p, tile, vec, j, c_lo, c_hi, 1);
        float* out = grads + off.grad[t] + static_cast<size_t>(j) * tile;
        if (vec) {
          *reinterpret_cast<float4*>(out + 4 * u) = sum;
        } else {
          out[u] = sum.x;
        }
      }
      continue;
    }
    for (int r = 0; r < groups; ++r) {  // CTA-uniform: the groups together, row by row
      const int jr = rb * groups + r;
      if (jr >= c.rows[t]) break;
      const int st = rn[jr], en = rn[jr + 1];
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      if (en > st && u < units) {
        sum = chunk_sum(p, tile, vec, jr, st / cs + g, (en - 1) / cs, groups);
      }
      red[threadIdx.x] = sum;
      __syncthreads();
      if (g == 0 && u < units) {
        for (int g2 = 1; g2 < groups; ++g2) {
          const float4 v = red[g2 * lanes + threadIdx.x];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        float* out = grads + off.grad[t] + static_cast<size_t>(jr) * tile;
        if (vec) {
          *reinterpret_cast<float4*>(out + 4 * u) = sum;
        } else {
          out[u] = sum.x;
        }
      }
      __syncthreads();  // red is written again by the next row
    }
  }
}

namespace {

Chain chain_of(int ndim, int nnz, int q0, int q1, int q2, int q3, int r1, int r2, int r3,
               int rows0, int rows1, int rows2, int rows3, const void* const* g,
               const void* const* gt, const int* idx) {
  const int q[kMaxDim] = {q0, q1, q2, q3};
  const int rin[kMaxDim - 1] = {r1, r2, r3};
  const int rows[kMaxDim] = {rows0, rows1, rows2, rows3};
  return make_chain(ndim, nnz, q, rin, rows, g, gt, idx);
}

template <int NDIM, int TPW>
cudaError_t launch_pivot(const Chain& c, const Pivot& p, const float* weights, const int* rowv,
                         const float* dout, int dz_by_lookup, const int* ord, const int* rn,
                         float* part, float* scratch0, float* scratch_last, int nza, int sub,
                         int lc, cudaStream_t st) {
  auto kern = tt_bwd_pivot_kernel<NDIM, TPW>;
  const size_t smem = pivot_smem_bytes(c, p, lc);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<(nza + sub - 1) / sub, kThreads, smem, st>>>(c, p, weights, rowv, dout, dz_by_lookup,
                                                      ord, rn, part, scratch0, scratch_last,
                                                      nza, sub, lc);
  return cudaGetLastError();
}

// One pivot pass of chain c (tt_ndim NDIM), built for its tiles a warp.
template <int NDIM>
cudaError_t launch_pass(const Chain& c, const float* weights, const int* rowv, const float* dout,
                        int dz_by_lookup, const int* ord, const int* rn, float* part,
                        float* scratch0, float* scratch_last, int nza, int sub, int lc,
                        cudaStream_t st) {
  const Pivot p = make_pivot(c);
  auto go = [&](auto launch) {
    return launch(c, p, weights, rowv, dout, dz_by_lookup, ord, rn, part, scratch0,
                  scratch_last, nza, sub, lc, st);
  };
  return p.tpw == 1   ? go(launch_pivot<NDIM, 1>)
         : p.tpw == 2 ? go(launch_pivot<NDIM, 2>)
         : p.tpw == 4 ? go(launch_pivot<NDIM, 4>)
         : p.tpw == 8 ? go(launch_pivot<NDIM, 8>)
                      : go(launch_pivot<NDIM, 16>);
}

// Rows per chunk of core t's partial tiles: `sub` for the pivot cores
// (core 1, and core 2 at tt_ndim 4) and kEndChunk for the end cores on the
// pivot path, the segment on the chain pass.
int core_chunk(int pivot, int ndim, int t, int seg, int sub) {
  if (!pivot) return seg;
  return t == 1 || (t > 1 && t < ndim - 1) ? sub : kEndChunk;
}

}  // namespace

extern "C" {

// lc of the pivot path for these shapes (q, the inner ranks), or 0 where
// the chain pass runs; *ctas_per_sm: the pivot CTAs an SM holds at once
// (0 on the chain pass; at tt_ndim 4 the least of its passes').
int fbtt_tt_bwd_path(int ndim, int q0, int q1, int q2, int q3, int r1, int r2, int r3,
                     int* ctas_per_sm) {
  const void* g[kMaxDim] = {};
  const Chain c = chain_of(ndim, 0, q0, q1, q2, q3, r1, r2, r3, 0, 0, 0, 0, g, nullptr,
                           nullptr);
  const int lc = pivot_chunk(c);
  *ctas_per_sm = lc ? pivot_ctas_per_sm(pivot_tpw(c)) : 0;
  return lc;
}

// Launches the path of `pivot` (1: the pivot passes, the end-core sums and
// the reduce; 0: the chain pass and the reduce) on `stream`; returns
// cudaGetLastError() after the launches (0 on success). g0..g3: the kernel
// core layouts (float32; unused ones null), gt1..gt3 the transposes
// [T*p_t, q_t r_{t+1}, r_t] of g1..g3 (the chain pass only); idx [ndim,
// nnz] int32 core rows; weights [nnz] or null; rowv [nnz] pooled rows (-1:
// no row); dout [T*B, D]; per core t: orders [ndim, nza] the lookups
// sorted stably by their core-t row, runs [ndim, rstride] span starts,
// first / cnt [ndim, nseg] the spans of each seg-row segment (the chain
// pass). partial holds, core after core, (ceil(nza / chunk_t) + rows_t)
// tiles of r_t q_t r_{t+1} floats (chunk_t: `sub` for the pivot cores and
// 32 for the end cores on the pivot path, `seg` on the chain pass) and
// grads rows_t such tiles; scratch (the pivot path) nnz q_0 r_1 floats,
// then at tt_ndim 3 and 4 nnz r_{n-1} q_{n-1}, then at tt_ndim 4 2 nnz q_0
// q_1 r_2. lc and zs as the wrapper sized the shared memory; on the pivot
// path lc must be fbtt_tt_bwd_path's.
int fbtt_tt_bwd(const void* g0, const void* g1, const void* g2, const void* g3,
                const void* gt1, const void* gt2, const void* gt3, const int* idx,
                const float* weights, const int* rowv, const float* dout, const int* orders,
                const int* runs, const int* first, const int* cnt, float* partial,
                float* grads, float* scratch, int ndim, int nnz, int nza, int nseg, int seg,
                int rstride, int q0, int q1, int q2, int q3, int r1, int r2, int r3,
                int rows0, int rows1, int rows2, int rows3, int lc, int zs, int pivot,
                int sub, void* stream) {
  const void* g[kMaxDim] = {g0, g1, g2, g3};
  const void* gt[kMaxDim] = {nullptr, gt1, gt2, gt3};
  const Chain c = chain_of(ndim, nnz, q0, q1, q2, q3, r1, r2, r3, rows0, rows1, rows2, rows3,
                           g, gt, idx);
  if (pivot && (lc != pivot_chunk(c) || sub < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets off{};
  size_t part = 0, grad = 0;
  int tile_max = 0, ctas = 0;
  for (int t = 0; t < ndim; ++t) {
    const int tile = slab_size(c, t);
    off.chunk[t] = core_chunk(pivot, ndim, t, seg, sub);
    off.part[t] = part;
    off.grad[t] = grad;
    const size_t chunks = (static_cast<size_t>(nza) + off.chunk[t] - 1) / off.chunk[t];
    part += (chunks + c.rows[t]) * tile;
    grad += static_cast<size_t>(c.rows[t]) * tile;
    tile_max = tile > tile_max ? tile : tile_max;
    off.cta[t] = ctas;
    ctas += reduce_blocks(off, t, tile, c.rows[t]);
  }
  off.cta[ndim] = ctas;
  for (int t = ndim + 1; t <= kMaxDim; ++t) off.cta[t] = ctas;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // CTAs of the end and reduce kernels: a few per SM, each taking blocks of
  // work in turn
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = 4 * sms;
  if (nza > 0 && pivot) {
    const int tile0 = slab_size(c, 0);
    const int tile_last = ndim > 2 ? slab_size(c, ndim - 1) : 0;
    float* scratch_last = scratch + static_cast<size_t>(nnz) * tile0;
    if (ndim == 4) {
      // after dz_0 and the last core's slabs, z_1 and then dz_1 by lookup
      // ([nnz, m_1 r_2] each)
      float* z1 = scratch_last + static_cast<size_t>(nnz) * tile_last;
      float* dz1 = z1 + static_cast<size_t>(nnz) * c.m[1] * c.r[2];
      const Chain head = sub_chain(c, 0, 1, nullptr), tail = sub_chain(c, 2, 3, z1);
      // z_1 = z_0 G_1[i_1]: the forward's head pass over core 1's order
      err = fbtt_fwd::launch_pivot<2>(head, fbtt_fwd::make_fwd_pivot(head), nullptr,
                                      orders + nza, runs + rstride, z1, nza, sub,
                                      fbtt_fwd::fwd_pivot_chunk(head), st);
      // core 2's order: dG_2's tiles, dz_1 by lookup, the last core's slabs
      if (err == cudaSuccess) {
        err = launch_pass<3>(tail, weights, rowv, dout, 0, orders + 2 * static_cast<size_t>(nza),
                             runs + 2 * rstride, partial + off.part[2], dz1, scratch_last, nza,
                             sub, lc, st);
      }
      // core 1's order: dG_1's tiles from dz_1, dz_0 by lookup
      if (err == cudaSuccess) {
        err = launch_pass<2>(head, nullptr, rowv, dz1, 1, orders + nza, runs + rstride,
                             partial + off.part[1], scratch, nullptr, nza, sub, lc, st);
      }
    } else if (ndim == 3) {
      err = launch_pass<3>(c, weights, rowv, dout, 0, orders + nza, runs + rstride,
                           partial + off.part[1], scratch, scratch_last, nza, sub, lc, st);
    } else {
      err = launch_pass<2>(c, weights, rowv, dout, 0, orders + nza, runs + rstride,
                           partial + off.part[1], scratch, nullptr, nza, sub, lc, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // the end cores (0, and the last at tt_ndim 3 and 4); chunks per CTA:
    // one per end_lanes(tile) threads
    int lanes = end_lanes(tile0);
    if (ndim > 2 && end_lanes(tile_last) > lanes) lanes = end_lanes(tile_last);
    const int per = kThreads / lanes;
    const int chunks = (nza + kEndChunk - 1) / kEndChunk;
    const int blocks = (chunks + per - 1) / per;
    tt_bwd_end_kernel<<<dim3(blocks < resident ? blocks : resident, ndim > 2 ? 2 : 1), kThreads,
                        0, st>>>(c, rowv, orders, scratch, scratch_last, partial, off, nza, tile0,
                                 tile_last, blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (nseg > 0) {
    const size_t smem = (3 * static_cast<size_t>(lc) * zs + tile_max) * sizeof(float);
    err = cudaFuncSetAttribute(tt_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tt_bwd_kernel<<<dim3(nseg, ndim), kThreads, smem, st>>>(
        c, weights, rowv, dout, orders, runs, first, cnt, partial, off, nza, nseg, seg,
        rstride, lc, zs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (ctas > 0) {
    tt_bwd_reduce_kernel<<<ctas < resident ? ctas : resident, kThreads, 0, st>>>(
        c, runs, partial, grads, off, rstride);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
