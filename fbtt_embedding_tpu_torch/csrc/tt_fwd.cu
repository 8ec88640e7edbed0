// Pooled per-lookup TT forward for Hopper (sm_90a): kernel B4.
//
// Replaces the Pallas TPU kernel fbtt_embedding_tpu/ops/pallas/tt_kernel.py
// :: _make_fwd_call (through tt_forward_pallas). For every pooled row
// (bag) b of T*B:
//
//     out[b] = sum over the bag's lookups l, in lookup order, of
//              w_l * G_0[i_0] G_1[i_1] ... G_{n-1}[i_{n-1}]      (float32)
//
// with the d-index in canonical digit order (tt_chain.cuh). Padding and
// dead lookups belong to no bag; an empty bag is exact zeros.
//
// The TPU kernel walks nnz-blocks in one sequential grid and pools each
// block through a [T*B, bn] one-hot product into an output that stays in
// VMEM. On Hopper the grid runs in parallel and nothing carries over
// between CTAs, so the pooling is a pass of its own and every output row is
// written once, in a fixed order: no atomics, bitwise repeatable. Two paths
// (fbtt_tt_fwd_path; the wrapper asks it which one runs).
//
// The pivot path (every config whose middle-core slabs stage in shared
// memory; kernels in tt_fwd_pivot.cuh). At tt_ndim 2 and 3 one pivot pass
// and the pool: two launches. At the headline shape (q = [4,4,4], ranks
// [32,32]) 89% of a lookup's 18 k multiply-adds are z_1 = z_0 G_1[i_1] (4 x
// 32 x 128), with G_1[i_1] 16 KB: read per lookup from L2 that is ~168 MB
// a call, for 220 distinct slabs. So the host sorts the lookups stably by
// their core-1 row (tt_ndim 2: the last core; dead lookups and padding
// take the sentinel row), and kernel 1 runs over that order's live rows,
// one CTA per even share of them (two or three CTAs an SM, one wave, so a
// hot row under Zipf is split). A CTA takes its rows in groups of up to lc
// lookups from up to a few spans (as many 16 KB slabs as fit 40 KB; eight
// where slabs are small and spans short): each span's slab G_1[j] and its
// lookups' z_0 = G_0[i_0] rows are staged in shared memory with cp.async
// (a span that goes on into the next group keeps its slab), and z_1 = z_0
// G_1[j] runs as a GEMM of the group's rows on the tensor cores, as 3xTF32
// mma.sync.m16n8k8 (tt_mma.cuh; plain TF32 misses the forward's 1e-5), each
// 16-row tile on its own span's slab. At tt_ndim 3 each lookup's z_1
// ([q_0 q_1, r_2]) then goes through its own last-core slab G_2[i_2] ([r_2,
// q_2], 2 k multiply-adds): where r_2 = 32, in the GEMM's epilogue, from
// the warps' tiles (each warp's four column tiles hold one item's z_1 row;
// a quad of lanes sums its k); else on the tensor cores or the CUDA cores
// from z_1 staged by items. The weighted row w * row goes to a float32
// scratch row per lookup ([nnz, D], 2.6 MB at the headline: it stays in
// L2). Kernel 2 pools: one group of lanes per bag adds the bag's scratch
// rows in `order` (lookup order within the bag), 16 in flight, and writes
// the bag's row once.
//
// At tt_ndim 4 (three launches) two middle cores each have a slab per
// lookup: at the billion-row model (q = [2,4,2,4], ranks 32) z_1 = z_0 G_1
// (2 x 32 x 128) and z_2 = z_1 G_2 (8 x 32 x 64) are 92% of a lookup's 27 k
// multiply-adds, on 16 KB and 8 KB slabs. No one order stages both, so the
// path runs two pivot passes, each the pass above on a sub-chain
// (tt_chain.cuh): the head (cores 0-1, a tt_ndim-2 chain whose row is z_1,
// weight 1) over core 1's order writes z_1 by lookup to a buffer after the
// scratch rows ([nnz, q_0 q_1 r_2], 10.5 MB at nnz 10240: it stays in L2);
// the tail (a tt_ndim-3 chain whose core 0 is that buffer, read at the
// lookup's id, then cores 2 and 3) over core 2's order runs z_2 = z_1
// G_2[j] on the staged slab with the last core fused into its epilogue and
// writes w * row. Both run at one lc, the least of their two rules.
// Recomputing z_1 per lookup in core 2's order instead would read G_1[i_1]
// (16 KB) per lookup from L2, the chain pass's cost.
//
// The chain pass (configs the pivot path cannot stage; one launch): one
// CTA per bag walks its lookups in chunks of `lc`, runs their
// chains in shared memory (tt_chain.cuh) on the CUDA cores and adds the
// rows into the bag's float32 sum, each element owned by one thread.
//
// Bound: operations. At the headline shape a lookup costs ~37 kFLOP (z_0
// G_1: 4x32x128, z_1 G_2: 16x32x4 multiply-adds), ~0.38 GFLOP at nnz 10240:
// ~5.6 us at the 67 TFLOP/s float32 CUDA-core rate (the chain pass), ~2.3
// us as three TF32 products at 495 TFLOP/s (the pivot pass), against ~4 MB
// of cores, ids and output (~1.2 us at 3.35 TB/s; the pivot pass adds the
// scratch rows, written and read once). At the tt_ndim-4 model ~53 kFLOP a
// lookup: ~8.1 us at the CUDA-core rate, ~3.3 us as 3xTF32, against ~5.4 MB
// (~1.6 us; the path adds the z_1 buffer, written and read once).

#include "tt_fwd_pivot.cuh"

using namespace fbtt_chain;
using namespace fbtt_mma;
using namespace fbtt_fwd;

__global__ void __launch_bounds__(kThreads)
tt_fwd_kernel(Chain c, const int* __restrict__ order, const int* __restrict__ starts,
              const float* __restrict__ weights, float* __restrict__ out, int lc,
              int zs) {
  extern __shared__ float smem[];
  __shared__ ChunkIdx ci;
  __shared__ float cw[kMaxChunk];
  float* za = smem;
  float* zb = za + lc * zs;
  float* acc = zb + lc * zs;  // [D], each element owned by one thread
  const int bag = blockIdx.x;
  const int st = starts[bag];
  const int en = starts[bag + 1];
  const int d = c.m[c.ndim - 1];
  for (int e = threadIdx.x; e < d; e += kThreads) acc[e] = 0.f;
  for (int base = st; base < en; base += lc) {
    const int n = min(lc, en - base);
    __syncthreads();  // the previous chunk's states and ids are no longer read
    if (threadIdx.x < n) {
      const int lk = order[base + threadIdx.x];
      for (int t = 0; t < c.ndim; ++t) {
        ci.core[t][threadIdx.x] = c.idx[static_cast<size_t>(t) * c.nnz + lk];
      }
      cw[threadIdx.x] = weights ? weights[lk] : 1.f;
    }
    __syncthreads();
    forward_chain(c, ci, c.ndim - 1, n, za, zb, za, zs);  // rows in za
    for (int e = threadIdx.x; e < d; e += kThreads) {
      float s = acc[e];
      for (int l = 0; l < n; ++l) s = fmaf(cw[l], za[l * zs + e], s);
      acc[e] = s;
    }
  }
  float* o = out + static_cast<size_t>(bag) * d;
  for (int e = threadIdx.x; e < d; e += kThreads) o[e] = acc[e];
}

// ---------------------------------------------------------------------------
// The pool

constexpr int kPoolThreads = 32;  // threads of a pool CTA
constexpr int kPoolBatch = 16;    // scratch rows a pool thread loads at once

// Threads of a bag in the pool kernel: a power of two, at least D / 4 where
// that is less than kPoolThreads.
__host__ __device__ inline int pool_lanes(int d4) {
  int lanes = 1;
  while (lanes < kPoolThreads && lanes < d4) lanes *= 2;
  return lanes;
}

// out[b] = the bag's scratch rows (w * row per lookup) added in `order`,
// lookup order within the bag, from zero; each row written once (an empty
// bag: zeros). `lanes` threads a bag, float4 columns; kPoolBatch rows in
// flight at once.
__global__ void __launch_bounds__(kPoolThreads)
tt_fwd_pool_kernel(const float* __restrict__ rows, const int* __restrict__ order,
                   const int* __restrict__ starts, float* __restrict__ out, int tb, int d,
                   int lanes) {
  const int bag = blockIdx.x * (kPoolThreads / lanes) + threadIdx.x / lanes;
  if (bag >= tb) return;
  const int st = starts[bag];
  const int en = starts[bag + 1];
  const int d4 = d / 4;
  for (int c4 = threadIdx.x & (lanes - 1); c4 < d4; c4 += lanes) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = st; i < en; i += kPoolBatch) {
      int lk[kPoolBatch];
#pragma unroll
      for (int u = 0; u < kPoolBatch; ++u) lk[u] = i + u < en ? order[i + u] : -1;
      float4 v[kPoolBatch];
#pragma unroll
      for (int u = 0; u < kPoolBatch; ++u) {
        v[u] = lk[u] >= 0 ? ld4(rows + static_cast<size_t>(lk[u]) * d + c4 * 4)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kPoolBatch; ++u) {
        if (lk[u] >= 0) {
          s.x += v[u].x;
          s.y += v[u].y;
          s.z += v[u].z;
          s.w += v[u].w;
        }
      }
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(bag) * d + c4 * 4) = s;
  }
}

namespace {

Chain chain_of(int ndim, int nnz, int q0, int q1, int q2, int q3, int r1, int r2, int r3,
               int rows1, int rows2, const void* const* g, const int* idx) {
  const int q[kMaxDim] = {q0, q1, q2, q3};
  const int rin[kMaxDim - 1] = {r1, r2, r3};
  const int rows[kMaxDim] = {0, rows1, rows2, 0};
  return make_chain(ndim, nnz, q, rin, rows, g, nullptr, idx);
}

}  // namespace

extern "C" {

// lc of the pivot path for these shapes (q, the inner ranks), or 0 where
// the chain pass runs; *ctas_per_sm: the pivot CTAs an SM holds at once
// (0 on the chain pass; at tt_ndim 4 those of the tail pass, which the
// head's launch shares).
int fbtt_tt_fwd_path(int ndim, int q0, int q1, int q2, int q3, int r1, int r2, int r3,
                     int* ctas_per_sm) {
  const void* g[kMaxDim] = {};
  const Chain c = chain_of(ndim, 0, q0, q1, q2, q3, r1, r2, r3, 0, 0, g, nullptr);
  const int lc = fwd_path_chunk(c);
  *ctas_per_sm = lc ? fwd_pivot_ctas(c, make_fwd_pivot(c), lc) : 0;
  return lc;
}

// Launches the pass of `pivot` on `stream` (1: the pivot path and the pool,
// 0: the chain pass; one CTA per bag, tb bags); returns cudaGetLastError()
// after the launches (0 on success). g0..g3: the kernel core layouts
// (float32; unused ones null), idx [ndim, nnz] int32 core rows, weights
// [nnz] float32 or null, order: lookup ids grouped by bag, starts [tb + 1]:
// each bag's range in order, out [tb, D] float32. The pivot path also
// takes ord1 [npiv, nza]: the lookups sorted stably by their core-1 row
// (dead ones and padding last) and, at tt_ndim 4, by their core-2 row
// (npiv = 2), runs1 [npiv, rstride]: their span starts (rstride at least
// rows1 + 2 and rows2 + 2), rows1 and rows2 those cores' rows, scratch
// [nnz, D] float32 and at tt_ndim 4 after it z_1 by lookup [nnz, q0 q1
// r2], ceil(nza / sub) CTAs a pass, and lc = fbtt_tt_fwd_path's. q0..q3
// and r1..r3 the shapes (unused ones 1); on the chain pass lc lookups per
// chunk and zs floats per lookup state, as the wrapper sized the shared
// memory.
int fbtt_tt_fwd(const void* g0, const void* g1, const void* g2, const void* g3,
                const int* idx, const float* weights, const int* order,
                const int* starts, float* out, const int* ord1, const int* runs1,
                float* scratch, int ndim, int nnz, int tb, int nza, int q0, int q1, int q2,
                int q3, int r1, int r2, int r3, int rows1, int rows2, int rstride, int lc,
                int zs, int pivot, int sub, void* stream) {
  const void* g[kMaxDim] = {g0, g1, g2, g3};
  const Chain c = chain_of(ndim, nnz, q0, q1, q2, q3, r1, r2, r3, rows1, rows2, g, idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (!pivot) {
    const size_t smem = (2 * static_cast<size_t>(lc) * zs + c.m[ndim - 1]) * sizeof(float);
    err = cudaFuncSetAttribute(tt_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tb > 0) {
      tt_fwd_kernel<<<tb, kThreads, smem, st>>>(c, order, starts, weights, out, lc, zs);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (lc != fwd_path_chunk(c) || sub < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int d = c.m[ndim - 1];
  if (nza > 0 && ndim == 4) {
    // the head writes z_1 = z_0 G_1[i_1] by lookup in core 1's order; the
    // tail reads it as its core 0 in core 2's order
    Chain pass[2];
    fwd_passes(c, scratch + static_cast<size_t>(nnz) * d, pass);
    err = launch_pivot<2>(pass[0], make_fwd_pivot(pass[0]), nullptr, ord1, runs1,
                          scratch + static_cast<size_t>(nnz) * d, nza, sub, lc, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_pivot<3>(pass[1], make_fwd_pivot(pass[1]), weights, ord1 + nza,
                          runs1 + rstride, scratch, nza, sub, lc, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (nza > 0) {
    const FwdPivot p = make_fwd_pivot(c);
    err = ndim == 3 ? launch_pivot<3>(c, p, weights, ord1, runs1, scratch, nza, sub, lc, st)
                    : launch_pivot<2>(c, p, weights, ord1, runs1, scratch, nza, sub, lc, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (tb > 0) {
    const int lanes = pool_lanes(d / 4);
    const int per = kPoolThreads / lanes;
    tt_fwd_pool_kernel<<<(tb + per - 1) / per, kPoolThreads, 0, st>>>(scratch, order, starts,
                                                                      out, tb, d, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
