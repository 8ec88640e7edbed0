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
// Design. The TPU kernel walks nnz-blocks in one sequential grid and pools
// each block through a [T*B, bn] one-hot product into an output that
// stays in VMEM. On Hopper the grid runs in parallel, so the pooling is
// turned around: the host groups lookups by bag (one stable sort, `order`
// and `starts`), and one CTA per bag walks its lookups in chunks of `lc`,
// runs their chains in shared memory (tt_chain.cuh) and adds the rows
// into the bag's float32 sum, each element owned by one thread. Each
// output row is written once: no atomics, bitwise repeatable.
//
// Bound: operations. At the headline shape (q = [4,4,4], ranks [32,32])
// a lookup costs ~37 kFLOP (z0 @ G1: 4x32x128, z1 @ G2: 16x32x4
// multiply-adds), ~0.38 GFLOP at nnz 10240: ~5.6 us at the 67 TFLOP/s
// float32 CUDA-core rate, against ~4 MB of cores, ids and output (~1.2 us
// at 3.35 TB/s). Tensor cores are later work.

#include "tt_chain.cuh"

using namespace fbtt_chain;

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

extern "C" {

// Launches the kernel on `stream` (one CTA per bag, tb bags); returns
// cudaGetLastError() after the launch (0 on success). g0..g3: the kernel
// core layouts (float32; unused ones null), idx [ndim, nnz] int32 core
// rows, weights [nnz] float32 or null, order: lookup ids grouped by bag,
// starts [tb + 1]: each bag's range in order, out [tb, D] float32. q0..q3
// and r1..r3 the shapes (unused ones 1); lc lookups per chunk and zs
// floats per lookup state, as the wrapper sized the shared memory.
int fbtt_tt_fwd(const void* g0, const void* g1, const void* g2, const void* g3,
                const int* idx, const float* weights, const int* order,
                const int* starts, float* out, int ndim, int nnz, int tb, int q0,
                int q1, int q2, int q3, int r1, int r2, int r3, int lc, int zs,
                void* stream) {
  const int q[kMaxDim] = {q0, q1, q2, q3};
  const int rin[kMaxDim - 1] = {r1, r2, r3};
  const int rows[kMaxDim] = {0, 0, 0, 0};
  const void* g[kMaxDim] = {g0, g1, g2, g3};
  const Chain c = make_chain(ndim, nnz, q, rin, rows, g, nullptr, idx);
  const size_t smem = (2 * static_cast<size_t>(lc) * zs + c.m[ndim - 1]) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tt_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tb > 0) {
    tt_fwd_kernel<<<tb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        c, order, starts, weights, out, lc, zs);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
