// Per-span gradient passes of the flat sorted-run pipeline, for Hopper
// (sm_90a). Shared by seg_accum.cu (kernel B3) and seg_fused_i2.cu
// (kernel B2); see those files for what each replaces.
//
// Lookups are sorted by one core index j, so the rows of core row j form
// one contiguous span runs[j] .. runs[j+1]. For every span j < p_rows and
// each of `blocks` lane-blocks b, one pass computes
//
//     z_b[rows of j]    = y_b[rows of j] @ T[j]^T               (NT product)
//     rows_b[rows of j] = x_b[rows of j] @ T[j]            (B2 only, forward)
//     acc[j]           += sum_b x_b[rows of j]^T @ y_b[rows of j]   (float32)
//
// with T[j] the bw_x x bw_y slab at rows j*bw_x of the stacked table. Rows
// of the sentinel span (dead / padded lookups) get exact zeros in z and
// rows; acc[j] of an empty span is zero.
//
// Design. Kernel 1 runs one CTA per `seg`-row segment of the sorted order,
// as the forward kernel (seg_transform.cu) does: the CTA walks the cnt[s]
// spans that meet its segment from first[s]. For each live span it stages
// T[j] in shared memory as float, transposed for the NT product (in
// chunks of its rows k: z's columns) and, for B2, as is for the forward
// product (in chunks of its columns: rows' columns), at most 64 KB at a
// time, so any width up to 2048 launches; each thread holds a 4-row x
// 8-column register tile of z or rows (x and y rows are read as 16-byte
// vectors).
// The gradient is where the TPU design cannot carry over: there one
// sequential grid adds every segment into one VMEM accumulator, while here
// a span straddles segments whose CTAs run at once. Float atomics would
// make core gradients depend on the schedule, so each CTA writes the
// float32 sum of its own rows of span j as a partial tile at slot s + j
// (unique, because first[s+1] >= last span of s), and kernel 2 (one CTA
// per span) adds span j's partial tiles in segment order into acc[j]. The
// result is bitwise repeatable. Within a CTA a partial tile is computed
// as 4x4 register tiles; when the tile has fewer 4x4 blocks than the CTA
// has threads, the span's rows are dealt to thread groups and the groups'
// sums are added in group order through shared memory.
//
// Segment-parallel (and not one CTA per span) because a hot core row under
// Zipf traffic owns thousands of rows: one CTA per span would serialise
// them on one SM, while segments stay balanced whatever the skew. The
// price is the partial tiles' round trip (about nseg + live spans tiles).
//
// Bound: memory. x, y read once, z (and rows) written once, live slabs and
// acc once: ~24-27 MB at the headline training shape, ~7-8 us at
// 3.35 TB/s, against ~0.5-0.7 GFLOP. Multiply-adds run on the CUDA cores;
// tensor cores (mma / wgmma) and TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace fbtt_span {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows of one thread's z / rows tile
constexpr int kCols = 8;  // columns of one thread's z / rows tile
constexpr int kAcc = 4;   // a thread's acc tile is kAcc x kAcc
constexpr int kRedFloats = kThreads * kAcc * kAcc;  // group-sum scratch
constexpr int kChunkFloats = 64 * 1024 / 4;          // staged slab chunk

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive values -> floats (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
// 4 consecutive values -> floats (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__device__ void zero_rows(T* out, int st, int nrows, int width) {
  const float zero[kCols] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  T* o = out + static_cast<size_t>(st) * width;
  for (int e = threadIdx.x; e < nrows * width / kCols; e += kThreads) {
    store8(o + e * kCols, zero);
  }
}

// out[r, b*n_out + o0 + c] = sum_k in[r, b*n_in + k] * w[k * nc + c] for
// the rows [st, en) and the nc columns c of one chunk: w is an [n_in, nc]
// float matrix in shared memory.
template <typename Tin, typename Tout>
__device__ void rows_times_slab(const Tin* __restrict__ in, Tout* __restrict__ out,
                                const float* w, int st, int en, int blocks,
                                int n_in, int n_out, int o0, int nc) {
  const int in_w = blocks * n_in;
  const int out_w = blocks * n_out;
  const int row_groups = (en - st + kRows - 1) / kRows;
  const int groups = nc / kCols;
  const int per_rg = blocks * groups;
  for (int e = threadIdx.x; e < row_groups * per_rg; e += kThreads) {
    const int rg = e / per_rg;
    const int rem = e - rg * per_rg;
    const int b = rem / groups;
    const int g = rem - b * groups;
    const int r0 = st + rg * kRows;
    const int nr = min(kRows, en - r0);
    const Tin* ir[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      // rows past the span repeat its last row: loaded, never stored
      ir[i] = in + static_cast<size_t>(r0 + min(i, nr - 1)) * in_w + b * n_in;
    }
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
    const float* wg = w + g * kCols;
    for (int k0 = 0; k0 < n_in; k0 += 8) {
      float iv[kRows][8];
#pragma unroll
      for (int i = 0; i < kRows; ++i) load8(ir[i] + k0, iv[i]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float wv[kCols];
        load8(wg + (k0 + kk) * nc, wv);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(iv[i][kk], wv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < nr) {
        store8(out + static_cast<size_t>(r0 + i) * out_w + b * n_out + o0 + g * kCols,
               acc[i]);
      }
    }
  }
}

// The float32 sum over rows [st, en) and blocks of x_b[r]^T y_b[r], an
// [bw_x, bw_y] tile written to `dst` (global memory).
template <typename Tin>
__device__ void span_outer(const Tin* __restrict__ x, const Tin* __restrict__ y,
                           float* __restrict__ dst, float* red, int st, int en,
                           int blocks, int bw_x, int bw_y) {
  const int x_w = blocks * bw_x;
  const int y_w = blocks * bw_y;
  const int cgroups = bw_y / kAcc;
  const int items = (bw_x / kAcc) * cgroups;
  // deal the rows to `split` thread groups when the tile is small
  const int split = items >= kThreads ? 1 : min(kThreads / items, 8);
  for (int base = 0; base < items; base += kThreads) {
    const int t = threadIdx.x;
    const int item = base + (split > 1 ? t % items : t);
    const int part = split > 1 ? t / items : 0;
    const bool active = item < items && part < split;
    float acc[kAcc][kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int c = 0; c < kAcc; ++c) acc[i][c] = 0.f;
    const int k0 = (item / cgroups) * kAcc;
    const int c0 = (item % cgroups) * kAcc;
    if (active) {
      for (int r = st + part; r < en; r += split) {
        const Tin* xr = x + static_cast<size_t>(r) * x_w + k0;
        const Tin* yr = y + static_cast<size_t>(r) * y_w + c0;
        for (int b = 0; b < blocks; ++b) {
          float xv[kAcc], yv[kAcc];
          load4(xr + b * bw_x, xv);
          load4(yr + b * bw_y, yv);
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
#pragma unroll
            for (int c = 0; c < kAcc; ++c) acc[i][c] = fmaf(xv[i], yv[c], acc[i][c]);
        }
      }
    }
    if (split == 1) {
      if (active) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          *reinterpret_cast<float4*>(dst + static_cast<size_t>(k0 + i) * bw_y + c0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      continue;
    }
    // split > 1 means items < kThreads: this is the only pass of the loop
    if (active) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
#pragma unroll
        for (int c = 0; c < kAcc; ++c)
          red[(part * items + item) * kAcc * kAcc + i * kAcc + c] = acc[i][c];
    }
    __syncthreads();
    if (t < items) {
      float sum[kAcc][kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
#pragma unroll
        for (int c = 0; c < kAcc; ++c) sum[i][c] = 0.f;
      for (int p = 0; p < split; ++p) {  // fixed group order: deterministic
#pragma unroll
        for (int i = 0; i < kAcc; ++i)
#pragma unroll
          for (int c = 0; c < kAcc; ++c)
            sum[i][c] += red[(p * items + t) * kAcc * kAcc + i * kAcc + c];
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(k0 + i) * bw_y + c0) =
            make_float4(sum[i][0], sum[i][1], sum[i][2], sum[i][3]);
      }
    }
  }
}

// Kernel 1: one CTA per segment. kRowsOut adds the forward product (B2).
// kc / cc: rows of T[j] per chunk of the NT product, columns per chunk of
// the forward product (multiples of 8; kc * bw_y and bw_x * cc floats fit
// kChunkFloats).
template <typename Tin, typename Tz, bool kRowsOut>
__global__ void __launch_bounds__(kThreads)
seg_span_grad_kernel(const int* __restrict__ runs, const int* __restrict__ first,
                     const int* __restrict__ cnt, const Tin* __restrict__ x,
                     const Tin* __restrict__ y, const Tin* __restrict__ table,
                     Tz* __restrict__ z, Tin* __restrict__ rows_out,
                     float* __restrict__ partial, int seg, int blocks, int bw_x,
                     int bw_y, int p_rows, int kc, int cc) {
  extern __shared__ float4 smem4[];
  const int tile = bw_x * bw_y;
  float* slab = reinterpret_cast<float*>(smem4);  // one chunk of T[j]
  float* red = slab + kChunkFloats;               // [kRedFloats]
  const int s = blockIdx.x;
  const int base = s * seg;
  const int j0 = first[s];
  const int nspan = cnt[s];

  for (int k = 0; k < nspan; ++k) {
    const int j = j0 + k;
    // every branch below depends on CTA-uniform values only, so each
    // __syncthreads() is reached by all threads or by none
    const int st = max(runs[j], base);
    const int en = min(runs[j + 1], base + seg);
    if (en <= st) continue;
    if (j >= p_rows) {  // sentinel / padded span: exact zeros, no gradient
      zero_rows(z, st, en - st, blocks * bw_x);
      if (kRowsOut) zero_rows(rows_out, st, en - st, blocks * bw_y);
      continue;
    }
    const Tin* tj = table + static_cast<size_t>(j) * tile;
    // z[:, k0:k0+kw] = y @ T[j][k0:k0+kw, :]^T, the chunk staged transposed
    for (int k0 = 0; k0 < bw_x; k0 += kc) {
      const int kw = min(kc, bw_x - k0);
      __syncthreads();  // the previous chunk and scratch are no longer read
      for (int e = threadIdx.x; e < kw * bw_y; e += kThreads) {
        const int kk = e / bw_y;
        const int c = e - kk * bw_y;
        slab[c * kw + kk] = to_f32(tj[(k0 + kk) * bw_y + c]);
      }
      __syncthreads();
      rows_times_slab(y, z, slab, st, en, blocks, bw_y, bw_x, k0, kw);
    }
    // rows[:, c0:c0+cw] = x @ T[j][:, c0:c0+cw]
    for (int c0 = 0; kRowsOut && c0 < bw_y; c0 += cc) {
      const int cw = min(cc, bw_y - c0);
      __syncthreads();
      for (int e = threadIdx.x; e < bw_x * cw; e += kThreads) {
        const int kk = e / cw;
        slab[e] = to_f32(tj[kk * bw_y + c0 + (e - kk * cw)]);
      }
      __syncthreads();
      rows_times_slab(x, rows_out, slab, st, en, blocks, bw_x, bw_y, c0, cw);
    }
    span_outer(x, y, partial + static_cast<size_t>(s + j) * tile, red, st, en,
               blocks, bw_x, bw_y);
  }
}

// Kernel 2: one CTA per span; acc[j] = span j's partial tiles added in
// segment order (zero for an empty span).
__global__ void __launch_bounds__(kThreads)
span_reduce_kernel(const int* __restrict__ runs, const float* __restrict__ partial,
                   float* __restrict__ acc, int seg, int tile) {
  const int j = blockIdx.x;
  const int st = runs[j];
  const int en = runs[j + 1];
  const int n4 = tile / 4;
  float4* out = reinterpret_cast<float4*>(acc + static_cast<size_t>(j) * tile);
  if (en <= st) {
    for (int e = threadIdx.x; e < n4; e += kThreads) out[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int s_lo = st / seg;
  const int s_hi = (en - 1) / seg;
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  for (int e = threadIdx.x; e < n4; e += kThreads) {
    float4 sum = p4[static_cast<size_t>(s_lo + j) * n4 + e];
    for (int s = s_lo + 1; s <= s_hi; ++s) {
      const float4 v = p4[static_cast<size_t>(s + j) * n4 + e];
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    out[e] = sum;
  }
}

// rows of T per chunk of the NT product, or columns per chunk of the
// forward product: whole 8-wide groups within kChunkFloats
inline int chunk_of(int width, int other) {
  return std::min(width, std::max(8, kChunkFloats / other / 8 * 8));
}

template <typename Tin, typename Tz, bool kRowsOut>
int launch(const int* runs, const int* first, const int* cnt, const void* x,
           const void* y, const void* table, void* z, void* rows_out,
           float* partial, float* acc, int nseg, int seg, int blocks, int bw_x,
           int bw_y, int p_rows, cudaStream_t stream) {
  const size_t smem = (kChunkFloats + kRedFloats) * sizeof(float);
  auto kern = seg_span_grad_kernel<Tin, Tz, kRowsOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nseg > 0) {
    kern<<<nseg, kThreads, smem, stream>>>(
        runs, first, cnt, static_cast<const Tin*>(x), static_cast<const Tin*>(y),
        static_cast<const Tin*>(table), static_cast<Tz*>(z),
        static_cast<Tin*>(rows_out), partial, seg, blocks, bw_x, bw_y, p_rows,
        chunk_of(bw_x, bw_y), chunk_of(bw_y, bw_x));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p_rows > 0) {
    span_reduce_kernel<<<p_rows, kThreads, 0, stream>>>(runs, partial, acc, seg,
                                                        bw_x * bw_y);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fbtt_span
