// Sorted-run segment transform for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fbtt_embedding_tpu/ops/pallas/tt_flat.py
// :: _seg_transform_call. Lookups are sorted by one core index j, so the
// rows of core row j form one contiguous span runs[j] .. runs[j+1]. For
// every span j < p_rows and each of `blocks` lane-blocks b:
//
//     y[rows of j, b*bw_out:(b+1)*bw_out] = x[rows of j, b*bw_in:(b+1)*bw_in] @ T[j]
//
// with T[j] the bw_in x bw_out slab at rows j*bw_in of the stacked table.
// Rows of the sentinel span (dead / padded lookups) and of any span past
// p_rows get exact zeros.
//
// Design: one CTA per `seg`-row segment of the sorted order. The CTA walks
// the cnt[s] spans that intersect its segment, starting at first[s]. For
// each live span it stages slab T[j] in shared memory as float, in column
// chunks of at most 48 KB (the sort is what makes one slab serve every row
// of its run). Each thread then owns a 4-row x 8-column register tile of
// one lane-block: per step of 8 along the reduction it loads 16 or 32
// bytes of x per row and two float4 of the slab per k, so one shared load
// feeds 4 rows. Inputs and outputs are float32 or bfloat16; accumulation
// is float32 and each output is rounded once. Widths must be multiples of
// 8 and rows 16-byte aligned (the wrapper checks).
//
// Bound: memory. Each x row is read once, each y row written once and each
// live slab read once per segment that meets it; at the headline serving
// shape (nza = 10240) that is about 15 MB per pass in bf16, ~4.5 us at
// 3.35 TB/s, against 0.17-0.34 GFLOP. The multiply-adds run on the CUDA
// cores; tensor-core tiles (mma / wgmma) fed by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kSlabFloats = 48 * 1024 / 4;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive values <-> floats (16-byte aligned)
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

constexpr int kRows = 4;  // rows of one thread's register tile
constexpr int kCols = 8;  // columns of one thread's register tile

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
seg_transform_kernel(const int* __restrict__ runs,
                     const int* __restrict__ first,
                     const int* __restrict__ cnt,
                     const Tin* __restrict__ x,
                     const Tin* __restrict__ table,
                     Tout* __restrict__ y,
                     int seg, int blocks, int bw_in, int bw_out, int p_rows,
                     int chunk) {
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);  // [bw_in, chunk]
  const int s = blockIdx.x;
  const int base = s * seg;
  const int in_w = blocks * bw_in;
  const int out_w = blocks * bw_out;
  const int j0 = first[s];
  const int nspan = cnt[s];

  for (int k = 0; k < nspan; ++k) {
    const int j = j0 + k;
    // every branch below depends on CTA-uniform values only, so each
    // __syncthreads() is reached by all threads or by none
    const int st = max(runs[j], base);
    const int en = min(runs[j + 1], base + seg);
    if (en <= st) continue;
    const int nrows = en - st;
    if (j >= p_rows) {  // sentinel / padded span: exact zeros
      Tout* yr = y + static_cast<size_t>(st) * out_w;
      const float zero[kCols] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int e = threadIdx.x; e < nrows * out_w / kCols; e += kThreads) {
        store8(yr + e * kCols, zero);
      }
      continue;
    }
    const Tin* tj = table + static_cast<size_t>(j) * bw_in * bw_out;
    const int row_groups = (nrows + kRows - 1) / kRows;
    for (int c0 = 0; c0 < bw_out; c0 += chunk) {
      const int cw = min(chunk, bw_out - c0);
      __syncthreads();  // the previous slab chunk is no longer read
      for (int e = threadIdx.x; e < bw_in * cw; e += kThreads) {
        const int kk = e / cw;
        slab[e] = to_f32(tj[kk * bw_out + c0 + (e - kk * cw)]);
      }
      __syncthreads();
      const int groups = cw / kCols;
      const int per_rg = blocks * groups;
      for (int e = threadIdx.x; e < row_groups * per_rg; e += kThreads) {
        const int rg = e / per_rg;
        const int rem = e - rg * per_rg;
        const int b = rem / groups;
        const int g = rem - b * groups;
        const int r0 = st + rg * kRows;
        const int nr = min(kRows, en - r0);
        const Tin* xr[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          // rows past the span repeat its last row: loaded, never stored
          xr[i] = x + static_cast<size_t>(r0 + min(i, nr - 1)) * in_w +
                  b * bw_in;
        }
        float acc[kRows][kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
        const float* sl = slab + g * kCols;
        for (int k0 = 0; k0 < bw_in; k0 += 8) {
          float xv[kRows][8];
#pragma unroll
          for (int i = 0; i < kRows; ++i) load8(xr[i] + k0, xv[i]);
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            float w[kCols];
            load8(sl + (k0 + kk) * cw, w);
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                acc[i][c] = fmaf(xv[i][kk], w[c], acc[i][c]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i < nr) {
            store8(y + static_cast<size_t>(r0 + i) * out_w + b * bw_out + c0 +
                       g * kCols,
                   acc[i]);
          }
        }
      }
    }
  }
}

template <typename Tin, typename Tout>
int launch(const int* runs, const int* first, const int* cnt, const void* x,
           const void* table, void* y, int nseg, int seg, int blocks,
           int bw_in, int bw_out, int p_rows, cudaStream_t stream) {
  // at most 48 KB of float slab (no opt-in attribute needed), in whole
  // 8-column groups
  const int chunk =
      std::min(bw_out, std::max(kCols, kSlabFloats / bw_in / kCols * kCols));
  const size_t smem = static_cast<size_t>(bw_in) * chunk * sizeof(float);
  seg_transform_kernel<Tin, Tout><<<nseg, kThreads, smem, stream>>>(
      runs, first, cnt, static_cast<const Tin*>(x),
      static_cast<const Tin*>(table), static_cast<Tout*>(y), seg, blocks,
      bw_in, bw_out, p_rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success). in_bf16 / out_bf16 select bfloat16 (1) or float32 (0).
int fbtt_seg_transform(const int* runs, const int* first, const int* cnt,
                       const void* x, const void* table, void* y, int nseg,
                       int seg, int blocks, int bw_in, int bw_out,
                       int p_rows, int in_bf16, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(runs, first, cnt, x, table, y, nseg, seg,
                                               blocks, bw_in, bw_out, p_rows, st)
        : launch<__nv_bfloat16, float>(runs, first, cnt, x, table, y, nseg, seg, blocks,
                                       bw_in, bw_out, p_rows, st);
  }
  return out_bf16
      ? launch<float, __nv_bfloat16>(runs, first, cnt, x, table, y, nseg, seg, blocks,
                                     bw_in, bw_out, p_rows, st)
      : launch<float, float>(runs, first, cnt, x, table, y, nseg, seg, blocks, bw_in,
                             bw_out, p_rows, st);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
