// Innermost gradient pass with the first-core gradient fused, for Hopper
// (sm_90a): kernel B6.
//
// Replaces the Pallas TPU kernel fbtt_embedding_tpu/ops/pallas/tt_flat.py
// :: _seg_accum_dg0_call (through its wrapper _seg_accum_i1). It does what
// B3 (seg_accum.cu) does on the i1 pass and folds dG0 in:
//
//     acc[j]  += sum_b x_b[rows of j]^T @ y_b[rows of j]         (float32)
//     dz0[r]   = y[r] @ T[j]^T  per row r of span j              (float32)
//     dG0[i0c[r]] += dz0[r]                                      (float32)
//
// x is z0 (the first core's rows of every lookup, s1 order), y the
// cotangent of the i1 pass's output, T the stacked G1 table, i0c each row's
// first-core row (the sentinel tp0 for dead and padded lookups, whose dz0
// is dropped). dz0 never reaches device memory.
//
// Design. On the TPU one sequential grid adds every segment's one-hot
// product into a [tp0, x_w] VMEM accumulator. Here segments run at once,
// and dG0 rows are keyed by i0 while the segments are sorted by i1; float
// atomics would make dG0 depend on the schedule. So:
//   kernel 1 (one CTA per 64-row segment) is B3's segment CTA with z
//     written to shared memory instead of device memory. Then the CTA
//     orders its rows by (i0, row), sums the dz0 rows of each distinct i0
//     in row order, and writes one float32 partial row per distinct i0 at
//     slot seg_index*seg + k, with its key (keys ascending, unused slots
//     INT_MAX). The dG1 gradient goes out as B3's partial tiles.
//   kernel 2 is B3's per-span reduction of the dG1 tiles.
//   kernel 3 (one CTA per dG0 row) finds that row's partial in each
//     segment by binary search in the segment's sorted keys and adds the
//     partials in a fixed order (thread groups over ranges of segments,
//     then the groups in order).
// Every sum has a fixed order: bitwise repeatable, like B2, B3 and B5.
// Limit: the segment's dz0 tile, seg * x_w floats, lives in shared memory;
// the wrapper refuses more than 128 KB of it (x_w = blocks*bw_x <= 512 at
// seg 64), which the port's FBTT_DG0 gate checks before choosing B6.
//
// Bound: memory. x, y, i0c, the live G1 slabs read once, acc and dG0
// written once: ~18.7 MB at the headline i1 shape (x [10240, 128], y
// [10240, 512] bf16, acc [220, 32, 128], dG0 [200, 128]), ~5.6 us at
// 3.35 TB/s: B3's bound less its float32 dz0 write. The partial rows
// (at most nza * x_w floats) are this design's own round trip.

#include <climits>

#include "seg_span.cuh"

namespace {

using namespace fbtt_span;

constexpr int kNoKey = INT_MAX;  // unused partial slot / dropped row
constexpr int kHitChunk = 2048;  // segments searched per pass of kernel 3

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
seg_dg0_kernel(const int* __restrict__ runs, const int* __restrict__ first,
               const int* __restrict__ cnt, const Tin* __restrict__ x,
               const Tin* __restrict__ y, const int* __restrict__ i0c,
               const Tin* __restrict__ table, float* __restrict__ partial,
               float* __restrict__ dg0_part, int* __restrict__ dg0_key, int seg,
               int blocks, int bw_x, int bw_y, int p_rows, int tp0, int kc) {
  extern __shared__ float4 smem4[];
  const int tile = bw_x * bw_y;
  const int x_w = blocks * bw_x;
  float* slab = reinterpret_cast<float*>(smem4);  // [kc * bw_y]
  float* red = slab + kc * bw_y;                   // [kRedFloats]
  float* zs = red + kRedFloats;                    // [seg, x_w] dz0 rows
  int* key = reinterpret_cast<int*>(zs + static_cast<size_t>(seg) * x_w);  // [seg]
  int* order = key + seg;     // [seg] rows in (key, row) order
  int* head = order + seg;    // [seg + 1] first position of each distinct key
  int* n_keys = head + seg + 1;
  const int s = blockIdx.x;
  const int base = s * seg;
  const int j0 = first[s];
  const int nspan = cnt[s];

  // B3's span walk, z into the shared tile (rows base .. base + seg)
  for (int k = 0; k < nspan; ++k) {
    const int j = j0 + k;
    // CTA-uniform branches only: every __syncthreads() is reached by all
    const int st = max(runs[j], base);
    const int en = min(runs[j + 1], base + seg);
    if (en <= st) continue;
    if (j >= p_rows) {  // sentinel / padded span: zero dz0, no gradient
      zero_rows(zs, st - base, en - st, x_w);
      continue;
    }
    const Tin* tj = table + static_cast<size_t>(j) * tile;
    for (int k0 = 0; k0 < bw_x; k0 += kc) {
      const int kw = min(kc, bw_x - k0);
      __syncthreads();  // the previous chunk and scratch are no longer read
      for (int e = threadIdx.x; e < kw * bw_y; e += kThreads) {
        const int kk = e / bw_y;
        const int c = e - kk * bw_y;
        slab[c * kw + kk] = to_f32(tj[(k0 + kk) * bw_y + c]);
      }
      __syncthreads();
      rows_times_slab(y, zs, slab, st, en, blocks, bw_y, bw_x, k0, kw, base);
    }
    span_outer(x, y, partial + static_cast<size_t>(s + j) * tile, red, st, en, blocks,
               bw_x, bw_y);
  }

  // order the segment's rows by (i0, row): rank by counting
  for (int r = threadIdx.x; r < seg; r += kThreads) {
    const int k = i0c[base + r];
    key[r] = (k >= 0 && k < tp0) ? k : kNoKey;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < seg; r += kThreads) {
    const int kr = key[r];
    int rank = 0;
    for (int q = 0; q < seg; ++q) {
      const int kq = key[q];
      rank += (kq < kr) || (kq == kr && q < r);
    }
    order[rank] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nd = 0;
    int i = 0;
    for (; i < seg && key[order[i]] != kNoKey; ++i) {
      if (i == 0 || key[order[i]] != key[order[i - 1]]) head[nd++] = i;
    }
    head[nd] = i;
    *n_keys = nd;
  }
  __syncthreads();  // also orders the z tile's writes before the reads below
  const int nd = *n_keys;
  for (int k = threadIdx.x; k < seg; k += kThreads) {
    dg0_key[base + k] = k < nd ? key[order[head[k]]] : kNoKey;
  }
  // one partial row per distinct i0: its rows' dz0 added in row order
  const int x4 = x_w / 4;
  for (int e = threadIdx.x; e < nd * x4; e += kThreads) {
    const int k = e / x4;
    const int c = e - k * x4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = head[k]; i < head[k + 1]; ++i) {
      const float4 v =
          reinterpret_cast<const float4*>(zs + static_cast<size_t>(order[i]) * x_w)[c];
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    reinterpret_cast<float4*>(dg0_part + static_cast<size_t>(base + k) * x_w)[c] = sum;
  }
}

// One CTA per dG0 row r: the partials of r, added in a fixed order. The
// x_w/4 float4 columns take x_w/4 threads; the CTA's kThreads / (x_w/4)
// thread groups each add a contiguous range of every chunk of segments,
// four loads in flight, and the groups' sums are added in group order at
// the end: bitwise repeatable, and a hot row (present in every segment
// under Zipf traffic) is not one thread's serial chain of L2 loads.
__global__ void __launch_bounds__(kThreads)
dg0_reduce_kernel(const float* __restrict__ dg0_part, const int* __restrict__ dg0_key,
                  float* __restrict__ dg0, int nseg, int seg, int x_w) {
  __shared__ int hit[kHitChunk];
  __shared__ float4 group_sum[kThreads];
  const int r = blockIdx.x;
  const int x4 = x_w / 4;  // <= kThreads
  const int groups = kThreads / x4;
  const int g = threadIdx.x / x4;
  const int c = threadIdx.x - g * x4;
  const bool active = g < groups;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sum = zero;
  for (int s0 = 0; s0 < nseg; s0 += kHitChunk) {
    const int n = min(kHitChunk, nseg - s0);
    __syncthreads();  // the previous chunk's hits are no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int* kk = dg0_key + static_cast<size_t>(s0 + i) * seg;
      int lo = 0, hi = seg;  // first slot whose key >= r
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kk[mid] < r) lo = mid + 1; else hi = mid;
      }
      hit[i] = (lo < seg && kk[lo] == r) ? lo : -1;
    }
    __syncthreads();
    if (!active) continue;
    const int lo = n * g / groups;
    const int hi = n * (g + 1) / groups;
    for (int i = lo; i < hi; i += 4) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int h = i + u < hi ? hit[i + u] : -1;
        v[u] = h >= 0 ? reinterpret_cast<const float4*>(
                            dg0_part + (static_cast<size_t>(s0 + i + u) * seg + h) *
                                           x_w)[c]
                      : zero;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sum.x += v[u].x; sum.y += v[u].y; sum.z += v[u].z; sum.w += v[u].w;
      }
    }
  }
  if (active) group_sum[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < x4) {
    float4 total = group_sum[c];
    for (int k = 1; k < groups; ++k) {
      const float4 v = group_sum[k * x4 + c];
      total.x += v.x; total.y += v.y; total.z += v.z; total.w += v.w;
    }
    reinterpret_cast<float4*>(dg0 + static_cast<size_t>(r) * x_w)[c] = total;
  }
}

template <typename Tin>
int launch_dg0(const int* runs, const int* first, const int* cnt, const void* x,
               const void* y, const int* i0c, const void* table, float* partial,
               float* acc, float* dg0_part, int* dg0_key, float* dg0, int nseg, int seg,
               int blocks, int bw_x, int bw_y, int p_rows, int tp0, cudaStream_t stream) {
  const int x_w = blocks * bw_x;
  if (x_w % 4 != 0 || x_w / 4 > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = chunk_of(bw_x, bw_y);
  const size_t smem =
      (static_cast<size_t>(kc) * bw_y + kRedFloats + static_cast<size_t>(seg) * x_w) *
          sizeof(float) +
      (3 * static_cast<size_t>(seg) + 2) * sizeof(int);
  auto kern = seg_dg0_kernel<Tin>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nseg > 0) {
    kern<<<nseg, kThreads, smem, stream>>>(
        runs, first, cnt, static_cast<const Tin*>(x), static_cast<const Tin*>(y), i0c,
        static_cast<const Tin*>(table), partial, dg0_part, dg0_key, seg, blocks, bw_x,
        bw_y, p_rows, tp0, kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p_rows > 0) {
    span_reduce_kernel<<<p_rows, kThreads, 0, stream>>>(runs, partial, acc, seg,
                                                        bw_x * bw_y);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (tp0 > 0) {
    dg0_reduce_kernel<<<tp0, kThreads, 0, stream>>>(dg0_part, dg0_key, dg0, nseg, seg,
                                                     x_w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream`; returns cudaGetLastError() after
// the launches (0 on success). in_bf16 selects bfloat16 (1) or float32 (0)
// for x, y and table. Scratch: `partial` holds (nseg + p_rows) float tiles
// of bw_x * bw_y, `dg0_part` nseg*seg float rows of blocks*bw_x and
// `dg0_key` nseg*seg ints. Outputs: acc [p_rows, bw_x, bw_y] and dg0
// [tp0, blocks*bw_x], both float32.
int fbtt_seg_accum_dg0(const int* runs, const int* first, const int* cnt, const void* x,
                       const void* y, const int* i0c, const void* table, float* partial,
                       float* acc, float* dg0_part, int* dg0_key, float* dg0, int nseg,
                       int seg, int blocks, int bw_x, int bw_y, int p_rows, int tp0,
                       int in_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch_dg0<__nv_bfloat16>(runs, first, cnt, x, y, i0c, table, partial, acc,
                                     dg0_part, dg0_key, dg0, nseg, seg, blocks, bw_x,
                                     bw_y, p_rows, tp0, st);
  }
  return launch_dg0<float>(runs, first, cnt, x, y, i0c, table, partial, acc, dg0_part,
                           dg0_key, dg0, nseg, seg, blocks, bw_x, bw_y, p_rows, tp0, st);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
