// Per-span gradient passes of the flat sorted-run pipeline, for Hopper
// (sm_90a). Shared by seg_accum.cu (kernel B3, replacing the Pallas TPU
// kernel tt_flat.py :: _seg_accum_call) and seg_fused_i2.cu (kernel B2,
// replacing _seg_fused_i2_call), and in part by seg_accum_dg0.cu (kernel
// B6, which runs the tensor-core kernel below with its own z epilogue, and
// the CUDA-core helpers and the span reduction) and seg_transform.cu
// (kernel B1, which uses the staging and mma primitives).
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
// The block-diagonal fold (mm). Past the first core the table is
// block-diagonal, T[j] = kron(I_mm, G[j]) with G[j] its first diagonal
// block [bw_x/mm, bw_y/mm]. Each lane-block of x and y is then mm
// sub-blocks of width kx = bw_x/mm and ky = bw_y/mm, the off-diagonal
// products are zeros, and only the sum of acc's diagonal blocks is the core
// gradient. So the kernels run on nb = blocks*mm lane-blocks of widths kx,
// ky, read only G[j] (row stride bw_y, slab stride bw_x*bw_y in the table)
// and write acc as [p_rows, kx, ky]: 1/mm of the work and of the tile.
//
// Gradient across segments. Kernel 1 runs one CTA per `seg`-row segment of
// the sorted order and walks the cnt[s] spans that meet it from first[s].
// On the TPU one sequential grid adds every segment into one VMEM
// accumulator; here a span straddles segments whose CTAs run at once, and
// float atomics would make the gradient depend on the schedule. So each CTA
// writes the float32 sum of its own rows of span j as a partial tile at
// slot s + j (unique, because first[s+1] >= last span of s), and kernel 2
// adds span j's partial tiles in a fixed order into acc[j]: bitwise
// repeatable. Segment-parallel (and not one CTA per span) because a hot
// core row under Zipf traffic owns thousands of rows: one CTA per span
// would serialise them on one SM, while segments stay balanced. For the
// same reason kernel 2 splits a span of many tiles into chunks of
// consecutive tiles, one CTA a chunk, and adds the chunk sums in chunk
// order in a second pass; a span of few tiles is one chunk (kernel 2 below).
//
// Kernel 1 takes one of four paths (span_path below):
//  - tensor cores (bf16 inputs, B3, kx and ky multiples of 16): the
//    headline i1 pass (x [10240, 4*32], y [10240, 4*128], float32 z) does
//    ~0.67 GFLOP on ~24 MB, ~36 FLOP per byte, above the CUDA cores' ridge
//    (~20 at 67 TFLOP/s), so only the tensor cores can bring it to its
//    memory bound (~7 us at 3.35 TB/s). The CTA stages its segment's x and
//    y rows in shared memory once (cp.async, rows padded by 16 bytes so
//    the eight row addresses of an ldmatrix fall in distinct banks), and
//    each span's slab as bf16, double-buffered: the next live span's slab
//    loads while the current span computes. Both products run on
//    mma.sync.m16n8k16 (bf16 in, float32 accumulate) fed by ldmatrix:
//    z = Y_j T_j^T with M = the span's rows x blocks (row-major T_j is the
//    col-major B operand as it lies), acc_j = X_j^T Y_j with K = the span's
//    rows x blocks through ldmatrix.trans, items outside the span zeroed in
//    both fragments of the k-steps at the span's edges. What becomes of z
//    is the kernel's epilogue, a template parameter: B3 writes it to device
//    memory (ZToDevice); B6 keeps it in shared memory (seg_accum_dg0.cu).
//  - narrow tensor cores (bf16, kx 16, 32 or 64, ky 2, 4 or 8, B2 and B3):
//    the folded last core, B2 at the headline shape (kx 32, ky 4, 16
//    sub-blocks), is a stream of ~27 MB (bound ~8 us) with only 4
//    multiply-adds per z element, so it wants few instructions per byte:
//    the same staging, with ky padded to 8 columns of zeros, and all three
//    products on mma.sync (seg_span_tcn_kernel).
//  - narrow (ky <= 8, kx a multiple of 8 up to 256; any dtype): the same
//    passes on the CUDA cores where the narrow tensor-core path does not
//    take them (float32; other widths; segments whose rows pass kMaxSmem,
//    staged in chunks). kx/8 lanes share one (row, sub-block) item, each
//    with 8 columns of x and z (16-byte loads and stores, neighbouring lanes
//    on neighbouring bytes), G[j] in registers. rows sums its 8-column
//    parts over the item's lanes by shuffles; acc sums over the warp's
//    items by shuffles, then over the warps in order through shared memory.
//    At one CTA per segment (160 CTAs at B=512) this item loop is bound by
//    instruction latency, ~150 instructions per item lane at two warps per
//    scheduler, not by bytes: ~2.3x slower than the tensor-core version,
//    and 1.3-1.9x faster on an H100 than the CUDA-core path below at the
//    partial fold that path takes (ky 8: 2x the multiply-adds, G[j]
//    re-staged per span), on the float32 headline last core and the
//    tt_ndim-4 last core (scripts/time_span_kernels.py --ndim4).
//  - CUDA cores otherwise (float32, or widths the other two do not take,
//    up to 2048): T[j] staged in 64 KB float chunks, transposed for the NT
//    product with neighbouring threads on neighbouring words (no bank
//    conflicts), 4-row x 8-column register tiles for z and rows, 4x4 tiles
//    for acc.
// Kernel 2 (span_reduce_kernel) is shared with B6.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace fbtt_span {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows of one thread's z / rows tile
constexpr int kCols = 8;  // columns of one thread's z / rows tile
constexpr int kAcc = 4;   // a thread's acc tile is kAcc x kAcc
constexpr int kRedFloats = kThreads * kAcc * kAcc;  // group-sum scratch
constexpr int kChunkFloats = 64 * 1024 / 4;          // staged slab chunk
constexpr int kMaxSmem = 227 * 1024;                 // per CTA on Hopper
constexpr int kMaxWidth = 2048;                      // CUDA-core path
constexpr int kReduceDepth = 4;  // partial-tile loads in flight per thread

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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
// two consecutive float32 results (8-byte aligned for float, 4 for bf16)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__device__ void zero_rows(T* out, int st, int nrows, int width) {
  const float zero[kCols] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  T* o = out + static_cast<size_t>(st) * width;
  for (int e = threadIdx.x; e < nrows * width / kCols; e += kThreads) {
    store8(o + e * kCols, zero);
  }
}

// Everything kernel 1 needs, after the fold: nb lane-blocks of widths kx
// (x, z) and ky (y, rows); G[j] at table + j * tstride with row stride ts.
template <typename Tin, typename Tz>
struct SpanArgs {
  const int* runs;
  const int* first;
  const int* cnt;
  const Tin* x;
  const Tin* y;
  const Tin* table;
  Tz* z;
  Tin* rows;
  float* partial;
  int seg, nb, kx, ky, ts, tstride, p_rows;
};

// Sentinel spans (j >= p_rows, dead and padded lookups) come last in every
// segment's walk: exact zeros in z (and rows), no gradient.
template <typename Tin, typename Tz, bool kRowsOut>
__device__ void zero_sentinel_rows(const SpanArgs<Tin, Tz>& a, int base) {
  const int s = blockIdx.x;
  for (int k = 0; k < a.cnt[s]; ++k) {
    const int j = a.first[s] + k;
    if (j < a.p_rows) continue;
    const int st = max(a.runs[j], base);
    const int en = min(a.runs[j + 1], base + a.seg);
    if (en <= st) continue;
    zero_rows(a.z, st, en - st, a.nb * a.kx);
    if (kRowsOut) zero_rows(a.rows, st, en - st, a.nb * a.ky);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core helpers (the fallback path, and B6's in float32)

// out[r - out_row0, b*n_out + o0 + c] = sum_k in[r, b*n_in + k] * w[k * nc + c]
// for the rows [st, en) and the nc columns c of one chunk: w is an [n_in, nc]
// float matrix in shared memory. out_row0 lets `out` be a tile that holds
// only the rows from out_row0 on (B6 keeps its segment's z in shared memory).
template <typename Tin, typename Tout>
__device__ void rows_times_slab(const Tin* __restrict__ in, Tout* __restrict__ out,
                                const float* w, int st, int en, int blocks,
                                int n_in, int n_out, int o0, int nc, int out_row0 = 0) {
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
        store8(out + static_cast<size_t>(r0 + i - out_row0) * out_w + b * n_out + o0 +
                   g * kCols,
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

// Kernel 1, CUDA-core path. kc / cc: rows of G[j] per chunk of the NT
// product, columns per chunk of the forward product (multiples of 8; kc *
// ky and kx * cc floats fit kChunkFloats).
template <typename Tin, typename Tz, bool kRowsOut>
__global__ void __launch_bounds__(kThreads)
seg_span_grad_kernel(const SpanArgs<Tin, Tz> a, int kc, int cc) {
  extern __shared__ float4 smem4[];
  const int tile = a.kx * a.ky;
  float* slab = reinterpret_cast<float*>(smem4);  // one chunk of G[j]
  float* red = slab + kChunkFloats;               // [kRedFloats]
  const int s = blockIdx.x;
  const int base = s * a.seg;
  const int j0 = a.first[s];
  const int nspan = a.cnt[s];
  zero_sentinel_rows<Tin, Tz, kRowsOut>(a, base);

  for (int k = 0; k < nspan; ++k) {
    const int j = j0 + k;
    // every branch below depends on CTA-uniform values only, so each
    // __syncthreads() is reached by all threads or by none
    const int st = max(a.runs[j], base);
    const int en = min(a.runs[j + 1], base + a.seg);
    if (en <= st || j >= a.p_rows) continue;
    const Tin* tj = a.table + static_cast<size_t>(j) * a.tstride;
    // z[:, k0:k0+kw] = y @ G[j][k0:k0+kw, :]^T, the chunk staged transposed
    // (slab[c * kw + kk] = G[k0 + kk][c]): each thread reads 8 consecutive
    // c of one row kk (one vector load) and neighbouring threads take
    // neighbouring kk, so a warp's stores land on consecutive words
    for (int k0 = 0; k0 < a.kx; k0 += kc) {
      const int kw = min(kc, a.kx - k0);
      __syncthreads();  // the previous chunk and scratch are no longer read
      for (int e = threadIdx.x; e < kw * (a.ky / 8); e += kThreads) {
        const int kk = e % kw;
        const int c8 = (e / kw) * 8;
        float v[8];
        load8(tj + static_cast<size_t>(k0 + kk) * a.ts + c8, v);
#pragma unroll
        for (int u = 0; u < 8; ++u) slab[(c8 + u) * kw + kk] = v[u];
      }
      __syncthreads();
      rows_times_slab(a.y, a.z, slab, st, en, a.nb, a.ky, a.kx, k0, kw);
    }
    // rows[:, c0:c0+cw] = x @ G[j][:, c0:c0+cw]
    for (int c0 = 0; kRowsOut && c0 < a.ky; c0 += cc) {
      const int cw = min(cc, a.ky - c0);
      __syncthreads();
      for (int e = threadIdx.x; e < a.kx * cw; e += kThreads) {
        const int kk = e / cw;
        slab[e] = to_f32(tj[static_cast<size_t>(kk) * a.ts + c0 + (e - kk * cw)]);
      }
      __syncthreads();
      rows_times_slab(a.x, a.rows, slab, st, en, a.nb, a.kx, a.ky, c0, cw);
    }
    span_outer(a.x, a.y, a.partial + static_cast<size_t>(s + j) * tile, red, st, en,
               a.nb, a.kx, a.ky);
  }
}

// ---------------------------------------------------------------------------
// cp.async staging

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// nbytes (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, spread over the CTA; the caller commits and waits
__device__ __forceinline__ void stage16(void* dst, const void* src, size_t nbytes) {
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  for (size_t o = static_cast<size_t>(threadIdx.x) * 16; o < nbytes; o += kThreads * 16) {
    cp_async16(d + o, g + o);
  }
}

// ---------------------------------------------------------------------------
// Narrow path: ky <= KY <= 8, kx a multiple of 8 up to 256.

// The lanes of one item: kx/8 rounded up to a power of two (<= 32).
inline int narrow_lanes_log2(int kx) {
  int lg = 0;
  while ((8 << lg) < kx) ++lg;
  return lg;
}

constexpr int kNarrowStage = 96 * 1024;  // bytes of x and y rows staged at once

// Rows of a segment staged at a time: all of them where they fit.
inline int narrow_chunk_rows(int seg, int nb, int kx, int ky, int elem) {
  const long long row = static_cast<long long>(nb) * (kx + ky) * elem;
  return static_cast<int>(std::max(1LL, std::min<long long>(seg, kNarrowStage / row)));
}

// Shared memory of one CTA: x rows [rows*nb][kx], y rows [rows*nb][ky]
// (padded to 16 bytes), warp sums [kWarps][kx][KY] float.
__host__ __device__ inline size_t narrow_y_bytes(int rows, int nb, int ky, int elem) {
  return (static_cast<size_t>(rows) * nb * ky * elem + 15) / 16 * 16;
}
inline size_t narrow_smem_bytes(int rows, int nb, int kx, int ky, int ky_max, int elem) {
  return static_cast<size_t>(rows) * nb * kx * elem + narrow_y_bytes(rows, nb, ky, elem) +
         static_cast<size_t>(kWarps) * kx * ky_max * sizeof(float);
}

// One CTA per segment. The segment's x and y rows are staged in shared
// memory (cp.async, all in flight at once; in chunks of chunk_rows rows
// where they do not fit), so the span walk below reads only shared memory
// and G[j]. Each item (row, sub-block) takes kx/8 lanes, each with 8
// columns of x and z (16-byte shared loads and device stores, neighbouring
// lanes on neighbouring bytes), this lane's 8 rows of G[j] in registers.
template <typename Tin, typename Tz, bool kRowsOut, int KY>
__global__ void __launch_bounds__(kThreads, KY <= 4 ? 2 : 1)
seg_span_narrow_kernel(const SpanArgs<Tin, Tz> a, int lanes_log2, int chunk_rows) {
  extern __shared__ float4 smem4[];
  const int nb = a.nb, kx = a.kx, ky = a.ky;
  char* smem = reinterpret_cast<char*>(smem4);
  const size_t xb = static_cast<size_t>(chunk_rows) * nb * kx * sizeof(Tin);
  Tin* x_s = reinterpret_cast<Tin*>(smem);                              // [rows*nb][kx]
  Tin* y_s = reinterpret_cast<Tin*>(smem + xb);                         // [rows*nb][ky]
  float* red = reinterpret_cast<float*>(
      smem + xb + narrow_y_bytes(chunk_rows, nb, ky, sizeof(Tin)));      // [kWarps][kx][KY]
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ic = lane & (lanes - 1);  // this lane's columns ic*8 .. ic*8+7
  const bool col_ok = ic * 8 < kx;
  const int per_pass = kThreads >> lanes_log2;  // items per pass of the CTA
  const int item0 = threadIdx.x >> lanes_log2;
  const int xw = nb * kx;
  const int yw = nb * ky;
  const int tile = kx * ky;
  const bool y16 = static_cast<size_t>(yw) * sizeof(Tin) % 16 == 0;
  const int s = blockIdx.x;
  const int base = s * a.seg;
  zero_sentinel_rows<Tin, Tz, kRowsOut>(a, base);
  int staged = -1;  // first row of the chunk in shared memory

  for (int k = 0; k < a.cnt[s]; ++k) {
    const int j = a.first[s] + k;
    const int st = max(a.runs[j], base);
    const int en = min(a.runs[j + 1], base + a.seg);
    if (en <= st || j >= a.p_rows) continue;  // CTA-uniform
    const Tin* tj = a.table + static_cast<size_t>(j) * a.tstride;
    float g[8][KY];  // G[j][ic*8 + u][c]
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int c = 0; c < KY; ++c)
        g[u][c] = (col_ok && c < ky) ? to_f32(tj[static_cast<size_t>(ic * 8 + u) * a.ts + c])
                                     : 0.f;
    float acc[8][KY];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int c = 0; c < KY; ++c) acc[u][c] = 0.f;

    for (int r0 = st; r0 < en;) {  // the span's rows, one staged chunk at a time
      const int cbase = base + (r0 - base) / chunk_rows * chunk_rows;
      const int cend = min(cbase + chunk_rows, base + a.seg);
      if (cbase != staged) {  // CTA-uniform
        __syncthreads();      // the previous chunk is no longer read
        const size_t n_rows = static_cast<size_t>(cend - cbase);
        stage16(x_s, a.x + static_cast<size_t>(cbase) * xw, n_rows * xw * sizeof(Tin));
        if (y16) {
          stage16(y_s, a.y + static_cast<size_t>(cbase) * yw, n_rows * yw * sizeof(Tin));
        } else {
          const Tin* yg = a.y + static_cast<size_t>(cbase) * yw;
          for (int e = threadIdx.x; e < static_cast<int>(n_rows) * yw; e += kThreads) {
            y_s[e] = yg[e];
          }
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        staged = cbase;
      }
      const int r1 = min(en, cend);
      const int i_lo = (r0 - cbase) * nb;  // the piece's first item in the chunk
      const int n_items = (r1 - r0) * nb;
      // every lane runs the same trip count (the shuffles need the whole warp)
      for (int p0 = 0; p0 < n_items; p0 += per_pass) {
        const int it = p0 + item0;
        const bool ok = it < n_items;
        const int li = i_lo + (ok ? it : 0);
        const size_t gi = static_cast<size_t>(cbase) * nb + li;  // item in device memory
        float xv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) xv[u] = 0.f;
        if (ok && col_ok) load8(x_s + li * kx + ic * 8, xv);
        float yv[KY];
#pragma unroll
        for (int c = 0; c < KY; ++c) yv[c] = (ok && c < ky) ? to_f32(y_s[li * ky + c]) : 0.f;
        // z: this lane's 8 columns, sums over the ky columns of y
        if (ok && col_ok) {
          float zv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            float t = 0.f;
#pragma unroll
            for (int c = 0; c < KY; ++c) t = fmaf(yv[c], g[u][c], t);
            zv[u] = t;
          }
          store8(a.z + gi * kx + ic * 8, zv);
        }
        if (kRowsOut) {
          // rows: this lane's 8-column part, then the item's lanes summed
          // by a butterfly (every lane ends with the same sums)
          float rv[KY];
#pragma unroll
          for (int c = 0; c < KY; ++c) {
            float t = 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u) t = fmaf(xv[u], g[u][c], t);
            rv[c] = t;
          }
          for (int m = 1; m < lanes; m <<= 1) {
#pragma unroll
            for (int c = 0; c < KY; ++c) rv[c] += __shfl_xor_sync(0xffffffffu, rv[c], m);
          }
#pragma unroll
          for (int c = 0; c < KY; ++c) {
            if (ok && c < ky && (c & (lanes - 1)) == ic) {
              a.rows[gi * ky + c] = from_f32<Tin>(rv[c]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int c = 0; c < KY; ++c) acc[u][c] = fmaf(xv[u], yv[c], acc[u][c]);
      }
      r0 = r1;
    }
    // acc: the warp's lanes of one column group summed by a butterfly,
    // then the warps in order: a fixed order, bitwise repeatable
    for (int m = lanes; m < 32; m <<= 1) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int c = 0; c < KY; ++c) acc[u][c] += __shfl_xor_sync(0xffffffffu, acc[u][c], m);
    }
    __syncthreads();  // the previous span's warp sums are no longer read
    if (lane < lanes && col_ok) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int c = 0; c < KY; ++c) red[(warp * kx + ic * 8 + u) * KY + c] = acc[u][c];
    }
    __syncthreads();
    float* dst = a.partial + static_cast<size_t>(s + j) * tile;
    for (int e = threadIdx.x; e < tile; e += kThreads) {
      const int i = e / ky;
      const int c = e - i * ky;
      float t = red[i * KY + c];
      for (int w = 1; w < kWarps; ++w) t += red[(w * kx + i) * KY + c];
      dst[e] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 x, y, table; kx, ky multiples of 16.

constexpr int kTcPad = 8;  // bf16 elements (16 bytes) of padding per row

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// keep the bf16 halves of a packed pair whose item lies in [lo, hi)
__device__ __forceinline__ uint32_t mask_pair(uint32_t v, int k, int lo, int hi) {
  const uint32_t keep_lo = (k >= lo && k < hi) ? 0x0000ffffu : 0u;
  const uint32_t keep_hi = (k + 1 >= lo && k + 1 < hi) ? 0xffff0000u : 0u;
  return v & (keep_lo | keep_hi);
}

// Shared memory of one CTA: x rows [seg*nb][kx + pad], y rows [seg*nb][ky +
// pad], two slab buffers [kx][ky + pad], all bf16.
inline size_t tc_smem_bytes(int seg, int nb, int kx, int ky) {
  const size_t items = static_cast<size_t>(seg) * nb;
  return 2 * (items * (kx + kTcPad) + items * (ky + kTcPad) +
              2 * static_cast<size_t>(kx) * (ky + kTcPad));
}

// B3's epilogue of the tensor-core kernel: z rows to device memory, each
// element rounded once to Tz; the sentinel span's rows get exact zeros.
// An epilogue gives the kernel:
//  - kInPlace: z overwrites the span's own y rows in shared memory, so the
//    acc product runs first, then a barrier, then the z product;
//  - kPasses: 32-column passes of z a warp holds in registers before it
//    stores any (in place, an m-tile's y rows are read by every pass);
//  - Args, what it needs beyond SpanArgs (its own shared memory, if any,
//    follows the slab buffers: the launch adds it);
//  - begin(a, base), while the segment's rows are staged; store(item,
//    column, v0, v1), two neighbouring z elements of one item of the
//    segment; finish(), after the span walk, every z element stored and
//    visible.
template <typename Tz>
struct ZToDevice {
  static constexpr bool kInPlace = false;
  static constexpr int kPasses = 1;
  struct Args {};

  Tz* z;  // the segment's first z row
  int kx;
  __device__ ZToDevice(const SpanArgs<__nv_bfloat16, Tz>& a, const Args&, __nv_bfloat16*,
                       int, void*, int base)
      : z(a.z + static_cast<size_t>(base) * a.nb * a.kx), kx(a.kx) {}
  __device__ void begin(const SpanArgs<__nv_bfloat16, Tz>& a, int base) const {
    zero_sentinel_rows<__nv_bfloat16, Tz, false>(a, base);
  }
  __device__ void store(int it, int col, float v0, float v1) const {
    store2(z + static_cast<size_t>(it) * kx + col, v0, v1);
  }
  __device__ void finish() const {}
};

template <typename Tz, typename Epi>
__global__ void __launch_bounds__(kThreads, 2)
seg_span_tc_kernel(const SpanArgs<__nv_bfloat16, Tz> a, const typename Epi::Args ea) {
  extern __shared__ float4 smem4[];
  using bf16 = __nv_bfloat16;
  constexpr int NP = Epi::kPasses;
  const int kx = a.kx, ky = a.ky;
  const int xs = kx + kTcPad, ys = ky + kTcPad;  // padded row strides
  const int items = a.seg * a.nb;
  bf16* x_s = reinterpret_cast<bf16*>(smem4);
  bf16* y_s = x_s + static_cast<size_t>(items) * xs;
  bf16* t_s = y_s + static_cast<size_t>(items) * ys;  // [2][kx][ys]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tile = kx * ky;
  const int s = blockIdx.x;
  const int base = s * a.seg;
  const int j0 = a.first[s];
  const int nspan = a.cnt[s];
  Epi epi(a, ea, y_s, ys, t_s + static_cast<size_t>(2) * kx * ys, base);

  auto live = [&](int k) {  // span k of this segment has rows and a slab
    const int j = j0 + k;
    return j < a.p_rows && min(a.runs[j + 1], base + a.seg) > max(a.runs[j], base);
  };
  auto next_live = [&](int k) {
    while (k < nspan && !live(k)) ++k;
    return k;
  };
  auto stage_slab = [&](int k, int buf) {
    const bf16* tj = a.table + static_cast<size_t>(j0 + k) * a.tstride;
    bf16* dst = t_s + static_cast<size_t>(buf) * kx * ys;
    const int c8 = ky / 8;
    for (int e = threadIdx.x; e < kx * c8; e += kThreads) {
      const int i = e / c8;
      const int c = (e - i * c8) * 8;
      cp_async16(dst + i * ys + c, tj + static_cast<size_t>(i) * a.ts + c);
    }
  };

  // the segment's x and y rows, once (contiguous in device memory)
  {
    const bf16* xg = a.x + static_cast<size_t>(base) * a.nb * kx;
    const bf16* yg = a.y + static_cast<size_t>(base) * a.nb * ky;
    const int cx = kx / 8, cy = ky / 8;
    for (int e = threadIdx.x; e < items * cx; e += kThreads) {
      const int it = e / cx;
      cp_async16(x_s + it * xs + (e - it * cx) * 8, xg + static_cast<size_t>(e) * 8);
    }
    for (int e = threadIdx.x; e < items * cy; e += kThreads) {
      const int it = e / cy;
      cp_async16(y_s + it * ys + (e - it * cy) * 8, yg + static_cast<size_t>(e) * 8);
    }
  }
  int k = next_live(0);
  if (k < nspan) stage_slab(k, 0);
  cp_async_commit();
  epi.begin(a, base);
  cp_async_wait_all();
  __syncthreads();

  int buf = 0;
  while (k < nspan) {
    const int kn = next_live(k + 1);
    if (kn < nspan) stage_slab(kn, buf ^ 1);  // lands while span k computes
    cp_async_commit();
    const int j = j0 + k;
    const int lo = (max(a.runs[j], base) - base) * a.nb;  // items of span j
    const int hi = (min(a.runs[j + 1], base + a.seg) - base) * a.nb;
    const int m_lo = lo & ~15;
    const bf16* ts_ = t_s + static_cast<size_t>(buf) * kx * ys;

    // z = Y_j T_j^T: m16 item tiles dealt to warps, 32 * NP columns at a
    // time. Rows of a tile outside [lo, hi) are computed and dropped (in
    // place, rows before lo hold the previous span's z).
    auto z_product = [&]() {
      for (int m0 = m_lo + warp * 16; m0 < hi; m0 += kWarps * 16) {
        for (int n0 = 0; n0 < kx; n0 += 32 * NP) {
          float c[4 * NP][4];
#pragma unroll
          for (int q = 0; q < 4 * NP; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[q][e] = 0.f;
          for (int k0 = 0; k0 < ky; k0 += 16) {
            uint32_t af[4];
            ldsm_x4(af, y_s + (m0 + (lane & 15)) * ys + k0 + (lane >> 4) * 8);
#pragma unroll
            for (int p = 0; p < 2 * NP; ++p) {
              if (n0 + p * 16 < kx) {
                uint32_t bf[4];
                const int q = lane >> 3;
                ldsm_x4(bf, ts_ + (n0 + p * 16 + (q >> 1) * 8 + (lane & 7)) * ys + k0 +
                                (q & 1) * 8);
                mma_bf16(c[2 * p], af, bf[0], bf[1]);
                mma_bf16(c[2 * p + 1], af, bf[2], bf[3]);
              }
            }
          }
          if (Epi::kInPlace) __syncwarp();  // the tile's y rows are read
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int it = m0 + g + h * 8;
            if (it < lo || it >= hi) continue;
#pragma unroll
            for (int q = 0; q < 4 * NP; ++q) {
              if (n0 + (q >> 1) * 16 < kx) {
                epi.store(it, n0 + q * 8 + 2 * t4, c[q][2 * h], c[q][2 * h + 1]);
              }
            }
          }
        }
      }
    };

    // acc_j = X_j^T Y_j: units of (16 columns of ky) x (up to 64 rows of
    // kx) dealt to warps; each warp runs the span's whole K, in order
    auto acc_product = [&]() {
      const int n_np = ky / 16;
      const int n_mg = (kx + 63) / 64;
      float* dst = a.partial + static_cast<size_t>(s + j) * tile;
      for (int u = warp; u < n_np * n_mg; u += kWarps) {
        const int n0 = (u % n_np) * 16;
        const int mb = (u / n_np) * 64;
        const int mtiles = min(4, (kx - mb) / 16);
        float c[4][2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[mi][q][e] = 0.f;
        for (int k0 = m_lo; k0 < hi; k0 += 16) {
          const int q = lane >> 3;
          uint32_t bf[4];  // Y rows k0.., columns n0..n0+16 (two n8 tiles)
          ldsm_x4_t(bf, y_s + (k0 + (q & 1) * 8 + (lane & 7)) * ys + n0 + (q >> 1) * 8);
          const bool edge = k0 < lo || k0 + 16 > hi;  // warp-uniform
          if (edge) {  // also clears the previous span's z bits, in place
            bf[0] = mask_pair(bf[0], k0 + 2 * t4, lo, hi);
            bf[1] = mask_pair(bf[1], k0 + 8 + 2 * t4, lo, hi);
            bf[2] = mask_pair(bf[2], k0 + 2 * t4, lo, hi);
            bf[3] = mask_pair(bf[3], k0 + 8 + 2 * t4, lo, hi);
          }
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            if (mi < mtiles) {
              uint32_t af[4];  // X^T: X rows k0.., columns mb + mi*16 ..
              ldsm_x4_t(af, x_s + (k0 + (q >> 1) * 8 + (lane & 7)) * xs + mb + mi * 16 +
                                (q & 1) * 8);
              if (edge) {
                af[0] = mask_pair(af[0], k0 + 2 * t4, lo, hi);
                af[1] = mask_pair(af[1], k0 + 2 * t4, lo, hi);
                af[2] = mask_pair(af[2], k0 + 8 + 2 * t4, lo, hi);
                af[3] = mask_pair(af[3], k0 + 8 + 2 * t4, lo, hi);
              }
              mma_bf16(c[mi][0], af, bf[0], bf[1]);
              mma_bf16(c[mi][1], af, bf[2], bf[3]);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          if (mi < mtiles) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float* dr =
                  dst + static_cast<size_t>(mb + mi * 16 + g + h * 8) * ky + n0 + 2 * t4;
              store2(dr, c[mi][0][2 * h], c[mi][0][2 * h + 1]);
              store2(dr + 8, c[mi][1][2 * h], c[mi][1][2 * h + 1]);
            }
          }
        }
      }
    };

    if constexpr (Epi::kInPlace) {
      acc_product();
      __syncthreads();  // every warp has read span j's y rows: z may replace them
      z_product();
    } else {
      z_product();
      acc_product();
    }
    cp_async_wait_all();
    __syncthreads();  // span kn's slab is in; nobody reads buffer `buf` now
    buf ^= 1;
    k = kn;
  }
  epi.finish();
}

// ---------------------------------------------------------------------------
// Narrow tensor-core path: bf16, kx in {16, 32, 64}, ky in {2, 4, 8}, the
// segment's rows within kMaxSmem (the folded last core at the headline
// shape: kx 32, ky 4). The CUDA-core narrow kernel above spends its time
// issuing ~150 instructions per item lane at two warps per scheduler; here
// the three products run on mma.sync with ky padded to 8 in shared memory
// (zeros that add nothing): z = Y G^T as m16n8k8 (K = ky), rows = X G as
// m16n8k16 (N = ky), acc = X^T Y as m16n8k16 (N = ky, K = the span's items
// in 16-item steps dealt to the warps, each warp's sum added in warp
// order: bitwise repeatable). G[j] is double-buffered as in the wide path,
// and its fragments stay in registers for the span.

constexpr int kTcnY = 8;  // bf16 columns of a staged y or G row (ky padded)

// d += a (16x8, row) * b (8x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// BYTES (4, 8 or 16, aligned to as many) from device to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    cp_async16(dst, src);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
  }
}
// rows 0 .. KX-1 of an [KX][kTcnY] bf16 tile as KX/8 ldmatrix 8x8 matrices,
// as they lie (kTrans false) or transposed
template <int KX, bool kTrans>
__device__ __forceinline__ void ldsm_rows(uint32_t (&r)[KX / 8], const __nv_bfloat16* t,
                                          int lane) {
  if constexpr (KX == 16) {
    uint32_t v[2];
    if constexpr (kTrans) ldsm_x2_t(v, t + (lane & 15) * kTcnY);
    else ldsm_x2(v, t + (lane & 15) * kTcnY);
    r[0] = v[0];
    r[1] = v[1];
  } else {
#pragma unroll
    for (int q = 0; q < KX / 32; ++q) {
      uint32_t v[4];
      if constexpr (kTrans) ldsm_x4_t(v, t + (q * 32 + lane) * kTcnY);
      else ldsm_x4(v, t + (q * 32 + lane) * kTcnY);
#pragma unroll
      for (int m = 0; m < 4; ++m) r[q * 4 + m] = v[m];
    }
  }
}

// Shared memory of one CTA: x rows [seg*nb][kx + pad], y rows [seg*nb][8]
// and two G buffers [kx][8] in bf16, warp sums [kWarps][kx][8] float.
inline size_t tcn_smem_bytes(int seg, int nb, int kx) {
  const size_t items = static_cast<size_t>(seg) * nb;
  return 2 * (items * (kx + kTcPad) + items * kTcnY + 2 * static_cast<size_t>(kx) * kTcnY) +
         static_cast<size_t>(kWarps) * kx * kTcnY * sizeof(float);
}

// KX = kx; CPB = 2 * ky, the bytes of one y or G row.
template <typename Tz, bool kRowsOut, int KX, int CPB>
__global__ void __launch_bounds__(kThreads, 2)
seg_span_tcn_kernel(const SpanArgs<__nv_bfloat16, Tz> a) {
  extern __shared__ float4 smem4[];
  using bf16 = __nv_bfloat16;
  constexpr int KY = CPB / 2;
  constexpr int xs = KX + kTcPad;  // padded x row stride
  constexpr int NT = KX / 8;       // z's n-tiles
  constexpr int KS = KX / 16;      // rows' k-steps, acc's m-tiles
  const int items = a.seg * a.nb;
  bf16* x_s = reinterpret_cast<bf16*>(smem4);
  bf16* y_s = x_s + static_cast<size_t>(items) * xs;                 // [items][8]
  bf16* g_s = y_s + static_cast<size_t>(items) * kTcnY;              // [2][KX][8]
  float* red = reinterpret_cast<float*>(g_s + 2 * KX * kTcnY);       // [kWarps][KX][8]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int s = blockIdx.x;
  const int base = s * a.seg;
  const int j0 = a.first[s];
  const int nspan = a.cnt[s];

  auto live = [&](int k) {  // span k of this segment has rows and a slab
    const int j = j0 + k;
    return j < a.p_rows && min(a.runs[j + 1], base + a.seg) > max(a.runs[j], base);
  };
  auto next_live = [&](int k) {
    while (k < nspan && !live(k)) ++k;
    return k;
  };
  auto stage_g = [&](int k, int buf) {
    const bf16* tj = a.table + static_cast<size_t>(j0 + k) * a.tstride;
    bf16* dst = g_s + buf * KX * kTcnY;
    for (int i = threadIdx.x; i < KX; i += kThreads) {
      cp_async_n<CPB>(dst + i * kTcnY, tj + static_cast<size_t>(i) * a.ts);
    }
  };

  // the padding columns of y and G are zeros; the copies never touch them
  if constexpr (KY < kTcnY) {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < items + 2 * KX; i += kThreads) {
      bf16* row = i < items ? y_s + i * kTcnY : g_s + (i - items) * kTcnY;
#pragma unroll
      for (int c = KY; c < kTcnY; ++c) row[c] = zero;
    }
  }
  // the segment's x and y rows, once
  {
    const bf16* xg = a.x + static_cast<size_t>(base) * a.nb * KX;
    const bf16* yg = a.y + static_cast<size_t>(base) * a.nb * KY;
    constexpr int cx = KX / 8;
    for (int e = threadIdx.x; e < items * cx; e += kThreads) {
      const int it = e / cx;
      cp_async16(x_s + it * xs + (e - it * cx) * 8, xg + static_cast<size_t>(e) * 8);
    }
    for (int it = threadIdx.x; it < items; it += kThreads) {
      cp_async_n<CPB>(y_s + it * kTcnY, yg + static_cast<size_t>(it) * KY);
    }
  }
  int k = next_live(0);
  if (k < nspan) stage_g(k, 0);
  cp_async_commit();
  zero_sentinel_rows<bf16, Tz, kRowsOut>(a, base);
  cp_async_wait_all();
  __syncthreads();

  int buf = 0;
  while (k < nspan) {
    const int kn = next_live(k + 1);
    if (kn < nspan) stage_g(kn, buf ^ 1);  // lands while span k computes
    cp_async_commit();
    const int j = j0 + k;
    const int lo = (max(a.runs[j], base) - base) * a.nb;  // items of span j
    const int hi = (min(a.runs[j + 1], base + a.seg) - base) * a.nb;
    const int m_lo = lo & ~15;
    // G[j]: rows n, columns k as z's B; rows k, columns n as rows' B
    const bf16* gb = g_s + buf * KX * kTcnY;
    uint32_t bz[NT], br[NT];
    ldsm_rows<KX, false>(bz, gb, lane);
    if constexpr (kRowsOut) ldsm_rows<KX, true>(br, gb, lane);

    // z (and rows): m16 item tiles dealt to warps
    for (int m0 = m_lo + warp * 16; m0 < hi; m0 += kWarps * 16) {
      uint32_t ay[2];
      ldsm_x2(ay, y_s + (m0 + (lane & 15)) * kTcnY);
      float cz[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cz[nt][e] = 0.f;
        mma_bf16_k8(cz[nt], ay[0], ay[1], bz[nt]);
      }
      float cr[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kRowsOut) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ax[4];
          ldsm_x4(ax, x_s + (m0 + (lane & 15)) * xs + ks * 16 + (lane >> 4) * 8);
          mma_bf16(cr, ax, br[2 * ks], br[2 * ks + 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int it = m0 + g + h * 8;
        if (it < lo || it >= hi) continue;
        const size_t gi = static_cast<size_t>(base) * a.nb + it;
        Tz* zr = a.z + gi * KX + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) store2(zr + nt * 8, cz[nt][2 * h], cz[nt][2 * h + 1]);
        if (kRowsOut && 2 * t4 < KY) {
          store2(a.rows + gi * KY + 2 * t4, cr[2 * h], cr[2 * h + 1]);
        }
      }
    }

    // acc = X_j^T Y_j: 16-item k-steps dealt to warps, KS m-tiles each
    float ca[KS][4];
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ca[mt][e] = 0.f;
    for (int k0 = m_lo + warp * 16; k0 < hi; k0 += kWarps * 16) {
      uint32_t by[2];  // Y rows k0 .. k0+15, columns 0 .. 7
      ldsm_x2_t(by, y_s + (k0 + (lane & 15)) * kTcnY);
      const bool edge = k0 < lo || k0 + 16 > hi;  // warp-uniform
      if (edge) {
        by[0] = mask_pair(by[0], k0 + 2 * t4, lo, hi);
        by[1] = mask_pair(by[1], k0 + 8 + 2 * t4, lo, hi);
      }
      const int q = lane >> 3;
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        uint32_t af[4];  // X^T: X rows k0.., columns mt*16 ..
        ldsm_x4_t(af, x_s + (k0 + (q >> 1) * 8 + (lane & 7)) * xs + mt * 16 + (q & 1) * 8);
        if (edge) {
          af[0] = mask_pair(af[0], k0 + 2 * t4, lo, hi);
          af[1] = mask_pair(af[1], k0 + 2 * t4, lo, hi);
          af[2] = mask_pair(af[2], k0 + 8 + 2 * t4, lo, hi);
          af[3] = mask_pair(af[3], k0 + 8 + 2 * t4, lo, hi);
        }
        mma_bf16(ca[mt], af, by[0], by[1]);
      }
    }
    // the warps' sums through shared memory, added in warp order
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* r = red + (warp * KX + mt * 16 + g + h * 8) * kTcnY + 2 * t4;
        r[0] = ca[mt][2 * h];
        r[1] = ca[mt][2 * h + 1];
      }
    __syncthreads();
    float* dst = a.partial + static_cast<size_t>(s + j) * (KX * KY);
    for (int e = threadIdx.x; e < KX * KY; e += kThreads) {
      const int i = e / KY;
      const int c = e - i * KY;
      float t = red[i * kTcnY + c];
      for (int w = 1; w < kWarps; ++w) t += red[(w * KX + i) * kTcnY + c];
      dst[e] = t;
    }
    cp_async_wait_all();
    __syncthreads();  // span kn's G is in; buffer `buf` and the sums are free
    buf ^= 1;
    k = kn;
  }
}

// ---------------------------------------------------------------------------
// Kernel 2 (span_reduce_kernel): acc[j] = span j's partial tiles added in
// a fixed order (zero for an empty span). Span j's tiles lie at the
// consecutive slots s + j, s over the segments it meets. Under Zipf traffic
// one core row meets most segments (a quarter of the 20480 at the training
// cell's i1 pass, ~90 MB of tiles): one CTA a span would add them in one
// serial chain of loads while the other spans are long done. So with a
// chunk C > 0 the tiles are added in two passes. CTAs over (span, chunk of
// at most C consecutive tiles, column block) add their chunk's tiles in
// slot order: a span of one chunk (nearly every span) writes acc[j] so; a
// split span's chunk writes its sum over its own first tile, which only
// that CTA reads, after reading it. Then a CTA per split span adds its
// chunk sums in chunk order into acc[j]. A schedule pass before them (one
// CTA) counts each span's chunks from runs and writes span j's first chunk,
// each chunk's span and the split spans to `sched`: the grids are sized by
// bounds the host knows, and nothing is read on the host. C = 0 is one
// chunk a span: the chunk pass alone, one CTA a span. In a CTA, a column
// block of cw <= kThreads float4 columns takes kThreads / cw thread groups,
// each adding a contiguous range of the chunk's tiles with kReduceDepth
// loads in flight, and the groups' sums are added in group order. Every
// sum has a fixed order: bitwise repeatable, no atomics.
constexpr int kReduceSchedule = 0;  // span_reduce_kernel's passes
constexpr int kReduceChunks = 1;
constexpr int kReduceChunkSums = 2;

// Chunks in all, at most: the spans' tiles fill at most nseg + p_rows slots,
// and each span has at most one chunk of fewer than C tiles.
inline long long reduce_chunks(int nseg, int p_rows, int chunk) {
  return (static_cast<long long>(nseg) + p_rows + chunk - 1) / chunk + p_rows;
}

// Split spans, at most: each has more than C tiles.
inline long long reduce_splits(int nseg, int p_rows, int chunk) {
  return std::min<long long>(p_rows, (static_cast<long long>(nseg) + p_rows) / (chunk + 1));
}

// Span j's partial tiles: how many, and (in `slot`) the slot of its first.
__device__ __forceinline__ int span_tiles(const int* __restrict__ runs, int j, int seg,
                                          int& slot) {
  const int st = runs[j];
  const int en = runs[j + 1];
  slot = st / seg + j;
  return en > st ? (en - 1) / seg - st / seg + 1 : 0;
}

// The exclusive prefix of v over the CTA's threads, and in `total` the sum;
// every thread of the CTA calls it. warp_tot holds kWarps entries.
__device__ __forceinline__ int2 cta_scan(int2 v, int2* warp_tot, int2& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, inc.x, o);
    const int b = __shfl_up_sync(0xffffffffu, inc.y, o);
    if (lane >= o) {
      inc.x += a;
      inc.y += b;
    }
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int2 before = make_int2(0, 0);
  total = make_int2(0, 0);
  for (int w = 0; w < kWarps; ++w) {
    const int2 t = warp_tot[w];
    if (w < warp) {
      before.x += t.x;
      before.y += t.y;
    }
    total.x += t.x;
    total.y += t.y;
  }
  __syncthreads();  // warp_tot is read before the next call writes it
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// Float4 column c of the `count` tiles at slots slot0, slot0 + stride, ...:
// thread group gi of `groups` (cw threads each) adds the gi-th contiguous
// range of them in order, kReduceDepth loads in flight, then the groups'
// sums are added in group order through group_sum. Every thread of the CTA
// calls it; group 0 (threadIdx.x < cw) returns the total. p4 may alias the
// tiles the caller writes after.
__device__ __forceinline__ float4 ordered_sum(const float4* p4, int slot0, int stride,
                                              int count, int n4, int c, int cw, int groups,
                                              float4* group_sum) {
  const int gi = threadIdx.x / cw;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sum = zero;
  if (gi < groups && c < n4) {
    const int lo = count * gi / groups;
    const int hi = count * (gi + 1) / groups;
    for (int i = lo; i < hi; i += kReduceDepth) {
      float4 v[kReduceDepth];
#pragma unroll
      for (int u = 0; u < kReduceDepth; ++u) {
        v[u] = i + u < hi ? p4[(static_cast<size_t>(slot0) +
                                static_cast<size_t>(i + u) * stride) * n4 + c]
                          : zero;
      }
#pragma unroll
      for (int u = 0; u < kReduceDepth; ++u) {
        sum.x += v[u].x; sum.y += v[u].y; sum.z += v[u].z; sum.w += v[u].w;
      }
    }
  }
  if (groups > 1) {
    if (gi < groups) group_sum[threadIdx.x] = sum;
    __syncthreads();
    if (threadIdx.x < cw) {
      for (int k = 1; k < groups; ++k) {
        const float4 v = group_sum[k * cw + threadIdx.x];
        sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
      }
    }
  }
  return sum;
}

// Pass kReduceSchedule: grid 1. kReduceChunks: grid (reduce_chunks, column
// blocks), or (p_rows, column blocks) at chunk 0. kReduceChunkSums: grid
// (reduce_splits, column blocks). CTAs past the work exit at once. The
// schedule, `sched` (2 * p_rows + 3 + reduce_chunks ints): start[p_rows + 1]
// (span j's first chunk; start[p_rows] the chunks in all), the split spans'
// count and p_rows less it, split[p_rows] (the split spans, ascending),
// span_of[reduce_chunks] (each chunk's span).
template <int kPass>
__global__ void __launch_bounds__(kThreads)
span_reduce_kernel(const int* __restrict__ runs, float* partial, float* __restrict__ acc,
                   int* sched, int p_rows, int seg, int tile, int chunk) {
  __shared__ float4 group_sum[kThreads];
  int* start = sched;
  int* counts = sched + p_rows + 1;  // split spans, p_rows less them
  int* split = counts + 2;
  int* span_of = split + p_rows;
  if constexpr (kPass == kReduceSchedule) {
    __shared__ int2 warp_tot[kWarps];
    int base = 0, nsplit = 0;  // CTA-uniform
    for (int j0 = 0; j0 < p_rows; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      int nch = 0;
      if (j < p_rows) {
        int slot;
        nch = max(1, (span_tiles(runs, j, seg, slot) + chunk - 1) / chunk);
      }
      int2 total;
      const int2 pre = cta_scan(make_int2(nch, nch > 1), warp_tot, total);
      if (j < p_rows) {
        start[j] = base + pre.x;
        if (nch > 1) split[nsplit + pre.y] = j;
        for (int k = 0; k < nch; ++k) span_of[base + pre.x + k] = j;
      }
      base += total.x;
      nsplit += total.y;
    }
    if (threadIdx.x == 0) {
      start[p_rows] = base;
      counts[0] = nsplit;
      counts[1] = p_rows - nsplit;
    }
  } else {
    const int n4 = tile / 4;
    const int cw = min(n4, kThreads);
    const int c = blockIdx.y * cw + threadIdx.x % cw;
    int j, slot0, count, stride = 1;
    float* dst;
    if constexpr (kPass == kReduceChunks) {
      int k = 0, nch = 1;
      if (chunk > 0) {
        const int b = blockIdx.x;
        if (b >= start[p_rows]) return;  // CTA-uniform, before any barrier
        j = span_of[b];
        k = b - start[j];
        nch = start[j + 1] - start[j];
      } else {
        j = blockIdx.x;
      }
      const int n = span_tiles(runs, j, seg, slot0);
      if (chunk > 0) {
        slot0 += k * chunk;
        count = min(chunk, n - k * chunk);
      } else {
        count = n;
      }
      dst = nch == 1 ? acc + static_cast<size_t>(j) * tile
                     : partial + static_cast<size_t>(slot0) * tile;
    } else {
      if (static_cast<int>(blockIdx.x) >= counts[0]) return;  // CTA-uniform
      j = split[blockIdx.x];
      span_tiles(runs, j, seg, slot0);
      count = start[j + 1] - start[j];
      stride = chunk;
      dst = acc + static_cast<size_t>(j) * tile;
    }
    const float4 sum = ordered_sum(reinterpret_cast<const float4*>(partial), slot0, stride,
                                   count, n4, c, cw, kThreads / cw, group_sum);
    if (threadIdx.x < cw && c < n4) reinterpret_cast<float4*>(dst)[c] = sum;
  }
}

// Kernel 2 on `stream`: acc [p_rows, tile] from the partial tiles of nseg
// segments. chunk 0: one launch, one CTA a span. chunk > 0: the schedule,
// chunk and chunk-sum passes, with `sched` for the schedule; the split
// spans' chunk sums overwrite tiles of `partial` once they are read.
inline cudaError_t launch_span_reduce(const int* runs, float* partial, float* acc, int* sched,
                                      int nseg, int p_rows, int seg, int tile, int chunk,
                                      cudaStream_t stream) {
  if (p_rows <= 0) return cudaSuccess;
  if (chunk < 0 || (chunk > 0 && sched == nullptr)) return cudaErrorInvalidValue;
  const unsigned cols = (tile / 4 + kThreads - 1) / kThreads;  // column blocks
  if (chunk == 0) {
    span_reduce_kernel<kReduceChunks><<<dim3(p_rows, cols), kThreads, 0, stream>>>(
        runs, partial, acc, sched, p_rows, seg, tile, 0);
    return cudaGetLastError();
  }
  span_reduce_kernel<kReduceSchedule><<<1, kThreads, 0, stream>>>(runs, partial, acc, sched,
                                                                  p_rows, seg, tile, chunk);
  const dim3 chunks(static_cast<unsigned>(reduce_chunks(nseg, p_rows, chunk)), cols);
  span_reduce_kernel<kReduceChunks><<<chunks, kThreads, 0, stream>>>(runs, partial, acc, sched,
                                                                    p_rows, seg, tile, chunk);
  const long long splits = reduce_splits(nseg, p_rows, chunk);
  if (splits > 0) {
    span_reduce_kernel<kReduceChunkSums><<<dim3(static_cast<unsigned>(splits), cols), kThreads,
                                           0, stream>>>(runs, partial, acc, sched, p_rows, seg,
                                                        tile, chunk);
  }
  return cudaGetLastError();
}

// rows of T per chunk of the NT product, or columns per chunk of the
// forward product: whole 8-wide groups within kChunkFloats
inline int chunk_of(int width, int other) {
  return std::min(width, std::max(8, kChunkFloats / other / 8 * 8));
}

// Which path kernel 1 takes for these widths (after the fold): 2 tensor
// cores, 1 narrow, 0 CUDA cores, -1 none (the widths do not stage).
enum SpanPath {
  kPathNone = -1,
  kPathCuda = 0,
  kPathNarrow = 1,
  kPathTc = 2,
  kPathTcNarrow = 3
};

inline SpanPath span_path(bool in_bf16, bool rows_out, int seg, int nb, int kx, int ky) {
  if (kx <= 0 || ky <= 0 || nb <= 0 || seg <= 0 || kx % 8 != 0) return kPathNone;
  if (in_bf16 && !rows_out && kx % 16 == 0 && ky % 16 == 0 &&
      (static_cast<long long>(seg) * nb) % 16 == 0 &&
      tc_smem_bytes(seg, nb, kx, ky) <= static_cast<size_t>(kMaxSmem)) {
    return kPathTc;
  }
  if (in_bf16 && (kx == 16 || kx == 32 || kx == 64) && (ky == 2 || ky == 4 || ky == 8) &&
      (static_cast<long long>(seg) * nb) % 16 == 0 &&
      tcn_smem_bytes(seg, nb, kx) <= static_cast<size_t>(kMaxSmem)) {
    return kPathTcNarrow;
  }
  if (ky <= 8 && kx <= 256) return kPathNarrow;
  if (ky % 8 == 0 && kx <= kMaxWidth && ky <= kMaxWidth) return kPathCuda;
  return kPathNone;
}

// The narrow tensor-core kernel for ky = 2, 4 or 8 (CPB = 2 * ky bytes).
template <typename Tz, bool kRowsOut, int KX>
cudaError_t launch_tcn(const SpanArgs<__nv_bfloat16, Tz>& a, int nseg, size_t smem,
                       cudaStream_t stream) {
  auto go = [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kern<<<nseg, kThreads, smem, stream>>>(a);
    return cudaSuccess;
  };
  return a.ky == 2   ? go(seg_span_tcn_kernel<Tz, kRowsOut, KX, 4>)
         : a.ky == 4 ? go(seg_span_tcn_kernel<Tz, kRowsOut, KX, 8>)
                     : go(seg_span_tcn_kernel<Tz, kRowsOut, KX, 16>);
}

// Kernel 1 on the chosen path, one CTA per segment, then kernel 2 in chunks
// of `chunk` tiles (0: one a span). mm folds the block-diagonal table (mm =
// 1: the slab as it is). `partial` holds nseg + p_rows tiles, `sched` the
// span reduce's schedule. Returns a cudaError_t as int.
template <typename Tin, typename Tz, bool kRowsOut>
int launch(const int* runs, const int* first, const int* cnt, const void* x,
           const void* y, const void* table, void* z, void* rows_out,
           float* partial, float* acc, int* sched, int nseg, int seg, int blocks,
           int bw_x, int bw_y, int mm, int p_rows, int chunk, cudaStream_t stream) {
  if (mm <= 0 || bw_x % mm != 0 || bw_y % mm != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SpanArgs<Tin, Tz> a{runs, first, cnt, static_cast<const Tin*>(x),
                      static_cast<const Tin*>(y), static_cast<const Tin*>(table),
                      static_cast<Tz*>(z), static_cast<Tin*>(rows_out), partial,
                      seg, blocks * mm, bw_x / mm, bw_y / mm, bw_y, bw_x * bw_y,
                      p_rows};
  constexpr bool kBf16 = sizeof(Tin) == 2;
  const SpanPath path = span_path(kBf16, kRowsOut, seg, a.nb, a.kx, a.ky);
  if (path == kPathNone) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (nseg > 0) {
    if (path == kPathTc) {
      if constexpr (kBf16 && !kRowsOut) {
        const size_t smem = tc_smem_bytes(seg, a.nb, a.kx, a.ky);
        auto kern = seg_span_tc_kernel<Tz, ZToDevice<Tz>>;
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        kern<<<nseg, kThreads, smem, stream>>>(a, typename ZToDevice<Tz>::Args{});
      }
    } else if (path == kPathTcNarrow) {
      if constexpr (kBf16) {
        const size_t smem = tcn_smem_bytes(seg, a.nb, a.kx);
        err = a.kx == 16   ? launch_tcn<Tz, kRowsOut, 16>(a, nseg, smem, stream)
              : a.kx == 32 ? launch_tcn<Tz, kRowsOut, 32>(a, nseg, smem, stream)
                           : launch_tcn<Tz, kRowsOut, 64>(a, nseg, smem, stream);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    } else if (path == kPathNarrow) {
      const int lg = narrow_lanes_log2(a.kx);
      const int ky_max = a.ky <= 1 ? 1 : a.ky <= 2 ? 2 : a.ky <= 4 ? 4 : 8;
      const int chunk = narrow_chunk_rows(seg, a.nb, a.kx, a.ky, sizeof(Tin));
      const size_t smem = narrow_smem_bytes(chunk, a.nb, a.kx, a.ky, ky_max, sizeof(Tin));
      auto go = [&](auto kern) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return e;
        kern<<<nseg, kThreads, smem, stream>>>(a, lg, chunk);
        return cudaSuccess;
      };
      err = ky_max == 1   ? go(seg_span_narrow_kernel<Tin, Tz, kRowsOut, 1>)
            : ky_max == 2 ? go(seg_span_narrow_kernel<Tin, Tz, kRowsOut, 2>)
            : ky_max == 4 ? go(seg_span_narrow_kernel<Tin, Tz, kRowsOut, 4>)
                          : go(seg_span_narrow_kernel<Tin, Tz, kRowsOut, 8>);
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      const size_t smem = (kChunkFloats + kRedFloats) * sizeof(float);
      auto kern = seg_span_grad_kernel<Tin, Tz, kRowsOut>;
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      kern<<<nseg, kThreads, smem, stream>>>(a, chunk_of(a.kx, a.ky), chunk_of(a.ky, a.kx));
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_span_reduce(runs, partial, acc, sched, nseg, p_rows, seg,
                                             a.kx * a.ky, chunk, stream));
}

}  // namespace fbtt_span
