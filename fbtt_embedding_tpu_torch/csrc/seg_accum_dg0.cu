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
// first-core row (the sentinel tp0 for dead and padded lookups). Rows of
// the sentinel span (j >= p_rows) and rows whose i0c is not in [0, tp0)
// add nothing to dG0; each is checked on its own. dz0 never reaches device
// memory.
//
// Bound: memory. x, y, i0c, the live G1 slabs read once, acc and dG0
// written once: ~18.7 MB at the headline i1 shape (x [10240, 128], y
// [10240, 512] bf16, acc [220, 32, 128], dG0 [200, 128]), ~5.6 us at
// 3.35 TB/s: B3's bound less its float32 dz0 write. The pass does ~0.67
// GFLOP, ~36 FLOP per byte, above the CUDA cores' ridge (~20 at 67
// TFLOP/s): in bf16 only the tensor cores can come near the byte bound.
//
// Design. On the TPU one sequential grid adds every segment's one-hot
// product into a [tp0, x_w] VMEM accumulator. Here segments run at once,
// and dG0 rows are keyed by i0 while the segments are sorted by i1; float
// atomics would make dG0 depend on the schedule. So:
//   kernel 1 (one CTA per 64-row segment) computes the segment's acc
//     partial tiles and dz0 rows, keeping dz0 in shared memory. Then the
//     CTA orders its rows by (i0, row), sums the dz0 rows of each distinct
//     i0 in row order, and writes one float32 partial row per distinct i0
//     at slot seg_index*seg + k, with its key (keys ascending, unused slots
//     INT_MAX).
//   kernel 2 is B3's per-span reduction of the acc tiles (seg_span.cuh).
//   kernel 3 (one CTA per dG0 row) finds that row's partial in each
//     segment by binary search in the segment's sorted keys and adds the
//     partials in a fixed order (thread groups over ranges of segments,
//     then the groups in order).
// Every sum has a fixed order: bitwise repeatable, like B2, B3 and B5.
//
// Kernel 1 takes one of three paths (dg0_path below):
//   - tensor cores, dz0 over y (bf16, bw_x and bw_y multiples of 16, bw_x
//     <= 64 and a float32 dz0 item row no wider than a padded bf16 y row:
//     2*bw_x <= bw_y + 8): B3's tensor-core kernel (seg_span_tc_kernel)
//     with the ZKeyed epilogue. The acc product of a span runs first; after
//     a barrier the z product writes each item's dz0 over that item's own
//     y row, which nothing reads again: the next span's edge tiles read
//     those rows only for outputs they drop (z) or mask to +0 (acc). The
//     CTA's shared memory stays B3's (107.5 KB at the headline, two CTAs
//     an SM).
//   - tensor cores, dz0 tile (the other bf16 widths the tensor-core kernel
//     takes): the same with dz0 in a float32 tile of its own after the
//     slabs (one CTA an SM at the headline widths).
//   - CUDA cores (float32, and widths neither takes): B3's CUDA-core span
//     walk (rows_times_slab, span_outer) with the dz0 tile, seg * x_w
//     floats, within 128 KB (x_w = blocks*bw_x <= 512 at seg 64).
// Kernel 3 takes x_w <= 4 * kThreads.

#include <climits>
#include <initializer_list>

#include "seg_span.cuh"

namespace {

using namespace fbtt_span;

constexpr int kNoKey = INT_MAX;               // unused partial slot / dropped row
constexpr int kHitChunk = 2048;               // segments searched per pass of kernel 3
constexpr int kMaxZTile = 128 * 1024;         // the CUDA-core path's dz0 tile, bytes
constexpr int kInPlacePasses = 2;             // bw_x <= 64 for dz0 over y

enum Dg0Path { kDg0None = -1, kDg0Cuda = 0, kDg0TcTile = 1, kDg0TcInPlace = 2 };

// ints of kernel 1's key arrays: key, order, ks and head [seg] each, and
// 2 * kWarps counts (keyed_partials)
inline size_t key_bytes(int seg) {
  return (4 * static_cast<size_t>(seg) + 2 * kWarps) * sizeof(int);
}

// The float32 dz0 tile of the tensor-core path, padded by 8 floats a row
// so that the epilogue's float2 stores of 8 rows fall in distinct banks.
inline size_t ztile_bytes(int seg, int blocks, int bw_x) {
  return static_cast<size_t>(seg) * blocks * (bw_x + 8) * sizeof(float);
}

inline size_t cuda_smem_bytes(int seg, int blocks, int bw_x, int bw_y) {
  const size_t kc = chunk_of(bw_x, bw_y);
  return (kc * bw_y + kRedFloats + static_cast<size_t>(seg) * blocks * bw_x) * sizeof(float) +
         key_bytes(seg);
}

// Whether kernel 1's `path` takes these widths.
inline bool dg0_takes(int path, bool in_bf16, int seg, int blocks, int bw_x, int bw_y) {
  if (seg <= 0 || blocks <= 0 || bw_x <= 0 || bw_y <= 0 || bw_x % 8 != 0 || bw_y % 8 != 0 ||
      bw_x > kMaxWidth || bw_y > kMaxWidth ||
      static_cast<long long>(blocks) * bw_x > 4LL * kThreads) {
    return false;
  }
  const size_t smem_max = static_cast<size_t>(kMaxSmem);
  if (path == kDg0Cuda) {
    return static_cast<long long>(seg) * blocks * bw_x * 4 <= kMaxZTile &&
           cuda_smem_bytes(seg, blocks, bw_x, bw_y) <= smem_max;
  }
  if (path != kDg0TcTile && path != kDg0TcInPlace) return false;
  if (!in_bf16 || bw_x % 16 != 0 || bw_y % 16 != 0 ||
      (static_cast<long long>(seg) * blocks) % 16 != 0) {
    return false;
  }
  const size_t tc = tc_smem_bytes(seg, blocks, bw_x, bw_y) + key_bytes(seg);
  if (path == kDg0TcInPlace) {
    return bw_x <= 32 * kInPlacePasses && 2 * bw_x <= bw_y + kTcPad && tc <= smem_max;
  }
  return tc + ztile_bytes(seg, blocks, bw_x) <= smem_max;
}

// The path kernel 1 takes: dz0 over y, else the dz0 tile, else the CUDA
// cores, else none.
inline int dg0_path(bool in_bf16, int seg, int blocks, int bw_x, int bw_y) {
  for (int path : {kDg0TcInPlace, kDg0TcTile, kDg0Cuda}) {
    if (dg0_takes(path, in_bf16, seg, blocks, bw_x, bw_y)) return path;
  }
  return kDg0None;
}

// key[r] for the segment's rows: i0c where the row lies before the
// sentinel span and i0c is in [0, tp0), else kNoKey.
__device__ void load_keys(int* key, const int* __restrict__ runs,
                          const int* __restrict__ i0c, int p_rows, int tp0, int base,
                          int seg) {
  const int live_end = runs[p_rows];  // the sentinel span's first row
  for (int r = threadIdx.x; r < seg; r += kThreads) {
    const int row = base + r;
    const int k = i0c[row];
    key[r] = (row < live_end && k >= 0 && k < tp0) ? k : kNoKey;
  }
}

// The segment's keyed partial rows. ints holds key[seg] (written, and
// visible to the CTA), then order[seg], ks[seg], head[seg] and
// 2 * kWarps counts; dz0 of item (row r, block b) lies at zf + (r*nb + b)
// * zstride, kx floats. Orders the rows by (key, row) by counting ranks
// (tpr neighbouring threads a row), numbers the distinct keys by warp
// ballots, then writes one partial row per distinct key (its rows' dz0
// added in row order) and the keys.
__device__ void keyed_partials(const float* zf, int zstride, int nb, int kx, int* ints,
                               int seg, int base, float* __restrict__ dg0_part,
                               int* __restrict__ dg0_key) {
  const int* key = ints;
  int* order = ints + seg;  // rows in (key, row) order
  int* ks = order + seg;    // their keys
  int* head = ks + seg;     // first position of each distinct key
  int* wsum = head + seg;   // [kWarps][2]: heads and kept rows per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int tpr = 1;
  while (tpr < 32 && seg * tpr * 2 <= kThreads) tpr *= 2;
  for (int t0 = 0; t0 < seg * tpr; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int r = t / tpr;
    const int part = t - r * tpr;
    const bool on = r < seg;
    const int kr = on ? key[r] : 0;
    int rank = 0;
    if (on) {
      for (int q = part; q < seg; q += tpr) {
        const int kq = key[q];
        rank += (kq < kr) || (kq == kr && q < r);
      }
    }
    for (int o = tpr >> 1; o > 0; o >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, o);
    if (on && part == 0) {
      order[rank] = r;
      ks[rank] = kr;
    }
  }
  __syncthreads();
  int nd = 0, n_kept = 0;  // CTA-uniform
  for (int i0 = 0; i0 < seg; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const int ki = i < seg ? ks[i] : kNoKey;
    const bool kept = ki != kNoKey;
    const bool first = kept && (i == 0 || ks[i - 1] != ki);
    const unsigned fm = __ballot_sync(0xffffffffu, first);
    const unsigned km = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) {
      wsum[2 * warp] = __popc(fm);
      wsum[2 * warp + 1] = __popc(km);
    }
    __syncthreads();
    int before = nd;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wsum[2 * w] : 0;
      nd += wsum[2 * w];
      n_kept += wsum[2 * w + 1];
    }
    if (first) head[before + __popc(fm & ((1u << lane) - 1u))] = i;
    __syncthreads();  // wsum is read; head is written
  }
  for (int k = threadIdx.x; k < seg; k += kThreads) {
    dg0_key[base + k] = k < nd ? ks[head[k]] : kNoKey;
  }
  const int k4 = kx / 4;
  const int x4 = nb * k4;
  for (int e = threadIdx.x; e < nd * x4; e += kThreads) {
    const int k = e / x4;
    const int c = e - k * x4;
    const int b = c / k4;
    const int cc = (c - b * k4) * 4;
    const int end = k + 1 < nd ? head[k + 1] : n_kept;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = head[k]; i < end; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          zf + static_cast<size_t>(order[i] * nb + b) * zstride + cc);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    reinterpret_cast<float4*>(dg0_part + static_cast<size_t>(base + k) * nb * kx)[c] = sum;
  }
}

// What the B6 epilogue needs beyond SpanArgs.
struct KeyedArgs {
  const int* i0c;
  float* dg0_part;
  int* dg0_key;
  int tp0;
};

// The tensor-core kernel's B6 epilogue (seg_span.cuh): float32 dz0 kept in
// shared memory, over the items' own y rows (kInPlace) or in a tile after
// the slabs, then the keyed partial rows. Its key arrays follow the tile.
template <bool kOverY>
struct ZKeyed {
  static constexpr bool kInPlace = kOverY;
  static constexpr int kPasses = kOverY ? kInPlacePasses : 1;
  using Args = KeyedArgs;

  Args e;
  float* zf;
  int zstride;  // floats from one item's dz0 to the next
  int* ints;
  int nb, kx, seg, base;
  __device__ ZKeyed(const SpanArgs<__nv_bfloat16, float>& a, const Args& e_,
                    __nv_bfloat16* y_s, int ys, void* tail, int base_)
      : e(e_), nb(a.nb), kx(a.kx), seg(a.seg), base(base_) {
    float* tile = static_cast<float*>(tail);
    zf = kOverY ? reinterpret_cast<float*>(y_s) : tile;
    zstride = kOverY ? ys / 2 : a.kx + 8;
    ints = reinterpret_cast<int*>(
        kOverY ? tile : tile + static_cast<size_t>(a.seg) * a.nb * zstride);
  }
  __device__ void begin(const SpanArgs<__nv_bfloat16, float>& a, int) const {
    load_keys(ints, a.runs, e.i0c, a.p_rows, e.tp0, base, seg);
  }
  __device__ void store(int it, int col, float v0, float v1) const {
    *reinterpret_cast<float2*>(zf + static_cast<size_t>(it) * zstride + col) =
        make_float2(v0, v1);
  }
  __device__ void finish() const {
    keyed_partials(zf, zstride, nb, kx, ints, seg, base, e.dg0_part, e.dg0_key);
  }
};

// Kernel 1, CUDA-core path: B3's CUDA-core span walk with z into the
// shared dz0 tile [seg, x_w] (rows base .. base + seg).
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
  int* ints = reinterpret_cast<int*>(zs + static_cast<size_t>(seg) * x_w);
  const int s = blockIdx.x;
  const int base = s * seg;
  const int j0 = first[s];
  const int nspan = cnt[s];
  load_keys(ints, runs, i0c, p_rows, tp0, base, seg);

  for (int k = 0; k < nspan; ++k) {
    const int j = j0 + k;
    // CTA-uniform branches only: every __syncthreads() is reached by all
    const int st = max(runs[j], base);
    const int en = min(runs[j + 1], base + seg);
    if (en <= st || j >= p_rows) continue;  // the sentinel span: no key
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
  __syncthreads();  // the keys and the dz0 tile are written
  keyed_partials(zs, bw_x, blocks, bw_x, ints, seg, base, dg0_part, dg0_key);
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

template <bool kOverY>
cudaError_t launch_tc(const SpanArgs<__nv_bfloat16, float>& a, const KeyedArgs& e, int nseg,
                      cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(a.seg, a.nb, a.kx, a.ky) + key_bytes(a.seg) +
                      (kOverY ? 0 : ztile_bytes(a.seg, a.nb, a.kx));
  auto kern = seg_span_tc_kernel<float, ZKeyed<kOverY>>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<nseg, kThreads, smem, stream>>>(a, e);
  return cudaGetLastError();
}

template <typename Tin>
int launch_dg0(const int* runs, const int* first, const int* cnt, const void* x,
               const void* y, const int* i0c, const void* table, float* partial,
               float* acc, float* dg0_part, int* dg0_key, float* dg0, int nseg, int seg,
               int blocks, int bw_x, int bw_y, int p_rows, int tp0, int path,
               cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(Tin) == 2;
  if (!dg0_takes(path, kBf16, seg, blocks, bw_x, bw_y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int x_w = blocks * bw_x;
  cudaError_t err = cudaSuccess;
  if (nseg > 0 && path == kDg0Cuda) {
    const int kc = chunk_of(bw_x, bw_y);
    const size_t smem = cuda_smem_bytes(seg, blocks, bw_x, bw_y);
    auto kern = seg_dg0_kernel<Tin>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<nseg, kThreads, smem, stream>>>(
        runs, first, cnt, static_cast<const Tin*>(x), static_cast<const Tin*>(y), i0c,
        static_cast<const Tin*>(table), partial, dg0_part, dg0_key, seg, blocks, bw_x,
        bw_y, p_rows, tp0, kc);
    err = cudaGetLastError();
  } else if (nseg > 0) {
    if constexpr (kBf16) {
      using bf16 = __nv_bfloat16;
      const SpanArgs<bf16, float> a{runs, first, cnt, static_cast<const bf16*>(x),
                                    static_cast<const bf16*>(y),
                                    static_cast<const bf16*>(table), nullptr, nullptr,
                                    partial, seg, blocks, bw_x, bw_y, bw_y, bw_x * bw_y,
                                    p_rows};
      const KeyedArgs e{i0c, dg0_part, dg0_key, tp0};
      err = path == kDg0TcInPlace ? launch_tc<true>(a, e, nseg, stream)
                                  : launch_tc<false>(a, e, nseg, stream);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_span_reduce(runs, partial, acc, p_rows, seg, bw_x * bw_y, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tp0 > 0) {
    dg0_reduce_kernel<<<tp0, kThreads, 0, stream>>>(dg0_part, dg0_key, dg0, nseg, seg,
                                                     x_w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream`, kernel 1 on `path` (2 tensor
// cores with dz0 over y, 1 tensor cores with a dz0 tile, 0 CUDA cores:
// fbtt_seg_accum_dg0_path gives the one to take); returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue where `path` does not take the widths. in_bf16
// selects bfloat16 (1) or float32 (0) for x, y and table. Scratch:
// `partial` holds (nseg + p_rows) float tiles of bw_x * bw_y, `dg0_part`
// nseg*seg float rows of blocks*bw_x and `dg0_key` nseg*seg ints. Outputs:
// acc [p_rows, bw_x, bw_y] and dg0 [tp0, blocks*bw_x], both float32.
int fbtt_seg_accum_dg0(const int* runs, const int* first, const int* cnt, const void* x,
                       const void* y, const int* i0c, const void* table, float* partial,
                       float* acc, float* dg0_part, int* dg0_key, float* dg0, int nseg,
                       int seg, int blocks, int bw_x, int bw_y, int p_rows, int tp0,
                       int in_bf16, int path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch_dg0<__nv_bfloat16>(runs, first, cnt, x, y, i0c, table, partial, acc,
                                     dg0_part, dg0_key, dg0, nseg, seg, blocks, bw_x,
                                     bw_y, p_rows, tp0, path, st);
  }
  return launch_dg0<float>(runs, first, cnt, x, y, i0c, table, partial, acc, dg0_part,
                           dg0_key, dg0, nseg, seg, blocks, bw_x, bw_y, p_rows, tp0,
                           path, st);
}

// The path kernel 1 takes for these widths: 2 tensor cores with dz0 over
// y, 1 tensor cores with a dz0 tile, 0 CUDA cores, -1 none.
int fbtt_seg_accum_dg0_path(int in_bf16, int seg, int blocks, int bw_x, int bw_y) {
  return dg0_path(in_bf16 != 0, seg, blocks, bw_x, bw_y);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
