// Bag-order pool for Hopper (sm_90a): each bag's rows summed in lookup
// order, from the TT rows and the cache's rows at once.
//
// Replaces no Pallas kernel. The JAX package pools on the TPU's matrix unit
// (fbtt_embedding_tpu/ops/pallas/tt_flat.py :: _pool_flat and
// models/tt_embedding.py :: _pool_cached_rows): a [T*B, nnz] one-hot
// product up to 4096 bags, segment_sum above. On this card the one-hot
// product is a float32 GEMM of T*B * nnz * D multiply-adds (43 GFLOP at
// 4096 bags of 20) over a mask of T*B * nnz floats, and segment_sum sorts
// every lookup's bag id again, although both walk lookups that arrive
// grouped by bag. For every bag b, with its lookups j in lookup order:
//
//     out[b] = sum_j  w_j * scale[loc_j] * cache[loc_j]   where loc_j >= 0
//                   | round(w_j) * rows[slot_j]           where slot_j < live
//                   | nothing                             otherwise
//
// rows (bfloat16 or float32) are the flat pipeline's last pass in its last
// sort space, slot_j the position of lookup j there (absent: rows are per
// lookup, slot_j = j); a lookup whose slot lies at or past `live` (the
// plan's dead and pad span) adds nothing. cache (float32, or int8 with its
// per-row float32 scale) holds the cache-served rows. w_j is 1 where no
// weights are given; round() rounds to bfloat16 where round_w is set (the
// one-hot product's weights, kept for its numbers). out is float32.
//
// Bag boundaries come from `bag`, each lookup's bag id, in any order; ids
// outside [0, T*B) are dropped, as segment_sum drops them. Ids that never
// decrease (CSR offsets, table-major, as rowidx_from_offsets gives them)
// take the fast route: a first kernel finds start[b] = the first lookup
// whose id is b or more by a binary search, ids below 0 counting before
// bag 0 and ids of T*B or more after the last bag, and raises a flag where
// an id falls below the one before it. Only then does a second kernel
// group the lookups by bag in lookup order (a stable counting sort:
// `order`, and the starts again); on sorted ids it reads the flag and
// exits. Either way each bag sums its lookups in lookup order, so the
// output does not depend on the route, and the grouping's cost falls on
// out-of-order ids alone (each block of 512 bags reads every id twice).
//
// Bound and design. The pool moves each pooled row once: at 4096 bags of
// 20 lookups with half of them cached, ~38k bf16 rows of 128 B and ~44k
// float32 rows of 256 B, ~18 MB in all (~5.4 us at 3.35 TB/s); at 65536
// bags of 20, 1.31M bf16 rows, ~195 MB with the slots and ids (~58 us).
// No arithmetic to speak of: the bound is bytes, read at rows scattered
// over the last sort space. Eight lanes take one bag and 64 columns (a
// second grid dimension takes wider rows), eight columns a lane, so one
// load of a lane is 16 B of a bf16 row and a warp pools four bags at
// once; the eight lanes load eight lookups' slot, cache row and weight at
// once, coalesced, and broadcast them by shuffles; four lookups' rows are
// loaded before their multiply-adds. Bags longer than eight lookups loop.
// Sums run in lookup order in registers: no atomics, bitwise repeatable,
// each bag written once. On the H100 (700 W) this layout pooled the
// training shape in ~85 us of device time and the serve shape in ~10.5;
// one warp a bag with two columns a lane took 184 and 8.0, and more rows in
// flight a warp (more registers, fewer warps) was slower still.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 8;    // lanes of one bag
constexpr int kCols = 8;     // columns of one lane
constexpr int kBlockCols = kLanes * kCols;  // columns of one bag's lanes
constexpr int kBags = 32 / kLanes;          // bags of a warp
constexpr int kWarps = 4;    // warps of a block
constexpr int kUnroll = 4;   // lookups whose rows load before their sums
constexpr int kGroupWarps = 16;   // warps of a grouping block: runs of lookups
constexpr int kGroupBags = kGroupWarps * 32;  // bags of a grouping block
constexpr int kGroupLoads = 8;    // ids of a lane loaded at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clamp_bag(int v, int tb) {
  return v < 0 ? -1 : (v > tb ? tb : v);
}

// start[b] for b in 0..tb, on ids that never decrease: the first lookup
// whose id is b or more, by a binary search (thread b); and start[tb + 1]
// (zeroed before) = 1 where an id falls below the one before it (thread
// j), which voids the starts: bag_group_kernel writes them then. Bounded
// work on any ids: (tb + 1) searches and n comparisons.
__global__ void bag_starts_kernel(const int* __restrict__ bag, int n, int tb,
                                  int* __restrict__ start) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t + 1 < n && clamp_bag(bag[t], tb) > clamp_bag(bag[t + 1], tb)) start[tb + 1] = 1;
  if (t > tb) return;
  int a = 0, z = n;
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (clamp_bag(bag[mid], tb) < t) a = mid + 1;
    else z = mid;
  }
  start[t] = a;
}

// Out-of-order ids only (start[tb + 1] set; else it exits at once): block
// g takes bags [lo, lo + kGroupBags), and its warps the lookups in
// kGroupWarps runs, one each, in lookup order. Each warp counts its run's
// lookups of the block's bags (shared-memory histogram, a row a warp) and
// the kept lookups of lower bags; one thread a bag then sums its row of
// counts, the block scans the sums into the bags' starts, and each warp's
// count turns into its cursor (the bag's start plus the lookups of
// earlier runs). Each warp then walks its run again and places each of
// its lookups at its bag's cursor (lanes of one bag ranked by lane):
// order[start[b]..start[b + 1]) = bag b's lookups, rising, so the pool
// sums them in lookup order as on sorted ids.
__global__ void __launch_bounds__(kGroupWarps * 32)
    bag_group_kernel(const int* __restrict__ bag, int n, int tb, int* __restrict__ start,
                     int* __restrict__ order) {
  if (start[tb + 1] == 0) return;
  __shared__ int cur[kGroupWarps][kGroupBags];
  __shared__ int part[kGroupWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = blockIdx.x * kGroupBags, m = min(kGroupBags, tb - lo);
  for (int k = threadIdx.x; k < kGroupWarps * kGroupBags; k += blockDim.x) {
    cur[k / kGroupBags][k % kGroupBags] = 0;
  }
  __syncthreads();
  const int run = (n + kGroupWarps - 1) / kGroupWarps;
  const int j_begin = min(warp * run, n), j_end = min(j_begin + run, n);
  int below = 0;
  for (int j0 = j_begin; j0 < j_end; j0 += 32 * kGroupLoads) {
    int b[kGroupLoads];
#pragma unroll
    for (int u = 0; u < kGroupLoads; ++u) {
      const int j = j0 + u * 32 + lane;
      b[u] = j < j_end ? bag[j] : -1;
    }
#pragma unroll
    for (int u = 0; u < kGroupLoads; ++u) {
      if (b[u] >= 0 && b[u] < lo) ++below;
      else if (b[u] >= lo && b[u] < lo + m) atomicAdd(&cur[warp][b[u] - lo], 1);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);
  if (lane == 0) part[warp] = below;
  __syncthreads();
  below = 0;
#pragma unroll
  for (int w = 0; w < kGroupWarps; ++w) below += part[w];
  __syncthreads();
  // thread k: bag lo + k's lookups, the block's exclusive scan of them
  const int k = threadIdx.x;
  int total = 0;
  if (k < m) {
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) total += cur[w][k];
  }
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int base = below;
  for (int w = 0; w < warp; ++w) base += part[w];
  if (k < m) {
    int c = base + incl - total;
    start[lo + k] = c;
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) {
      const int cnt = cur[w][k];
      cur[w][k] = c;
      c += cnt;
    }
  }
  if (lo + m == tb && k == kGroupWarps * 32 - 1) start[tb] = base + incl;
  __syncthreads();
  const unsigned lower = (1u << lane) - 1;
  for (int j0 = j_begin; j0 < j_end; j0 += 32 * kGroupLoads) {
    int b[kGroupLoads];
#pragma unroll
    for (int u = 0; u < kGroupLoads; ++u) {
      const int j = j0 + u * 32 + lane;
      b[u] = j < j_end ? bag[j] : -1;
    }
#pragma unroll
    for (int u = 0; u < kGroupLoads; ++u) {
      const bool mine = b[u] >= lo && b[u] < lo + m;
      if (__ballot_sync(kFull, mine) == 0) continue;
      const unsigned same = __match_any_sync(kFull, mine ? b[u] : -1);
      const int pos = mine ? cur[warp][b[u] - lo] + __popc(same & lower) : 0;
      __syncwarp();
      if (mine) {
        order[pos] = j0 + u * 32 + lane;
        if ((same & lower) == 0) cur[warp][b[u] - lo] = pos + __popc(same);
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

// Eight adjacent columns; p is 16-byte aligned (8-byte for int8).
__device__ __forceinline__ void load8(const float* p, float (&v)[kCols]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kCols]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&v)[kCols]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < kCols; ++i) v[i] = static_cast<float>(c[i]);
}

// Lane column i: c + i (kVec: eight adjacent columns, one vector load) or
// c + i * kLanes (any width and alignment); zero past d.
template <bool kVec>
__device__ __forceinline__ int col(int c, int i) {
  return kVec ? c + i : c + i * kLanes;
}
template <bool kVec, typename T>
__device__ __forceinline__ void load_cols(const T* row, int c, int d, float (&v)[kCols]) {
  if (kVec) {
    if (c < d) load8(row + c, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (col<kVec>(c, i) < d) v[i] = to_f(row[col<kVec>(c, i)]);
  }
}

enum Source { kNone = 0, kRows = 1, kCache = 2 };

template <typename RowT, typename CacheT, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    bag_pool_kernel(const int* __restrict__ start, const int* __restrict__ order, int tb,
                    int d, const RowT* __restrict__ rows, const int* __restrict__ slot,
                    const int* __restrict__ live, const float* __restrict__ w, int round_w,
                    const CacheT* __restrict__ cache, const int* __restrict__ loc,
                    const float* __restrict__ scale, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;  // the lane's place among its bag's lanes
  const int b = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kBags + lane / kLanes;
  const int c = blockIdx.y * kBlockCols + (kVec ? sub * kCols : sub);
  const int s = b < tb ? start[b] : 0, e = b < tb ? start[b + 1] : 0;
  const bool grouped = start[tb + 1] != 0;  // positions index `order`
  const int n_live = live != nullptr ? *live : INT_MAX;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  // the warp's longest bag bounds its loop: every lane takes part in the
  // shuffles
  int len = e - s;
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) len = max(len, __shfl_xor_sync(kFull, len, o));
  for (int base = 0; base < len; base += kLanes) {
    // this lane's lookup: where its row comes from, which row, its factor
    const int p = s + base + sub;
    int src = kNone, row = 0;
    float f = 0.f;
    if (p < e) {
      const int j = grouped ? order[p] : p;
      const float wj = w != nullptr ? w[j] : 1.f;
      const int l = loc != nullptr ? loc[j] : -1;
      if (l >= 0) {
        src = kCache;
        row = l;
        f = scale != nullptr ? scale[l] * wj : wj;
      } else if (rows != nullptr) {
        const int sl = slot != nullptr ? slot[j] : j;
        if (sl < n_live) {
          src = kRows;
          row = sl;
          f = round_w ? __bfloat162float(__float2bfloat16_rn(wj)) : wj;
        }
      }
    }
    const int cnt = min(kLanes, len - base);
    for (int k0 = 0; k0 < cnt; k0 += kUnroll) {
      int sk[kUnroll];
      float fk[kUnroll];
      float v[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // k0 + u < kLanes; lanes past their bag's end hold src kNone
        sk[u] = __shfl_sync(kFull, src, k0 + u, kLanes);
        const int rk = __shfl_sync(kFull, row, k0 + u, kLanes);
        fk[u] = __shfl_sync(kFull, f, k0 + u, kLanes);
#pragma unroll
        for (int i = 0; i < kCols; ++i) v[u][i] = 0.f;
        if (sk[u] == kRows) {
          load_cols<kVec>(rows + static_cast<size_t>(rk) * d, c, d, v[u]);
        } else if (sk[u] == kCache) {
          load_cols<kVec>(cache + static_cast<size_t>(rk) * d, c, d, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (sk[u] != kNone) {
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[i] = fmaf(fk[u], v[u][i], acc[i]);
        }
      }
    }
  }
  if (b >= tb) return;
  float* o = out + static_cast<size_t>(b) * d;
  if (kVec) {
    if (c < d) {
      *reinterpret_cast<float4*>(o + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(o + c + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (col<kVec>(c, i) < d) o[col<kVec>(c, i)] = acc[i];
  }
}

template <typename RowT, typename CacheT, bool kVec>
int launch(const int* bag, int n, int tb, int d, int* start, int* order, const void* rows,
           const int* slot, const int* live, const float* w, int round_w, const void* cache,
           const int* loc, const float* scale, float* out, cudaStream_t st) {
  const int threads = 256;
  cudaMemsetAsync(start + tb + 1, 0, sizeof(int), st);
  const int starts_threads = n > tb ? n : tb + 1;
  bag_starts_kernel<<<(starts_threads + threads - 1) / threads, threads, 0, st>>>(bag, n, tb,
                                                                               start);
  bag_group_kernel<<<(tb + kGroupBags - 1) / kGroupBags, kGroupWarps * 32, 0, st>>>(
      bag, n, tb, start, order);
  const dim3 grid((tb + kWarps * kBags - 1) / (kWarps * kBags),
                  (d + kBlockCols - 1) / kBlockCols);
  bag_pool_kernel<RowT, CacheT, kVec><<<grid, kWarps * 32, 0, st>>>(
      start, order, tb, d, static_cast<const RowT*>(rows), slot, live, w, round_w,
      static_cast<const CacheT*>(cache), loc, scale, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename RowT, typename CacheT>
int launch_cols(int vec, const int* bag, int n, int tb, int d, int* start,
                int* order, const void* rows, const int* slot, const int* live, const float* w,
                int round_w, const void* cache, const int* loc, const float* scale,
                float* out, cudaStream_t st) {
  return vec ? launch<RowT, CacheT, true>(bag, n, tb, d, start, order, rows, slot, live, w,
                                          round_w, cache, loc, scale, out, st)
             : launch<RowT, CacheT, false>(bag, n, tb, d, start, order, rows, slot, live, w,
                                           round_w, cache, loc, scale, out, st);
}

template <typename RowT>
int launch_cache(int cache_int8, int vec, const int* bag, int n, int tb, int d,
                 int* start, int* order, const void* rows, const int* slot, const int* live,
                 const float* w, int round_w, const void* cache, const int* loc,
                 const float* scale, float* out, cudaStream_t st) {
  return cache_int8 ? launch_cols<RowT, int8_t>(vec, bag, n, tb, d, start, order, rows, slot,
                                                live, w, round_w, cache, loc, scale, out, st)
                    : launch_cols<RowT, float>(vec, bag, n, tb, d, start, order, rows, slot,
                                               live, w, round_w, cache, loc, scale, out, st);
}

}  // namespace

extern "C" {

// Queues a flag's reset and the three kernels on `stream`; returns
// cudaGetLastError() after the launches (0 on success). bag [n] int32, any
// order; start [tb + 2] and order [n] int32 scratch; out [tb, d] float32.
// rows [*, d] (rows_bf16: bfloat16, else float32) or null, with slot [n]
// int32 or null (rows[j]) and live (one int32 on the device) or null
// (every slot live); w [n] float32 or null (1); cache [*, d] (cache_int8:
// int8, else float32) or null, with loc [n] int32 (-1: not cached) and
// scale [*] float32 or null. vec: d is a multiple of 8 and rows, cache and
// out are 16-byte aligned.
int fbtt_bag_pool(const int* bag, int n, int tb, int d, int* start, int* order,
                  const void* rows, int rows_bf16, const int* slot, const int* live, const float* w,
                  int round_w, const void* cache, int cache_int8, const int* loc,
                  const float* scale, float* out, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tb <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  return rows_bf16
             ? launch_cache<__nv_bfloat16>(cache_int8, vec, bag, n, tb, d, start, order, rows,
                                           slot, live, w, round_w, cache, loc, scale, out, st)
             : launch_cache<float>(cache_int8, vec, bag, n, tb, d, start, order, rows, slot,
                                   live, w, round_w, cache, loc, scale, out, st);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
