// Sorted-run segment transform for Hopper (sm_90a): kernel B1.
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
// p_rows get exact zeros. Accumulation is float32 and each output is
// rounded once. One CTA and one warp own each output element, summed in a
// fixed order: no sums across CTAs, bitwise repeatable.
//
// The block-diagonal fold (mm). Past the first core the table is
// kron(I_mm, G[j]) with G[j] its first diagonal block [bw_in/mm,
// bw_out/mm]. The tensor-core kernel then runs on nb = blocks*mm sub-blocks
// of widths kx = bw_in/mm and ky = bw_out/mm and reads only G[j] (row
// stride bw_out, slab stride bw_in*bw_out): 1/mm of the dense
// multiply-adds, none of them with the off-diagonal zeros.
//
// Where it runs: the first-core pass of every flat training step and
// serve (x [nza, 4*32] -> y [nza, 4*128] at the headline shape) and the
// last-core pass of every serve (x [nza, 4*128] -> y [nza, 4*16], folded
// by 4: 16 sub-blocks of 32 -> 4).
//
// Bound, on the H100: memory. At the headline serve (nza = 10240, bf16)
// the first-core pass moves ~13 MB (y is ~80% of it), ~4 us at 3.35 TB/s,
// and does 0.34 GFLOP: ~25 FLOP per byte, above the CUDA cores' ridge
// (~20 at 67 TFLOP/s), so the multiply-adds go to the tensor cores. The
// folded last-core pass moves ~12 MB (x) with 4 multiply-adds per input
// element: a stream that wants few instructions per byte.
//
// Paths (fbtt_seg_transform_path):
//  - tensor cores (bf16 x and table, kx a multiple of 16, ky a multiple of
//    8, or 2 or 4 padded to 16 columns of zeros: "narrow"). One CTA per
//    chunk of a `seg`-row segment of the sorted order (32 rows wide, 16
//    narrow: the headline passes have only 160 segments for 132 SMs). It
//    stages the chunk's x rows in shared memory once (cp.async, rows
//    padded by 16 bytes so the eight row addresses of an ldmatrix fall in
//    distinct banks) while one warp lists the live spans that meet the
//    chunk, then stages up to 4 (wide) or 8 (narrow) of their G[j] at once,
//    as bf16 as they lie (row-major, K down the rows): one wait and one
//    barrier per batch of spans, where a walk span by span would wait on
//    each slab's latency. y_j = X_j G[j] runs on mma.sync.m16n8k16 (bf16
//    in, float32 accumulate): A from ldmatrix on the staged x (M = the
//    span's items, row x sub-block), B from ldmatrix.trans on G[j]. The
//    warps take the batch's (m16 item tile, 64-column) units in one loop;
//    rows of a tile outside its span are masked at the store. y, the
//    dominant stream, leaves through a per-warp shared tile, rounded once,
//    in 16-byte pieces that cover whole 128-byte lines; at ky 2 or 4 each
//    item's few bytes are stored straight from the accumulators. On the
//    H100 the headline first-core pass reads ~2x its byte bound and the
//    folded last-core pass ~2.4x: about half of each is the x staging that
//    no compute overlaps (PERF.md).
//  - CUDA cores otherwise (float32, or widths the tensor cores do not
//    take), at fold 1 only: the kernel of the first port. Slab T[j] staged
//    in shared memory as float in column chunks of at most 48 KB, each
//    thread a 4-row x 8-column register tile of one lane-block.

#include "seg_span.cuh"

namespace {

using namespace fbtt_span;

// ---------------------------------------------------------------------------
// CUDA-core path (fold 1)

constexpr int kSlabFloats = 48 * 1024 / 4;

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
      zero_rows(y, st, nrows, out_w);
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

// at most 48 KB of float slab (no opt-in attribute needed), in whole
// 8-column groups
inline int cuda_chunk(int bw_in, int bw_out) {
  return std::min(bw_out, std::max(kCols, kSlabFloats / bw_in / kCols * kCols));
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 x and table; kx a multiple of 16; ky a multiple
// of 8, or 2 or 4 (kNarrow)

constexpr int kTrEpS = 72;  // row stride of a warp's y tile (elements)
constexpr int kTrMaxG = 8;  // G buffers: live spans of a chunk staged at once
// rows of a segment per CTA and G buffers, the fastest of 8-64 rows on the
// H100 at the headline passes: the wide pass 32 rows (two CTAs a segment)
// and 4 slabs, the narrow pass 16 rows and 8 slabs
constexpr int kTrRowsWide = 32, kTrGWide = 4, kTrRowsNarrow = 16;
// shared memory the dynamic part may take (the span list is static)
constexpr int kTrSmem = kMaxSmem - 1024;

struct TrArgs {
  const int* runs;
  const int* first;
  const int* cnt;
  const __nv_bfloat16* x;
  const __nv_bfloat16* table;
  void* y;
  int seg, nb, kx, ky, ts, tstride, p_rows, rows, ng;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Shared memory of one CTA staging `rows` rows of a segment and `ng` slabs:
// x items [round16(rows*nb)][kx + pad], G buffers [ng][kx][round16(ky) +
// pad] in bf16, and (ky a multiple of 8) a [16][kTrEpS] y tile per warp of
// `ysize`-byte elements.
inline size_t tr_smem_bytes(int rows, int ng, int kx, int nb, int ky, int ysize) {
  const size_t items = round16(rows * nb);
  return 2 * (items * (kx + kTcPad) +
              static_cast<size_t>(ng) * kx * (round16(ky) + kTcPad)) +
         (ky % 8 == 0 ? static_cast<size_t>(kWarps) * 16 * kTrEpS * ysize : 0);
}

// Rows of a segment one CTA takes (at most `want`, halved until one slab
// fits beside them; 0 where not even one row does) and the slabs it stages
// at once (up to `ng_want`, as many as fit).
struct TrShape {
  int rows, ng;
};
inline TrShape tr_shape(int want, int ng_want, int nb, int kx, int ky, int ysize) {
  TrShape t{want, ng_want};
  while (t.rows > 0 && tr_smem_bytes(t.rows, 1, kx, nb, ky, ysize) > kTrSmem) t.rows /= 2;
  while (t.ng > 1 && tr_smem_bytes(t.rows, t.ng, kx, nb, ky, ysize) > kTrSmem) --t.ng;
  return t;
}

// One CTA per `rows`-row chunk of a segment (grid: segments x chunks). It
// stages the chunk's x rows once, lists the live spans that meet the chunk
// (a warp reads 32 span starts at a time), stages up to ng of their slabs
// at once and deals all their (m16 tile, kTrN-column) units to the warps
// in one loop: one wait and one barrier per batch of spans, not per span.
template <typename Tout, bool kNarrow, int kTrN>
__global__ void __launch_bounds__(kThreads, 3)  // <= 80 registers: 3 CTAs an SM
seg_transform_tc_kernel(const TrArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ int sp_j[kTrMaxG], sp_lo[kTrMaxG], sp_hi[kTrMaxG], sp_u[kTrMaxG + 1];
  __shared__ int sp_n, sp_next;
  using bf16 = __nv_bfloat16;
  const int nb = a.nb, kx = a.kx, ky = a.ky;
  const int xs = kx + kTcPad;           // padded x row stride
  const int kyp = round16(ky);          // staged G columns, zeros past ky
  const int gs = kyp + kTcPad;          // padded G row stride
  const int n_nc = (kyp + kTrN - 1) / kTrN;
  bf16* x_s = reinterpret_cast<bf16*>(smem4);                               // [items][xs]
  bf16* g_s = x_s + static_cast<size_t>(round16(a.rows * nb)) * xs;        // [ng][kx][gs]
  Tout* ep = reinterpret_cast<Tout*>(g_s + static_cast<size_t>(a.ng) * kx * gs);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int base = blockIdx.x * a.seg;
  const int c0 = base + blockIdx.y * a.rows;       // this CTA's rows c0 .. c1
  const int c1 = min(c0 + a.rows, base + a.seg);
  const int j0 = a.first[blockIdx.x];
  const int nspan = a.cnt[blockIdx.x];
  const size_t gi0 = static_cast<size_t>(c0) * nb;  // the chunk's first item
  Tout* y = static_cast<Tout*>(a.y);

  // the chunk's x rows (contiguous in device memory), in flight while the
  // spans are listed
  {
    const bf16* xg = a.x + gi0 * kx;
    const int cx = kx / 8;
    const int n = (c1 - c0) * nb * cx;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int it = e / cx;
      cp_async16(x_s + it * xs + (e - it * cx) * 8, xg + static_cast<size_t>(e) * 8);
    }
  }
  // the padding columns of the G buffers are zeros; the copies never touch
  // them
  if (ky < kyp) {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < a.ng * kx * (kyp - ky); e += kThreads) {
      const int i = e / (kyp - ky);
      g_s[i * gs + ky + (e - i * (kyp - ky))] = zero;
    }
  }
  // rows of the sentinel spans (j >= p_rows, from runs[p_rows] on): zeros
  const int dead = max(a.runs[a.p_rows], c0);
  if (dead < c1) zero_rows(y, dead, c1 - dead, nb * ky);

  int kbeg = 0;  // the span walk resumes here
  for (bool first_batch = true;; first_batch = false) {
    // every branch below depends on CTA-uniform values only, so each
    // __syncthreads() is reached by all threads or by none
    if (warp == 0) {  // list up to ng live spans from kbeg on
      int n = 0, k = kbeg;
      while (k < nspan && n < a.ng) {
        const int kk = k + lane;
        const int j = j0 + kk;
        int lo = 0, hi = 0;
        bool past = false;
        if (kk < nspan) {
          const int r0 = a.runs[j];
          lo = max(r0, c0);
          hi = min(a.runs[j + 1], c1);
          past = r0 >= c1;
        }
        const bool lv = kk < nspan && j < a.p_rows && hi > lo;
        const unsigned m = __ballot_sync(0xffffffffu, lv);
        const int rank = __popc(m & ((1u << lane) - 1u));
        if (lv && n + rank < a.ng) {
          sp_j[n + rank] = j;
          sp_lo[n + rank] = (lo - c0) * nb;
          sp_hi[n + rank] = (hi - c0) * nb;
        }
        const int taken = min(__popc(m), a.ng - n);
        n += taken;
        if (taken < __popc(m)) {  // resume at the first live span not taken
          unsigned rest = m;
          for (int t = 0; t < taken; ++t) rest &= rest - 1u;
          k += __ffs(rest) - 1;
          break;
        }
        k = __ballot_sync(0xffffffffu, past) ? nspan : k + 32;
      }
      __syncwarp();
      if (lane == 0) {
        int u = 0;
        for (int i = 0; i < n; ++i) {
          sp_u[i] = u;
          u += (sp_hi[i] - (sp_lo[i] & ~15) + 15) / 16 * n_nc;
        }
        sp_u[n] = u;
        sp_n = n;
        sp_next = k;
      }
    }
    __syncthreads();
    const int n = sp_n;
    if (n == 0) {
      if (first_batch) cp_async_wait_all();  // x was staged for nothing
      break;
    }
    for (int i = 0; i < n; ++i) {  // the batch's slabs G[j], as they lie
      const bf16* tj = a.table + static_cast<size_t>(sp_j[i]) * a.tstride;
      bf16* dst = g_s + i * kx * gs;
      if (kNarrow) {
        for (int r = threadIdx.x; r < kx; r += kThreads) {
          if (ky == 4) cp_async_n<8>(dst + r * gs, tj + static_cast<size_t>(r) * a.ts);
          else cp_async_n<4>(dst + r * gs, tj + static_cast<size_t>(r) * a.ts);
        }
      } else {
        const int c8 = ky / 8;
        for (int e = threadIdx.x; e < kx * c8; e += kThreads) {
          const int r = e / c8;
          const int c = (e - r * c8) * 8;
          cp_async16(dst + r * gs + c, tj + static_cast<size_t>(r) * a.ts + c);
        }
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    const int units = sp_u[n];
    int i = 0;  // the span of unit u (u only grows)
    for (int u = warp; u < units; u += kWarps) {
      while (u >= sp_u[i + 1]) ++i;
      const int lo = sp_lo[i], hi = sp_hi[i];
      const int uu = u - sp_u[i];
      const int m0 = (lo & ~15) + (uu / n_nc) * 16;
      const int n0 = (uu % n_nc) * kTrN;
      const int npairs = min(kTrN / 16, (kyp - n0) / 16);
      const bf16* gb = g_s + i * kx * gs;
      float c[kTrN / 8][4];
#pragma unroll
      for (int q = 0; q < kTrN / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[q][e] = 0.f;
      for (int k0 = 0; k0 < kx; k0 += 16) {
        uint32_t af[4];  // X items m0.., columns k0..k0+15
        ldsm_x4(af, x_s + (m0 + (lane & 15)) * xs + k0 + (lane >> 4) * 8);
#pragma unroll
        for (int p = 0; p < kTrN / 16; ++p) {
          if (p < npairs) {
            uint32_t bf[4];  // G rows k0.., columns n0 + p*16 .. (two n8 tiles)
            ldsm_x4_t(bf, gb + (k0 + (lane & 15)) * gs + n0 + p * 16 + (lane >> 4) * 8);
            mma_bf16(c[2 * p], af, bf[0], bf[1]);
            if (n0 + p * 16 + 8 < ky) mma_bf16(c[2 * p + 1], af, bf[2], bf[3]);
          }
        }
      }
      if (kNarrow) {
        // ky 2 or 4: each item's ky values straight from the accumulators
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int it = m0 + g + h * 8;
          if (it >= lo && it < hi && 2 * t4 < ky) {
            store2(y + (gi0 + it) * ky + 2 * t4, c[0][2 * h], c[0][2 * h + 1]);
          }
        }
        continue;
      }
      // through the warp's shared tile, then 16-byte pieces of whole rows
      Tout* eb = ep + warp * 16 * kTrEpS;
#pragma unroll
      for (int q = 0; q < kTrN / 8; ++q) {
        if (q < 2 * npairs) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            store2(eb + (g + h * 8) * kTrEpS + q * 8 + 2 * t4, c[q][2 * h], c[q][2 * h + 1]);
          }
        }
      }
      __syncwarp();
      constexpr int kE = 16 / sizeof(Tout);  // elements of a 16-byte piece
      auto put = [&](int r, int cc) {
        const int it = m0 + r;
        if (it >= lo && it < hi) {
          *reinterpret_cast<uint4*>(y + (gi0 + it) * ky + n0 + cc * kE) =
              *reinterpret_cast<const uint4*>(eb + r * kTrEpS + cc * kE);
        }
      };
      if (ky - n0 >= kTrN) {  // a whole unit: kTrN columns of 16 items
        constexpr int kCpr = kTrN / kE;
#pragma unroll
        for (int e = lane; e < 16 * kCpr; e += 32) put(e / kCpr, e % kCpr);
      } else {
        const int cpr = (ky - n0) / kE;
        for (int e = lane; e < 16 * cpr; e += 32) put(e / cpr, e - e / cpr * cpr);
      }
      __syncwarp();  // the tile is read before the next unit writes it
    }
    kbeg = sp_next;
    if (kbeg >= nspan) break;
    __syncthreads();  // the slabs and the span list are no longer read
  }
}

// Which path the kernels take for these widths after folding by mm: 3
// narrow tensor cores, 2 tensor cores, 0 CUDA cores, -1 none.
SpanPath transform_path(bool in_bf16, int seg, int blocks, int bw_in, int bw_out, int mm) {
  if (mm <= 0 || seg <= 0 || blocks <= 0 || bw_in % mm != 0 || bw_out % mm != 0 ||
      bw_in % 8 != 0 || bw_out % 8 != 0) {
    return kPathNone;
  }
  const int nb = blocks * mm, kx = bw_in / mm, ky = bw_out / mm;
  if (in_bf16 && kx % 16 == 0 && (ky % 8 == 0 || ky == 2 || ky == 4) &&
      tr_shape(seg, 1, nb, kx, ky, sizeof(float)).rows > 0) {
    return ky <= 8 ? kPathTcNarrow : kPathTc;
  }
  if (mm == 1 && bw_in * kCols * static_cast<int>(sizeof(float)) <= kSlabFloats * 4) {
    return kPathCuda;
  }
  return kPathNone;
}

template <typename Tin, typename Tout>
int launch_transform(const int* runs, const int* first, const int* cnt, const void* x,
                     const void* table, void* y, int nseg, int seg, int blocks,
                     int bw_in, int bw_out, int mm, int p_rows, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(Tin) == 2;
  const SpanPath path = transform_path(kBf16, seg, blocks, bw_in, bw_out, mm);
  if (path == kPathNone) return static_cast<int>(cudaErrorInvalidValue);
  if (path == kPathCuda) {
    const int chunk = cuda_chunk(bw_in, bw_out);
    const size_t smem = static_cast<size_t>(bw_in) * chunk * sizeof(float);
    seg_transform_kernel<Tin, Tout><<<nseg, kThreads, smem, stream>>>(
        runs, first, cnt, static_cast<const Tin*>(x),
        static_cast<const Tin*>(table), static_cast<Tout*>(y), seg, blocks,
        bw_in, bw_out, p_rows, chunk);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (kBf16) {
    const int nb = blocks * mm, kx = bw_in / mm, ky = bw_out / mm;
    const bool narrow = ky % 8 != 0;
    const TrShape sh = narrow ? tr_shape(std::min(seg, kTrRowsNarrow), kTrMaxG, nb, kx, ky,
                                         sizeof(Tout))
                              : tr_shape(std::min(seg, kTrRowsWide), kTrGWide, nb, kx, ky,
                                         sizeof(Tout));
    const TrArgs a{runs, first, cnt, static_cast<const __nv_bfloat16*>(x),
                   static_cast<const __nv_bfloat16*>(table), y, seg, nb, kx, ky,
                   bw_out, bw_in * bw_out, p_rows, sh.rows, sh.ng};
    const size_t smem = tr_smem_bytes(sh.rows, sh.ng, kx, nb, ky, sizeof(Tout));
    const dim3 grid(nseg, (seg + sh.rows - 1) / sh.rows);
    auto go = [&](auto kern) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      kern<<<grid, kThreads, smem, stream>>>(a);
      return cudaGetLastError();
    };
    return static_cast<int>(narrow ? go(seg_transform_tc_kernel<Tout, true, 16>)
                                   : go(seg_transform_tc_kernel<Tout, false, 64>));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success). in_bf16 / out_bf16 select bfloat16 (1) or float32 (0). mm
// folds the block-diagonal table (1: the slab as it is).
int fbtt_seg_transform(const int* runs, const int* first, const int* cnt,
                       const void* x, const void* table, void* y, int nseg,
                       int seg, int blocks, int bw_in, int bw_out, int mm,
                       int p_rows, int in_bf16, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16
        ? launch_transform<__nv_bfloat16, __nv_bfloat16>(runs, first, cnt, x, table, y, nseg, seg,
                                               blocks, bw_in, bw_out, mm, p_rows, st)
        : launch_transform<__nv_bfloat16, float>(runs, first, cnt, x, table, y, nseg, seg, blocks,
                                       bw_in, bw_out, mm, p_rows, st);
  }
  return out_bf16
      ? launch_transform<float, __nv_bfloat16>(runs, first, cnt, x, table, y, nseg, seg, blocks,
                                     bw_in, bw_out, mm, p_rows, st)
      : launch_transform<float, float>(runs, first, cnt, x, table, y, nseg, seg, blocks, bw_in,
                             bw_out, mm, p_rows, st);
}

// The path the kernels take for these widths after folding by mm: 3
// narrow tensor cores, 2 tensor cores, 0 CUDA cores, -1 the widths do not
// stage at this fold.
int fbtt_seg_transform_path(int in_bf16, int seg, int blocks, int bw_in, int bw_out,
                            int mm) {
  return transform_path(in_bf16 != 0, seg, blocks, bw_in, bw_out, mm);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
