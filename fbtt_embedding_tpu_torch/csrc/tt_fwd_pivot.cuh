// The forward pivot pass of kernel B4 (tt_fwd.cu), for Hopper (sm_90a):
// shared with kernel B5 (tt_bwd.cu), whose pivot path at tt_ndim 4 runs
// its head pass for z_1. See tt_fwd.cu for the design and what it
// replaces.
//
// One pass runs a tt_ndim-2 or -3 chain (a whole chain, or a sub_chain of
// a tt_ndim-4 one, tt_chain.cuh) over the live rows of its core 1's sorted
// order, and writes each lookup's w * row (its last state) to a row of
// rows_out. At tt_ndim 4 the path runs two: the head (cores 0-1, w = 1)
// writes z_1 = z_0 G_1 by lookup to a buffer, and the tail reads that
// buffer as its core 0 (core 2 its pivot, core 3 its last core).

#pragma once

#include <algorithm>

#include "tt_chain.cuh"
#include "tt_mma.cuh"

namespace fbtt_fwd {

using namespace fbtt_chain;
using namespace fbtt_mma;

constexpr int kPivotChunkMax = 16;          // lookups per group (lc <= this)
constexpr int kPivotSmemPref = 100 * 1024;  // take the largest lc within this
constexpr int kPivotSmemMax = 200 * 1024;   // else lc = 4 within this
constexpr int kPivotSmemThree = 72 * 1024;  // shared memory of a CTA where three fit an SM
constexpr int kSlabBudget = 40 * 1024;  // shared memory for the staged slabs
constexpr int kSlabsMax = 8;            // slabs (spans) a group holds at most
constexpr int kGroupTiles = 64;         // 16-row tiles of a group's product at most
constexpr int kWarps = kThreads / 32;
constexpr int kIdWindow = 64;     // rows whose ids a pivot CTA stages (>= lc; 2 warps)

// Where the last core's product runs at tt_ndim 3: in the epilogue of z_1's
// product, from the warps' tiles (r2 = 32, so that a warp's 4 column tiles
// hold all of an item's z_1 row; q2 of 4 up to 8); on the tensor cores per
// lookup (m1 a multiple of 16, r2 of 8, q2 of 4); else on the CUDA cores.
constexpr int kLastCuda = 0, kLastTc = 1, kLastFused = 2;

// The pivot core's shapes (core 1; at tt_ndim 2 also the last core).
struct FwdPivot {
  int m0;   // q_0: rows of z_0 per lookup
  int R;    // r_1: rows of the pivot slab
  int W;    // q_1 r_2: its columns
  int Wp;   // W rounded up to the tensor cores' 8 columns (zero past W)
  int gs;   // Wp, + 8 where Wp / 8 is even: the staged slab's row stride
            // (an odd number of 8-float blocks: conflict-free B fragments)
  int zs;   // R + 4: padded row stride of z_0
  int d;    // floats of a row
  int slabs;  // slabs a group stages: kSlabBudget's worth, 1 .. kSlabsMax
  int q1, m1, r2, q2;  // tt_ndim 3: m1 = q_0 q_1 items of z_1, the last slab [r2, q2]
  // tt_ndim 3: where the last core's product runs (kLastFused, kLastTc,
  // kLastCuda), its staged slabs' row stride q2s (q2, padded with zeros to 8
  // columns on the tensor cores) and z_1's item stride zs1 (r2 + 4 on the
  // tensor cores, r2 + 1 on the CUDA cores: conflict-free fragments, or
  // rows; no z_1 is staged where it is fused)
  int last;
  int q2s, zs1;
  FastDiv f_m0, f_m1, f_r2, f_R4, f_Wp4, f_q24, f_g24, f_q2s4;
};

inline FwdPivot make_fwd_pivot(const Chain& c) {
  FwdPivot p{};
  p.m0 = c.q[0];
  p.R = c.r[1];
  p.W = c.q[1] * c.r[2];
  p.Wp = (p.W + 7) / 8 * 8;
  p.gs = (p.Wp / 8) % 2 ? p.Wp : p.Wp + 8;
  p.zs = p.R + 4;
  p.d = c.m[c.ndim - 1];
  const int slab_bytes = p.R * p.gs * static_cast<int>(sizeof(float));
  p.slabs = std::min(kSlabsMax, std::max(1, kSlabBudget / std::max(slab_bytes, 1)));
  p.q1 = c.q[1];
  p.m1 = c.m[1];
  p.r2 = c.ndim == 3 ? c.r[2] : 1;
  p.q2 = c.ndim == 3 ? c.q[2] : 1;
  p.last = c.ndim != 3                                       ? kLastCuda
           : p.r2 == 32 && p.q2 % 4 == 0 && p.q2 <= 8        ? kLastFused
           : p.m1 % 16 == 0 && p.r2 % 8 == 0 && p.q2 % 4 == 0 ? kLastTc
                                                               : kLastCuda;
  p.q2s = p.last == kLastTc ? (p.q2 + 7) / 8 * 8 : p.q2;
  p.zs1 = p.last == kLastTc ? p.r2 + 4 : p.r2 + 1;
  auto fd = [](int x) { return fast_div(x > 0 ? x : 1); };
  p.f_m0 = fd(p.m0);
  p.f_m1 = fd(p.m1);
  p.f_r2 = fd(p.r2);
  p.f_R4 = fd(p.R / 4);
  p.f_Wp4 = fd(p.Wp / 4);
  p.f_q24 = fd((p.q2 + 3) / 4);
  p.f_g24 = fd(p.r2 * p.q2 / 4);
  p.f_q2s4 = fd(p.q2s / 4);
  return p;
}

// Rows of a group's product: lc q_0 rounded up to whole 16-row tiles.
__host__ __device__ inline int fwd_pivot_rows(int m0, int lc) { return (lc * m0 + 15) / 16 * 16; }

// Shared memory of a pivot CTA with groups of lc lookups: the slabs
// [slabs][R][gs], z_0 [rows][zs], and at tt_ndim 3 the group's last-core
// slabs [lc][r2][q2s] and z_1 by items [lc m1][zs1].
inline size_t fwd_pivot_smem_bytes(const Chain& c, const FwdPivot& p, int lc) {
  size_t f = static_cast<size_t>(p.slabs) * p.R * p.gs +
             static_cast<size_t>(fwd_pivot_rows(p.m0, lc)) * p.zs;
  if (c.ndim == 3) {
    f += static_cast<size_t>(lc) * (p.r2 * p.q2s + (p.last == kLastFused ? 0 : p.m1 * p.zs1));
  }
  return f * sizeof(float);
}

// lc of the pivot pass, or 0 where it does not take the config: tt_ndim 2
// or 3, r_1 a multiple of 8 (the tensor cores' depth), q_1 r_2, D and at
// tt_ndim 3 r_2 q_2 multiples of 4 (16-byte rows), the slabs and a group
// of 4 lookups within kPivotSmemMax bytes of shared memory, its product
// within kGroupTiles tiles, and every index of a group's loops within
// FastDiv's range.
inline int fwd_pivot_chunk(const Chain& c) {
  if (c.ndim != 2 && c.ndim != 3) return 0;
  const FwdPivot p = make_fwd_pivot(c);
  if (p.R % 8 || p.W % 4 || p.d % 4 || (c.ndim == 3 && (p.r2 * p.q2) % 4)) return 0;
  auto fits = [&](int lc, size_t smem) {
    using ll = long long;
    const ll rows = fwd_pivot_rows(p.m0, lc);
    const ll last = c.ndim == 3 ? std::max(static_cast<ll>(lc) * p.m1 * ((p.q2 + 3) / 4),
                                           static_cast<ll>(lc) * p.r2 * p.q2s)
                                : 0;
    const ll most = std::max({rows * p.R / 4, static_cast<ll>(p.R) * p.Wp / 4,
                              static_cast<ll>(p.Wp), last});
    return fwd_pivot_smem_bytes(c, p, lc) <= smem && most < kIndexMax &&
           rows / 16 <= kGroupTiles;
  };
  for (int lc = kPivotChunkMax; lc >= 4; lc -= 4) {
    if (fits(lc, kPivotSmemPref)) return lc;
  }
  return fits(4, kPivotSmemMax) ? 4 : 0;
}

// Pivot CTAs an SM holds at once: three at tt_ndim 2 where their shared
// memory fits (its kernel is built for 80 registers a thread: no last-core
// product), else two.
inline int fwd_pivot_ctas(const Chain& c, const FwdPivot& p, int lc) {
  return c.ndim == 2 && fwd_pivot_smem_bytes(c, p, lc) <= kPivotSmemThree ? 3 : 2;
}

// The pivot pass: one CTA per even share of the live rows of core 1's order
// (ord, span starts rn; in a sub_chain the whole chain's core src[1]); each
// live lookup's w * row into rows_out[lookup] (rows of d floats).
// The share's rows run in groups of up to lc lookups from up to p.slabs spans:
// each span's piece of the group takes whole 16-row tiles of the product
// (its rows from a tile boundary) and multiplies its span's staged slab.
template <int NDIM>
__global__ void __launch_bounds__(kThreads, NDIM == 2 ? 3 : 2)
tt_fwd_pivot_kernel(Chain c, FwdPivot p, const float* __restrict__ weights,
                    const int* __restrict__ ord, const int* __restrict__ rn,
                    float* __restrict__ rows_out, int lc) {
  extern __shared__ float4 smem4[];
  // the ids of up to kIdWindow rows of the share from row wb: lookup, its
  // core-0, core-1 (its span: nondecreasing) and core-2 rows, weight
  __shared__ int w_lk[kIdWindow], w_i0[kIdWindow], w_i1[kIdWindow], w_i2[kIdWindow];
  __shared__ float w_w[kIdWindow];
  // bit r of the 64: window row r is its span's last in the window
  __shared__ unsigned w_ends[2];
  // per 16-row tile of the group's product, its span's piece: slab slot,
  // first row, first lookup (of the group) and lookups
  __shared__ int t_slot[kGroupTiles], t_row0[kGroupTiles], t_u0[kGroupTiles], t_n[kGroupTiles];
  const int m0 = p.m0, R = p.R, W = p.W, gs = p.gs, zs = p.zs, d = p.d;
  const int r2 = p.r2, q2 = p.q2, q1 = p.q1, zs1 = p.zs1, q2s = p.q2s;
  const int r2q2 = r2 * q2;
  const int slab = R * gs;
  const int rows_cap = fwd_pivot_rows(m0, lc);
  float* g_s = reinterpret_cast<float*>(smem4);  // [slabs][R][gs]
  float* z0_s = g_s + p.slabs * slab;             // [rows][zs]
  float* g2_s = z0_s + rows_cap * zs;             // [lc][r2][q2s] (NDIM 3)
  float* z1_s = g2_s + lc * r2 * q2s;             // [lc m1][zs1] (NDIM 3)
  // the live lookups lead core 1's order: each CTA takes an even share of
  // them (the dead and the padding ones are in no share)
  const int nlive = rn[c.rows[1]];
  const int share = (nlive + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * share;
  const int hi = min(lo + share, nlive);
  const float* g0 = c.g[0];
  const float* g2 = c.g[2];
  const int tile0 = m0 * R;
  const int R4 = R / 4, W4 = W / 4, Wp4 = p.Wp / 4, Wp8 = p.Wp / 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int wb = 0, we = 0;  // the rows whose ids are staged

  // the group from row gb: gn lookups in rows gr of the product, from gsl
  // spans, in slab slots base, base + 1, .. (mod p.slabs); the span last
  // staged and its slot, which the next group keeps where it goes on
  int gb = lo, gn = 0, gr = 0, gsl = 0, base = 0, last_j = -1, last_slot = 0;
  // the product of the group's gathered rows, its rows out, then an empty
  // group from row gb + gn (CTA-uniform, all threads)
  auto flush = [&]() {
    cp_async_commit();
    cp_async_wait_prior<0>();
    __syncthreads();
    const int* c_lk = w_lk + (gb - wb);
    const float* c_w = w_w + (gb - wb);
    // z_1 = z_0 G_1[j]: tile mt of [gr][R] x [R][Wp] by its span's slab,
    // NT column tiles a warp at a time; tt_ndim 2: w * z_1 is the row;
    // tt_ndim 3: z_1 by items (item a_0 q_1 + a_1 of lookup u, column k,
    // from lookup u's row a_0, column a_1 r2 + k)
    auto z1_all = [&](auto nt_tag) {
      constexpr int NT = decltype(nt_tag)::value;
      const int groups = Wp8 / NT;
      for (int tl = warp; tl < (gr / 16) * groups; tl += kWarps) {
        const int mt = tl / groups;
        const int wt = (tl - mt * groups) * NT;
        float o[NT][4] = {};
        mma_3xtf32<NT>(o, z0_s + mt * 16 * zs, zs, 1, g_s + t_slot[mt] * slab + wt * 8, gs, 1,
                       0, R, 8);
        const int row0 = t_row0[mt], u0 = t_u0[mt], un = t_n[mt];
        if constexpr (NDIM == 3 && NT == 4) {
          if (p.last == kLastFused) {
            // this warp's 32 columns are item a_0 q_1 + a_1's z_1 row (a_1
            // = wt / 4) for its rows a_0: times the lookup's last slab
            // [32][q2], each lane its k = 8 i + 2 t4 (+ 1), summed over the
            // quad; lane t4 writes columns t4 and t4 + 4
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pr = mt * 16 + g + 8 * h - row0;  // row in the piece
              const int du = pr / p.f_m0;
              const bool live = du < un;
              const int u = live ? u0 + du : u0;
              const float* y = g2_s + u * 32 * q2;
              float acc[8] = {};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                  const float zv = o[i][2 * h + v];
                  const float* yk = y + (8 * i + 2 * t4 + v) * q2;
                  const float4 ya = ld4(yk);
                  acc[0] = fmaf(zv, ya.x, acc[0]);
                  acc[1] = fmaf(zv, ya.y, acc[1]);
                  acc[2] = fmaf(zv, ya.z, acc[2]);
                  acc[3] = fmaf(zv, ya.w, acc[3]);
                  if (q2 == 8) {
                    const float4 yb = ld4(yk + 4);
                    acc[4] = fmaf(zv, yb.x, acc[4]);
                    acc[5] = fmaf(zv, yb.y, acc[5]);
                    acc[6] = fmaf(zv, yb.z, acc[6]);
                    acc[7] = fmaf(zv, yb.w, acc[7]);
                  }
                }
#pragma unroll
              for (int cc = 0; cc < 8; ++cc) {
                acc[cc] += __shfl_xor_sync(0xffffffffu, acc[cc], 1);
                acc[cc] += __shfl_xor_sync(0xffffffffu, acc[cc], 2);
              }
              if (live) {
                const float wv = c_w[u];
                float* out = rows_out + static_cast<size_t>(c_lk[u]) * d +
                             ((pr - du * m0) * q1 + wt / 4) * q2;
                const float lo4 = t4 == 0 ? acc[0] : t4 == 1 ? acc[1] : t4 == 2 ? acc[2] : acc[3];
                out[t4] = wv * lo4;
                if (q2 == 8) {
                  const float hi4 =
                      t4 == 0 ? acc[4] : t4 == 1 ? acc[5] : t4 == 2 ? acc[6] : acc[7];
                  out[t4 + 4] = wv * hi4;
                }
              }
            }
            continue;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pr = mt * 16 + g + 8 * h - row0;  // row in the piece
          const int du = pr / p.f_m0;
          if (du >= un) continue;
          const int u = u0 + du;
          const int a0 = pr - du * m0;
          if (NDIM == 2) {
            const float wv = c_w[u];
            float* dst = rows_out + static_cast<size_t>(c_lk[u]) * d + a0 * W;
#pragma unroll
            for (int i = 0; i < NT; ++i) {
              const int col = (wt + i) * 8 + 2 * t4;
              if (col < W) {
                *reinterpret_cast<float2*>(dst + col) =
                    make_float2(wv * o[i][2 * h], wv * o[i][2 * h + 1]);
              }
            }
          } else {
            float* dst = z1_s + (u * p.m1 + a0 * q1) * zs1;
            if (p.last == kLastTc) {  // r2 % 8 == 0: a tile's columns share a_1
#pragma unroll
              for (int i = 0; i < NT; ++i) {
                const int a1 = ((wt + i) * 8) / p.f_r2;
                const int k = (wt + i) * 8 - a1 * r2 + 2 * t4;
                *reinterpret_cast<float2*>(dst + a1 * zs1 + k) =
                    make_float2(o[i][2 * h], o[i][2 * h + 1]);
              }
            } else {
#pragma unroll
              for (int i = 0; i < NT; ++i) {
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                  const int col = (wt + i) * 8 + 2 * t4 + v;
                  const int a1 = col / p.f_r2;
                  if (col < W) dst[a1 * zs1 + col - a1 * r2] = o[i][2 * h + v];
                }
              }
            }
          }
        }
      }
    };
    if (Wp8 % 4 == 0) {
      z1_all(IntC<4>{});
    } else if (Wp8 % 2 == 0) {
      z1_all(IntC<2>{});
    } else {
      z1_all(IntC<1>{});
    }
    if (NDIM == 3 && p.last != kLastFused) {
      __syncthreads();
      if (p.last == kLastTc) {
        // each lookup's items [m1][r2] times its slab [r2][q2s] on the
        // tensor cores: 16 items by 8 columns a tile
        const int mt1 = p.m1 / 16, nt1 = q2s / 8;
        for (int tl = warp; tl < gn * mt1 * nt1; tl += kWarps) {
          const int u = tl / (mt1 * nt1);
          const int mt = (tl - u * mt1 * nt1) / nt1;
          const int nt = tl - u * mt1 * nt1 - mt * nt1;
          float o[1][4] = {};
          mma_3xtf32<1>(o, z1_s + (u * p.m1 + mt * 16) * zs1, zs1, 1, g2_s + u * r2 * q2s + nt * 8,
                        q2s, 1, 0, r2, 8);
          const float wv = c_w[u];
          const int col = nt * 8 + 2 * t4;
          if (col < q2) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = mt * 16 + g + 8 * h;
              *reinterpret_cast<float2*>(rows_out + static_cast<size_t>(c_lk[u]) * d + i * q2 +
                                         col) =
                  make_float2(wv * o[0][2 * h], wv * o[0][2 * h + 1]);
            }
          }
        }
      } else {
        // each item's [r2] times its lookup's [r2][q2] slab on the CUDA
        // cores: row item i of lookup u, four columns of q2 a thread
        const int q24 = (q2 + 3) / 4;
        for (int e = threadIdx.x; e < gn * p.m1 * q24; e += kThreads) {
          const int ui = e / p.f_q24;  // u m1 + i
          const int c4 = e - ui * q24;
          const int u = ui / p.f_m1;
          const int i = ui - u * p.m1;
          const int nc = min(4, q2 - c4 * 4);
          const float* z = z1_s + ui * zs1;
          const float* y = g2_s + u * r2q2 + c4 * 4;
          float v[4] = {};
          for (int k = 0; k < r2; ++k) {
            const float zv = z[k];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) v[cc] = fmaf(zv, y[k * q2 + min(cc, nc - 1)], v[cc]);
          }
          const float wv = c_w[u];
          float* out = rows_out + static_cast<size_t>(c_lk[u]) * d + i * q2 + c4 * 4;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            if (cc < nc) out[cc] = wv * v[cc];
          }
        }
      }
    }
    gb += gn;
    gn = gr = gsl = 0;
  };

  // CTA-uniform: every __syncthreads() below is reached by all or none
  for (int cb = lo; cb < hi;) {
    if (gn == 0) {  // a new group: the previous one's rows, slabs and ids are no longer read
      __syncthreads();
      if (gb + lc > we) {  // stage the ids of the group's rows (and more)
        wb = gb;
        we = min(hi, gb + kIdWindow);
        if (threadIdx.x < we - wb) {
          const int lk = ord[wb + threadIdx.x];
          w_lk[threadIdx.x] = lk;
          w_i0[threadIdx.x] = core_row(c, 0, lk);
          w_i1[threadIdx.x] = core_row(c, 1, lk);
          if (NDIM == 3) w_i2[threadIdx.x] = core_row(c, 2, lk);
          w_w[threadIdx.x] = weights ? weights[lk] : 1.f;
        }
        __syncthreads();
        if (threadIdx.x < kIdWindow) {  // two whole warps
          const int r = threadIdx.x;
          const bool last = r < we - wb && (r + 1 == we - wb || w_i1[r + 1] != w_i1[r]);
          const unsigned bits = __ballot_sync(0xffffffffu, last);
          if ((r & 31) == 0) w_ends[r >> 5] = bits;
        }
        __syncthreads();
      }
    }
    // this span's lookups the group takes: up to lc in all, within the
    // product's rows from the next tile boundary, and a free slab slot
    const int cap = min(lc - gn, (rows_cap - gr) / m0);
    if (cap <= 0 || gsl == p.slabs) {
      flush();
      continue;
    }
    const int j = w_i1[cb - wb];
    // the span's rows from cb: to its last in the window (its last overall,
    // or the window's), within cap
    const unsigned long long ends =
        (static_cast<unsigned long long>(w_ends[1]) << 32 | w_ends[0]) >> (cb - wb);
    const int n = min(cap, __ffsll(static_cast<long long>(ends)));
    // the span's slab into its slot (kept where the previous group's last
    // span goes on), its lookups' z_0 rows from row gr (and at tt_ndim 3
    // their last-core slabs), in flight until the flush
    if (gsl == 0) base = j == last_j ? last_slot : (last_slot + 1) % p.slabs;
    const int slot = (base + gsl) % p.slabs;
    if (gsl > 0 || j != last_j) {
      const float* gj = c.g[1] + static_cast<size_t>(j) * R * W;
      float* gsj = g_s + slot * slab;
      for (int e = threadIdx.x; e < R * Wp4; e += kThreads) {
        const int k = e / p.f_Wp4;
        const int c4 = e - k * Wp4;
        const bool in = c4 < W4;
        cp_async16(gsj + k * gs + c4 * 4, in ? gj + k * W + c4 * 4 : gj, in);
      }
    }
    last_j = j;
    last_slot = slot;
    const int* c_i0 = w_i0 + (cb - wb);
    for (int e = threadIdx.x; e < n * m0 * R4; e += kThreads) {
      const int row = e / p.f_R4;
      const int c4 = e - row * R4;
      const int u = row / p.f_m0;
      cp_async16(z0_s + (gr + row) * zs + c4 * 4,
                 g0 + static_cast<size_t>(c_i0[u]) * tile0 + (row - u * m0) * R + c4 * 4, true);
    }
    if (NDIM == 3) {
      const int* c_i2 = w_i2 + (cb - wb);
      if (p.last == kLastTc) {  // rows of q2 floats, zero to q2s
        const int q2s4 = q2s / 4;
        float* g2b = g2_s + gn * r2 * q2s;
        for (int e = threadIdx.x; e < n * r2 * q2s4; e += kThreads) {
          const int uk = e / p.f_q2s4;  // u r2 + k
          const int c4 = e - uk * q2s4;
          const int u = uk / p.f_r2;
          const bool in = c4 * 4 < q2;
          const float* src =
              g2 + static_cast<size_t>(c_i2[u]) * r2q2 + (uk - u * r2) * q2 + c4 * 4;
          cp_async16(g2b + e * 4, in ? src : g2, in);
        }
      } else {
        const int g24 = r2q2 / 4;
        float* g2b = g2_s + gn * r2q2;
        for (int e = threadIdx.x; e < n * g24; e += kThreads) {
          const int u = e / p.f_g24;
          cp_async16(g2b + e * 4, g2 + static_cast<size_t>(c_i2[u]) * r2q2 + (e - u * g24) * 4,
                     true);
        }
      }
    }
    const int tiles = (n * m0 + 15) / 16;
    if (threadIdx.x < tiles) {
      t_slot[gr / 16 + threadIdx.x] = slot;
      t_row0[gr / 16 + threadIdx.x] = gr;
      t_u0[gr / 16 + threadIdx.x] = gn;
      t_n[gr / 16 + threadIdx.x] = n;
    }
    gn += n;
    gr += tiles * 16;
    ++gsl;
    cb += n;
  }
  if (gn > 0) flush();
}

// The chains the pivot path runs, into pass[]; returns their count: the
// chain itself at tt_ndim 2 and 3, and at tt_ndim 4 its head (cores 0-1,
// whose row is z_1) and its tail (z_1 by lookup from z1, cores 2-3).
inline int fwd_passes(const Chain& c, const float* z1, Chain* pass) {
  if (c.ndim != 4) {
    pass[0] = c;
    return 1;
  }
  pass[0] = sub_chain(c, 0, 1, nullptr);
  pass[1] = sub_chain(c, 2, 3, z1);
  return 2;
}

// lc of the pivot path, or 0 where the chain pass runs: every pass's
// fwd_pivot_chunk, the least (one lc for all: a pass's shared memory only
// shrinks with lc).
inline int fwd_path_chunk(const Chain& c) {
  Chain pass[2];
  const int n = fwd_passes(c, nullptr, pass);
  int lc = kPivotChunkMax;
  for (int i = 0; i < n; ++i) lc = std::min(lc, fwd_pivot_chunk(pass[i]));
  return lc;
}

// One pivot pass of chain c (tt_ndim NDIM), ceil(nza / sub) CTAs, groups of
// lc lookups: each live lookup's w * row (w = 1 where weights is null) into
// rows_out at its id, from ord1 / runs1, the order and span starts of c's
// core 1.
template <int NDIM>
inline cudaError_t launch_pivot(const Chain& c, const FwdPivot& p, const float* weights,
                                const int* ord1, const int* runs1, float* rows_out, int nza,
                                int sub, int lc, cudaStream_t st) {
  auto kern = tt_fwd_pivot_kernel<NDIM>;
  const size_t smem = fwd_pivot_smem_bytes(c, p, lc);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<(nza + sub - 1) / sub, kThreads, smem, st>>>(c, p, weights, ord1, runs1, rows_out, lc);
  return cudaGetLastError();
}

}  // namespace fbtt_fwd
