// Float32-accurate tensor-core products, cp.async staging and fast index
// division for the generic kernels' pivot passes on Hopper (sm_90a):
// tt_fwd.cu (kernel B4) and tt_bwd.cu (kernel B5). Each float32 operand is
// split into a TF32 part and the TF32 rest, and a product runs as three
// mma.sync.m16n8k8 TF32 products (3xTF32): float32 accuracy at the TF32
// tensor-core rate, where plain TF32 (~3 decimal digits) would miss the
// kernels' float32 limits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fbtt_mma {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes from device to shared memory (both 16-byte aligned), or 16 zero
// bytes where !valid (src is then not read); the caller commits the group
// and waits for it. Cached in L1 too (.ca): under skewed traffic many
// lookups gather the same hot core row, which then comes from L1 rather
// than queueing at one L2 slice.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait for all committed groups but the N most recent
template <int N>
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x as a TF32 part hi (x with its 13 low mantissa bits cleared) and the
// rest lo = x - hi (exact in float32), which the tensor cores read
// truncated to TF32: hi + lo keeps 21 of x's 24 significant bits. Two
// integer and float operations, where cvt.rna.tf32 runs at a fraction of
// the ALU rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col); TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp, NT tiles of 16 x 8 that share their rows: d[i] (the tile at
// the origin of a and at column block i of b) += sum over k of a(r, k)
// b(k, 8 i + n), with a(r, k) = a[r ar + k ac] and b(k, n) = b[k bk + n
// bn], for k = k0, k0 + kstep, .. < k1 in steps of 8, as 3xTF32: each
// operand is split into a TF32 part and the rest (split_tf32), the products lo hi
// and hi lo accumulate in a second set of tiles (so that consecutive mma
// are independent) and hi hi in d, all in float32; the second set is added
// at the end (float32 accuracy: each product within ~2^-19 of its value,
// the lo lo term and the truncation of lo dropped). Lane (g, t) = (lane / 4, lane % 4) holds a(g | g + 8, t | t +
// 4), b(t | t + 4, g) and d(g | g + 8, 2t | 2t + 1).
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[NT][4], const float* a, int ar, int ac,
                                           const float* b, int bk, int bn, int k0, int k1,
                                           int kstep) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* a_g = a + g * ar + t * ac;
  const float* b_g = b + t * bk + g * bn;
  float ds[NT][4] = {};
#pragma unroll 4
  for (int k = k0; k < k1; k += kstep) {
    const float av[4] = {a_g[k * ac], a_g[8 * ar + k * ac], a_g[(k + 4) * ac],
                         a_g[8 * ar + (k + 4) * ac]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float* bi = b_g + i * 8 * bn;
      const float bv[2] = {bi[k * bk], bi[(k + 4) * bk]};
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) split_tf32(bv[h], bh[h], bl[h]);
      mma_tf32(ds[i], al, bh[0], bh[1]);
      mma_tf32(d[i], ah, bh[0], bh[1]);
      mma_tf32(ds[i], ah, bl[0], bl[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) d[i][v] += ds[i][v];
}

constexpr int kIndexMax = 1 << 16;  // FastDiv's range

// x / d for 0 <= x, d < 2^16 as one multiply-high: m = floor(2^32 / d) + 1
// (x m / 2^32 exceeds x / d by less than x / 2^32 < 1 / d).
struct FastDiv {
  unsigned d, m;
};
inline FastDiv fast_div(int d) {
  return FastDiv{static_cast<unsigned>(d),
                 d == 1 ? 0u : static_cast<unsigned>((1ull << 32) / d + 1)};
}
__device__ __forceinline__ int operator/(int x, const FastDiv& f) {
  return f.d == 1 ? x : static_cast<int>(__umulhi(static_cast<unsigned>(x), f.m));
}

template <int N>
struct IntC {
  static constexpr int value = N;
};

}  // namespace fbtt_mma
