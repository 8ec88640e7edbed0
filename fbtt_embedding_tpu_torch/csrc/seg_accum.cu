// Sorted-run gradient pass for Hopper (sm_90a): kernel B3.
//
// Replaces the Pallas TPU kernel fbtt_embedding_tpu/ops/pallas/tt_flat.py
// :: _seg_accum_call (through its wrapper _seg_accum). For every span j
// < p_rows of the sorted order and each lane-block b:
//
//     acc[j]   += sum_b x_b[rows of j]^T @ y_b[rows of j]     (float32)
//     z_b[rows of j] = y_b[rows of j] @ T[j]^T    (rounded once to z's type)
//
// x is the pass's forward input (the staged state), y the cotangent of its
// output, T the stacked core table; acc is the core gradient and z the
// cotangent handed to the previous core. Sentinel rows of z are exact
// zeros, and so is acc[j] of an empty span. With mm > 1 the table is
// block-diagonal, kron(I_mm, G[j]): the kernel reads only G[j], works on
// the mm sub-blocks of every lane-block, and acc is the sum of the diagonal
// blocks, [p_rows, bw_x/mm, bw_y/mm] (seg_span.cuh).
//
// Where it runs: the i1 backward of every training step (float32 z, feeding
// the exact first-core gradient), and the i2 backward (mm = 4) of the
// two-pass autograd path.
//
// Bound and design (seg_span.cuh). At the headline i1 shape (x [10240,
// 4*32], y [10240, 4*128] bf16, float32 z, acc [220, 32, 128]) the pass
// must move ~24 MB (~7 us at 3.35 TB/s) and do ~0.67 GFLOP: ~36 FLOP per
// byte, past what the CUDA cores feed at that rate. So bf16 passes whose
// folded widths are multiples of 16 run both products on the tensor cores
// (mma.sync.m16n8k16 from ldmatrix, the segment's rows staged in shared
// memory once, the slabs double-buffered): on the H100 the headline i1
// pass reads ~3x its byte bound, most of it staging and the partial tiles'
// round trip, no longer the multiply-adds. The folded i2 pass (32 x 4) is
// a narrow stream, on the narrow tensor-core path in bf16 (seg_fused_i2.cu's
// path without the forward product); float32 and other widths take the
// CUDA-core paths. Partial gradient tiles are added per span in segment
// order by a second kernel: no float atomics, bitwise repeatable.

#include "seg_span.cuh"

using fbtt_span::launch;

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 on success). in_bf16 / z_bf16 select bfloat16 (1) or
// float32 (0) for x, y, table and for z. mm folds the block-diagonal table
// (1: the slab as it is). `partial` holds (nseg + p_rows) float tiles of
// (bw_x/mm) * (bw_y/mm); acc is [p_rows, bw_x/mm, bw_y/mm] float.
int fbtt_seg_accum(const int* runs, const int* first, const int* cnt, const void* x,
                   const void* y, const void* table, void* z, float* partial,
                   float* acc, int nseg, int seg, int blocks, int bw_x, int bw_y,
                   int mm, int p_rows, int in_bf16, int z_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return z_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, false>(
                        runs, first, cnt, x, y, table, z, nullptr, partial, acc, nseg,
                        seg, blocks, bw_x, bw_y, mm, p_rows, st)
                  : launch<__nv_bfloat16, float, false>(
                        runs, first, cnt, x, y, table, z, nullptr, partial, acc, nseg,
                        seg, blocks, bw_x, bw_y, mm, p_rows, st);
  }
  return z_bf16 ? launch<float, __nv_bfloat16, false>(runs, first, cnt, x, y, table, z,
                                                     nullptr, partial, acc, nseg, seg,
                                                     blocks, bw_x, bw_y, mm, p_rows, st)
                : launch<float, float, false>(runs, first, cnt, x, y, table, z, nullptr,
                                             partial, acc, nseg, seg, blocks, bw_x, bw_y,
                                             mm, p_rows, st);
}

// The path the first kernel takes for these widths after folding by mm:
// 3 narrow tensor cores, 2 tensor cores, 1 narrow, 0 CUDA cores, -1 the
// widths do not stage.
int fbtt_seg_accum_path(int in_bf16, int seg, int blocks, int bw_x, int bw_y, int mm) {
  if (mm <= 0 || bw_x % mm != 0 || bw_y % mm != 0) return fbtt_span::kPathNone;
  return fbtt_span::span_path(in_bf16 != 0, false, seg, blocks * mm, bw_x / mm,
                              bw_y / mm);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
