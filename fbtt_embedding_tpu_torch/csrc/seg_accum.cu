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
// zeros, and so is acc[j] of an empty span. In the training step this is
// the i1 backward pass, with a float32 z that feeds the exact first-core
// gradient.
//
// Design and bound: seg_span.cuh (segment-parallel passes, partial
// gradient tiles added per span in segment order by a second kernel: no
// float atomics, bitwise repeatable). At the headline i1 shape (x [10240,
// 4*32], y [10240, 4*128] bf16, float32 z, acc [220, 32, 128]) the pass
// must move about 24 MB: ~7 us at 3.35 TB/s.

#include "seg_span.cuh"

using fbtt_span::launch;

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 on success). in_bf16 / z_bf16 select bfloat16 (1) or
// float32 (0) for x, y, table and for z. `partial` holds (nseg + p_rows)
// float tiles of bw_x * bw_y; acc is [p_rows, bw_x, bw_y] float.
int fbtt_seg_accum(const int* runs, const int* first, const int* cnt, const void* x,
                   const void* y, const void* table, void* z, float* partial,
                   float* acc, int nseg, int seg, int blocks, int bw_x, int bw_y,
                   int p_rows, int in_bf16, int z_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return z_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, false>(
                        runs, first, cnt, x, y, table, z, nullptr, partial, acc, nseg,
                        seg, blocks, bw_x, bw_y, p_rows, st)
                  : launch<__nv_bfloat16, float, false>(
                        runs, first, cnt, x, y, table, z, nullptr, partial, acc, nseg,
                        seg, blocks, bw_x, bw_y, p_rows, st);
  }
  return z_bf16 ? launch<float, __nv_bfloat16, false>(runs, first, cnt, x, y, table, z,
                                                     nullptr, partial, acc, nseg, seg,
                                                     blocks, bw_x, bw_y, p_rows, st)
                : launch<float, float, false>(runs, first, cnt, x, y, table, z, nullptr,
                                             partial, acc, nseg, seg, blocks, bw_x, bw_y,
                                             p_rows, st);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
