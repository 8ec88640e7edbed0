// Fused last-core training pass for Hopper (sm_90a): kernel B2.
//
// Replaces the Pallas TPU kernel fbtt_embedding_tpu/ops/pallas/tt_flat.py
// :: _seg_fused_i2_call. In the training step d_output is known up front,
// so the last core's forward and backward run as one pass: for every span
// j < p_rows of the sorted order and each lane-block b,
//
//     rows_b[rows of j] = x_b[rows of j] @ T[j]       (output rows)
//     z_b[rows of j]    = y_b[rows of j] @ T[j]^T     (dZ1)
//     acc[j]           += sum_b x_b^T @ y_b           (dG2, float32)
//
// with x the staged forward state, y the gathered output cotangents and T
// the block-diagonal last-core table. rows and z are rounded once to the
// staging type; sentinel rows of both are exact zeros.
//
// Design and bound: seg_span.cuh. One staged slab (as is and transposed,
// built from one read of T[j]) serves both products of a span, and the
// segment's x and y rows feed all three outputs. At the headline shape
// (x [10240, 4*128], y [10240, 4*16] bf16, T[j] 128 x 16) the pass must
// move about 27 MB (z, [10240, 512] bf16, is the largest stream): ~8 us
// at 3.35 TB/s. The acc tile is computed whole, though only its mm = 4
// diagonal [32, 4] blocks survive _extract_bd_grad: 4x the needed
// multiply-adds, left for a later change.

#include "seg_span.cuh"

using fbtt_span::launch;

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 on success). in_bf16 selects bfloat16 (1) or float32 (0) for
// x, y, table, z and rows. `partial` holds (nseg + p_rows) float tiles of
// bw_x * bw_y; acc is [p_rows, bw_x, bw_y] float.
int fbtt_seg_fused_i2(const int* runs, const int* first, const int* cnt, const void* x,
                      const void* y, const void* table, void* z, void* rows,
                      float* partial, float* acc, int nseg, int seg, int blocks,
                      int bw_x, int bw_y, int p_rows, int in_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16, true>(runs, first, cnt, x, y, table, z,
                                                      rows, partial, acc, nseg, seg,
                                                      blocks, bw_x, bw_y, p_rows, st);
  }
  return launch<float, float, true>(runs, first, cnt, x, y, table, z, rows, partial, acc,
                                    nseg, seg, blocks, bw_x, bw_y, p_rows, st);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
