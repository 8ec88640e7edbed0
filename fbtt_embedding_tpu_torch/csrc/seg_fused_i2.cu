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
// the block-diagonal last-core table, kron(I_mm, G2[j]). rows and z are
// rounded once to the staging type; sentinel rows of both are exact zeros.
// With mm > 1 the kernel reads only G2[j] and acc is the sum of the
// diagonal blocks, [p_rows, bw_x/mm, bw_y/mm] (seg_span.cuh).
//
// Bound and design (seg_span.cuh). Folded at the headline shape (mm = 4)
// the pass is 16 sub-blocks of x [10240, 16*32] and y [10240, 16*4] bf16
// with G2[j] 32 x 4: ~27 MB to move (z, [10240, 512] bf16, is the largest
// stream; ~8 us at 3.35 TB/s) and 4 multiply-adds per z element, so a
// memory-bound stream whose cost on the card is instructions per byte. In
// bf16 it runs the narrow tensor-core path: the segment's x and y rows
// staged in shared memory at once (cp.async), ky padded to 8 columns of
// zeros, and rows = X G2, z = Y G2^T and acc = X^T Y on mma.sync. Float32
// and the widths that path does not take run the narrow CUDA-core path
// (lanes of 8 columns, shuffle sums), about 2.3x slower in bf16. Unfolded
// (mm = 1: the whole 128 x 16 slab, 4x the multiply-adds) it takes the
// CUDA-core path. Partial gradient tiles are added per span in segment
// order by a second kernel: bitwise repeatable.

#include "seg_span.cuh"

using fbtt_span::launch;

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 on success). in_bf16 selects bfloat16 (1) or float32 (0) for
// x, y, table, z and rows. mm folds the block-diagonal table (1: the slab
// as it is). `partial` holds (nseg + p_rows) float tiles of (bw_x/mm) *
// (bw_y/mm); acc is [p_rows, bw_x/mm, bw_y/mm] float.
int fbtt_seg_fused_i2(const int* runs, const int* first, const int* cnt, const void* x,
                      const void* y, const void* table, void* z, void* rows,
                      float* partial, float* acc, int nseg, int seg, int blocks,
                      int bw_x, int bw_y, int mm, int p_rows, int in_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16, true>(runs, first, cnt, x, y, table, z,
                                                      rows, partial, acc, nseg, seg,
                                                      blocks, bw_x, bw_y, mm, p_rows, st);
  }
  return launch<float, float, true>(runs, first, cnt, x, y, table, z, rows, partial, acc,
                                    nseg, seg, blocks, bw_x, bw_y, mm, p_rows, st);
}

// The path the first kernel takes for these widths after folding by mm:
// 3 narrow tensor cores, 1 narrow, 0 CUDA cores, -1 the widths do not
// stage.
int fbtt_seg_fused_i2_path(int in_bf16, int seg, int blocks, int bw_x, int bw_y, int mm) {
  if (mm <= 0 || bw_x % mm != 0 || bw_y % mm != 0) return fbtt_span::kPathNone;
  return fbtt_span::span_path(in_bf16 != 0, true, seg, blocks * mm, bw_x / mm,
                              bw_y / mm);
}

const char* fbtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
