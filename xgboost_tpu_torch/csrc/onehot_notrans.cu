// T2 on Hopper (sm_90a): the no-transpose int8 one-hot histogram prototype.
//
// Replaces the TPU kernel of tools/hist_notrans_proto.py: build -> fn ->
// pl.pallas_call of make_kernel.  Same function as T3 (onehot_i8.cu) on
// the original row-major (n, F) u8 bins: pos (n, 1) int32, gh (n, 2)
// int32 wrapped to int8, the first (n // r_tile) * r_tile rows, out
// (1, F * B, 2 * m_pad) int32.  The block stages its rows' bytes of one
// feature, read at a row stride of F, and compares them four at a time;
// no transpose, no copy.
//
// Bound on the H100: bytes, 1M x 28 u8 bins + pos + gh, about 40 MB:
// ~0.012 ms at 3.35 TB/s.  The strided byte reads of one feature per block
// take whole 32-byte sectors; the 28 feature blocks of one row chunk run
// side by side (blockIdx.x is the feature), so the other features' bytes
// of a sector are L2 hits.
//
// C interface for ctypes: onehot_notrans_launch returns a cudaError_t;
// variant 0 takes one column tile per task (M <= 4), 1 four.

#include "onehot_mma.cuh"

extern "C" int onehot_notrans_launch(const OnehotArgs* a, int variant,
                                     int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {  // column tiles per task: 1 (M <= 4) or 4
    case 0:
      return (int)onehot_launch<uint8_t, 1>(
          a, n_row_blocks, s);
    case 1:
      return (int)onehot_launch<uint8_t, 4>(
          a, n_row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* onehot_notrans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
