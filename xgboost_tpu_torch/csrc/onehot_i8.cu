// T3 on Hopper (sm_90a): the int8 one-hot histogram prototype.
//
// Replaces the TPU kernel of tools/hist_int8_proto.py: build_i8 -> fn ->
// pl.pallas_call of make_i8_kernel.  Same function: bins (F, n) int32
// feature-major, pos (n, 1) int32, gh (n, 2) int32 wrapped to int8; only
// the first (n // r_tile) * r_tile rows count (the prototype's grid drops
// the rest); out (1, F * B, 2 * m_pad) int32, cell [0, f * B + b,
// c * m_pad + j] = sum of int8(gh[r, c]) over rows with bins[f, r] == b
// and pos[r] == j.  The product is onehot_mma.cuh's m16n8k32 s8 one; the
// int32 bins are staged as bytes (a bin outside [0, 256) matches no bin
// of B <= 256: its row is zeroed) and compared four at a time.
//
// Bound on the H100: bytes, 1,007,616 x 28 int32 bins (113 MB) + pos and
// gh: ~0.037 ms at 3.35 TB/s; the one-hot product's tensor-core floor at
// M = 32 is ~0.12 ms (onehot_mma.cuh).
//
// C interface for ctypes: onehot_i8_launch returns a cudaError_t (0 = ok);
// variant 0 takes one column tile per task (M <= 4), 1 four.

#include "onehot_mma.cuh"

extern "C" int onehot_i8_launch(const OnehotArgs* a, int variant,
                                int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {  // column tiles per task: 1 (M <= 4) or 4
    case 0:
      return (int)onehot_launch<int32_t, 1>(
          a, n_row_blocks, s);
    case 1:
      return (int)onehot_launch<int32_t, 4>(
          a, n_row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* onehot_i8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
