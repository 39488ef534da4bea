// T6 on Hopper (sm_90a): the round-4 bf16 one-hot histogram A/B.
//
// Replaces the TPU kernel of tools/hist_r4_ab.py: build(mode, r_tile) ->
// fn -> pl.pallas_call of make_kernel.  Same function: bins (F, n)
// feature-major (int32; uint8 for "u8bins"), pos (n, 1) int32, gh (n, 2)
// f32 rounded to bf16, M = 64 nodes, the first (n // r_tile) * r_tile
// rows; out (1, F * B, 128) f32, cell [0, f * B + b, c * 64 + j] = sum
// of bf16(gh[r, c]) over rows with bins[f, r] == b and pos[r] == j.
//
// Four compiled variants of the shared one-feature kernel
// (onehot_mma.cuh, four column tiles a task) that differ only in how the
// one-hot A fragment is built; each stages the same bytes and runs the
// same gh_exp B build and the same mma.syncs:
//   prod      by numbers, as the prototype's astype(bfloat16): each bin
//             byte compared alone as an int, 1.0f / 0.0f selected, and
//             pairs converted with one cvt.rn.bf16x2.f32;
//   dotfloor  a constant fragment, 1.0 in bin row 0 and 0 elsewhere: no
//             one-hot is built, every feature's bin 0 holds the node
//             totals (the bins are not read, as in the prototype);
//             prod - dotfloor is the one-hot build's cost;
//   u8bins    prod on uint8 bins (a quarter of the bin bytes);
//   i16hot    the bit pattern: four bytes compared at once, the match
//             flags widened by a byte permute and ANDed with 0x3F803F80
//             (bf16 1.0 in both halves), the Hopper form of the
//             prototype's int16 select of 0x3F80 and bitcast; the
//             build T5 uses.
// r_tile is the row step (1,024 or 2,048; 4,096 is staged as two steps
// of 2,048) and the granularity at which the tail is dropped.
//
// Bound on the H100: bytes, 1,007,616 x 28 int32 bins (113 MB) + pos and
// gh, ~0.037 ms at 3.35 TB/s (u8bins ~0.012 ms); the product's
// tensor-core floor at M = 64, B = 64 is ~0.47 ms at 989 TFLOP/s.
//
// C interface for ctypes: onehot_r4_launch returns a cudaError_t;
// variant 0 prod, 1 dotfloor, 2 u8bins, 3 i16hot.

#include "onehot_mma.cuh"

extern "C" int onehot_r4_launch(const OnehotArgs* a, int variant,
                                int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return (int)onehot_launch<OH_BF16, int32_t, true, 4, 1, OH_A_NUM>(
          a, n_row_blocks, s);
    case 1:
      return (int)onehot_launch<OH_BF16, int32_t, true, 4, 1, OH_A_CONST>(
          a, n_row_blocks, s);
    case 2:
      return (int)onehot_launch<OH_BF16, uint8_t, true, 4, 1, OH_A_NUM>(
          a, n_row_blocks, s);
    case 3:
      return (int)onehot_launch<OH_BF16, int32_t, true, 4, 1, OH_A_BITS>(
          a, n_row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* onehot_r4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
