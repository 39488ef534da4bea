// T6 on Hopper (sm_90a): the round-4 bf16 one-hot histogram A/B.
//
// Replaces the TPU kernel of tools/hist_r4_ab.py: build(mode, r_tile) ->
// fn -> pl.pallas_call of make_kernel.  Same function: bins (F, n)
// feature-major (int32; uint8 for "u8bins"), pos (n, 1) int32, gh (n, 2)
// f32 rounded to bf16 (nearest even), M = 64 nodes, the first (n //
// r_tile) * r_tile rows; out (1, F * B, 128) f32, cell [0, f * B + b,
// c * 64 + j] = sum of bf16(gh[r, c]) over rows with bins[f, r] == b and
// pos[r] == j.
//
// The kernel is the wgmma one-hot product of onehot_wgmma.cuh (shared
// with T5, T1 and T7) at N = 128, staging the feature-major bins with
// rows inner (uint8 ones 16 rows a load, a straight copy into the
// [feature][row] stage).  The four modes differ only in how the one-hot
// A fragment is built (template AB); each stages the same bytes and runs
// the same gh_exp B tiles and the same wgmma:
//   prod      by numbers, as the prototype's astype(bfloat16): each bin
//             byte compared alone as an int, 1.0f / 0.0f selected, and
//             pairs converted with one cvt.rn.bf16x2.f32 (OHW_A_NUM);
//   dotfloor  a constant fragment, 1.0 in the bin-0 row of every feature:
//             no one-hot is built and no bins are read, as in the
//             prototype, and every feature's bin 0 holds the node totals;
//             prod - dotfloor is the one-hot build's cost (OHW_A_CONST);
//   u8bins    prod on uint8 bins (a quarter of the bin bytes);
//   i16hot    the bit pattern: four bytes compared at once, the match
//             flags widened by byte permutes and ANDed with 0x3F803F80
//             (bf16 1.0 in both halves), the Hopper form of the
//             prototype's int16 select of 0x3F80 and bitcast; the build
//             T5 and T1 use (OHW_A_BITS).
// r_tile is only where the tail is dropped: the kernel's row step is its
// own (256 rows at B = 64).
//
// Bound on the H100: bytes, 1,007,616 x 28 int32 bins (113 MB) + pos and
// gh, ~0.037 ms at 3.35 TB/s (u8bins ~0.012 ms); the product's
// tensor-core floor at M = 64, B = 64 is ~0.47 ms at 989 TFLOP/s, which
// bounds the kernel.
//
// C interface for ctypes: onehot_r4_launch returns a cudaError_t;
// variant 0 prod, 1 dotfloor, 2 u8bins, 3 i16hot.

#include "onehot_wgmma.cuh"

extern "C" int onehot_r4_launch(const WgmmaArgs* a, int variant,
                                int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
    case 2:
      return (int)onehot_wgmma_launch_fm<OHW_BF16, OHW_A_NUM, false>(
          a, n_row_blocks, s);
    case 1:
      return (int)onehot_wgmma_launch_n<128, 1, OHW_BF16, OHW_A_CONST, false,
                                        OHW_ST_FEAT>(a, n_row_blocks, s);
    case 3:
      return (int)onehot_wgmma_launch_n<128, 1, OHW_BF16, OHW_A_BITS, false,
                                        OHW_ST_FEAT>(a, n_row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* onehot_r4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
