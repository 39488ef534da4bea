// T7 on Hopper (sm_90a): the round-5 int8 one-hot histogram A/B.
//
// Replaces the TPU kernel of tools/hist_r5_ab.py: build(mode, n_bin,
// n_levels) -> fn -> pl.pallas_call of make_kernel.  Same function: bins
// (F, n) u8 feature-major, pos (1, n) int32, gh (2, n) int32 wrapped to
// int8, M = 64 nodes, the first (n // 2048) * 2048 rows; out (n_levels,
// F * B, 128) int32.  With n_levels == 1 row r is active in node j iff
// pos[r] == j; with n_levels > 1, in level lv iff floor_mod(pos[r] + lv,
// M) == j, so pad rows (pos = -1) count in node M - 1 at level 0 and in
// node lv - 1 after, as in the prototype.
//
// The kernel is the wgmma one-hot product of onehot_wgmma.cuh (shared
// with T5, T1 and T6) in s8: wgmma.mma_async.m64n128k32.s32.s8.s8, gh_exp
// the low bytes of gh, s32 sums without .satfinite (they wrap, as the
// prototype's int32 sums do), flushed with red.global.add.s32: bitwise
// the same from run to run.  The prototype's knobs, on Hopper:
//   mode "prod"   each staged u8 bin widened to int and compared alone,
//                 the four 0 / 1 results packed into a register of the A
//                 fragment (OHW_A_NUM);
//   mode "u8cmp"  the four bins of a register compared at once (SWAR),
//                 the flags shifted to 0x01 bytes, which is the register
//                 (OHW_A_BITS) -- the packed compare that failed to
//                 compile on the TPU;
//   n_levels > 1  the levels form: the block builds each M tile's s8
//                 one-hot once a row step into shared memory, and each
//                 warpgroup multiplies its tile against one level's
//                 gh_exp tile (the prototype's shared6 restructure: one
//                 one-hot for all the levels a block covers).
//
// Bound on the H100: bytes, 1,001,472 x 28 u8 bins + pos + gh, ~40 MB,
// ~0.012 ms at 3.35 TB/s (with 6 levels 5.5 MB more of output); the
// product's int8 tensor-core floor, 2 n F Bp 128 a level at 1,979
// TOP/s, ~0.23-0.27 ms a level at B = 64-67, bounds the kernel.
//
// C interface for ctypes: onehot_r5_launch returns a cudaError_t (0 = ok);
// variant = 2 * (mode == "u8cmp") + (n_levels > 1).

#include "onehot_wgmma.cuh"

extern "C" int onehot_r5_launch(const WgmmaArgs* a, int variant,
                                int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return (int)onehot_wgmma_launch_fm<OHW_S8, OHW_A_NUM, false>(
          a, n_row_blocks, s);
    case 1:
      return (int)onehot_wgmma_launch_fm<OHW_S8, OHW_A_NUM, true>(
          a, n_row_blocks, s);
    case 2:
      return (int)onehot_wgmma_launch_fm<OHW_S8, OHW_A_BITS, false>(
          a, n_row_blocks, s);
    case 3:
      return (int)onehot_wgmma_launch_fm<OHW_S8, OHW_A_BITS, true>(
          a, n_row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* onehot_r5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
