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
// The prototype's knobs, on Hopper:
//   mode "prod"   widens each staged u8 bin to int and compares it alone;
//   mode "u8cmp"  compares the four bins packed in one 32-bit word at once
//                 (SWAR bit logic) -- the packed compare that failed to
//                 compile on the TPU, and the one T5, T3 and T2 use here;
//   n_levels > 1  builds each one-hot fragment once per 32 rows and
//                 multiplies it against all the levels' gh_exp fragments
//                 (up to 6 levels per task, one column tile each); a
//                 level's node bytes are the staged pos mod 64 plus lv,
//                 masked.
//
// Bound on the H100: bytes, 1,001,472 x 28 u8 bins + pos + gh, ~40 MB,
// ~0.012 ms at 3.35 TB/s; with 6 levels 5.5 MB more of output.
//
// C interface for ctypes: onehot_r5_launch returns a cudaError_t (0 = ok);
// variant = 2 * (mode == "u8cmp") + (n_levels > 1).

#include "onehot_mma.cuh"

extern "C" int onehot_r5_launch(const OnehotArgs* a, int variant,
                                int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return (int)onehot_launch<OH_INT8, uint8_t, false, 4, 1>(
          a, n_row_blocks, s);
    case 1:
      return (int)onehot_launch<OH_INT8, uint8_t, false, 1, 6>(
          a, n_row_blocks, s);
    case 2:
      return (int)onehot_launch<OH_INT8, uint8_t, true, 4, 1>(
          a, n_row_blocks, s);
    case 3:
      return (int)onehot_launch<OH_INT8, uint8_t, true, 1, 6>(
          a, n_row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* onehot_r5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
