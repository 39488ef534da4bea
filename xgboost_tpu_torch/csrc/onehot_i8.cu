// T3 on Hopper (sm_90a): the int8 one-hot histogram prototype.
//
// Replaces the TPU kernel of tools/hist_int8_proto.py: build_i8 -> fn ->
// pl.pallas_call of make_i8_kernel.  Same function: bins (F, n) int32
// feature-major, pos (n, 1) int32, gh (n, 2) int32 wrapped to int8; only
// the first (n // r_tile) * r_tile rows count (the prototype's grid drops
// the rest); out (1, F * B, 2 * m_pad) int32, cell [0, f * B + b,
// c * m_pad + j] = sum of int8(gh[r, c]) over rows with bins[f, r] == b
// and pos[r] == j; a bin outside [0, B) adds nothing to its feature.
//
// The kernel is the wgmma one-hot product of onehot_wgmma.cuh in s8
// (wgmma.mma_async.m64nNk32.s32.s8.s8), gh_exp the low bytes of gh, s32
// sums that wrap, flushed with red.global.add.s32: bitwise the same from
// run to run.  M runs over the F Bp (feature, bin) rows, N = 2 m_pad
// rounded up to 8, 16, 32 or 64 (M = 1-4: 8; M = 32: 64); above 32 nodes
// N = 128 in node tiles of 64, T7's instance.  The small-N form: Bp = B
// rounded up to 16, a warpgroup holds 7, 5, 3 or 2 M tiles (N = 8, 16,
// 32, 64), builds all their A fragments of a k32 step in registers by
// SWAR byte compares (two words of staged bytes a tile), issues their
// products as one group and waits once; a block takes up to 28, 20, 12
// or 8 tiles, so at F = 28, B = 64 one block (N = 8) to four (N = 64)
// stage each row's pos and gh and build its gh_exp entries.  The int32
// bins are staged with rows inner, one element a load, as bytes (a bin
// outside [0, 256) becomes 255, which no bin < B <= 255 matches), 128 rows
// a step at 28 features.  r_tile only says where the tail is dropped.
//
// Bound on the H100: bytes, 1,007,616 x 28 int32 bins (113 MB) + pos and
// gh: ~0.037 ms at 3.35 TB/s; the product's int8 tensor-core floor, 2 n F
// Bp N at 1,979 TOP/s, 0.015 ms at N = 8 to 0.117 ms at N = 64.  The A
// build, about 22 integer instructions a thread a tile and k32 step (28
// tiles x n / 32 steps x 4 warps), is of the same order at small N: it is
// what bounds the kernel there.
//
// C interface for ctypes: onehot_i8_launch returns a cudaError_t (0 = ok);
// variant 0.

#include "onehot_wgmma.cuh"

extern "C" int onehot_i8_launch(const WgmmaArgs* a, int variant,
                                int n_row_blocks, void* stream) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return (int)onehot_wgmma_launch_s8<OHW_ST_FEAT>(
      a, n_row_blocks, static_cast<cudaStream_t>(stream));
}

extern "C" const char* onehot_i8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
