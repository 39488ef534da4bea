// T4a and T4b on Hopper (sm_90a): the feature-paired and one-big bf16
// one-hot histograms.
//
// Replaces the TPU kernels of tools/hist_pack2_proto.py: build(mode,
// m_pad, r_tile) -> fn -> pl.pallas_call of make_kernel (T4a, modes
// "prod" and "pack2") and build_onebig(m_pad, r_tile) -> fn ->
// pl.pallas_call of make_onebig_kernel (T4b).  Same function for all
// three: bins (F, n) int32 feature-major, pos (n, 1) int32, gh (n, 2)
// f32 rounded to bf16; only the first (n // r_tile) * r_tile rows count
// (the prototypes' grid drops the rest); out (1, F * B, 2 * m_pad) f32,
// cell [0, f * B + b, c * m_pad + j] = sum of bf16(gh[r, c]) over rows
// with bins[f, r] == b and pos[r] == j (rows with pos outside [0, m_pad)
// and bins outside [0, B) add nothing).
//
// The prototypes put 1 ("prod"), 2 ("pack2") or all F ("onebig")
// features' one-hots into the rows of one MXU operand, so that one
// product fills more of the 128 x 128 unit.  Here all three are one
// launch of the wgmma one-hot product of onehot_wgmma.cuh in its bf16
// small-N form (shared with T3 and T2, which run it in s8):
// wgmma.mma_async.m64nNk16.f32.bf16.bf16 with N = 2 m_pad rounded up to
// 8, 16, 32 or 64 (M = 1-4: 8; M = 32: 64), M over the F Bp (feature,
// bin) rows, Bp = B rounded up to 16.  A warpgroup holds 7, 5, 3 or 2 M
// tiles, builds all their A fragments of a k16 step in registers (one
// byte permute of two words of staged bins, two SWAR compares with bins
// b and b + 8, four permutes and four ANDs with bf16 1.0), issues their
// products as one group and waits once; a block takes up to 28, 20, 12
// or 8 tiles, so at F = 28, B = 64 one block (N = 8) to four (N = 64)
// stage each row's pos and gh once for all their features: what the
// prototypes' grouping shares, a block shares whatever the mode.  f32
// sums, flushed with red.global.add.f32 (zero cells skipped).  Above 32
// nodes T6's i16hot instance (N = 128), in node tiles of 64 above 64.
// r_tile only says where the tail is dropped.
//
// Bound on the H100: bytes, 1,007,616 x 28 int32 bins (113 MB) + pos
// and gh: ~0.037 ms at 3.35 TB/s; the product's tensor-core floor
// (2 n F Bp N at 989 TFLOP/s) ~0.029 ms at M = 1-4, ~0.23 ms at M = 32.
// At small N the products' instruction count bounds the form (28 tiles
// x n / 16 k16 steps, twice T3's k32 count), then the A build.
//
// C interface for ctypes: onehot_pack2_launch returns a cudaError_t
// (0 = ok); variant 0 (every mode and T4b launch the same instance).

#include "onehot_wgmma.cuh"

extern "C" int onehot_pack2_launch(const WgmmaArgs* a, int variant,
                                   int n_row_blocks, void* stream) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return (int)onehot_wgmma_launch<1, OHW_BF16, OHW_ST_FEAT>(
      a, n_row_blocks, static_cast<cudaStream_t>(stream));
}

extern "C" const char* onehot_pack2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
