// T1 on Hopper (sm_90a): the feature-grouped bf16 one-hot histogram.
//
// Replaces the TPU kernel of tools/hist_group_proto.py: grouped ->
// pl.pallas_call of _grouped_kernel.  Same function: bins (N, F) row-major
// int32, gh (N, 2) f32, pos (N,) int32, any n_node in node tiles of
// m_pad = min(n_node, 64); out node-major (n_node, F, n_bin, 2) f32,
// written in place by the flush.  Rows with pos < 0 or pos >= n_node add
// nothing; a (row, feature) whose bin lies outside [0, n_bin) adds
// nothing to that feature and still counts in the others.  No row is
// dropped (the prototype pads to its r_tile).
//
// The prototype concatenates fg features' one-hots into one (fg * b_pad,
// R) operand so that one MXU product serves fg features.  On Hopper the
// wgmma kernel of onehot_wgmma.cuh (shared with T5, onehot_variant.cu)
// concatenates every feature's one-hot along M, (F * Bp, R), and a block
// stages its rows once for all the features its M tiles cover, so the
// prototype's knobs change nothing here:
//   fg         moot: a block's features are those of its M tiles;
//   r_tile     moot: the kernel's row step is its own;
//   hot_dtype  none: gh is rounded to bf16 in either case, as the TPU's
//              Precision.DEFAULT rounds an f32 operand, and the one-hot
//              is 0 / 1 in any type.
//
// Bound on the H100: bytes, 1M x 28 int32 bins (112 MB) + pos + gh +
// the 0.96 MB output: ~0.037 ms at 3.35 TB/s; the product's tensor-core
// floor at n_node = 64, B = 67 -> Bp = 72 is ~0.52 ms in bf16 (989
// TFLOP/s).
//
// C interface for ctypes: onehot_group_launch returns a cudaError_t;
// variant 0 is the only one (bf16).

#include "onehot_wgmma.cuh"

extern "C" int onehot_group_launch(const WgmmaArgs* a, int variant,
                                   int n_row_blocks, void* stream) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return (int)onehot_wgmma_launch<1, OHW_BF16, OHW_ST_ROWS>(
      a, n_row_blocks, static_cast<cudaStream_t>(stream));
}

extern "C" const char* onehot_group_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
