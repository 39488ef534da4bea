// T5 on Hopper (sm_90a): the one-hot histogram microbenchmark variant.
//
// Replaces the TPU kernel of tools/hist_microbench.py: variant ->
// pl.pallas_call of _variant_kernel.  Same function: bins (N, F) row-major
// int32 or int16, gh (N, 2) f32, pos (N,) int32, any n_node in node tiles
// of m_pad = min(n_node, 64) nodes; out node-major (n_node, F, B, 2) f32,
// written in place by the flush (no transpose afterwards).  Rows with
// pos < 0 or pos >= n_node add nothing; a bin outside [0, B) adds nothing.
//
// The kernel is the wgmma one-hot product of onehot_wgmma.cuh (shared with
// T1, onehot_group.cu).  The prototype's knobs, on Hopper:
//   precision "bf16" (or hot_dtype bfloat16): gh rounded to bf16, one
//       wgmma per A fragment (variant 0);
//   precision "fp32" with an f32 one-hot: gh split exactly into three
//       bf16 parts, three wgmma into one f32 sum (variant 1), the analog
//       of Precision.HIGHEST.  The one-hot is 0/1 in any type, so
//       hot_dtype has no other meaning here;
//   bin_dtype: the width of the bins the kernel reads, int32 or int16;
//   r_tile: no effect (the kernel's row step is its own).
//
// Bound on the H100: bytes, 1M x 28 int32 bins (112 MB) + pos + gh + the
// 0.96 MB output: ~0.037 ms at 3.35 TB/s (int16 bins ~0.021 ms); the
// product's tensor-core floor at n_node = 64, B = 67 -> Bp = 72 is ~0.52
// ms in bf16, three times that in the exact mode.
//
// C interface for ctypes: onehot_variant_launch returns a cudaError_t.

#include "onehot_wgmma.cuh"

extern "C" int onehot_variant_launch(const WgmmaArgs* a, int variant,
                                     int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return (int)onehot_wgmma_launch<1, OHW_BF16, OHW_ST_ROWS>(
          a, n_row_blocks, s);
    case 1:
      return (int)onehot_wgmma_launch<3, OHW_BF16, OHW_ST_ROWS>(
          a, n_row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* onehot_variant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
