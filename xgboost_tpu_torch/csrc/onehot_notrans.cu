// T2 on Hopper (sm_90a): the no-transpose int8 one-hot histogram prototype.
//
// Replaces the TPU kernel of tools/hist_notrans_proto.py: build -> fn ->
// pl.pallas_call of make_kernel.  Same function as T3 (onehot_i8.cu) on
// the original row-major (n, F) u8 bins: pos (n, 1) int32, gh (n, 2)
// int32 wrapped to int8, the first (n // r_tile) * r_tile rows, out
// (1, F * B, 2 * m_pad) int32.  No transpose, no copy.
//
// The kernel is T3's: the wgmma s8 product of onehot_wgmma.cuh in its
// small-N form (N = 8-64; N = 128, T7's instance, above 32 nodes).  What
// differs is the staging into the block's [feature][row] byte stage.
// Where a row's F bytes are whole words (F % 4 == 0 and the bins 4-byte
// aligned: the main's F = 28), a thread loads one word, four features of
// one row, and stores its bytes into their features' rows; neighbouring
// threads take neighbouring rows of the same word, so a warp's loads
// fall on one run of rows and each of its byte stores on 32 consecutive
// bytes of one feature (no bank conflict).  Otherwise (F = 3, 5) each
// (row, feature) byte is a load of its own, with rows inner.  r_tile only
// says where the tail is dropped.
//
// Bound on the H100: bytes, 1,007,616 x 28 u8 bins + pos + gh, about 40
// MB: ~0.012 ms at 3.35 TB/s; the product's int8 tensor-core floor 0.015
// ms at N = 8 to 0.117 ms at N = 64; at small N the A build (onehot_i8.cu)
// bounds the kernel.
//
// C interface for ctypes: onehot_notrans_launch returns a cudaError_t;
// variant 0 (the wrapper sets vec where the rows are whole words).

#include "onehot_wgmma.cuh"

extern "C" int onehot_notrans_launch(const WgmmaArgs* a, int variant,
                                     int n_row_blocks, void* stream) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->vec ? onehot_wgmma_launch_s8<OHW_ST_RWORD>(a, n_row_blocks,
                                                             s)
                      : onehot_wgmma_launch_s8<OHW_ST_FEAT>(a, n_row_blocks,
                                                            s));
}

extern "C" const char* onehot_notrans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
