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
// product fills more of the 128 x 128 unit.  On Hopper the product runs
// on 16-bin tiles whatever the grouping; what a group shares here is the
// staged rows and the gh_exp B fragments, built once per group into
// shared memory by the grouped kernel of onehot_mma.cuh:
//   prod    FG = 1: 4 (feature, bin tile) units of B = 64, two warps on
//           each (they split the rows);
//   pack2   FG = 2: 8 units, a warp each;
//   onebig  FG = F (112 units at F = 28, B = 64: 16 a warp), the whole
//           (F * B, R) operand in one task; the budget of 64 accumulator
//           registers leaves such a task one column tile, so at M > 4 the
//           one-hot is rebuilt once per column tile of 8.
// r_tile is the row step (1,024 or 2,048) and the granularity at which
// the tail is dropped.
//
// Bound on the H100: bytes, 1,007,616 x 28 int32 bins (113 MB) + pos
// and gh: ~0.037 ms at 3.35 TB/s; the product's tensor-core floor
// (2 n F 64 2M_pad at 989 TFLOP/s) ~0.029 ms at M = 1-4, ~0.23 ms at
// M = 32.
//
// C interface for ctypes: onehot_pack2_launch returns a cudaError_t;
// variant v takes 2^v units a warp (onehot_mma.cuh).

#include "onehot_mma.cuh"

extern "C" int onehot_pack2_launch(const OnehotArgs* a, int variant,
                                   int n_row_blocks, void* stream) {
  return (int)onehot_group_dispatch(a, variant, n_row_blocks,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* onehot_pack2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
