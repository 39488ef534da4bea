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
// product is mma.sync m16n8k16 bf16 x bf16 -> f32 on 16-bin tiles, so
// there is nothing to concatenate; what a group shares here is the other
// operand: the grouped kernel of onehot_mma.cuh stages each row's node
// and gh once for fg features and builds the gh_exp B fragments of a row
// once per group into shared memory, where every warp multiplies them
// against its own features' one-hot tiles.
//
// The prototype's knobs, on Hopper:
//   fg         features per task (blockIdx.x: the feature group); a warp
//              takes fg x 5 / 8 (feature, bin tile) units, so the larger
//              the group, the fewer column tiles a task takes (16 / PW
//              for PW units a warp) and the more often a one-hot
//              fragment is rebuilt for another column group;
//   r_tile     rows staged per block step: 1,024 or 2,048; 4,096 is
//              staged as two steps of 2,048 (the prototype pads, so the
//              tile changes no result);
//   hot_dtype  none: gh is rounded to bf16 in either case, as the TPU's
//              Precision.DEFAULT rounds an f32 operand, and the one-hot
//              is 0 / 1 in any type.
//
// Bound on the H100: bytes, 1M x 28 int32 bins (112 MB) + pos + gh +
// the 0.96 MB output: ~0.037 ms at 3.35 TB/s; the product's tensor-core
// floor at n_node = 64, B = 67 -> 80 is ~0.58 ms in bf16 (989 TFLOP/s).
//
// C interface for ctypes: onehot_group_launch returns a cudaError_t;
// variant v takes 2^v units a warp (onehot_mma.cuh).

#include "onehot_mma.cuh"

extern "C" int onehot_group_launch(const OnehotArgs* a, int variant,
                                   int n_row_blocks, void* stream) {
  return (int)onehot_group_dispatch(a, variant, n_row_blocks,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* onehot_group_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
