// K1: one tree level's gradient histogram on Hopper (sm_90a).
//
// Replaces the TPU kernel xgboost_tpu/ops/pallas_hist.py:_hist_kernel,
// launched through _hist_pallas_pre.  Same function: for every row r with
// pos[r] >= 0 and every feature f, add (g[r], h[r]) into the cell
// [f, bins[r, f], channel, pos[r]] of a (F, B, 2, n_node) histogram -- the
// node-minor layout the TPU kernel writes for its split finder.
//
// The TPU kernel turns the scatter into one-hot matmuls because a scatter
// serializes on the MXU.  Here the scatter is direct: the kernel of
// hist_scatter.cuh at T = 1, the same code as K3 (hist_batched.cu), so a K3
// tree slice and a K1 launch on that tree's gh and pos add the same integers.
//
// What bounds it on the H100: per level the kernel must read the active
// rows' u8 bins (N*F bytes), every row's pos (4 N) and the active rows' gh
// (8 N): 40 MB at 1M x 28, ~12 us at 3.35 TB/s, against 56 M shared-memory
// additions (~8 us at one warp-wide atomic a clock on 132 SMs).  The
// earlier kernel here flushed every row block's histogram with global
// atomics (1.9 M onto 3,584 cells at the root, 6.5 M at 32 nodes) and
// re-read pos and gh for each of 10 feature tiles at 32 nodes; the scatter
// answers both (hist_scatter.cuh).  At a lanes tenant's 12-16k rows the
// launch itself is most of the time.
//
// C interface for ctypes: hist_level_launch and hist_level_resident return
// a cudaError_t (0 = ok).

#include "hist_scatter.cuh"

extern "C" int hist_level_launch(
    int mode, const void* bins, const void* pos, const void* gh, void* out,
    long long n_rows, int n_feat, int n_bin, int n_node, int f_tile,
    int m_tile, int copies, int n_groups, long long rows_per_copy,
    int rows_per_step, int hist_bytes, int store, void* stream) {
  const hist_scatter::Args a = hist_scatter::make_args(
      bins, pos, gh, out, n_rows, 0, n_feat, n_bin, 1, n_node, f_tile, 1,
      m_tile, copies, n_groups, rows_per_copy, rows_per_step, hist_bytes,
      store);
  return hist_scatter::launch_mode(mode, a, n_groups * copies,
                                   hist_scatter::smem_bytes(a), stream);
}

extern "C" int hist_level_resident(int mode, long long smem_bytes,
                                   int* blocks) {
  return hist_scatter::resident_mode(mode, smem_bytes, blocks);
}

extern "C" const char* hist_level_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code & 0xffff));
}
