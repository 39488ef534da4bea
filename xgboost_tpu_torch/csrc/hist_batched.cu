// K3: T trees' level histograms over ONE shared bins matrix, on Hopper
// (sm_90a).
//
// Replaces the TPU kernel xgboost_tpu/ops/pallas_hist.py:_batched_hist_kernel,
// launched through _hist_pallas_batched_pre (entries
// build_level_histogram_pallas_batched and _hist_pallas_batched_prequant).
// Same function: for every tree t, every row r with pos[t, r] >= 0 and every
// feature f, add (g[t, r], h[t, r]) into the cell
// [f, bins[r, f], channel, t * n_node + pos[t, r]] of a
// (F, B, 2, T * n_node) histogram -- tree outer, node inner in the last
// axis, so the split finder reads T * n_node independent "nodes" at once.
//
// The TPU kernel builds each feature's one-hot once and contracts it on the
// MXU against every tree's gradients.  Here the function is the scatter of
// hist_scatter.cuh, which K1 (hist_level.cu) launches at T = 1: any T, the
// trees tiled with the features and nodes by the wrapper's plan
// (ops/cuda_hist_batched.py:scatter_plan).
//
// What bounds it on the H100: per level the kernel must read the bins once
// (N*F u8), every tree's pos (4 T N) and gh (8 T N) and write the histogram
// (23 MB at 200k x 28, T = 6, 32 nodes, B = 64: ~7 us at 3.35 TB/s), and do
// T*N*F*2 shared-memory additions (67 M, ~9 us at one warp-wide atomic a
// clock on 132 SMs).  The earlier kernel here spent 33x its byte bound on a
// flush of 11-13 M global atomics a level, two waves of blocks, and pos and
// gh re-read for every feature.  The scatter answers each
// (hist_scatter.cuh): one wave of resident blocks, units chosen by the
// bytes they move, and one flush a block and unit.
//
// C interface for ctypes: hist_batched_launch and hist_batched_resident
// return a cudaError_t (0 = ok).

#include "hist_scatter.cuh"

extern "C" int hist_batched_launch(
    int mode, const void* bins, const void* pos, const void* gh, void* out,
    long long n_rows, int n_feat, int n_bin, int n_tree, int n_node,
    int f_tile, int t_tile, int m_tile, int copies, int n_groups,
    long long rows_per_copy, int rows_per_step, int hist_bytes, int store,
    void* stream) {
  const hist_scatter::Args a = hist_scatter::make_args(
      bins, pos, gh, out, n_rows, 0, n_feat, n_bin, n_tree, n_node, f_tile,
      t_tile, m_tile, copies, n_groups, rows_per_copy, rows_per_step,
      hist_bytes, store);
  return hist_scatter::launch_mode(mode, a, n_groups * copies,
                                   hist_scatter::smem_bytes(a), stream);
}

extern "C" int hist_batched_resident(int mode, long long smem_bytes,
                                     int* blocks) {
  return hist_scatter::resident_mode(mode, smem_bytes, blocks);
}

extern "C" const char* hist_batched_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code & 0xffff));
}
