// K4: L tenants' level histograms in ONE launch, on Hopper (sm_90a).
//
// Replaces the TPU kernel xgboost_tpu/ops/pallas_hist.py:_hist_pallas_lanes_pre
// (the lane-stacked launch of _hist_kernel; raw-operand entry
// build_level_histogram_pallas_lanes).  Same function: for every lane l,
// every row r with pos[l, r] >= 0 and every feature f, add
// (g[l, r], h[l, r]) into the cell [f, bins[l, r, f], channel,
// l * n_node + pos[l, r]] of a (F, B, 2, L * n_node) histogram -- lane
// outer, node inner in the last axis, so the split finder runs once over
// the L * n_node columns of every tenant.
//
// Unlike the trees of K3, lanes share no rows: each tenant has its own
// (N, F) u8 bins (0 = missing), (N, 2) gh and (N,) pos, N the bucket's
// padded row count (pad rows and pad lanes carry pos = -1).  So K4 is the
// scatter kernel of hist_scatter.cuh (K1's and K3's) with the lanes as its
// trees and a bins stride of N rows between them: units of f_tile features
// x t_tile lanes x m_tile nodes, planned by ops/cuda_hist_batched.py:
// scatter_plan (shared_bins=False), one wave of resident blocks, each
// step listing only the in-tile (row, lane) pairs, so pad rows and pad
// lanes cost one read of their pos and no addition.  The TPU kernel's
// row-tile packing of the lanes is TPU layout and is not carried over.
//
// Modes as K1 (hist_scatter.cuh).  In mode int each lane's slice is bitwise
// a solo K1 launch on that lane's rows: integer sums are exact and
// order-free.
//
// Bound on the H100: bytes.  Per level the kernel must read every row's
// pos (4 L N), the active rows' bins and gh (F + 8 bytes each) and write
// the histogram (F * B * 2 * L * n_node * 4): 48 tenants of ~14k rows in
// a stack of 64 x 16,384 rows, 28 features, B = 64, at depth 5 that is
// about 58 MB (29 MB of it the output), ~0.017 ms at 3.35 TB/s, against 2
// shared-memory additions per active (row, feature), 38 M at that level
// (~5 us at one warp-wide atomic a clock on 132 SMs).  The output is most
// of the bytes at the deep levels, where the plan has more units than
// resident blocks and so one copy a unit: there the flush stores it once
// (hist_scatter.cuh) instead of a memset and up to 7 M global atomics.
// The earlier kernel here (a block per lane, row chunk and feature tile,
// a 48 KB histogram each) re-read pos and gh for each of 10 feature tiles
// at 32 nodes and flushed every row chunk's histogram with atomics.
//
// C interface for ctypes: hist_lanes_launch and hist_lanes_resident return
// a cudaError_t (0 = ok).

#include "hist_scatter.cuh"

extern "C" int hist_lanes_launch(
    int mode, const void* bins, const void* pos, const void* gh, void* out,
    long long n_rows, int n_feat, int n_bin, int n_lane, int n_node,
    int f_tile, int t_tile, int m_tile, int copies, int n_groups,
    long long rows_per_copy, int rows_per_step, int hist_bytes, int store,
    void* stream) {
  const hist_scatter::Args a = hist_scatter::make_args(
      bins, pos, gh, out, n_rows, n_rows, n_feat, n_bin, n_lane, n_node,
      f_tile, t_tile, m_tile, copies, n_groups, rows_per_copy, rows_per_step,
      hist_bytes, store);
  return hist_scatter::launch_mode(mode, a, n_groups * copies,
                                   hist_scatter::smem_bytes(a), stream);
}

extern "C" int hist_lanes_resident(int mode, long long smem_bytes,
                                   int* blocks) {
  return hist_scatter::resident_mode(mode, smem_bytes, blocks);
}

extern "C" const char* hist_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code & 0xffff));
}
