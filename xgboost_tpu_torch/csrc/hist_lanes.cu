// L tenants' level histograms in ONE launch, on Hopper (sm_90a).
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
// padded row count (pad rows carry pos = -1).  So K4 is K1's privatized
// shared-memory scatter with a lane index in the grid: one block per
// (lane, row chunk, feature tile, node tile) runs hist_block (shared with
// K1, hist_block.cuh) over that lane's rows and flushes into the lane's
// columns with global atomics.  The TPU kernel's row-tile packing of the
// lanes is TPU layout and is not carried over.
//
// Modes as K1 (hist_block.cuh).  In mode int each lane's slice is bitwise
// a solo K1 launch on that lane's rows: integer sums are exact and
// order-free, and pad rows and pad lanes (every row at pos = -1) add
// nothing.
//
// Bound on the H100: bytes.  Per level the kernel must read every row's
// pos (4 L N), the active rows' bins and gh (F + 8 bytes each) and write
// the histogram (F * B * 2 * L * n_node * 4): 48 tenants of ~14k rows in
// a stack of 64 x 16,384 rows, 28 features, B = 64, at depth 5 that is
// about 58 MB (29 MB of it the output), ~0.017 ms at 3.35 TB/s, against 2
// additions per active (row, feature), under 1 us at the f32 rate.
//
// C interface for ctypes: hist_lanes_launch returns a cudaError_t (0 = ok).

#include "hist_block.cuh"

namespace {

template <int MODE>
__global__ void hist_lanes_kernel(const uint8_t* __restrict__ bins,
                                  const int32_t* __restrict__ pos,
                                  const void* __restrict__ gh,
                                  void* __restrict__ out, int n_lane,
                                  long long n_rows, int n_feat, int n_bin,
                                  int n_node, int f_tile, int m_tile,
                                  int n_row_blocks,
                                  long long rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // grid x enumerates (lane, row block), row block minor
  const int lane = blockIdx.x / n_row_blocks;
  const int rb = blockIdx.x % n_row_blocks;
  const int f0 = blockIdx.y * f_tile;
  const int m0 = blockIdx.z * m_tile;
  const long long r_begin = (long long)rb * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > n_rows) r_end = n_rows;
  const long long row0 = (long long)lane * n_rows;
  // gh rows are 8 bytes (float2 or int2) in every mode
  const void* lane_gh = static_cast<const char*>(gh) + row0 * 8;
  hist_block<MODE>(bins + row0 * n_feat, pos + row0, lane_gh, out, r_begin,
                   r_end, n_feat, n_bin, f0, min(f_tile, n_feat - f0), m0,
                   min(m_tile, n_node - m0), m_tile,
                   (long long)n_lane * n_node, (long long)lane * n_node + m0,
                   smem_raw);
}

template <int MODE>
cudaError_t launch(const void* bins, const void* pos, const void* gh,
                   void* out, int n_lane, long long n_rows, int n_feat,
                   int n_bin, int n_node, int f_tile, int m_tile,
                   int n_row_blocks, long long rows_per_block, int threads,
                   size_t smem, cudaStream_t stream) {
  cudaError_t e = allow_smem(hist_lanes_kernel<MODE>, smem);
  if (e != cudaSuccess) return e;
  const int n_f_tiles = (n_feat + f_tile - 1) / f_tile;
  const int n_m_tiles = (n_node + m_tile - 1) / m_tile;
  dim3 grid((unsigned)n_lane * n_row_blocks, n_f_tiles, n_m_tiles);
  hist_lanes_kernel<MODE><<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const int32_t*>(pos),
      gh, out, n_lane, n_rows, n_feat, n_bin, n_node, f_tile, m_tile,
      n_row_blocks, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hist_lanes_launch(int mode, const void* bins, const void* pos,
                                 const void* gh, void* out, int n_lane,
                                 long long n_rows, int n_feat, int n_bin,
                                 int n_node, int f_tile, int m_tile,
                                 int n_row_blocks, long long rows_per_block,
                                 int threads, long long smem_bytes,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  switch (mode) {
    case 0:
      return (int)launch<0>(bins, pos, gh, out, n_lane, n_rows, n_feat,
                            n_bin, n_node, f_tile, m_tile, n_row_blocks,
                            rows_per_block, threads, smem, s);
    case 1:
      return (int)launch<1>(bins, pos, gh, out, n_lane, n_rows, n_feat,
                            n_bin, n_node, f_tile, m_tile, n_row_blocks,
                            rows_per_block, threads, smem, s);
    case 2:
      return (int)launch<2>(bins, pos, gh, out, n_lane, n_rows, n_feat,
                            n_bin, n_node, f_tile, m_tile, n_row_blocks,
                            rows_per_block, threads, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hist_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
