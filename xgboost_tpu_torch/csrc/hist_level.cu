// One tree level's gradient histogram on Hopper (sm_90a).
//
// Replaces the TPU kernel xgboost_tpu/ops/pallas_hist.py:_hist_kernel,
// launched through _hist_pallas_pre.  Same function: for every row r with
// pos[r] >= 0 and every feature f, add (g[r], h[r]) into the cell
// [f, bins[r, f], channel, pos[r]] of a (F, B, 2, n_node) histogram -- the
// node-minor layout the TPU kernel writes for its split finder.
//
// The TPU kernel turns the scatter into one-hot matmuls because a scatter
// serializes on the MXU.  Here the scatter is direct: one block per
// (row chunk, feature tile, node tile of <= 64 nodes) keeps a private
// (f_tile, B, 2, m_tile) histogram in shared memory, threads stride the
// chunk's rows and add with shared-memory atomics, and the block flushes
// its non-zero cells into the output with global atomics.
//
// Modes (template MODE): fp32 (0), bf16 (1) and int (2), as hist_block.cuh
// states them; the block's work itself is hist_block, shared with K4.
//
// Bound on the H100: bytes.  Per level the kernel must read the active
// rows' u8 bins (N*F bytes), every row's pos (4 N) and the active rows'
// gh (8 N): 40 MB at 1M x 28, about 12 us at 3.35 TB/s, against 56 M
// additions (under 1 us at the f32 rate).  What limits it in practice is
// shared-memory atomic contention on hot cells (at the root level every
// row of a block lands in one node) and the global flush, whose size
// grows with the node count.
//
// C interface for ctypes: hist_level_launch returns a cudaError_t (0 = ok).

#include "hist_block.cuh"

namespace {

template <int MODE>
__global__ void hist_level_kernel(const uint8_t* __restrict__ bins,
                                  const int32_t* __restrict__ pos,
                                  const void* __restrict__ gh,
                                  void* __restrict__ out,
                                  long long n_rows, int n_feat, int n_bin,
                                  int n_node, int f_tile, int m_tile,
                                  long long rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f0 = blockIdx.y * f_tile;
  const int m0 = blockIdx.z * m_tile;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > n_rows) r_end = n_rows;
  hist_block<MODE>(bins, pos, gh, out, r_begin, r_end, n_feat, n_bin, f0,
                   min(f_tile, n_feat - f0), m0, min(m_tile, n_node - m0),
                   m_tile, n_node, m0, smem_raw);
}

template <int MODE>
cudaError_t launch(const void* bins, const void* pos, const void* gh,
                   void* out, long long n_rows, int n_feat, int n_bin,
                   int n_node, int f_tile, int m_tile, int n_row_blocks,
                   long long rows_per_block, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t e = allow_smem(hist_level_kernel<MODE>, smem);
  if (e != cudaSuccess) return e;
  const int n_f_tiles = (n_feat + f_tile - 1) / f_tile;
  const int n_m_tiles = (n_node + m_tile - 1) / m_tile;
  dim3 grid(n_row_blocks, n_f_tiles, n_m_tiles);
  hist_level_kernel<MODE><<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const int32_t*>(pos),
      gh, out, n_rows, n_feat, n_bin, n_node, f_tile, m_tile,
      rows_per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hist_level_launch(int mode, const void* bins, const void* pos,
                                 const void* gh, void* out, long long n_rows,
                                 int n_feat, int n_bin, int n_node,
                                 int f_tile, int m_tile, int n_row_blocks,
                                 long long rows_per_block, int threads,
                                 long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  switch (mode) {
    case 0:
      return (int)launch<0>(bins, pos, gh, out, n_rows, n_feat, n_bin,
                            n_node, f_tile, m_tile, n_row_blocks,
                            rows_per_block, threads, smem, s);
    case 1:
      return (int)launch<1>(bins, pos, gh, out, n_rows, n_feat, n_bin,
                            n_node, f_tile, m_tile, n_row_blocks,
                            rows_per_block, threads, smem, s);
    case 2:
      return (int)launch<2>(bins, pos, gh, out, n_rows, n_feat, n_bin,
                            n_node, f_tile, m_tile, n_row_blocks,
                            rows_per_block, threads, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hist_level_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
