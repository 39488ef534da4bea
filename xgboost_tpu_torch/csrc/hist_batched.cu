// T trees' level histograms over ONE shared bins matrix, on Hopper (sm_90a).
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
// MXU against every tree's gradients, because the one-hot is the costly
// part there.  On Hopper the costly part shared by the trees is reading the
// row's bins, so the design is K1's privatized scatter widened over trees:
// one block per (row chunk, feature tile, tree tile x node tile) keeps a
// (f_tile, B, 2, t_tile, m_tile) histogram in shared memory; each thread
// takes a row, reads the row's pos and gh in each tree of its tile into
// registers (at most T_TILE_MAX trees), then reads each of the row's bins
// ONCE and adds every tree's (g, h) into its sub-histogram with
// shared-memory atomics.  The block flushes its non-zero cells into the
// zeroed output with global atomics.  Any T is taken: trees are tiled by
// the wrapper (grid z enumerates tree tile x node tile), as the TPU tiles
// them for its memory (_t_tile_of).
//
// Modes (template MODE), the same as K1:
//   0 fp32  -- f32 gh, f32 atomics (exact additions, run-to-run order).
//   1 bf16  -- g and h rounded to bf16 (__float2bfloat16_rn), f32 atomics.
//   2 int   -- pre-quantized int32 gh (per-tree int8 scales, or "fixed"),
//              int32 atomics: exact and order-free, so each tree's slice
//              equals a solo K1 launch bit for bit.
//
// Bound on the H100: bytes.  Per level the kernel must read the bins once
// (N*F u8), every tree's pos (4 T N) and gh (8 T N), and write the
// histogram (F*B*2*T*n_node*4): 23 MB at 200k x 28, T = 6, 32 nodes,
// B = 64, about 7 us at 3.35 TB/s, against T*N*F*2 additions (67 M, 1 us
// at the f32 rate).  What limits this simple version is shared memory: one
// feature's sub-histogram is B*2*t_tile*m_tile*4 bytes (98 KB at B = 64,
// 6 trees, 32 nodes), so deep levels run one feature per block and the
// per-row pos/gh are re-read once per feature tile (from L2); the wrapper
// opts in to up to 227 KB of dynamic shared memory per block.
//
// C interface for ctypes: hist_batched_launch returns a cudaError_t (0 = ok).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int T_TILE_MAX = 8;  // trees held in registers per row

template <int MODE>
struct Acc { typedef float type; };
template <>
struct Acc<2> { typedef int type; };

template <int MODE>
__global__ void hist_batched_kernel(const uint8_t* __restrict__ bins,
                                    const int32_t* __restrict__ pos,
                                    const void* __restrict__ gh,
                                    void* __restrict__ out,
                                    long long n_rows, int n_feat, int n_bin,
                                    int n_tree, int n_node, int f_tile,
                                    int t_tile, int m_tile,
                                    long long rows_per_block) {
  typedef typename Acc<MODE>::type T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);

  // grid z enumerates (tree tile, node tile) pairs, node tile minor
  const int n_m_tiles = (n_node + m_tile - 1) / m_tile;
  const int t0 = (blockIdx.z / n_m_tiles) * t_tile;
  const int m0 = (blockIdx.z % n_m_tiles) * m_tile;
  const int nt = min(t_tile, n_tree - t0);
  const int nm = min(m_tile, n_node - m0);
  const int f0 = blockIdx.y * f_tile;
  const int nf = min(f_tile, n_feat - f0);
  // cell (fl, b, c, k, j) at ((fl * B + b) * 2 + c) * tm + k * m_tile + j
  const int tm = t_tile * m_tile;
  const int cells = nf * n_bin * 2 * tm;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = T(0);
  __syncthreads();

  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > n_rows) r_end = n_rows;
  for (long long r = r_begin + threadIdx.x; r < r_end; r += blockDim.x) {
    // the row's slot (k * m_tile + j, or -1) and (g, h) in each tree of
    // the tile; inactive rows (pos < 0) and other node tiles fall outside
    int slot[T_TILE_MAX];
    T g[T_TILE_MAX], h[T_TILE_MAX];
    bool any = false;
#pragma unroll
    for (int k = 0; k < T_TILE_MAX; ++k) {
      slot[k] = -1;
      g[k] = T(0);
      h[k] = T(0);
      if (k < nt) {
        const long long tr = (long long)(t0 + k) * n_rows + r;
        const int j = pos[tr] - m0;
        if (j >= 0 && j < nm) {
          slot[k] = k * m_tile + j;
          any = true;
          if constexpr (MODE == 2) {
            const int2 v = static_cast<const int2*>(gh)[tr];
            g[k] = v.x;
            h[k] = v.y;
          } else {
            float2 v = static_cast<const float2*>(gh)[tr];
            if constexpr (MODE == 1) {
              v.x = __bfloat162float(__float2bfloat16_rn(v.x));
              v.y = __bfloat162float(__float2bfloat16_rn(v.y));
            }
            g[k] = v.x;
            h[k] = v.y;
          }
        }
      }
    }
    if (!any) continue;
    const uint8_t* row = bins + r * n_feat + f0;
    for (int fl = 0; fl < nf; ++fl) {
      const int b = row[fl];      // read once for every tree of the tile
      if (b >= n_bin) continue;   // never produced by binning; keeps smem safe
      T* cell = hist + ((fl * n_bin + b) * 2) * tm;
#pragma unroll
      for (int k = 0; k < T_TILE_MAX; ++k) {
        if (slot[k] >= 0) {
          atomicAdd(cell + slot[k], g[k]);
          atomicAdd(cell + tm + slot[k], h[k]);
        }
      }
    }
  }
  __syncthreads();

  // Flush.  Skipping zero cells is exact: a cell that received additions
  // is never -0 (the sum starts at +0), so leaving +0 out changes nothing;
  // padding slots (k >= nt or j >= nm) receive nothing and are skipped.
  T* o = reinterpret_cast<T*>(out);
  const long long out_cols = (long long)n_tree * n_node;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const T v = hist[i];
    if (v == T(0)) continue;
    const int s = i % tm;
    const int k = s / m_tile;
    const int j = s % m_tile;
    const int fbc = i / tm;  // (fl * B + b) * 2 + c
    const int fl = fbc / (2 * n_bin);
    const int bc = fbc % (2 * n_bin);
    const long long dst = ((long long)(f0 + fl) * 2 * n_bin + bc) * out_cols
                          + (long long)(t0 + k) * n_node + m0 + j;
    atomicAdd(o + dst, v);
  }
}

template <int MODE>
cudaError_t launch(const void* bins, const void* pos, const void* gh,
                   void* out, long long n_rows, int n_feat, int n_bin,
                   int n_tree, int n_node, int f_tile, int t_tile,
                   int m_tile, int n_row_blocks, long long rows_per_block,
                   int threads, size_t smem, cudaStream_t stream) {
  if (t_tile < 1 || t_tile > T_TILE_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_batched_kernel<MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_f_tiles = (n_feat + f_tile - 1) / f_tile;
  const int n_t_tiles = (n_tree + t_tile - 1) / t_tile;
  const int n_m_tiles = (n_node + m_tile - 1) / m_tile;
  dim3 grid(n_row_blocks, n_f_tiles, n_t_tiles * n_m_tiles);
  hist_batched_kernel<MODE><<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const int32_t*>(pos),
      gh, out, n_rows, n_feat, n_bin, n_tree, n_node, f_tile, t_tile,
      m_tile, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hist_batched_launch(int mode, const void* bins,
                                   const void* pos, const void* gh,
                                   void* out, long long n_rows, int n_feat,
                                   int n_bin, int n_tree, int n_node,
                                   int f_tile, int t_tile, int m_tile,
                                   int n_row_blocks, long long rows_per_block,
                                   int threads, long long smem_bytes,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  switch (mode) {
    case 0:
      return (int)launch<0>(bins, pos, gh, out, n_rows, n_feat, n_bin,
                            n_tree, n_node, f_tile, t_tile, m_tile,
                            n_row_blocks, rows_per_block, threads, smem, s);
    case 1:
      return (int)launch<1>(bins, pos, gh, out, n_rows, n_feat, n_bin,
                            n_tree, n_node, f_tile, t_tile, m_tile,
                            n_row_blocks, rows_per_block, threads, smem, s);
    case 2:
      return (int)launch<2>(bins, pos, gh, out, n_rows, n_feat, n_bin,
                            n_tree, n_node, f_tile, t_tile, m_tile,
                            n_row_blocks, rows_per_block, threads, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hist_batched_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
