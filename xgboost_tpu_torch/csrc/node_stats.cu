// Per-node (G, H) sums of T trees' rows on Hopper (sm_90a), deterministic.
//
// Replaces the TPU kernel xgboost_tpu/ops/pallas_hist.py:_nst_kernel,
// launched through node_stats_pallas (vmapped over the trees of an
// ensemble round).  Same function: out[t, m, c] = sum of gh[t, r, c] over
// the rows r with pos[t, r] == m; rows with pos < 0 are dropped.  f32 in,
// f32 out, (T, N, 2) gh, (T, N) pos, (T, n_node, 2) out.
//
// The TPU kernel is a ones-matmul on the MXU.  Here it is a segmented sum
// in two passes with a fixed order, so the result is the same bits from run
// to run (float atomics would not be):
//   pass 1, grid (row block, tree, node tile of NODE_TILE nodes): each
//     thread sums its rows (r0 + tid, r0 + tid + THREADS, ...) per node in
//     registers, then the block sums its threads with a fixed tree
//     reduction in shared memory and writes one partial per
//     (block, tree, node, channel) to part (n_blocks, T, n_node, 2);
//   pass 2: one thread per (tree, node, channel) adds the blocks' partials
//     in block order.
// The row blocks depend only on N (ROWS_PER_BLOCK), not on the card.
//
// Bound on the H100: bytes.  The sums need pos (4 T N) and gh (8 T N)
// once: 2.4 MB at 200k rows x 1 tree, under 1 us at 3.35 TB/s; one
// addition per row and channel is far below the f32 rate.  At the depth-0
// boosters that call it the launch itself dominates; the design keeps it
// to two launches whatever T.
//
// C interface for ctypes: node_stats_launch returns a cudaError_t (0 = ok).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NODE_TILE = 8;  // nodes summed in registers per pass

__global__ void node_stats_partial(const int32_t* __restrict__ pos,
                                   const float2* __restrict__ gh,
                                   float* __restrict__ part,
                                   long long n_rows, int n_tree, int n_node,
                                   long long rows_per_block) {
  __shared__ float red[2 * NODE_TILE][THREADS];
  const int t = blockIdx.y;
  const int m0 = blockIdx.z * NODE_TILE;
  float acc[2 * NODE_TILE];
#pragma unroll
  for (int q = 0; q < 2 * NODE_TILE; ++q) acc[q] = 0.0f;

  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > n_rows) r_end = n_rows;
  for (long long r = r_begin + threadIdx.x; r < r_end; r += THREADS) {
    const long long tr = (long long)t * n_rows + r;
    const int j = pos[tr] - m0;   // pos < 0 and other tiles fall outside
    if (j < 0 || j >= NODE_TILE) continue;
    const float2 v = gh[tr];
#pragma unroll
    for (int k = 0; k < NODE_TILE; ++k) {
      if (j == k) {
        acc[2 * k] += v.x;
        acc[2 * k + 1] += v.y;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2 * NODE_TILE; ++q) red[q][threadIdx.x] = acc[q];
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int q = 0; q < 2 * NODE_TILE; ++q)
        red[q][threadIdx.x] += red[q][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < 2 * NODE_TILE) {
    const int k = threadIdx.x / 2;
    if (m0 + k < n_node) {
      // part[(block, t, m0 + k, c)], c = threadIdx.x % 2
      part[(((long long)blockIdx.x * n_tree + t) * n_node + m0 + k) * 2
           + threadIdx.x % 2] = red[threadIdx.x][0];
    }
  }
}

__global__ void node_stats_final(const float* __restrict__ part,
                                 float* __restrict__ out, int n_blocks,
                                 long long n_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += part[(long long)b * n_out + i];
  out[i] = s;
}

}  // namespace

// part: n_blocks * T * n_node * 2 floats of scratch; out: T * n_node * 2.
extern "C" int node_stats_launch(const void* pos, const void* gh, void* part,
                                 void* out, long long n_rows, int n_tree,
                                 int n_node, int n_blocks,
                                 long long rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1 || n_tree < 1 || n_node < 1) return cudaErrorInvalidValue;
  dim3 grid(n_blocks, n_tree, (n_node + NODE_TILE - 1) / NODE_TILE);
  node_stats_partial<<<grid, THREADS, 0, s>>>(
      static_cast<const int32_t*>(pos), static_cast<const float2*>(gh),
      static_cast<float*>(part), n_rows, n_tree, n_node, rows_per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_out = (long long)n_tree * n_node * 2;
  const int fin_threads = 256;
  node_stats_final<<<(unsigned)((n_out + fin_threads - 1) / fin_threads),
                     fin_threads, 0, s>>>(static_cast<const float*>(part),
                                          static_cast<float*>(out), n_blocks,
                                          n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* node_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
