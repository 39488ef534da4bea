// Per-node (G, H) sums of T trees' rows on Hopper (sm_90a), deterministic,
// in one launch.
//
// Replaces the TPU kernel xgboost_tpu/ops/pallas_hist.py:_nst_kernel,
// launched through node_stats_pallas (vmapped over the trees of an
// ensemble round).  Same function: out[t, m, c] = sum of gh[t, r, c] over
// the rows r with pos[t, r] == m; rows with pos outside [0, n_node) are
// dropped.  f32 in, f32 out, (T, N, 2) gh, (T, N) pos, (T, n_node, 2) out.
//
// The TPU kernel is a ones-matmul on the MXU.  Here it is a segmented sum
// in a fixed order, so the result is the same bits from run to run and on
// any card (float atomics would not be):
//  - one thread block cluster of CLUSTER blocks a (tree, node tile of NT
//    nodes); block rank b of the cluster sums rows
//    [b * rows_per_block, (b + 1) * rows_per_block) of its tree, each
//    thread its rows r, r + THREADS, ... per node in registers;
//  - the block sums its threads: each warp with __shfl_down_sync in a
//    fixed tree, then one thread a (node, channel) adds the warps in order;
//  - block rank 0 adds the cluster's block sums through distributed shared
//    memory in rank order and writes the result.
// Every row split and every order of additions depends only on N, T and
// n_node (ops/cuda_node_stats.py:node_stats_plan), never on the card's SM
// count.  No global scratch, no memset, no second pass.
//
// Bound on the H100: bytes.  The sums need pos (4 T N), the active rows'
// gh (8 each) and the output once: 14.4 MB at the depth-0 path's six trees
// of 200k rows, ~4.3 us at 3.35 TB/s; one addition per row and channel is
// far below the f32 rate.  At that shape the grid is 6 clusters of 8
// blocks: 48 SMs, each streaming 300 KB with four rows of loads in flight
// a thread.  The earlier design here took two launches, a scratch tensor,
// a shared-memory tree reduction with 8 barriers and a serial final pass.
//
// C interface for ctypes: node_stats_launch returns a cudaError_t (0 = ok).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // blocks a (tree, node tile), in rank order
constexpr int UNROLL = 4;   // rows a thread loads before it adds

template <int NT, int THREADS>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    node_stats_kernel(const int32_t* __restrict__ pos,
                      const float2* __restrict__ gh, float* __restrict__ out,
                      long long n_rows, int n_node,
                      long long rows_per_block) {
  __shared__ float warp_sum[THREADS / 32][2 * NT];
  __shared__ float block_sum[2 * NT];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.y;
  const int m0 = blockIdx.z * NT;
  const int32_t* const p = pos + (long long)t * n_rows;
  const float2* const g = gh + (long long)t * n_rows;
  const long long rb = (long long)rank * rows_per_block;
  const long long re = min(n_rows, rb + rows_per_block);

  float acc[2 * NT];
#pragma unroll
  for (int q = 0; q < 2 * NT; ++q) acc[q] = 0.0f;
  for (long long r0 = rb + threadIdx.x; r0 < re;
       r0 += (long long)UNROLL * THREADS) {
    int j[UNROLL];
    float2 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = r0 + (long long)u * THREADS;
      j[u] = r < re ? __ldg(p + r) - m0 : -1;  // < 0: inactive, or below
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = (unsigned)j[u] < (unsigned)NT
                 ? __ldg(g + r0 + (long long)u * THREADS)
                 : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        if (j[u] == k) {
          acc[2 * k] += v[u].x;
          acc[2 * k + 1] += v[u].y;
        }
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 2 * NT; ++q) {
    float s = acc[q];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
    if (lane == 0) warp_sum[warp][q] = s;
  }
  __syncthreads();
  if (threadIdx.x < 2 * NT) {
    float s = warp_sum[0][threadIdx.x];
    for (int w = 1; w < THREADS / 32; ++w) s += warp_sum[w][threadIdx.x];
    block_sum[threadIdx.x] = s;
  }
  cluster.sync();  // every block's sums are in its shared memory
  if (rank == 0 && threadIdx.x < 2 * NT) {
    float s = block_sum[threadIdx.x];
    for (int b = 1; b < CLUSTER; ++b)
      s += *cluster.map_shared_rank(block_sum + threadIdx.x, b);
    const int k = threadIdx.x >> 1;
    if (m0 + k < n_node)
      out[((long long)t * n_node + m0 + k) * 2 + (threadIdx.x & 1)] = s;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

template <int NT, int THREADS>
int launch(const void* pos, const void* gh, void* out, long long n_rows,
           int n_tree, int n_node, long long rows_per_block,
           cudaStream_t stream) {
  const dim3 grid(CLUSTER, n_tree, (n_node + NT - 1) / NT);
  node_stats_kernel<NT, THREADS><<<grid, THREADS, 0, stream>>>(
      static_cast<const int32_t*>(pos), static_cast<const float2*>(gh),
      static_cast<float*>(out), n_rows, n_node, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// out: T * n_node * 2 floats, every one written.  node_tile and threads
// and rows_per_block come from the wrapper's plan (node_stats_plan): 1 and
// 1024, or 32 and 512; rows_per_block * CLUSTER >= n_rows.
extern "C" int node_stats_launch(const void* pos, const void* gh, void* out,
                                 long long n_rows, int n_tree, int n_node,
                                 int node_tile, int threads, int cluster,
                                 long long rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // a stale error is not this launch's
  const bool one = node_tile == 1 && threads == 1024;
  const bool wide = node_tile == 32 && threads == 512;
  if (!(one || wide) || n_tree < 1 || n_tree > 65535 || n_node < 1
      || (n_node + node_tile - 1) / node_tile > 65535 || cluster != CLUSTER
      || rows_per_block < 1 || rows_per_block * CLUSTER < n_rows)
    return (int)cudaErrorInvalidValue;
  return one ? launch<1, 1024>(pos, gh, out, n_rows, n_tree, n_node,
                               rows_per_block, s)
             : launch<32, 512>(pos, gh, out, n_rows, n_tree, n_node,
                               rows_per_block, s);
}

extern "C" const char* node_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
