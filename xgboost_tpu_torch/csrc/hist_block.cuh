// One block's share of a level histogram: the device code of K4
// (hist_lanes.cu) only.  K1 and K3 run the scatter of hist_scatter.cuh.
//
// The block keeps a private (nf, B, 2, m_tile) histogram in shared memory,
// its threads stride rows [r_begin, r_end) and add with shared-memory
// atomics, and the block flushes its non-zero cells into a zeroed
// (F, B, 2, n_col) output with global atomics, node j of its tile landing
// in column col0 + j: K4 writes lane l's columns of an L * n_node wide
// output (col0 = l * n_node + m0).
//
// Modes (template MODE):
//   0 fp32  -- f32 gh, f32 atomics.  Exact f32 additions; the order of the
//              additions changes from run to run.
//   1 bf16  -- g and h rounded to bf16 (__float2bfloat16_rn), f32 atomics.
//   2 int   -- pre-quantized int32 gh, int32 atomics.  Integer sums are
//              exact and order-free, so the result is bitwise
//              deterministic (the int8 and "fixed" precisions).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

template <int MODE>
struct HistAcc { typedef float type; };
template <>
struct HistAcc<2> { typedef int type; };

// bins (rows of n_feat u8), pos (int32, < 0 = inactive) and gh (int2 in
// mode 2, else float2) point at the rows of ONE tree or lane.  smem holds
// nf * n_bin * 2 * m_tile cells.  Every thread of the block must call it.
template <int MODE>
__device__ void hist_block(const uint8_t* __restrict__ bins,
                           const int32_t* __restrict__ pos,
                           const void* __restrict__ gh,
                           void* __restrict__ out, long long r_begin,
                           long long r_end, int n_feat, int n_bin, int f0,
                           int nf, int m0, int nm, int m_tile, long long n_col,
                           long long col0, unsigned char* smem) {
  typedef typename HistAcc<MODE>::type T;
  T* hist = reinterpret_cast<T*>(smem);
  // cell (fl, b, c, j) at ((fl * B + b) * 2 + c) * m_tile + j
  const int cells = nf * n_bin * 2 * m_tile;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = T(0);
  __syncthreads();

  for (long long r = r_begin + threadIdx.x; r < r_end; r += blockDim.x) {
    // inactive rows (pos < 0) and rows of other node tiles fall outside
    const int j = pos[r] - m0;
    if (j < 0 || j >= nm) continue;
    T g, h;
    if constexpr (MODE == 2) {
      const int2 v = static_cast<const int2*>(gh)[r];
      g = v.x;
      h = v.y;
    } else {
      float2 v = static_cast<const float2*>(gh)[r];
      if constexpr (MODE == 1) {
        v.x = __bfloat162float(__float2bfloat16_rn(v.x));
        v.y = __bfloat162float(__float2bfloat16_rn(v.y));
      }
      g = v.x;
      h = v.y;
    }
    const uint8_t* row = bins + r * n_feat + f0;
    for (int fl = 0; fl < nf; ++fl) {
      const int b = row[fl];
      if (b >= n_bin) continue;  // never produced by binning; keeps smem safe
      T* cell = hist + ((fl * n_bin + b) * 2) * m_tile + j;
      atomicAdd(cell, g);
      atomicAdd(cell + m_tile, h);
    }
  }
  __syncthreads();

  // Flush.  Skipping zero cells is exact: a cell that received additions
  // is never -0 (the sum starts at +0), so leaving +0 out changes nothing.
  T* o = reinterpret_cast<T*>(out);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const T v = hist[i];
    if (v == T(0)) continue;
    const int j = i % m_tile;
    const int fbc = i / m_tile;  // (fl * B + b) * 2 + c
    const int fl = fbc / (2 * n_bin);
    const int bc = fbc % (2 * n_bin);
    const long long dst =
        ((long long)(f0 + fl) * 2 * n_bin + bc) * n_col + col0 + j;
    atomicAdd(o + dst, v);
  }
}

// Opt in to more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}
