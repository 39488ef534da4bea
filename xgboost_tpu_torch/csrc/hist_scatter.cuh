// The scatter level histogram of K1 (hist_level.cu, one tree), K3
// (hist_batched.cu, T trees over one bins matrix) and K4 (hist_lanes.cu,
// T tenant lanes, each on its own bins), on Hopper (sm_90a).
//
// Replaces the TPU kernels xgboost_tpu/ops/pallas_hist.py:_hist_kernel
// (K1, through _hist_pallas_pre; K4, through _hist_pallas_lanes_pre) and
// _batched_hist_kernel (K3, through _hist_pallas_batched_pre).  One
// function: for every tree t, every row r with pos[t, r] >= 0 and every
// feature f, add (g[t, r], h[t, r]) into the cell
// [f, bins[t, r, f], channel, t * n_node + pos[t, r]] of a
// (F, B, 2, T * n_node) histogram (node minor, trees outer in the last
// axis; K1 is T = 1).  The trees of K1 and K3 share one (N, F) bins matrix
// (a bins stride of 0 rows between trees); K4's lanes are its trees, each
// with its own (N, F) matrix (a stride of N rows).
//
// What bounds it on the H100.  The function's bytes are small (23 MB at
// 200k x 28, six trees, 32 nodes: ~7 us at 3.35 TB/s) and its additions
// are T * N * F * 2 shared-memory atomics (67 M at that shape, ~9 us at one
// warp-wide atomic a clock on 132 SMs without conflicts).  The earlier
// design (one block per row chunk x tile, four blocks an SM wanted) lost
// most of its time elsewhere: every block zeroed and flushed its whole
// private histogram with global atomics (11-13 M atomics a K3 level, up to
// 528 adds on one output cell), two waves of blocks, and pos and gh re-read
// once per feature tile.  What bounds this design is the rows a unit
// reads again (pos for every row, bins and gh of its pairs) and, at deep
// levels, the flush of every resident block's histogram (PERF.md).
//
// The design:
//  - Units.  The wrapper's plan (ops/cuda_hist_batched.py:scatter_plan)
//    cuts the (feature, tree, node) cells into units of f_tile x t_tile x
//    m_tile whose private histogram fits one block's shared memory,
//    choosing the tiles that move the fewest bytes: every unit reads its
//    rows once, so units cost re-reads of pos, gh and bins, and copies
//    cost flushes.
//  - One wave.  The grid is the blocks that are resident at once.  Each
//    unit gets `copies` blocks; a block walks its copy's share of the rows
//    in steps, zeroes its histogram once and flushes it once per unit.  Where there are more units than groups
//    of copies, each group walks units g, g + n_groups, ... in turn.
//  - A thread a (row, tree) pair.  Each step of R rows first lists the
//    pairs whose node is in the unit's tile (read from pos, coalesced), so
//    no lane idles on an inactive row or another tile's; a thread then
//    holds its pair's node and gh in registers and reads the row's bins
//    four features a load (the aligned words of the row, L1-cached).
//    Staging the rows in shared memory with cp.async measured slower
//    (PERF.md) and is not done.
//  - The private histogram is two planes (g, h) of bin-minor cells with
//    an odd bin pitch, so the flush reads consecutive nodes at a stride
//    that no bank repeats.
//  - The flush.  Where the plan gives every unit one copy (K4's deep
//    levels; some K1 and K3 levels), each output cell belongs to one
//    block: the block stores every cell of its unit, zeros included, in
//    output order, into an output the wrapper leaves uninitialised, so the
//    output is written once and never zeroed.  Otherwise a block adds each
//    non-zero cell of its histogram to a zeroed output with one global
//    atomic.  The values are the same either way: an int sum is exact,
//    and a float cell owned by one block is that block's sum from +0,
//    stored or added onto +0.  Summing the private
//    histograms of a thread block cluster through distributed shared
//    memory first measured slower at every cluster size on the H100: the
//    remote reads are serial loads where the atomics they save are
//    fire-and-forget (tools/hist_scatter_split.py, variants c2 / c4 / c8;
//    PERF.md).
//
// Modes (template MODE):
//   0 fp32  -- f32 gh, f32 atomics.  Exact f32 additions; their order
//              changes from run to run.
//   1 bf16  -- g and h rounded to bf16 (__float2bfloat16_rn), f32 atomics.
//   2 int   -- pre-quantized int32 gh, int32 atomics.  Integer sums are
//              exact and order-free, so the result is bitwise deterministic
//              and each tree's slice of a K3 launch is a solo K1 launch.
//
// Bins >= B are skipped (binning never makes them; it keeps shared memory
// safe).  Every (feature, tree, node) cell is owned by one unit, and each
// unit's copies split the rows, so every addition happens once.  A K4
// launch on lanes of N rows is a K3 launch whose trees read their own
// rows: in mode int each lane's slice is bitwise a solo K1 launch on the
// lane's rows, and pad rows and pad lanes (pos = -1) add nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace hist_scatter {

constexpr int THREADS = 1024;
constexpr int MAX_DEVICES = 64;

template <int MODE>
struct Acc { typedef float type; typedef float2 pair; };
template <>
struct Acc<2> { typedef int type; typedef int2 pair; };

// One launch's shapes and plan (ops/cuda_hist_batched.py:scatter_plan).
struct Args {
  const uint8_t* bins;   // (N, F) u8 shared by the trees, or (T, N, F)
  const int32_t* pos;    // (T, N) int32, < 0 = inactive
  const void* gh;        // (T, N, 2): int2 in mode 2, else float2
  void* out;             // (F, B, 2, T * n_node): zeroed unless `store`
  long long n_rows;
  long long bins_stride;  // rows between two trees' bins: 0 or n_rows
  int n_feat, n_bin, n_tree, n_node;
  int f_tile, t_tile, m_tile;
  int n_t_tiles, n_m_tiles, n_units;
  int copies;            // blocks per unit
  int n_groups;          // grid / copies
  long long rows_per_copy;  // a multiple of 16
  int rows_per_step;        // R, a multiple of 16, at most 65,536
  int bin_pitch;            // Bp = B | 1
  int hist_bytes;           // two planes of f_tile * t_tile * m_tile * Bp
  int store;                // 1: the store flush (copies == 1), 0: atomics
};

// The 4 bytes of bins at [p, p + 4), those outside [lo, hi) zero: a row's
// last word may reach past the matrix.
__device__ __forceinline__ uint32_t bins_word(const uint8_t* p,
                                              const uint8_t* lo,
                                              const uint8_t* hi) {
  if (p >= lo && p + 4 <= hi)
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
  for (int q = 0; q < 4; ++q)
    if (p + q >= lo && p + q < hi) v |= (uint32_t)p[q] << (8 * q);
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    kernel(const Args a) {
  typedef typename Acc<MODE>::type T;
  typedef typename Acc<MODE>::pair GH;
  extern __shared__ __align__(16) unsigned char smem[];
  T* hist = reinterpret_cast<T*>(smem);
  // after the histogram: the step's list of (row, tree) pairs, after its
  // count
  int* n_pairs = reinterpret_cast<int*>(smem + a.hist_bytes);
  int* list = n_pairs + 4;

  const int F = a.n_feat, B = a.n_bin;
  const int R = a.rows_per_step;
  const long long N = a.n_rows;
  // cell (fl, k, j, b) of a plane at (fl * tm + k * m_tile + j) * Bp + b
  const int Bp = a.bin_pitch, tm = a.t_tile * a.m_tile;
  const int P = a.f_tile * tm * Bp;  // cells of one plane
  const GH* gh = static_cast<const GH*>(a.gh);
  // the whole bins matrix: a row's last word may read into the next one
  const uint8_t* const bins_hi =
      a.bins + (a.bins_stride ? a.n_tree * a.bins_stride : N) * F;
  const int group = blockIdx.x / a.copies;
  const int copy = blockIdx.x % a.copies;
  const long long rb = (long long)copy * a.rows_per_copy;
  const long long re = min(N, rb + a.rows_per_copy);
  const int lane = threadIdx.x & 31;

  for (int u = group; u < a.n_units; u += a.n_groups) {
    const int mi = u % a.n_m_tiles;
    const int ti = (u / a.n_m_tiles) % a.n_t_tiles;
    const int fi = u / (a.n_m_tiles * a.n_t_tiles);
    const int f0 = fi * a.f_tile, nf = min(a.f_tile, F - f0);
    const int t0 = ti * a.t_tile, nt = min(a.t_tile, a.n_tree - t0);
    const int m0 = mi * a.m_tile, nm = min(a.m_tile, a.n_node - m0);
    const int NW = (nf + 3) / 4;  // words of a row's features

    for (int i = threadIdx.x; i < a.hist_bytes / 16; i += blockDim.x)
      reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);

    for (long long r0 = rb; r0 < re; r0 += R) {
      const int rows = (int)min((long long)R, re - r0);
      if (threadIdx.x == 0) *n_pairs = 0;
      __syncthreads();  // the count reset (and, first, the zeroed histogram)
      // tree k's pos, and gh, of step row r
      auto pos_of = [&](int k, int r) {
        return a.pos[(long long)(t0 + k) * N + r0 + r];
      };
      auto gh_of = [&](int k, int r) {
        return gh[(long long)(t0 + k) * N + r0 + r];
      };
      // the list of the step's (row, tree) pairs whose node is in the
      // unit's tile, (tree << 16) | row
      for (int q0 = 0; q0 < nt * rows; q0 += blockDim.x) {
        const int q = q0 + threadIdx.x;
        int k = 0, r = 0;
        bool in = false;
        if (q < nt * rows) {
          k = q / rows;
          r = q - k * rows;
          in = (unsigned)(pos_of(k, r) - m0) < (unsigned)nm;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, in);
        int base = 0;
        if (lane == 0 && mask) base = atomicAdd(n_pairs, __popc(mask));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (in) list[base + __popc(mask & ((1u << lane) - 1))] = (k << 16) | r;
      }
      __syncthreads();
      const int n = *n_pairs;
      // a thread adds a pair's features: its node and gh in registers, its
      // row's bins four features a load
      for (int p = threadIdx.x; p < n; p += blockDim.x) {
        const int e = list[p];
        const int k = e >> 16, r = e & 0xffff;
        const int j = pos_of(k, r) - m0;
        const GH v = gh_of(k, r);
        T g = v.x, h = v.y;
        if constexpr (MODE == 1) {
          g = __bfloat162float(__float2bfloat16_rn(g));
          h = __bfloat162float(__float2bfloat16_rn(h));
        }
        // the aligned words from the one holding the row's first feature
        const uint8_t* rp =
            a.bins + ((t0 + k) * a.bins_stride + r0 + r) * F + f0;
        const uint8_t* rw = reinterpret_cast<const uint8_t*>(
            reinterpret_cast<uintptr_t>(rp) & ~static_cast<uintptr_t>(3));
        const int sh = 8 * (int)(rp - rw);
        T* hc = hist + (k * a.m_tile + j) * Bp;
        uint32_t lo = bins_word(rw, a.bins, bins_hi);
        for (int w = 0; w < NW; ++w) {
          const uint32_t hi = bins_word(rw + 4 * (w + 1), a.bins, bins_hi);
          const uint32_t bytes = __funnelshift_r(lo, hi, sh);
          lo = hi;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int b = (bytes >> (8 * q)) & 0xff;
            if (4 * w + q < nf && b < B) {
              T* cell = hc + (4 * w + q) * tm * Bp + b;
              atomicAdd(cell, g);
              atomicAdd(cell + P, h);
            }
          }
        }
      }
      __syncthreads();  // the list is rewritten by the next step
    }

    // Flush: the unit's cells in output order (node fastest), stored where
    // the unit has one copy, else added.
    __syncthreads();  // every add done (a copy with no rows: the zeroing)
    T* o = reinterpret_cast<T*>(a.out);
    const long long cols = (long long)a.n_tree * a.n_node;
    if (a.store) {
      // Every cell, zeros included.  A thread's cells e, e + blockDim.x,
      // ... carry their digits (node j, tree k, channel c, bin b, feature
      // f) from one to the next instead of dividing them out of e: the
      // divisions made the flush of a deep level instruction-bound.
      int q = threadIdx.x, j = q % nm;
      q /= nm;
      int k = q % nt;
      q /= nt;
      int c = q & 1, b = (q >> 1) % B, f = (q >> 1) / B;
      q = blockDim.x;
      const int sj = q % nm;
      q /= nm;
      const int sk = q % nt;
      q /= nt;
      const int sc = q & 1, sb = (q >> 1) % B, sf = (q >> 1) / B;
      while (f < nf) {
        const int cell = (f * tm + k * a.m_tile + j) * Bp + b;
        o[(((long long)(f0 + f) * B + b) * 2 + c) * cols
          + (long long)(t0 + k) * a.n_node + m0 + j] = hist[c * P + cell];
        j += sj;
        int carry = j >= nm;
        j -= carry ? nm : 0;
        k += sk + carry;
        carry = k >= nt;
        k -= carry ? nt : 0;
        c += sc + carry;
        carry = c >= 2;
        c -= carry ? 2 : 0;
        b += sb + carry;
        carry = b >= B;
        b -= carry ? B : 0;
        f += sf + carry;
      }
    } else {
      // Skipping zero sums is exact: a float sum from +0 is never -0.
      const int cells = nf * B * 2 * nt * nm;
      for (int e = threadIdx.x; e < cells; e += blockDim.x) {
        const int j = e % nm;
        const int e1 = e / nm;
        const int k = e1 % nt;
        const int e2 = e1 / nt;
        const int c = e2 & 1;
        const int b = (e2 >> 1) % B;
        const int f = (e2 >> 1) / B;
        const int cell = (f * tm + k * a.m_tile + j) * Bp + b;
        const T v = hist[c * P + cell];
        if (v == T(0)) continue;
        atomicAdd(o + (((long long)(f0 + f) * B + b) * 2 + c) * cols
                      + (long long)(t0 + k) * a.n_node + m0 + j,
                  v);
      }
    }
    __syncthreads();  // the histogram is zeroed for the next unit
  }
}

// The Args of one launch, from the C entry points' scalars.
inline Args make_args(const void* bins, const void* pos, const void* gh,
                      void* out, long long n_rows, long long bins_stride,
                      int n_feat, int n_bin, int n_tree, int n_node,
                      int f_tile, int t_tile, int m_tile, int copies,
                      int n_groups, long long rows_per_copy,
                      int rows_per_step, int hist_bytes, int store) {
  Args a;
  a.bins = static_cast<const uint8_t*>(bins);
  a.pos = static_cast<const int32_t*>(pos);
  a.gh = gh;
  a.out = out;
  a.n_rows = n_rows;
  a.bins_stride = bins_stride;
  a.n_feat = n_feat;
  a.n_bin = n_bin;
  a.n_tree = n_tree;
  a.n_node = n_node;
  a.f_tile = f_tile;
  a.t_tile = t_tile;
  a.m_tile = m_tile;
  a.n_t_tiles = (n_tree + t_tile - 1) / t_tile;
  a.n_m_tiles = (n_node + m_tile - 1) / m_tile;
  a.n_units = (n_feat + f_tile - 1) / f_tile * a.n_t_tiles * a.n_m_tiles;
  a.copies = copies;
  a.n_groups = n_groups;
  a.rows_per_copy = rows_per_copy;
  a.rows_per_step = rows_per_step;
  a.bin_pitch = n_bin | 1;
  a.hist_bytes = hist_bytes;
  a.store = store;
  return a;
}

// A launch's dynamic shared memory: the histogram and the step's pair list
// (4 ints of header, one int a (row, tree) pair).
inline long long smem_bytes(const Args& a) {
  return a.hist_bytes + 16 + 4LL * a.t_tile * a.rows_per_step;
}

// Opt in, once per device and mode, to the device's limit of shared memory
// a block (227 KB on Hopper), and return that limit.  The attribute belongs
// to the function, not to a launch: set per launch to the launch's own
// size, a thread launching a larger plan could find it lowered by another
// thread's smaller one in between (the lanes' host loop launches K1 from
// several threads).  Launches that take less stay valid.  `static`: each
// library that includes this header keeps its own flags (a function-local
// static of a template with external linkage is one symbol in the whole
// process, so K1's library would mark K3's kernel as opted in).
template <int MODE>
static cudaError_t opt_in(int* limit) {
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t err[MAX_DEVICES];
  static int most[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaDeviceGetAttribute(
        &most[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncSetAttribute(
          kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          most[dev]);
  });
  *limit = most[dev];
  return err[dev];
}

// Launch `grid` blocks of the plan, and report the launch's error: a
// cudaError_t, with the step that failed in bits 16 and up (1: the
// arguments, 2: the shared-memory opt-in, 3: the launch).
template <int MODE>
int launch(const Args& a, int grid, size_t smem, cudaStream_t stream) {
  (void)cudaGetLastError();  // a stale error is not this launch's
  int limit = 0;
  cudaError_t e = opt_in<MODE>(&limit);
  if (e != cudaSuccess) return (int)e | (2 << 16);
  if (grid < 1 || smem > (size_t)limit || a.rows_per_step % 16
      || a.rows_per_step > 65536 || (a.store && a.copies != 1)
      || (a.bins_stride != 0 && a.bins_stride != a.n_rows)
      || a.hist_bytes < 8LL * a.f_tile * a.t_tile * a.m_tile * a.bin_pitch)
    return (int)cudaErrorInvalidValue | (1 << 16);
  kernel<MODE><<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : (int)e | (3 << 16);
}

// Blocks of `smem` bytes resident at once on the current device: the
// occupancy query's blocks an SM times the SMs.
template <int MODE>
cudaError_t resident(size_t smem, int* blocks) {
  int limit = 0, per_sm = 0, n_sm = 0, dev = 0;
  cudaError_t e = opt_in<MODE>(&limit);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem <= (size_t)limit)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel<MODE>,
                                                      THREADS, smem);
  *blocks = per_sm * n_sm;
  return e;
}

// The C entry points' body: mode -> template.
inline int launch_mode(int mode, const Args& a, int grid, long long smem,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(a, grid, (size_t)smem, s);
    case 1: return launch<1>(a, grid, (size_t)smem, s);
    case 2: return launch<2>(a, grid, (size_t)smem, s);
    default: return (int)cudaErrorInvalidValue | (1 << 16);
  }
}

inline int resident_mode(int mode, long long smem, int* blocks) {
  switch (mode) {
    case 0: return (int)resident<0>((size_t)smem, blocks);
    case 1: return (int)resident<1>((size_t)smem, blocks);
    case 2: return (int)resident<2>((size_t)smem, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace hist_scatter
