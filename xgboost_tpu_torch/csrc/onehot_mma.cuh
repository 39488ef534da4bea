// The one-hot histogram as a tensor-core product on Hopper (sm_90a): the
// mma.sync device code of the int8 one-feature kernel below (T3
// onehot_i8.cu, T2 onehot_notrans.cu) and the bf16 feature-grouped kernel
// at the end (T4a / T4b onehot_pack2.cu).  T5, T1, T6 and T7 run the
// wgmma kernel of onehot_wgmma.cuh instead.
//
// The TPU prototypes in tools/ compute a level histogram per feature f as
// one matrix product
//
//   H_f (B x 2M) = onehot(bins[:, f]) (B x R)  @  gh_exp (R x 2M),
//   gh_exp[r, j] = g[r] if row r is active in node j      (j < M)
//                = h[r] if row r is active in node j - M  (j >= M)
//
// which here runs on the tensor cores through mma.sync: m16n8k32 s8 x s8 ->
// s32 for int (gh wrapped to int8, as the prototypes' astype(int8) wraps),
// m16n8k16 bf16 x bf16 -> f32 for floats.  A is the one-hot (16 bins x K
// rows), B the gh_exp (K rows x 8 columns).  In both shapes a thread's A
// and B fragments cover the SAME rows of a 32-row step (int8: rows
// 4t..4t+3 and 16+4t..16+4t+3; bf16: 2t, 2t+1, 2t+8, 2t+9 and 16 + those,
// t = lane % 4), so each thread builds both operands in registers from
// its own rows: the one-hot never exists in memory.
//
// Staging.  A block of the one-feature kernel takes one feature
// (blockIdx.x), one task (blockIdx.y: a group of up to 5 bin tiles of 16,
// a group of up to CT column tiles of 8, one node tile) and one chunk of
// rows (blockIdx.z), in steps of r_tile rows (at most 2,048).  Per step
// the block reads each row once (neighbouring threads on neighbouring
// rows) and stages it in shared memory as bytes: the bin (int bins outside
// [0, 256) zero the row's gh), the row's node in the task's node tile
// (255: none), and gh as int8 bytes.  The next step's loads are issued
// before this step's products, so their latency hides behind them.  In
// each step warp w takes its own r_tile / 8 consecutive rows, 32 per mma
// step.  CT = 1 (one column tile, M <= 4) keeps the accumulators in 20
// registers and runs two blocks an SM.
//
// Operands from packed bytes.  A thread reads its rows' bins and nodes as
// 32-bit words of four bytes and compares all four at once (oh_eq_msb):
// the one-hot A of a bin tile is one compare and one AND per register, the
// gh_exp B of a column tile a compare of the node bytes against the
// column's node and an AND with the gh bytes.  Pad bins (B rounded up to
// 16) and pad columns (2M rounded up to 8: M = 1, 2 pad to one tile; a
// task's column tiles past 2M) take part in the products, without a
// branch, and are never written; rows past the end stage zero gh and add
// nothing.
//
// Flush: each warp adds its accumulators into a block histogram in shared
// memory, then the block adds the non-zero cells into the zeroed output
// with global atomics at strides the wrapper gives.  int sums are exact
// and order-free: int results are bitwise deterministic.
//
// What bounds it on the H100.  The function itself is bytes-bound: it
// must read each row's bins, pos and gh once and write the histogram
// (1M x 28: 40 MB with u8 bins, ~0.012 ms at 3.35 TB/s; 125 MB with int32
// bins, ~0.037 ms).  The one-hot product does 2 N F B_pad 2M_pad
// operations, most of them on zeros: at M = 32 and B = 64 about 2.3e11
// int8 operations, ~0.12 ms at 1,979 TOP/s.  So the formulation is
// operation-bound at deep levels, and nearest its byte bound at M = 1-4.
// mma.sync reaches only part of the dense rate (wgmma is the full-rate
// path), and building the operands costs integer instructions of the same
// order as the products.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int OH_WARPS = 8;
constexpr int OH_THREADS = OH_WARPS * 32;
constexpr int OH_BT = 5;  // bin tiles of 16 per task: B <= 80 in one task
constexpr int OH_STEP_MAX = 2048;  // rows staged per block step

// One launch.  Mirrored field by field by ctypes in
// xgboost_tpu_torch/ops/cuda_hist_onehot.py (OnehotArgs).
struct OnehotArgs {
  const void* bins;          // element (r, f) at r * bin_sr + f * bin_sf
  const int32_t* pos;        // (n_rows,)
  const void* gh;            // g at r * gh_sr, h at r * gh_sr + gh_sc
  void* out;                 // zeroed; cell strides below
  long long bin_sr, bin_sf, gh_sr, gh_sc;
  long long s_f, s_b, s_c, s_node;
  long long n_rows;          // rows that count; later rows are dropped
  long long rows_per_block;  // a multiple of r_tile
  int n_feat, n_bin;         // n_bin <= 256
  int m_pad;                 // nodes per node tile, <= 128
  int n_node_out;            // nodes past this are not written
  int n_bg, n_cg, n_mt;      // bin, column and node tile groups
  int r_tile;                // rows per block step, a multiple of 256
  int fg;                    // grouped kernel: features per task
  int rep;                   // grouped kernel: warps per (feature, bin tile)
};

__device__ __forceinline__ uint16_t oh_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void oh_mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void oh_mma_bf16(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0x80 in each byte of w equal to the same byte of t4, 0x00 in the others:
// four byte compares in four integer instructions (SWAR; __vcmpeq4 gives
// the same answer through more instructions on sm_90).  The low seven
// bits of a byte of x = w ^ t4, plus 0x7F, set its top bit unless they are
// all zero, and no byte carries into the next.
__device__ __forceinline__ uint32_t oh_eq_msb(uint32_t w, uint32_t t4) {
  const uint32_t x = w ^ t4;
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// prmt.b32: byte n of the result is byte sel[n] of {b, a} (a the low
// word); a selector nibble with its top bit set replicates that byte's
// sign bit, which widens 0x80 / 0x00 flags into 0xFF / 0x00 masks.
__device__ __forceinline__ uint32_t oh_prmt(uint32_t a, uint32_t b,
                                            uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The int8 one-feature kernel: CT column tiles per task; instantiated by
// the .cu files.
template <typename BinT, int CT>
__global__ void __launch_bounds__(OH_THREADS, CT == 1 ? 2 : 1)
onehot_kernel(const OnehotArgs a) {
  constexpr int RB = OH_BT * 16, RC = CT * 8;
  constexpr int SR = OH_STEP_MAX / OH_THREADS;   // staged rows a thread
  __shared__ int red[RB][RC];
  __shared__ __align__(16) uint8_t s_bin[OH_STEP_MAX], s_node[OH_STEP_MAX];
  __shared__ __align__(16) uint8_t s_val[2 * OH_STEP_MAX];  // g, then h

  const int f = blockIdx.x;
  int task = blockIdx.y;
  const int bg = task % a.n_bg;
  task /= a.n_bg;
  const int cg = task % a.n_cg;
  const int mi = task / a.n_cg;
  const int b_base = bg * RB;
  const int nbt = min(OH_BT, (a.n_bin - b_base + 15) / 16);
  const int n_col = 2 * a.m_pad;
  const int col_base = cg * RC;
  const int nct = min(CT, (n_col - col_base + 7) / 8);
  const int node_base = mi * a.m_pad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int i = threadIdx.x; i < RB * RC; i += OH_THREADS)
    (&red[0][0])[i] = 0;

  // this thread's B column in each column tile: its channel, and its node
  // as four equal bytes (254 for a pad column: no row's node byte)
  uint32_t col_j4[CT];
  bool col_h[CT];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct) {
    const int cc = col_base + ct * 8 + g;
    col_h[ct] = cc >= a.m_pad;
    const int j = cc - (col_h[ct] ? a.m_pad : 0);
    col_j4[ct] = (uint32_t)(ct < nct && cc < n_col ? j : 254) * 0x01010101u;
  }

  int acc[OH_BT][CT][4];
#pragma unroll
  for (int bt = 0; bt < OH_BT; ++bt)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[bt][ct][k] = 0;

  const BinT* bins = static_cast<const BinT*>(a.bins) + f * a.bin_sf;
  const long long r_begin = (long long)blockIdx.z * a.rows_per_block;
  const long long r_end = min(a.n_rows, r_begin + a.rows_per_block);
  const int per_warp = a.r_tile / OH_WARPS;

  int st_bin[SR], st_node[SR];
  uint32_t st_g[SR], st_h[SR];  // raw int32
  auto stage_load = [&](long long step) {
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      const int i = threadIdx.x + k * OH_THREADS;
      const long long r = step + i;
      const bool ok = i < a.r_tile && r < r_end;
      const int p = ok ? a.pos[r] : -1;
      const int v = ok ? (int)bins[r * a.bin_sr] : 0;
      const bool keep = ok && v >= 0 && v < 256;
      const uint32_t* q = static_cast<const uint32_t*>(a.gh) + r * a.gh_sr;
      st_g[k] = keep ? q[0] : 0u;
      st_h[k] = keep ? q[a.gh_sc] : 0u;
      st_bin[k] = keep ? v : 0;
      const unsigned j = (unsigned)(p - node_base);
      st_node[k] = j < (unsigned)a.m_pad ? (int)j : 255;
    }
  };
  auto stage_store = [&]() {
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      const int i = threadIdx.x + k * OH_THREADS;
      s_bin[i] = (uint8_t)st_bin[k];
      s_node[i] = (uint8_t)st_node[k];
      s_val[i] = (uint8_t)st_g[k];
      s_val[OH_STEP_MAX + i] = (uint8_t)st_h[k];
    }
  };

  const uint32_t* w_bin = reinterpret_cast<const uint32_t*>(s_bin);
  const uint32_t* w_node = reinterpret_cast<const uint32_t*>(s_node);
  const uint32_t* w_val = reinterpret_cast<const uint32_t*>(s_val);

  if (r_begin < r_end) stage_load(r_begin);
  for (long long step = r_begin; step < r_end; step += a.r_tile) {
    stage_store();
    __syncthreads();
    if (step + a.r_tile < r_end) stage_load(step + a.r_tile);
#pragma unroll 2
    for (int r0 = warp * per_warp; r0 < (warp + 1) * per_warp; r0 += 32) {
      // rows 4t..4t+3 (word 0) and 16+4t..16+4t+3 (word 1)
      const int w0 = (r0 >> 2) + t, w1 = w0 + 4;
      const uint32_t wb[2] = {w_bin[w0], w_bin[w1]};
      const uint32_t wn[2] = {w_node[w0], w_node[w1]};
      const uint32_t wg[2] = {w_val[w0], w_val[w1]};
      const uint32_t wh[2] = {w_val[OH_STEP_MAX / 4 + w0],
                              w_val[OH_STEP_MAX / 4 + w1]};
      uint32_t bf[CT][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ct = 0; ct < CT; ++ct)
          bf[ct][h] = oh_prmt(oh_eq_msb(wn[h], col_j4[ct]), 0, 0xBA98) &
                      (col_h[ct] ? wh[h] : wg[h]);
#pragma unroll
      for (int bt = 0; bt < OH_BT; ++bt) {
        if (bt >= nbt) continue;
        const int tb0 = b_base + bt * 16 + g;
        const uint32_t k0 = (uint32_t)tb0 * 0x01010101u;
        const uint32_t k1 = (uint32_t)(tb0 + 8) * 0x01010101u;
        const uint32_t af[4] = {oh_eq_msb(wb[0], k0) >> 7,
                                oh_eq_msb(wb[0], k1) >> 7,
                                oh_eq_msb(wb[1], k0) >> 7,
                                oh_eq_msb(wb[1], k1) >> 7};
#pragma unroll
        for (int ct = 0; ct < CT; ++ct)
          oh_mma_s8(acc[bt][ct], af, bf[ct][0], bf[ct][1]);
      }
    }
    __syncthreads();  // the step's rows are read before the next store
  }

  // ---- reduce the warps' tiles in shared memory, then flush
#pragma unroll
  for (int bt = 0; bt < OH_BT; ++bt)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = acc[bt][ct][k];
        if (v != 0)  // c0, c1: bin g; c2, c3: bin g + 8
          atomicAdd(
              &red[bt * 16 + g + 8 * (k >> 1)][ct * 8 + 2 * t + (k & 1)], v);
      }
  __syncthreads();
  int* out = static_cast<int*>(a.out);
  for (int i = threadIdx.x; i < RB * RC; i += OH_THREADS) {
    const int v = (&red[0][0])[i];
    if (v == 0) continue;
    const int b = b_base + i / RC;
    const int cc = col_base + i % RC;
    if (b >= a.n_bin || cc >= n_col) continue;
    const int ch = cc >= a.m_pad;
    const int node = node_base + cc - ch * a.m_pad;
    if (node >= a.n_node_out) continue;
    atomicAdd(out + f * a.s_f + b * a.s_b + ch * a.s_c + node * a.s_node, v);
  }
}

template <typename BinT, int CT>
cudaError_t onehot_launch(const OnehotArgs* a, int n_row_blocks,
                          cudaStream_t stream) {
  const dim3 grid(a->n_feat, a->n_bg * a->n_cg * a->n_mt, n_row_blocks);
  onehot_kernel<BinT, CT><<<grid, OH_THREADS, 0, stream>>>(*a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ grouped
// The feature-grouped bf16 kernel (T4a / T4b onehot_pack2.cu): a task
// takes FG features (a.fg; blockIdx.x the feature group), one group of up
// to CT column tiles and one node tile (blockIdx.y), and one chunk of rows
// (blockIdx.z).
//
// Per step of a.r_tile rows (a power of two, at most 2,048) the block
// stages each row's node byte and bf16 g and h ONCE for its FG features,
// and each feature's bin bytes; a thread issues a batch of 8 loads before
// it stores any of them.  A bin outside [0, 256) becomes the byte 255 of that feature
// alone, which no written bin matches (the wrapper keeps n_bin <= 255):
// the row still counts in the group's other features.  Then, per
// sub-step of S rows, the block builds the gh_exp B fragments of those
// rows for the task's column tiles ONCE into shared memory (S x CT tiles
// x 16 bytes <= 32 KB; S = 2,048 / CT rounded to powers of two, at most
// the step), and every warp multiplies them against the one-hot A
// fragments of its own (feature, bin tile) units over all S rows.  The
// B fragments of a row are thus built once per FG features and CT
// column tiles, not once per feature; each A fragment serves CT column
// tiles.
//
// Units.  A task has FG x nbt (feature, bin tile) units (nbt = the bin
// tiles of 16, up to 16).  Warp w takes units w, w + 8, ... (at most PW
// of them, each with CT column tiles of accumulators: PW x CT x 4 = 64
// f32 registers).  A task of fewer than 8 units gives each unit a.rep
// warps, which split its rows by 16-row halves, so no warp idles when
// 8 is a multiple of the units.  A warp owns its cells outright, so the
// flush goes from registers straight to the output with global atomics
// (no shared histogram).
//
// Budget: 256 threads, at most 128 registers (two blocks an SM);
// dynamic shared memory 32 KB of B fragments + r_tile x (5 + FG) bytes
// of staged rows: 100 KB at FG = 28 and 2,048 rows, so two blocks an SM
// fit in its 228 KB.
constexpr int OH_GB_CELLS = 2048;  // sub-step rows x column tiles staged

template <int CT, int PW>
__global__ void __launch_bounds__(OH_THREADS, 2)
onehot_group_kernel(const OnehotArgs a) {
  extern __shared__ __align__(16) uint8_t oh_smem[];
  const int R = a.r_tile;
  uint2* s_b = reinterpret_cast<uint2*>(oh_smem);
  // bf16 g of the step's rows, then h
  uint16_t* s_val = reinterpret_cast<uint16_t*>(oh_smem + OH_GB_CELLS * 16);
  uint8_t* s_node = oh_smem + OH_GB_CELLS * 16 + 4 * R;
  uint8_t* s_bin = s_node + R;  // [FG][R]
  const uint32_t* w_val = reinterpret_cast<const uint32_t*>(s_val);
  const uint32_t* w_node = reinterpret_cast<const uint32_t*>(s_node);
  const uint32_t* w_bin = reinterpret_cast<const uint32_t*>(s_bin);

  const int f0 = blockIdx.x * a.fg;
  const int nf = min(a.fg, a.n_feat - f0);
  const int cg = blockIdx.y % a.n_cg, mi = blockIdx.y / a.n_cg;
  const int nbt = (a.n_bin + 15) >> 4;
  const int n_units = nf * nbt;
  const int n_col = 2 * a.m_pad;
  const int col_base = cg * CT * 8;
  const int nct = min(CT, (n_col - col_base + 7) >> 3);
  const int node_base = mi * a.m_pad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  int pct = 1;
  while (pct < nct) pct <<= 1;
  const int S = min(R, OH_GB_CELLS / pct);  // rows of one B sub-step
  const int NH = S >> 4;                     // 16-row halves in it
  const int lg_r = 31 - __clz(R);            // R is a power of two
  constexpr int SR = OH_STEP_MAX / OH_THREADS;  // staged rows a thread

  // this warp's units k < n_mine, one register each: the bin of row g
  // in the unit's bin tile (low byte) and the word offset of its
  // feature's staged bins; with a.rep > 1 a warp has one unit and takes
  // every rep-th half from h0
  const int n_items = n_units * a.rep;
  const int n_mine = warp < n_items ? (n_items - warp + OH_WARPS - 1) / OH_WARPS
                                    : 0;
  uint32_t u_key[PW];
#pragma unroll
  for (int k = 0; k < PW; ++k) {
    const int u = (warp + k * OH_WARPS) % n_units;
    u_key[k] = (uint32_t)((u % nbt) * 16 + g) |
               (uint32_t)((u / nbt) * (R >> 2)) << 8;
  }
  const int h0 = a.rep > 1 ? warp / n_units : 0;

  float acc[PW][CT][4];
#pragma unroll
  for (int k = 0; k < PW; ++k)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][ct][q] = 0.0f;

  const int32_t* bins = static_cast<const int32_t*>(a.bins);
  const long long r_begin = (long long)blockIdx.z * a.rows_per_block;
  const long long r_end = min(a.n_rows, r_begin + a.rows_per_block);
  constexpr uint32_t ONE2 = 0x3F803F80u;  // bf16 1.0 in both halves
  const int off = 2 * (t & 1);            // rows 2t, 2t+1 in a word
  const uint32_t sel = off | (off + 1) << 4 | (off + 4) << 8 | (off + 5) << 12;

  for (long long step = r_begin; step < r_end; step += R) {
    // ---- stage: node byte and bf16 gh once, bin bytes per feature.  A
    // thread issues all its loads of a batch before it stores any, so a
    // batch costs one round trip to memory, not one a row
    int st_p[SR];
    float st_g[SR], st_h[SR];
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      const int i = threadIdx.x + k * OH_THREADS;
      const long long r = step + i;
      const bool ok = i < R && r < r_end;
      const float* q = static_cast<const float*>(a.gh) + r * a.gh_sr;
      st_p[k] = ok ? a.pos[r] : -1;
      st_g[k] = ok ? q[0] : 0.0f;
      st_h[k] = ok ? q[a.gh_sc] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < SR; ++k) {
      const int i = threadIdx.x + k * OH_THREADS;
      if (i >= R) continue;
      const unsigned j = (unsigned)(st_p[k] - node_base);
      s_node[i] = j < (unsigned)a.m_pad ? (uint8_t)j : (uint8_t)255;
      s_val[i] = oh_bf16_bits(st_g[k]);
      s_val[R + i] = oh_bf16_bits(st_h[k]);
    }
    // bins: element e is row e % R of the group's feature e / R
    for (int e0 = 0; e0 < nf * R; e0 += SR * OH_THREADS) {
      int v[SR];
#pragma unroll
      for (int k = 0; k < SR; ++k) {
        const int e = e0 + threadIdx.x + k * OH_THREADS;
        const long long r = step + (e & (R - 1));
        v[k] = e < nf * R && r < r_end
                   ? bins[(long long)(f0 + (e >> lg_r)) * a.bin_sf +
                          r * a.bin_sr]
                   : 255;
      }
#pragma unroll
      for (int k = 0; k < SR; ++k) {
        const int e = e0 + threadIdx.x + k * OH_THREADS;
        if (e < nf * R)
          s_bin[e] = (unsigned)v[k] < 256u ? (uint8_t)v[k] : (uint8_t)255;
      }
    }
    __syncthreads();
    for (int s0 = 0; s0 < R; s0 += S) {
      // ---- B fragments of rows [s0, s0 + S), built once for the task
      for (int it = warp; it < NH * nct; it += OH_WARPS) {
        const int h = it / nct, ct = it - h * nct;
        const int cc = col_base + ct * 8 + g;
        const int ch = cc >= a.m_pad;
        // the column's node as four equal bytes (254: a pad column)
        const uint32_t j4 =
            (uint32_t)(cc < n_col ? cc - ch * a.m_pad : 254) * 0x01010101u;
        const int base = s0 + h * 16;
        const int wa = (base >> 2) + (t >> 1);
        const uint32_t m =
            oh_eq_msb(oh_prmt(w_node[wa], w_node[wa + 2], sel), j4);
        const uint32_t* wv = w_val + ch * (R >> 1);
        const int u = (base >> 1) + t;
        s_b[it * 32 + lane] = make_uint2(oh_prmt(m, 0, 0x9988) & wv[u],
                                         oh_prmt(m, 0, 0xBBAA) & wv[u + 4]);
      }
      __syncthreads();
      // ---- each unit's one-hot against the shared B fragments
      for (int h = h0; h < NH; h += a.rep) {
        const int wa = ((s0 + h * 16) >> 2) + (t >> 1);
        const uint2* sb = s_b + h * nct * 32 + lane;
        uint2 bpre[CT <= 8 ? CT : 1];
        if constexpr (CT <= 8) {
#pragma unroll
          for (int ct = 0; ct < CT; ++ct)
            if (ct < nct) bpre[ct] = sb[ct * 32];
        }
#pragma unroll
        for (int k = 0; k < PW; ++k) {
          if (k >= n_mine) continue;
          const int wb = (int)(u_key[k] >> 8) + wa;
          const uint32_t k0 = (u_key[k] & 0xFFu) * 0x01010101u;
          const uint32_t bq = oh_prmt(w_bin[wb], w_bin[wb + 2], sel);
          const uint32_t e0 = oh_eq_msb(bq, k0);
          const uint32_t e1 = oh_eq_msb(bq, k0 + 0x08080808u);
          const uint32_t af[4] = {oh_prmt(e0, 0, 0x9988) & ONE2,
                                  oh_prmt(e1, 0, 0x9988) & ONE2,
                                  oh_prmt(e0, 0, 0xBBAA) & ONE2,
                                  oh_prmt(e1, 0, 0xBBAA) & ONE2};
#pragma unroll
          for (int ct = 0; ct < CT; ++ct) {
            if (ct >= nct) continue;
            uint2 b;
            if constexpr (CT <= 8) {
              b = bpre[ct];
            } else {
              b = sb[ct * 32];
            }
            oh_mma_bf16(acc[k][ct], af, b.x, b.y);
          }
        }
      }
      __syncthreads();  // B fragments and staged rows read before reuse
    }
  }

  // ---- flush: a warp's cells are its own; zero cells are skipped (a
  // sum that received additions is never -0)
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int k = 0; k < PW; ++k) {
    if (k >= n_mine) continue;
    const int u = (warp + k * OH_WARPS) % n_units;
    const int f = f0 + u / nbt, bt = u % nbt;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      if (ct >= nct) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = acc[k][ct][q];
        if (v == 0.0f) continue;  // c0, c1: bin g; c2, c3: bin g + 8
        const int b = bt * 16 + g + 8 * (q >> 1);
        const int cc = col_base + ct * 8 + 2 * t + (q & 1);
        if (b >= a.n_bin || cc >= n_col) continue;
        const int ch = cc >= a.m_pad;
        const int node = node_base + cc - ch * a.m_pad;
        if (node >= a.n_node_out) continue;
        atomicAdd(out + f * a.s_f + b * a.s_b + ch * a.s_c + node * a.s_node,
                  v);
      }
    }
  }
}

// Dynamic shared memory of one grouped block.
inline int oh_group_smem(const OnehotArgs* a) {
  return OH_GB_CELLS * 16 + a->r_tile * (5 + a->fg);
}

template <int CT, int PW>
cudaError_t onehot_group_launch_ct(const OnehotArgs* a, int n_row_blocks,
                                   cudaStream_t stream) {
  const int smem = oh_group_smem(a);
  const cudaError_t e = cudaFuncSetAttribute(
      onehot_group_kernel<CT, PW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a->n_feat + a->fg - 1) / a->fg, a->n_cg * a->n_mt,
                  n_row_blocks);
  onehot_group_kernel<CT, PW><<<grid, OH_THREADS, smem, stream>>>(*a);
  return cudaGetLastError();
}

// variant v: PW = 2^v units a warp, CT = 16 / PW column tiles a task
inline cudaError_t onehot_group_dispatch(const OnehotArgs* a, int variant,
                                         int n_row_blocks,
                                         cudaStream_t stream) {
  switch (variant) {
    case 0:
      return onehot_group_launch_ct<16, 1>(a, n_row_blocks, stream);
    case 1:
      return onehot_group_launch_ct<8, 2>(a, n_row_blocks, stream);
    case 2:
      return onehot_group_launch_ct<4, 4>(a, n_row_blocks, stream);
    case 3:
      return onehot_group_launch_ct<2, 8>(a, n_row_blocks, stream);
    case 4:
      return onehot_group_launch_ct<1, 16>(a, n_row_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
