// The feature-grouped bf16 one-hot histogram as an mma.sync product on
// Hopper (sm_90a): the kernel of T4a and T4b (onehot_pack2.cu).  T5, T1,
// T6, T7, T3 and T2 run the wgmma kernel of onehot_wgmma.cuh instead.
//
// The TPU prototypes in tools/ compute a level histogram per feature f as
// one matrix product
//
//   H_f (B x 2M) = onehot(bins[:, f]) (B x R)  @  gh_exp (R x 2M),
//   gh_exp[r, j] = g[r] if row r is active in node j      (j < M)
//                = h[r] if row r is active in node j - M  (j >= M)
//
// which here runs on the tensor cores through mma.sync m16n8k16 bf16 x
// bf16 -> f32.  A is the one-hot (16 bins x K rows), B the gh_exp (K rows
// x 8 columns).  A thread's A fragment covers rows 2t, 2t+1, 2t+8, 2t+9
// of a 16-row half (t = lane % 4), built in registers from staged bin
// bytes by SWAR compares (oh_eq_msb): the one-hot never exists in memory.
// Pad bins (B rounded up to 16) and pad columns take part in the products
// without a branch and are never written.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int OH_WARPS = 8;
constexpr int OH_THREADS = OH_WARPS * 32;
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
  int n_feat, n_bin;         // n_bin <= 255
  int m_pad;                 // nodes per node tile, <= 128
  int n_node_out;            // nodes past this are not written
  int n_cg, n_mt;            // column and node tile groups
  int r_tile;                // rows per block step, a power of two >= 256
  int fg;                    // features per task
  int rep;                   // warps per (feature, bin tile)
};

__device__ __forceinline__ uint16_t oh_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
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
