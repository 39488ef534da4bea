// The node-major one-hot histogram as a wgmma product on Hopper (sm_90a):
// the kernel of T5 (onehot_variant.cu) and T1 (onehot_group.cu).
//
// Replaces the TPU kernels of tools/hist_microbench.py:59 variant (body
// :26) and tools/hist_group_proto.py:59 grouped (body :23).  Both compute
// the same function: bins (N, F) int32 or int16 at the strides given, gh
// (N, 2) f32, pos (N,) int32, any n_node in node tiles of m_pad =
// min(n_node, 64); out node-major (n_node, F, B, 2) f32, zeroed by the
// wrapper and written by the flush.  Rows with pos outside the node tile
// add nothing; a (row, feature) whose bin lies outside [0, B) adds nothing
// to that feature and still counts in the others.
//
// The product, transposed onto the shapes wgmma has:
//
//   H (F Bp x N) += onehot (F Bp x K) @ gh_exp (K x N),   Bp = B rounded
//                                                          up to 8
//   onehot[f Bp + b, r] = bins[r, f] == b
//   gh_exp[r, c]  = g[r] (c = j) or h[r] (c = m_pad + j) if row r is in
//                   node j of the node tile, else 0
//
// M runs over the (feature, bin) pairs concatenated across features (28
// features x 72 = 2,016 rows, 32 tiles of 64 at the mains' B = 67); N =
// 2 m_pad rounded up to one of 8, 16, 32, 64, 128 (n_node = 1-4: N = 8;
// the mains' 64 nodes: 128); K is rows, 16 an instruction:
// wgmma.mma_async.m64nNk16.f32.bf16.bf16 with A from registers and B
// from shared memory.
//
// A, the one-hot, is built in registers and never exists in memory.  A
// thread's fragment of an m64k16 tile holds M rows g and g + 8 of its
// warp's 16 and K columns 2t, 2t+1, 2t+8, 2t+9 (the mma.sync m16n8k16 A
// layout, one warp per 16 rows).  The block stages its features' bins of
// a row step as bytes (a bin outside [0, 256) becomes 255, which no
// bin < B <= 255 matches), so a thread reads its four rows' bins of one
// feature as two words, gathers them with one byte permute and compares
// all four with one SWAR compare against the row's bin; two more permutes
// widen the flags to bf16 1.0 / 0.0 pairs.  An M row whose bin is a pad
// bin (b >= B) or lies past F Bp is ANDed to zero once, outside the loop,
// so pad bins and bad bins need no branch.
//
// B, gh_exp, is built once per row step for the whole block, in shared
// memory, in the canonical K-major layout without swizzle: 8 x 16-byte
// core matrices (8 columns x 8 rows of K), the two K halves of a k16
// step 128 bytes apart (the descriptor's leading byte offset, LBO) and
// neighbouring 8-column groups 256 bytes apart (stride byte offset, SBO);
// a k16 step takes 32 N bytes.  Each row has at most two non-zero
// entries (g at its node's column, h at m_pad + node), so the tile is
// zeroed once and each step a thread writes its row's two entries and
// clears the two it wrote the last time this stage held a row.  Every M
// tile of the block, in both consumer warpgroups, reads the same B: each
// A fragment meets the whole N = 128 in one instruction.  The exact mode
// (T5 "fp32") splits gh into hi + mid + lo bf16 parts (the f32's rounding
// residuals fit three bf16), keeps three B tiles and issues three wgmma
// per A fragment into one f32 sum; the one-hot is exact in bf16, so every
// product is exact.
//
// Rows arrive through a two-stage ring in shared memory: each thread
// issues its loads of step s + 2 (its row's pos and gh, and up to 2,048 /
// 512 = 4 of the block's (row, feature) bins) right after it stages step
// s + 1, and stores them into the free stage at the end of step s + 1,
// converting on the way (bins to bytes, gh to bf16 entries of B).  The
// loads are plain ld.global into registers, not cp.async or TMA: the
// data is converted before it is stored, and int16 bins are below
// cp.async's 4-byte grain.  A warpgroup stages as soon as its own
// products of a step are done, while the others' still run; one barrier
// a step hands the stage over.  A producer warp with TMA boxes and
// setmaxnreg is the next step.
//
// Tiles and registers.  Four warpgroups a block, one M tile each at N =
// 128 (two below): 64 f32 accumulators a thread, within the 128
// registers a thread that 512 threads leave.  Each warpgroup builds its
// A fragment, issues its wgmma and waits for it (a wgmma reads its A
// registers until it completes, and the compiler may give them to the
// next fragment), so the warpgroups take turns at the tensor cores: four
// keep them busier than two of two tiles (0.88 against 1.10 ms at the
// mains' shape on the H100).  A block owns 4 (8) tiles = 256 (512)
// (feature, bin) rows; the grid is M blocks x node tiles x row chunks,
// the row chunks chosen to fill the SMs (8 x 16 = 128 blocks at the
// mains' shape).  Accumulators stay in registers for the block's whole
// row chunk; the flush adds them once, with red.global.add.f32, into the
// zeroed output at the strides given (zero cells skipped: a sum that
// received additions is never -0).  Float sums change order from run to
// run.
//
// The prototypes' knobs: r_tile (T5, T1) and fg (T1) change no result
// and are moot here: the row step is the kernel's own (256 rows, 64 in
// the exact mode, fewer when a block covers many narrow features), and
// every block stages its rows once for all the features its M tiles
// cover, whatever fg.  T5's bin_dtype is the width the kernel reads
// (bin_bytes 4 or 2); its hot_dtype only says whether gh is rounded.
//
// What bounds it on the H100.  The function is bytes-bound: 1M x 28
// int32 bins (112 MB) + pos + gh + the 0.96 MB output, ~0.037 ms at 3.35
// TB/s (int16 bins ~0.021 ms).  The one-hot product does 2 N_rows F Bp
// N operations, most of them on zeros: at n_node = 64 (N = 128) and
// Bp = 72, 5.2e11, ~0.52 ms at 989 TFLOP/s in bf16, three times that in
// the exact mode.  What the design does about the costs of the mma.sync
// kernels it replaces: the rows are staged once per block for all its
// features, not once per feature (T5) or per column group (T1); gh_exp
// is built once per row step for all M tiles, not per warp and feature;
// the one-hot fragment is built once per (tile, k16 step) and meets all
// N columns in one instruction, so T1's accumulator budget no longer
// forces it to be rebuilt per column group; and the products are
// wgmma, the tensor cores' full-rate path, running asynchronously beside
// the staging.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int OHW_WARPGROUPS = 4;  // warpgroups a block
constexpr int OHW_THREADS = 128 * OHW_WARPGROUPS;
constexpr int OHW_STAGE_BINS = 2048;  // staged bins (bytes) a step
constexpr int OHW_SLOTS =             // staged bins a thread per step
    (OHW_STAGE_BINS + OHW_THREADS - 1) / OHW_THREADS;

// One launch.  Mirrored field by field by ctypes in
// xgboost_tpu_torch/ops/cuda_hist_onehot.py (WgmmaArgs), which computes
// the tiling (wgmma_plan).
struct WgmmaArgs {
  const void* bins;          // element (r, f) at r * bin_sr + f * bin_sf
  const int32_t* pos;        // (n_rows,)
  const float* gh;           // g at r * gh_sr, h at r * gh_sr + gh_sc
  float* out;                // zeroed; cell strides below
  long long bin_sr, bin_sf, gh_sr, gh_sc;
  long long s_f, s_b, s_c, s_node;
  long long n_rows;
  long long rows_per_block;  // a multiple of step
  int n_feat, n_bin;         // n_bin <= 255
  int b_pad;                 // n_bin rounded up to 8
  int m_pad;                 // nodes per node tile, <= 64
  int n_node_out;            // nodes past this are not written
  int n_col;                 // N: 8, 16, 32, 64 or 128, >= 2 m_pad
  int n_mblk, n_mt;          // M blocks, node tiles
  int step;                  // rows a block step: a multiple of 16, <= 256
  int bin_bytes;             // 4: int32 bins, 2: int16
};

// M tiles a warpgroup: 64 f32 accumulators a thread at N = 128 and 64
// (within 128 registers a thread at 512 threads); two below N = 128 keep
// a block's features (at Bp = 8) within 65, so its row step >= 16
__host__ __device__ constexpr int ohw_tiles(int n) { return n >= 128 ? 1 : 2; }

// Dynamic shared memory of one block: two stages of NP B tiles, then two
// stages of staged bin bytes.
__host__ __device__ constexpr int ohw_smem(int n, int np, int step) {
  return 2 * np * step * n * 2 + 2 * OHW_STAGE_BINS;
}

__device__ __forceinline__ uint32_t ohw_prmt(uint32_t a, uint32_t b,
                                             uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// 0x80 in each byte of w equal to the same byte of t4, 0x00 in the others
// (SWAR: the low seven bits of a byte of x = w ^ t4, plus 0x7F, set its
// top bit unless they are all zero, and no byte carries into the next)
__device__ __forceinline__ uint32_t ohw_eq_msb(uint32_t w, uint32_t t4) {
  const uint32_t x = w ^ t4;
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

__device__ __forceinline__ uint16_t ohw_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The matrix descriptor of a K-major B tile without swizzle at shared
// address addr: start >> 4, LBO 128 bytes (the K halves of a core-matrix
// pair), SBO 256 bytes (neighbouring 8-column groups), layout type 0.
__device__ __forceinline__ uint64_t ohw_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)(128 >> 4) << 16 |
         (uint64_t)(256 >> 4) << 32;
}

__device__ __forceinline__ void ohw_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ohw_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// every committed group of this warpgroup complete
__device__ __forceinline__ void ohw_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread visible to wgmma (the async proxy)
__device__ __forceinline__ void ohw_fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator across a wait
__device__ __forceinline__ void ohw_fence_acc(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// d (64 x N f32, N / 2 a thread) += A (64 x 16 bf16, registers) @ B (16 x
// N bf16, shared memory at desc)
template <int N>
__device__ __forceinline__ void ohw_mma(float (&d)[N / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128,
                "N: 8, 16, 32, 64 or 128");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
}

// NP bf16 parts of gh: 1 (rounded) or 3 (exact); instantiated by the .cu
// files for N in 8, 16, 32, 64, 128.
template <int N, int NP>
__global__ void __launch_bounds__(OHW_THREADS, 1)
onehot_wgmma_kernel(const WgmmaArgs a) {
  constexpr int TW = ohw_tiles(N);
  constexpr int TPB = OHW_WARPGROUPS * TW;  // M tiles a block
  constexpr uint32_t ONE2 = 0x3F803F80u;  // bf16 1.0 in both halves
  extern __shared__ __align__(1024) uint8_t ohw_sm[];
  const int KS = a.step;
  const int b_bytes = KS * N * 2;      // one B tile of one stage
  uint8_t* s_b = ohw_sm;               // [stage][part] B tiles
  uint8_t* s_bin = ohw_sm + 2 * NP * b_bytes;  // [stage][feature][KS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m_rows = a.n_feat * a.b_pad;
  const int mt0 = blockIdx.x * TPB;
  const int f_lo = mt0 * 64 / a.b_pad;
  const int nf = (min(m_rows, (mt0 + TPB) * 64) - 1) / a.b_pad - f_lo + 1;
  const int node_base = blockIdx.y * a.m_pad;

  // this thread's two M rows in each of its tiles: the word offset of the
  // row's feature in a stage's bin bytes, its bin in four bytes, and 1.0
  // pairs, or 0 for a pad bin or a row past F Bp
  int a_word[TW][2];
  uint32_t a_key[TW][2], a_one[TW][2];
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mt0 + wg * TW + T) * 64 + wq * 16 + g + 8 * h;
      const int f = m / a.b_pad, b = m - f * a.b_pad;
      const bool ok = m < m_rows && b < a.n_bin;
      a_word[T][h] = ok ? (f - f_lo) * (KS >> 2) : 0;
      a_key[T][h] = (uint32_t)b * 0x01010101u;
      a_one[T][h] = ok ? ONE2 : 0u;
    }

  // staging: this thread's (row, feature) bins of a step (row | feature
  // << 8, ~0: none), rows in the inner order so that a warp reads whole
  // runs of a row's features
  uint32_t slot[OHW_SLOTS];
#pragma unroll
  for (int i = 0; i < OHW_SLOTS; ++i) {
    const int e = tid + i * OHW_THREADS;
    const int r = e / nf;
    slot[i] = e < KS * nf ? (uint32_t)r | (uint32_t)(e - r * nf) << 8 : ~0u;
  }
  const long long r_begin = (long long)blockIdx.z * a.rows_per_block;
  const long long r_end = min(a.n_rows, r_begin + a.rows_per_block);
  const int n_steps =
      r_begin < r_end ? (int)((r_end - r_begin + KS - 1) / KS) : 0;
  const int k_ofs = (tid >> 4) * (32 * N) + ((tid >> 3) & 1) * 128 +
                    (tid & 7) * 2;   // this thread's row slot in a B tile

  int pf_bin[OHW_SLOTS];
  int pf_pos = 0;
  float pf_g = 0.0f, pf_h = 0.0f;
  auto load_step = [&](long long r0) {
#pragma unroll
    for (int i = 0; i < OHW_SLOTS; ++i) {
      int v = -1;
      const long long r = r0 + (slot[i] & 0xFF);
      if (slot[i] != ~0u && r < r_end) {
        const long long e = r * a.bin_sr + (f_lo + (int)(slot[i] >> 8)) *
                                               a.bin_sf;
        v = a.bin_bytes == 4 ? __ldg(static_cast<const int32_t*>(a.bins) + e)
                             : (int)__ldg(static_cast<const int16_t*>(a.bins) +
                                          e);
      }
      pf_bin[i] = v;
    }
    const long long r = r0 + tid;
    pf_pos = -1;
    if (tid < KS && r < r_end) {
      pf_pos = __ldg(a.pos + r);
      pf_g = __ldg(a.gh + r * a.gh_sr);
      pf_h = __ldg(a.gh + r * a.gh_sr + a.gh_sc);
    }
  };
  // the node column this thread's row slot last wrote in each stage (-1:
  // none)
  int old0 = -1, old1 = -1;
  auto store_step = [&](int stage) {
    uint8_t* sb = s_bin + stage * OHW_STAGE_BINS;
#pragma unroll
    for (int i = 0; i < OHW_SLOTS; ++i)
      if (slot[i] != ~0u)
        sb[(int)(slot[i] >> 8) * KS + (int)(slot[i] & 0xFF)] =
            (uint8_t)min((unsigned)pf_bin[i], 255u);
    if (tid >= KS) return;
    uint8_t* bt = s_b + stage * NP * b_bytes + k_ofs;
    const int old = stage ? old1 : old0;
    if (old >= 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = old + c * a.m_pad;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          *reinterpret_cast<uint16_t*>(bt + p * b_bytes + (n >> 3) * 256 +
                                       (n & 7) * 16) = 0;
      }
    }
    const unsigned j = (unsigned)pf_pos - (unsigned)node_base;
    const int nw = j < (unsigned)a.m_pad ? (int)j : -1;
    if (nw >= 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = nw + c * a.m_pad;
        float x = c ? pf_h : pf_g;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint16_t bits = ohw_bf16_bits(x);
          *reinterpret_cast<uint16_t*>(bt + p * b_bytes + (n >> 3) * 256 +
                                       (n & 7) * 16) = bits;
          x -= __bfloat162float(__ushort_as_bfloat16(bits));
        }
      }
    }
    if (stage)
      old1 = nw;
    else
      old0 = nw;
  };

  float acc[TW][N / 2];
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[T][i] = 0.0f;

  for (int i = tid * 16; i < 2 * NP * b_bytes; i += OHW_THREADS * 16)
    *reinterpret_cast<uint4*>(s_b + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (n_steps > 0) {
    load_step(r_begin);
    store_step(0);
  }
  if (n_steps > 1) load_step(r_begin + KS);
  ohw_fence_proxy();
  __syncthreads();

  const int off = 2 * (t & 1);  // rows 2t, 2t+1 in a word of four
  const uint32_t sel = off | (off + 1) << 4 | (off + 4) << 8 | (off + 5) << 12;
  const uint32_t b_base = (uint32_t)__cvta_generic_to_shared(s_b);
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) ohw_fence_acc(acc[T][i]);
  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    const uint32_t* wb =
        reinterpret_cast<const uint32_t*>(s_bin + cur * OHW_STAGE_BINS);
    const uint64_t desc0 = ohw_desc(b_base + cur * NP * b_bytes);
    for (int kb = 0; kb < (KS >> 4); ++kb) {
      const int w = kb * 4 + (t >> 1);
      uint32_t af[TW][4];
#pragma unroll
      for (int T = 0; T < TW; ++T) {
        const uint32_t q0 = ohw_prmt(wb[a_word[T][0] + w],
                                     wb[a_word[T][0] + w + 2], sel);
        const uint32_t q1 = ohw_prmt(wb[a_word[T][1] + w],
                                     wb[a_word[T][1] + w + 2], sel);
        const uint32_t e0 = ohw_eq_msb(q0, a_key[T][0]);
        const uint32_t e1 = ohw_eq_msb(q1, a_key[T][1]);
        af[T][0] = ohw_prmt(e0, 0, 0x9988) & a_one[T][0];  // row g, k 2t..
        af[T][1] = ohw_prmt(e1, 0, 0x9988) & a_one[T][1];  // row g + 8
        af[T][2] = ohw_prmt(e0, 0, 0xBBAA) & a_one[T][0];  // k 2t+8..
        af[T][3] = ohw_prmt(e1, 0, 0xBBAA) & a_one[T][1];
      }
      ohw_fence();
#pragma unroll
      for (int T = 0; T < TW; ++T)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          ohw_mma<N>(acc[T], af[T],
                     desc0 + (uint64_t)((p * b_bytes + kb * 32 * N) >> 4));
      ohw_commit();
      // A wgmma reads its A registers until its group completes, and the
      // compiler, which sees the asm read them at issue, may give them to
      // the next step's fragments: so wait for the group here.  The other
      // warpgroup's products fill the tensor cores meanwhile.
      ohw_wait();
    }
    // every group that read the other stage completed before the last
    // barrier, so it is free
    if (s + 1 < n_steps) store_step(cur ^ 1);
    if (s + 2 < n_steps) load_step(r_begin + (long long)(s + 2) * KS);
    ohw_fence_proxy();
    __syncthreads();
  }
  ohw_wait();
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) ohw_fence_acc(acc[T][i]);

  // ---- flush: accumulator 4j + 2h + q is M row g + 8h, column 8j + 2t + q
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mt0 + wg * TW + T) * 64 + wq * 16 + g + 8 * h;
      const int f = m / a.b_pad, b = m - f * a.b_pad;
      if (m >= m_rows || b >= a.n_bin) continue;
      float* cell = a.out + f * a.s_f + b * a.s_b;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float v = acc[T][4 * j + 2 * h + q];
          const int n = 8 * j + 2 * t + q;
          if (v == 0.0f || n >= 2 * a.m_pad) continue;
          const int ch = n >= a.m_pad;
          const int node = node_base + n - ch * a.m_pad;
          if (node < a.n_node_out)
            atomicAdd(cell + ch * a.s_c + node * a.s_node, v);
        }
    }
}

template <int N, int NP>
cudaError_t onehot_wgmma_launch_n(const WgmmaArgs* a, int n_row_blocks,
                                  cudaStream_t stream) {
  const int smem = ohw_smem(N, NP, a->step);
  const cudaError_t e = cudaFuncSetAttribute(
      onehot_wgmma_kernel<N, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a->n_mblk, a->n_mt, n_row_blocks);
  onehot_wgmma_kernel<N, NP><<<grid, OHW_THREADS, smem, stream>>>(*a);
  return cudaGetLastError();
}

// The launch's tiling as the kernel needs it: the wrapper's plan
// (wgmma_plan) gives it, and a launch that breaks it is refused.
inline bool ohw_tiling_ok(const WgmmaArgs* a) {
  if (a->n_bin < 1 || a->n_bin > 255 || a->b_pad != (a->n_bin + 7) / 8 * 8 ||
      a->m_pad < 1 || a->m_pad > 64 || 2 * a->m_pad > a->n_col ||
      a->step < 16 || a->step > 256 || a->step % 16 ||
      a->rows_per_block % a->step || a->n_feat < 1)
    return false;
  const int tpb = OHW_WARPGROUPS * ohw_tiles(a->n_col);
  const int m_rows = a->n_feat * a->b_pad;
  if (a->n_mblk != (m_rows + 64 * tpb - 1) / (64 * tpb)) return false;
  for (int blk = 0; blk < a->n_mblk; ++blk) {  // staged bins fit a stage
    const int m0 = blk * tpb * 64;
    const int m1 = m0 + tpb * 64 < m_rows ? m0 + tpb * 64 : m_rows;
    if (a->step * ((m1 - 1) / a->b_pad - m0 / a->b_pad + 1) > OHW_STAGE_BINS)
      return false;
  }
  return true;
}

// One launch with NP parts at a->n_col columns.
template <int NP>
cudaError_t onehot_wgmma_launch(const WgmmaArgs* a, int n_row_blocks,
                                cudaStream_t stream) {
  if (!ohw_tiling_ok(a)) return cudaErrorInvalidValue;
  switch (a->n_col) {
    case 8:
      return onehot_wgmma_launch_n<8, NP>(a, n_row_blocks, stream);
    case 16:
      return onehot_wgmma_launch_n<16, NP>(a, n_row_blocks, stream);
    case 32:
      return onehot_wgmma_launch_n<32, NP>(a, n_row_blocks, stream);
    case 64:
      return onehot_wgmma_launch_n<64, NP>(a, n_row_blocks, stream);
    case 128:
      return onehot_wgmma_launch_n<128, NP>(a, n_row_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
