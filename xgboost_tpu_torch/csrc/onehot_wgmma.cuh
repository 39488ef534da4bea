// The one-hot histogram as a wgmma product on Hopper (sm_90a): the
// kernel of T5 (onehot_variant.cu), T1 (onehot_group.cu), T6
// (onehot_r4.cu), T7 (onehot_r5.cu), T3 (onehot_i8.cu) and T2
// (onehot_notrans.cu).
//
// Replaces the TPU kernels of tools/hist_microbench.py:59 variant (body
// :26), tools/hist_group_proto.py:59 grouped (body :23),
// tools/hist_r4_ab.py:78 build (body make_kernel :35),
// tools/hist_r5_ab.py:80 build (body make_kernel :40),
// tools/hist_int8_proto.py:61 build_i8 (body :31) and
// tools/hist_notrans_proto.py:56 build (body :28).  All six compute one
// function: a level histogram of bins at the strides given (row-major
// (N, F) int32 / int16 for T5 and T1, uint8 for T2; feature-major (F, n)
// int32 / uint8 for T6, T7 and T3), gh (g, h) at the strides given and
// pos, into an output
// zeroed by the wrapper and written by the flush at the cell strides
// given.  Rows with pos outside the node tile add nothing; a (row,
// feature) whose bin lies outside [0, B) adds nothing to that feature and
// still counts in the others.
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
// features x 72 = 2,016 rows, 32 tiles of 64 at the T5 main's B = 67); N
// = 2 m_pad rounded up to one of 8, 16, 32, 64, 128 (n_node = 1-4: N = 8;
// 64 nodes: 128); K is rows.  Two element types (template ET):
//   bf16  wgmma.mma_async.m64nNk16.f32.bf16.bf16, gh rounded to bf16 (or,
//         T5's exact mode, split into three bf16 parts), f32 sums;
//   s8    wgmma.mma_async.m64nNk32.s32.s8.s8 (T7 at N = 128; T3 and T2
//         at N = 8-64, or 128 above 32 nodes), gh the low byte of an
//         int32 (a wrap), s32 sums that wrap (no .satfinite) and are
//         bitwise the same from run to run.
//
// A, the one-hot, is built in registers and never exists in device
// memory.  A thread's fragment of an m64k16 bf16 tile holds M rows g and
// g + 8 of its warp's 16 and K columns 2t, 2t+1, 2t+8, 2t+9; of an
// m64k32 s8 tile rows g and g + 8 and K 4t..4t+3 and 4t+16..4t+19, four
// K of one row a register.  The block stages its features' bins of a row
// step as bytes, [feature][row] (a bin outside [0, 256) becomes 255,
// which no bin < B <= 255 matches), so a bf16 fragment takes its four
// rows' bins of one feature from two words and one byte permute, and an
// s8 register is one aligned word.  How A is built (template AB; T6's and
// T7's modes compare these builds):
//   BITS   four bytes compared at once (SWAR, ohw_eq_msb); bf16: the flags
//          widened by byte permutes and ANDed with 0x3F803F80 (T5, T1, T6
//          i16hot); s8: the flags shifted to 0x01 bytes (T7 u8cmp);
//   NUM    each byte compared alone as an int; bf16: 1.0f / 0.0f selected
//          and pairs converted by cvt.rn.bf16x2.f32 (T6 prod, u8bins);
//          s8: the four 0 / 1 bytes packed (T7 prod);
//   CONST  1.0 in the bin-0 row of every feature, no bins staged (T6
//          dotfloor: every feature's bin 0 holds the node totals).
// An M row whose bin is a pad bin (b >= B) or lies past F Bp is ANDed to
// zero once, outside the loop, so pad bins and bad bins need no branch.
//
// B, gh_exp, is built once per row step for the whole block, in shared
// memory, in the canonical K-major layout without swizzle: core matrices
// of 8 N rows x 16 bytes (8 bf16 or 16 s8 K), the two K halves of an
// instruction's 32 bytes of K 128 bytes apart (the descriptor's leading
// byte offset, LBO) and neighbouring 8-column groups 256 bytes apart
// (stride byte offset, SBO); an instruction's K takes 32 N bytes.  The
// same bytes in both types, so the same descriptor.  Each row has at most
// two non-zero entries (g at its node's column, h at m_pad + node), so
// the tile is zeroed once and each step a thread writes its row's two
// entries and clears the two it wrote the last time this stage held a
// row.  Every M tile of the block reads the same B: each A fragment meets
// the whole N in one instruction.  T5's exact mode keeps three B tiles
// (hi + mid + lo bf16 parts of gh) and issues three wgmma per A fragment
// into one f32 sum; the one-hot is exact in bf16, so every product is
// exact.
//
// Rows arrive through a two-stage ring in shared memory: each thread
// issues its loads of step s + 2 (its row's pos and gh, and up to 4 of
// the block's (row, feature) bins) right after it stages step s + 1, and
// stores them into the free stage at the end of step s + 1, converting on
// the way (bins to bytes, gh to B entries).  Row-major bins are read with
// features inner, so a warp reads whole runs of a row's features;
// feature-major bins with rows inner, so a warp reads a run of one
// feature's rows, and uint8 ones (T6 u8bins, T7) 16 rows a 16-byte load
// where the rows of a feature are 16-byte aligned: the stage is already
// [feature][row] bytes, so that is a straight copy.  A warpgroup stages as
// soon as its own products of a step are done, while the others' still
// run; one barrier a step hands the stage over.  A producer warp with TMA
// boxes and setmaxnreg is the next step.
//
// Tiles and registers.  Four warpgroups a block, one M tile each at N =
// 128 (two below): 64 accumulators a thread, within the 128 registers a
// thread that 512 threads leave.  Each warpgroup builds its A fragment,
// issues its wgmma and waits for it (a wgmma reads its A registers until
// it completes, and the compiler may give them to the next fragment), so
// the warpgroups take turns at the tensor cores.  A block owns 4 (8)
// tiles = 256 (512) (feature, bin) rows; the grid is M blocks x node
// tiles x row chunks, the row chunks chosen to fill the SMs.
// Accumulators stay in registers for the block's whole row chunk; the
// flush adds them once, with red.global.add (f32 or s32), into the zeroed
// output at the strides given (zero cells skipped: a float sum that
// received additions is never -0, and an int zero adds nothing).
//
// Levels (T7, n_levels > 1; template LVL): row r is in node floor_mod(pos
// + lv, 64) of level lv, pad rows (pos = -1) included.  Each level has its
// own B tile a stage (the same entries, columns turned by lv), and one
// one-hot must meet several levels' B, which 64 accumulators a (tile,
// level) pair do not leave registers for.  So in this form A comes from
// shared memory: each step the whole block writes the s8 one-hot of its
// M tiles once, in the same K-major layout (64 rows x 32 K = 2,048 bytes
// an instruction), double buffered, and each warpgroup owns one (M tile,
// level) pair and reads its tile's A through a descriptor.  A block
// covers 4 / lv_block tiles x lv_block levels; further levels are level
// groups on the grid's y.  A warpgroup no longer waits after each
// product: it issues a step's products, the block stages the next step
// and builds its A into the other buffer, then waits before the barrier
// that frees the stage.
//
// The small-N form (T3, T2: s8 below N = 128, template SMALL).  At N = 8
// a product is a few cycles of the tensor cores, and the cost moves to the
// A build, the staging and the wait for the products.  So a warpgroup
// holds up to 7, 5, 3 or 2 M tiles (N = 8, 16, 32, 64: their N / 2
// accumulators and four live A registers each within the 128 registers a
// thread), builds all their fragments of a k32 step, issues their
// products as one group and waits once; a block holds up to 4 x that
// (28 tiles at N = 8: the 28 features of B = 64 in one block, which stages
// each row's pos and gh and builds its gh_exp entries once), the tiles
// spread evenly over as few blocks as hold them and over a block's
// warpgroups.  Bp is rounded up to 16, so a thread's M rows g and g + 8
// of a tile are bins b and b + 8 of one feature: one word of staged bytes
// serves both, two words a tile and k32 step, and no mask (a pad bin's
// row is built like any other and never flushed).  A stage holds 4,096
// bins (128 rows at 28 features).  T2's row-major uint8 bins are read a
// word (four features of a row) a load where the rows are 4-byte aligned
// (template ST RWORD), else a byte a load (ST FEAT with row-major
// strides).
//
// The prototypes' knobs: r_tile (T5, T1, T6, T3, T2) and fg (T1) change no
// result and are moot here, but for where T6, T3 and T2 drop their tail:
// the row step
// is the kernel's own (at most 256 rows, 64 in the exact mode, fewer
// when a block covers many narrow features), and every block stages its
// rows once for all the features its M tiles cover.  T5's bin_dtype is
// the width the kernel reads (bin_bytes 4 or 2); its hot_dtype only says
// whether gh is rounded.
//
// What bounds it on the H100.  The function is bytes-bound: 1M x 28
// int32 bins (112 MB) + pos + gh + the 0.96 MB output, ~0.037 ms at 3.35
// TB/s (uint8 bins ~0.012 ms).  The one-hot product does 2 N_rows F Bp N
// operations, most of them on zeros: at n_node = 64 (N = 128) and Bp =
// 72, 5.2e11, ~0.52 ms at 989 TFLOP/s in bf16, three times that in the
// exact mode, half of it at 1,979 TOP/s in s8, once per level.  What the
// design does about the costs of the mma.sync kernels it replaces: the
// rows are staged once per block for all its features, not once per
// feature; gh_exp is built once per row step for all M tiles, not per
// warp and feature; the one-hot fragment is built once per (tile, K step)
// and meets all N columns in one instruction (with levels, once per
// (tile, step) for all the block's levels); and the products are wgmma,
// the tensor cores' full-rate path, running asynchronously beside the
// staging.  T3 and T2 (B = 64, M = 1-32 nodes, N = 8-64): T3's bytes
// take ~0.037 ms (int32 bins), T2's ~0.012 (uint8), the int8 floor 0.015
// (N = 8) to 0.117 ms (N = 64); below N = 64 the A build, two loads and
// about 22 integer instructions a thread, tile and k32 step, takes longer
// than either.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

constexpr int OHW_WARPGROUPS = 4;  // warpgroups a block
constexpr int OHW_THREADS = 128 * OHW_WARPGROUPS;
constexpr int OHW_STAGE_BINS = 2048;  // staged bins (bytes) a step
constexpr int OHW_SMEM_MAX = 232448;  // dynamic shared memory of a block

// The product's element type (template ET), the one-hot A build
// (template AB) and the staging of the bins (template ST: row-major
// int32 / int16; one element a load with rows inner, of feature-major
// int32 / uint8 or row-major uint8 bins; feature-major uint8 16 rows a
// load; or row-major uint8 a word of four features a load)
enum { OHW_BF16 = 0, OHW_S8 = 1 };
enum { OHW_A_BITS = 0, OHW_A_NUM = 1, OHW_A_CONST = 2 };
enum { OHW_ST_ROWS = 0, OHW_ST_FEAT = 1, OHW_ST_VEC = 2, OHW_ST_RWORD = 3 };

// One launch.  Mirrored field by field by ctypes in
// xgboost_tpu_torch/ops/cuda_hist_onehot.py (WgmmaArgs), which computes
// the tiling (wgmma_plan).
struct WgmmaArgs {
  const void* bins;          // element (r, f) at r * bin_sr + f * bin_sf
  const int32_t* pos;        // (n_rows,)
  const void* gh;            // g at r * gh_sr, h at r * gh_sr + gh_sc: f32
                             // (bf16 products) or int32 (s8: its low byte)
  void* out;                 // zeroed, f32 or int32; cell strides below
  long long bin_sr, bin_sf, gh_sr, gh_sc;
  long long s_lv, s_f, s_b, s_c, s_node;
  long long n_rows;
  long long rows_per_block;  // a multiple of step
  int n_feat, n_bin;         // n_bin <= 255
  int b_pad;                 // n_bin rounded up to 8
  int m_pad;                 // nodes per node tile, <= 64 (64 with levels)
  int n_node_out;            // nodes past this are not written
  int n_col;                 // N: 8, 16, 32, 64 or 128, >= 2 m_pad
  int n_mblk;                // M blocks
  int n_mt;                  // grid y: node tiles, or level groups
  int step;                  // rows a block step: a multiple of 16 (s8:
                             // 32), <= 256
  int bin_bytes;             // 4: int32 bins, 2: int16, 1: uint8
  int fm;                    // 1: feature-major bins (OHW_ST_FEAT, _VEC)
  int vec;                   // 1: uint8 bins read 16 feature-major rows a
                             // load (OHW_ST_VEC), or a row-major row's
                             // four features a word (OHW_ST_RWORD)
  int n_levels;              // levels form: > 1
  int lv_block;              // levels form: levels a block, 1, 2 or 4
};

// M tiles a warpgroup: 64 f32 accumulators a thread at N = 128 and 64
// (within 128 registers a thread at 512 threads); two below N = 128 keep
// a block's features (at Bp = 8) within 65, so its row step >= 16
__host__ __device__ constexpr int ohw_tiles(int n) { return n >= 128 ? 1 : 2; }

// s8 products below N = 128 without levels (T3, T2): the small-N form
__host__ __device__ constexpr bool ohw_small(int n, bool s8, bool lvl) {
  return s8 && !lvl && n < 128;
}
// M tiles a warpgroup may hold in the small-N form: each holds N / 2
// accumulators and its four A registers, which stay live until the
// step's products complete, so 7 x (4 + 4) at N = 8, 5 x (8 + 4), 3 x
// (16 + 4), 2 x (32 + 4): 56-72 registers of the 128 a thread
__host__ __device__ constexpr int ohw_s8_tiles(int n) {
  return n <= 8 ? 7 : n <= 16 ? 5 : n <= 32 ? 3 : 2;
}
__host__ __device__ constexpr int ohw_tw(int n, bool s8, bool lvl) {
  return lvl ? 1 : ohw_small(n, s8, lvl) ? ohw_s8_tiles(n) : ohw_tiles(n);
}
// staged bins (bytes) a stage: twice the default in the small-N form,
// whose products are short, so that a step is 128 rows at 28 features
__host__ __device__ constexpr int ohw_stage_bins(int n, bool s8, bool lvl) {
  return ohw_small(n, s8, lvl) ? 2 * OHW_STAGE_BINS : OHW_STAGE_BINS;
}
// staged elements a thread per step: bins, or with OHW_ST_RWORD words
// (a step's words are at most step x (nf + 6) / 4 <= stage / 4 + 384)
__host__ __device__ constexpr int ohw_slots(int sb, int st) {
  return st == OHW_ST_RWORD ? (sb / 4 + 384 + OHW_THREADS - 1) / OHW_THREADS
                            : (sb + OHW_THREADS - 1) / OHW_THREADS;
}

// Dynamic shared memory of one block: two stages of B tiles (NP parts,
// or lv_block levels), with levels two stages of the block's A tiles,
// then two stages of staged bin bytes.
inline int ohw_smem(const WgmmaArgs* a, bool s8, bool lvl, int np) {
  const int nb = lvl ? a->lv_block : np;
  const int tpb = lvl ? OHW_WARPGROUPS / a->lv_block : 0;
  return 2 * nb * a->step * a->n_col * (s8 ? 1 : 2) +
         2 * tpb * 64 * a->step + 2 * ohw_stage_bins(a->n_col, s8, lvl);
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

// 0x01 in each byte of w equal to b, each byte widened to int and
// compared alone (the prototypes' int32 iota compare)
__device__ __forceinline__ uint32_t ohw_eq_widened(uint32_t w, int b) {
  uint32_t r = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r |= (uint32_t)((int)((w >> (8 * k)) & 0xFFu) == b) << (8 * k);
  return r;
}

__device__ __forceinline__ uint16_t ohw_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// bf16 pair (lo, hi) of 1.0 / 0.0 from two flags, by numbers: a float
// selected each, one cvt.rn.bf16x2.f32 for the pair
__device__ __forceinline__ uint32_t ohw_num2(bool lo, bool hi) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(lo ? 1.0f : 0.0f, hi ? 1.0f : 0.0f);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A bf16 A fragment from q0 / q1, the bins of rows 2t, 2t+1, 2t+8, 2t+9
// for M rows g / g + 8, whose bins are key (four equal bytes) and whose
// masks are one (0x3F803F80, or 0 for a pad row)
template <int AB>
__device__ __forceinline__ void ohw_hot_bf16(uint32_t (&af)[4], uint32_t q0,
                                             uint32_t q1,
                                             const uint32_t (&key)[2],
                                             const uint32_t (&one)[2]) {
  if constexpr (AB == OHW_A_BITS) {
    const uint32_t e0 = ohw_eq_msb(q0, key[0]);
    const uint32_t e1 = ohw_eq_msb(q1, key[1]);
    af[0] = ohw_prmt(e0, 0, 0x9988) & one[0];  // row g, k 2t, 2t+1
    af[1] = ohw_prmt(e1, 0, 0x9988) & one[1];  // row g + 8
    af[2] = ohw_prmt(e0, 0, 0xBBAA) & one[0];  // k 2t+8, 2t+9
    af[3] = ohw_prmt(e1, 0, 0xBBAA) & one[1];
  } else {
    const int k0 = (int)(key[0] & 0xFFu), k1 = (int)(key[1] & 0xFFu);
    int x0[4], x1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x0[k] = (int)((q0 >> (8 * k)) & 0xFFu);
      x1[k] = (int)((q1 >> (8 * k)) & 0xFFu);
    }
    af[0] = ohw_num2(x0[0] == k0, x0[1] == k0) & one[0];
    af[1] = ohw_num2(x1[0] == k1, x1[1] == k1) & one[1];
    af[2] = ohw_num2(x0[2] == k0, x0[3] == k0) & one[0];
    af[3] = ohw_num2(x1[2] == k1, x1[3] == k1) & one[1];
  }
}

// One register of an s8 A fragment: 0x01 in each byte of w (four rows'
// bins) equal to the M row's bin (key, four equal bytes)
template <int AB>
__device__ __forceinline__ uint32_t ohw_hot_s8(uint32_t w, uint32_t key) {
  if constexpr (AB == OHW_A_BITS)
    return ohw_eq_msb(w, key) >> 7;
  else
    return ohw_eq_widened(w, (int)(key & 0xFFu));
}

// The matrix descriptor of a K-major tile without swizzle at shared
// address addr: start >> 4, LBO 128 bytes (the K halves of a core-matrix
// pair), SBO 256 bytes (neighbouring 8-row groups of N, or of M for an A
// tile), layout type 0.
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
__device__ __forceinline__ void ohw_fence_acc(int& x) {
  asm volatile("" : "+r"(x)::"memory");
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

// the 64 s32 accumulators of an m64n128 tile as asm operands
#define OHW_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define OHW_R64(d)                                                          \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),   \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),          \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),      \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),      \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),      \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),      \
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),      \
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),      \
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),      \
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),      \
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),      \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),      \
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// d (64 x 128 s32, 64 a thread) += A (64 x 32 s8, registers) @ B (32 x
// 128 s8, shared memory at desc); the sums wrap (no .satfinite)
__device__ __forceinline__ void ohw_mma_s8(int (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " OHW_D64
      ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : OHW_R64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the same with A (64 x 32 s8) from shared memory at desc_a
__device__ __forceinline__ void ohw_mma_s8_ss(int (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " OHW_D64
      ", %64, %65, p;\n}\n"
      : OHW_R64(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x N s32, N / 2 a thread) += A (64 x 32 s8, registers) @ B (32 x N
// s8, shared memory at desc) at N = 8, 16, 32, 64 (128: ohw_mma_s8); the
// sums wrap
template <int N>
__device__ __forceinline__ void ohw_mma_s8n(int (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128,
                "N: 8, 16, 32, 64 or 128");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else {
    ohw_mma_s8(d, a, desc);
  }
}

// ET the element type, NP its gh parts (bf16: 1 rounded, or 3 exact), AB
// the one-hot build, LVL the levels form (s8, A from shared memory), ST
// the staging; instantiated by the .cu files.
template <int N, int NP, int ET, int AB, bool LVL, int ST>
__global__ void __launch_bounds__(OHW_THREADS, 1)
onehot_wgmma_kernel(const WgmmaArgs a) {
  constexpr bool S8 = ET == OHW_S8;
  static_assert(!S8 || (NP == 1 && AB != OHW_A_CONST),
                "s8: one part, a built one-hot");
  static_assert(!LVL || (S8 && N == 128), "levels: s8 at N = 128 only");
  static_assert(ST != OHW_ST_RWORD || S8, "row-major uint8 words: s8 only");
  typedef typename std::conditional<S8, int, float>::type Acc;
  constexpr bool SMALL = ohw_small(N, S8, LVL);  // T3, T2 below N = 128
  constexpr int ES = S8 ? 1 : 2;     // bytes of a B entry
  constexpr int TW = ohw_tw(N, S8, LVL);
  constexpr int NBM = LVL ? OHW_WARPGROUPS : NP;  // most B tiles a stage
  constexpr int SB = ohw_stage_bins(N, S8, LVL);  // bytes of a bin stage
  constexpr int SLOTS = ohw_slots(SB, ST);
  constexpr uint32_t ONE2 = 0x3F803F80u;  // bf16 1.0 in both halves
  extern __shared__ __align__(1024) uint8_t ohw_sm[];
  const int KS = a.step;
  const int nb = LVL ? a.lv_block : NP;  // B tiles a stage: parts or levels
  const int m_rows = a.n_feat * a.b_pad;
  const int n_tiles = (m_rows + 63) >> 6;
  // M tiles a block: the small-N form spreads the tiles evenly over its
  // M blocks
  const int TPB = LVL     ? OHW_WARPGROUPS / nb
                  : SMALL ? (n_tiles + a.n_mblk - 1) / a.n_mblk
                          : OHW_WARPGROUPS * TW;
  const int b_bytes = KS * N * ES;       // one B tile of one stage
  const int a_bytes = 64 * KS;           // one s8 A tile (levels)
  uint8_t* s_b = ohw_sm;                 // [stage][part | level] B tiles
  uint8_t* s_a = ohw_sm + 2 * nb * b_bytes;  // levels: [stage][tile] A
  uint8_t* s_bin = s_a + (LVL ? 2 * TPB * a_bytes : 0);  // [stage][f][KS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int mt0 = blockIdx.x * TPB;
  const int f_lo = mt0 * 64 / a.b_pad;
  const int nf = (min(m_rows, (mt0 + TPB) * 64) - 1) / a.b_pad - f_lo + 1;
  // row-major uint8 words: the first word of the block's features in a
  // row, and the words they span
  const int w_lo = f_lo >> 2;
  const int n_wd = ((f_lo + nf - 1) >> 2) - w_lo + 1;
  const int node_base = LVL ? 0 : blockIdx.y * a.m_pad;
  const int lv0 = LVL ? blockIdx.y * nb : 0;  // the block's first level
  // the small-N form: the block's tiles over its warpgroups, as evenly as
  // they go (ntw <= TW each)
  const int bt = SMALL ? min(TPB, n_tiles - mt0) : 0;
  const int ntw = SMALL ? (bt >> 2) + (wg < (bt & 3)) : TW;
  // this warpgroup's first M tile in the block, and its level
  const int wt0 = LVL     ? wg % TPB
                  : SMALL ? wg * (bt >> 2) + min(wg, bt & 3)
                          : wg * TW;
  const int lv = LVL ? lv0 + wg / TPB : 0;
  const bool busy =
      !LVL || (lv < a.n_levels && (mt0 + wt0) * 64 < m_rows);

  // this thread's two M rows in each of its tiles: the word offset of the
  // row's feature in a stage's bin bytes, its bin in four bytes, and its
  // mask (bf16 1.0 pairs, s8 all ones; dotfloor: 1.0 pairs in bin 0), or
  // 0 for a pad bin or a row past F Bp
  int a_word[TW][2];
  uint32_t a_key[TW][2], a_one[TW][2];
  if constexpr (!SMALL) {
#pragma unroll
    for (int T = 0; T < TW; ++T)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mt0 + wt0 + T) * 64 + wq * 16 + g + 8 * h;
        const int f = m / a.b_pad, b = m - f * a.b_pad;
        const bool ok = m < m_rows && b < a.n_bin;
        a_word[T][h] = ok ? (f - f_lo) * (KS >> 2) : 0;
        a_key[T][h] = (uint32_t)b * 0x01010101u;
        a_one[T][h] = !ok                           ? 0u
                      : S8                          ? ~0u
                      : AB != OHW_A_CONST || b == 0 ? ONE2
                                                    : 0u;
      }
  }
  // the small-N form: Bp is a multiple of 16, so M rows g and g + 8 of a
  // tile are bins b and b + 8 of one feature, and one word of staged
  // bytes serves both: the word offset of the feature and b in four
  // bytes.  A pad bin or a row past F Bp is built like any other and
  // never flushed
  int s_word[SMALL ? TW : 1];
  uint32_t s_key[SMALL ? TW : 1];
  if constexpr (SMALL) {
#pragma unroll
    for (int T = 0; T < TW; ++T) {
      const int m = (mt0 + wt0 + T) * 64 + wq * 16 + g;
      const int f = m / a.b_pad, b = m - f * a.b_pad;
      s_word[T] = T < ntw && m < m_rows ? (f - f_lo) * (KS >> 2) : 0;
      s_key[T] = (uint32_t)b * 0x01010101u;
    }
  }
  // levels: the s8 A this thread builds, 16 bytes at a time.  Group u =
  // tid + 512 i of a tile is 4 K words (16 rows) of one M row, at byte
  // 16 u of the K-major layout: M row ((u >> 4) & 7) 8 + (u & 7), K words
  // 8 (u >> 7) + 4 ((u >> 3) & 1) + 0..3, so a warp writes 512
  // contiguous bytes.  A thread's M row is the same in every group: the
  // byte offset of its feature's rows (K half included) in a stage, its
  // key and its mask, in each of the block's tiles
  int c_off[OHW_WARPGROUPS];
  uint32_t c_key[OHW_WARPGROUPS], c_one[OHW_WARPGROUPS];
  if constexpr (LVL) {
    const int am = ((tid >> 4) & 7) * 8 + (tid & 7);
#pragma unroll
    for (int T = 0; T < OHW_WARPGROUPS; ++T) {
      const int m = (mt0 + T) * 64 + am;
      const int f = m / a.b_pad, b = m - f * a.b_pad;
      const bool ok = T < TPB && m < m_rows && b < a.n_bin;
      c_off[T] = (ok ? (f - f_lo) * KS : 0) + ((tid >> 3) & 1) * 16;
      c_key[T] = (uint32_t)b * 0x01010101u;
      c_one[T] = ok ? ~0u : 0u;
    }
  }

  // staging: this thread's (row, feature) bins of a step (row | feature
  // << 8, ~0: none).  Row-major bins: rows in the inner order so that a
  // warp reads whole runs of a row's features; one element a load (ST
  // FEAT): neighbouring threads on neighbouring rows of one feature, so
  // that a warp reads a run of a feature-major feature's rows and stores
  // a run of one feature's bytes; with vec, slot 0 is 16 rows of one
  // feature; row-major uint8 words (ST RWORD): (row, word) pairs,
  // neighbouring threads on neighbouring rows of one word, so that a
  // warp's byte stores fall on one feature's run of rows (no bank
  // conflict)
  uint32_t slot[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e = tid + i * OHW_THREADS;
    uint32_t sl = ~0u;
    if constexpr (ST == OHW_ST_VEC) {
      const int n16 = KS >> 4;
      if (i == 0 && e < n16 * nf)
        sl = (uint32_t)(e % n16 * 16) | (uint32_t)(e / n16) << 8;
    } else if constexpr (ST == OHW_ST_FEAT) {
      if (e < KS * nf) sl = (uint32_t)(e % KS) | (uint32_t)(e / KS) << 8;
    } else if constexpr (ST == OHW_ST_RWORD) {
      if (e < KS * n_wd) sl = (uint32_t)(e % KS) | (uint32_t)(e / KS) << 8;
    } else if (e < KS * nf) {
      const int r = e / nf;
      sl = (uint32_t)r | (uint32_t)(e - r * nf) << 8;
    }
    slot[i] = sl;
  }
  const long long r_begin = (long long)blockIdx.z * a.rows_per_block;
  const long long r_end = min(a.n_rows, r_begin + a.rows_per_block);
  const int n_steps =
      r_begin < r_end ? (int)((r_end - r_begin + KS - 1) / KS) : 0;
  // this thread's row slot in a B tile
  const int k_ofs = S8 ? (tid >> 5) * (32 * N) + ((tid >> 4) & 1) * 128 +
                             (tid & 15)
                       : (tid >> 4) * (32 * N) + ((tid >> 3) & 1) * 128 +
                             (tid & 7) * 2;

  // Loads only: nothing here reads a loaded value, so no thread waits
  // for its loads before the next step's products (its row's node is
  // found when the step is stored)
  // the bins, with vec slot 0's 16 bytes, with RWORD four features' bins
  uint32_t pf_bin[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) pf_bin[i] = ~0u;
  int pf_pos = 0;
  bool pf_ok = false;          // the row slot holds a row of the chunk
  uint32_t pf_g = 0u, pf_h = 0u;  // raw f32 or int32 bits
  auto load_step = [&](long long r0) {
    if constexpr (AB == OHW_A_CONST) {
      // no bins: the one-hot is a constant
    } else if constexpr (ST == OHW_ST_VEC) {
      const long long r = r0 + (slot[0] & 0xFF);
      if (slot[0] != ~0u && r < r_end) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const uint8_t*>(a.bins) +
            (f_lo + (int)(slot[0] >> 8)) * a.bin_sf + r));
        pf_bin[0] = v.x;
        pf_bin[1] = v.y;
        pf_bin[2] = v.z;
        pf_bin[3] = v.w;
      }
    } else if constexpr (ST == OHW_ST_RWORD) {
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        uint32_t v = 0u;
        const long long r = r0 + (slot[i] & 0xFF);
        if (slot[i] != ~0u && r < r_end)
          v = __ldg(reinterpret_cast<const uint32_t*>(
                        static_cast<const uint8_t*>(a.bins) + r * a.bin_sr) +
                    w_lo + (int)(slot[i] >> 8));
        pf_bin[i] = v;
      }
    } else {
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        int v = -1;
        const long long r = r0 + (slot[i] & 0xFF);
        if (slot[i] != ~0u && r < r_end) {
          const long long e = r * a.bin_sr + (f_lo + (int)(slot[i] >> 8)) *
                                                 a.bin_sf;
          // 4-byte bins, else 2-byte (row-major) or 1-byte (feature-major)
          if constexpr (ST == OHW_ST_ROWS)
            v = a.bin_bytes == 4
                    ? __ldg(static_cast<const int32_t*>(a.bins) + e)
                    : (int)__ldg(static_cast<const int16_t*>(a.bins) + e);
          else
            v = a.bin_bytes == 4
                    ? __ldg(static_cast<const int32_t*>(a.bins) + e)
                    : (int)__ldg(static_cast<const uint8_t*>(a.bins) + e);
        }
        pf_bin[i] = (uint32_t)v;
      }
    }
    const long long r = r0 + tid;
    pf_ok = tid < KS && r < r_end;
    if (pf_ok) {
      pf_pos = __ldg(a.pos + r);
      const uint32_t* q = static_cast<const uint32_t*>(a.gh) + r * a.gh_sr;
      pf_g = __ldg(q);
      pf_h = __ldg(q + a.gh_sc);
    }
  };
  // the node this thread's row slot last wrote in each stage (-1: none)
  int old0 = -1, old1 = -1;
  auto store_step = [&](int stage) {
    if constexpr (AB != OHW_A_CONST) {
      uint8_t* sb = s_bin + stage * SB;
      if constexpr (ST == OHW_ST_VEC) {
        if (slot[0] != ~0u)
          *reinterpret_cast<uint4*>(sb + (int)(slot[0] >> 8) * KS +
                                    (int)(slot[0] & 0xFF)) =
              make_uint4(pf_bin[0], pf_bin[1], pf_bin[2], pf_bin[3]);
      } else if constexpr (ST == OHW_ST_RWORD) {
        // a word's four bytes into their features' rows, those of the
        // block's features only
#pragma unroll
        for (int i = 0; i < SLOTS; ++i)
          if (slot[i] != ~0u) {
            const int r = (int)(slot[i] & 0xFF);
            const int f0 = 4 * (w_lo + (int)(slot[i] >> 8)) - f_lo;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if ((unsigned)(f0 + k) < (unsigned)nf)
                sb[(f0 + k) * KS + r] = (uint8_t)(pf_bin[i] >> (8 * k));
          }
      } else {
#pragma unroll
        for (int i = 0; i < SLOTS; ++i)
          if (slot[i] != ~0u)
            sb[(int)(slot[i] >> 8) * KS + (int)(slot[i] & 0xFF)] =
                (uint8_t)min(pf_bin[i], 255u);
      }
    }
    if (tid >= KS) return;
    uint8_t* bt = s_b + stage * nb * b_bytes + k_ofs;
    // node j's column of channel c in B tile p (a level's columns are
    // turned by its level)
    auto col = [&](int j, int c, int p) {
      return (LVL ? (j + lv0 + p) & 63 : j) + c * a.m_pad;
    };
    auto put = [&](int n, int p, uint32_t v) {
      uint8_t* e = bt + p * b_bytes + (n >> 3) * 256 + (n & 7) * 16;
      if constexpr (S8)
        *e = (uint8_t)v;
      else
        *reinterpret_cast<uint16_t*>(e) = (uint16_t)v;
    };
    const int old = stage ? old1 : old0;
    if (old >= 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int p = 0; p < NBM; ++p)
          if (p < nb) put(col(old, c, p), p, 0u);
    }
    // the row's node: floor_mod(pos, 64) with levels (pad rows count),
    // else pos in the node tile
    const unsigned j = (unsigned)pf_pos - (unsigned)node_base;
    const int nw = !pf_ok ? -1
                   : LVL  ? pf_pos & 63
                   : j < (unsigned)a.m_pad ? (int)j
                                           : -1;
    if (nw >= 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if constexpr (S8) {
          // the low byte: int8(gh), a wrap
#pragma unroll
          for (int p = 0; p < NBM; ++p)
            if (p < nb) put(col(nw, c, p), p, c ? pf_h : pf_g);
        } else {
          float x = __uint_as_float(c ? pf_h : pf_g);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const uint16_t bits = ohw_bf16_bits(x);
            put(col(nw, c, p), p, bits);
            x -= __bfloat162float(__ushort_as_bfloat16(bits));
          }
        }
      }
    }
    if (stage)
      old1 = nw;
    else
      old0 = nw;
  };
  // levels: the s8 one-hot of the block's M tiles for the step staged in
  // stage, into that stage's A tiles
  auto build_a = [&](int stage) {
    if constexpr (LVL) {
      const uint8_t* sb = s_bin + stage * SB;
      uint8_t* at = s_a + stage * TPB * a_bytes + tid * 16;
#pragma unroll
      for (int T = 0; T < OHW_WARPGROUPS; ++T) {
        if (T >= TPB) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // groups of a tile: 4 KS <= 1,024
          const int jb = (tid >> 7) + 4 * i;  // the group's k32 step
          if (jb >= (KS >> 5)) break;
          const uint4 w =
              *reinterpret_cast<const uint4*>(sb + c_off[T] + jb * 32);
          *reinterpret_cast<uint4*>(at + T * a_bytes + i * 16 * OHW_THREADS) =
              make_uint4(ohw_hot_s8<AB>(w.x, c_key[T]) & c_one[T],
                         ohw_hot_s8<AB>(w.y, c_key[T]) & c_one[T],
                         ohw_hot_s8<AB>(w.z, c_key[T]) & c_one[T],
                         ohw_hot_s8<AB>(w.w, c_key[T]) & c_one[T]);
        }
      }
    }
  };

  Acc acc[TW][N / 2];
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[T][i] = Acc(0);

  for (int i = tid * 16; i < 2 * nb * b_bytes; i += OHW_THREADS * 16)
    *reinterpret_cast<uint4*>(s_b + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (n_steps > 0) {
    load_step(r_begin);
    store_step(0);
  }
  if (n_steps > 1) load_step(r_begin + KS);
  if constexpr (LVL) {
    __syncthreads();  // step 0's bins staged
    if (n_steps > 0) build_a(0);
  }
  ohw_fence_proxy();
  __syncthreads();

  const uint32_t b_base = (uint32_t)__cvta_generic_to_shared(s_b);
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) ohw_fence_acc(acc[T][i]);
  if constexpr (!LVL && !SMALL) {
    const int off = 2 * (t & 1);  // rows 2t, 2t+1 in a word of four
    const uint32_t sel =
        off | (off + 1) << 4 | (off + 4) << 8 | (off + 5) << 12;
    for (int s = 0; s < n_steps; ++s) {
      const int cur = s & 1;
      const uint32_t* wb =
          reinterpret_cast<const uint32_t*>(s_bin + cur * SB);
      const uint64_t desc0 = ohw_desc(b_base + cur * nb * b_bytes);
      for (int kb = 0; kb < (KS >> (S8 ? 5 : 4)); ++kb) {
        uint32_t af[TW][4];
        if constexpr (S8) {
          const int w = kb * 8 + t;  // rows 32 kb + 4t..; w + 4: 16 rows on
#pragma unroll
          for (int T = 0; T < TW; ++T) {
            af[T][0] = ohw_hot_s8<AB>(wb[a_word[T][0] + w], a_key[T][0]) &
                       a_one[T][0];
            af[T][1] = ohw_hot_s8<AB>(wb[a_word[T][1] + w], a_key[T][1]) &
                       a_one[T][1];
            af[T][2] = ohw_hot_s8<AB>(wb[a_word[T][0] + w + 4], a_key[T][0]) &
                       a_one[T][0];
            af[T][3] = ohw_hot_s8<AB>(wb[a_word[T][1] + w + 4], a_key[T][1]) &
                       a_one[T][1];
          }
        } else if constexpr (AB == OHW_A_CONST) {
#pragma unroll
          for (int T = 0; T < TW; ++T) {
            af[T][0] = af[T][2] = a_one[T][0];
            af[T][1] = af[T][3] = a_one[T][1];
          }
        } else {
          const int w = kb * 4 + (t >> 1);
#pragma unroll
          for (int T = 0; T < TW; ++T) {
            const uint32_t q0 = ohw_prmt(wb[a_word[T][0] + w],
                                         wb[a_word[T][0] + w + 2], sel);
            const uint32_t q1 = ohw_prmt(wb[a_word[T][1] + w],
                                         wb[a_word[T][1] + w + 2], sel);
            ohw_hot_bf16<AB>(af[T], q0, q1, a_key[T], a_one[T]);
          }
        }
        ohw_fence();
#pragma unroll
        for (int T = 0; T < TW; ++T) {
          if constexpr (S8) {
            ohw_mma_s8(acc[T], af[T], desc0 + (uint64_t)((kb * 32 * N) >> 4));
          } else {
#pragma unroll
            for (int p = 0; p < NP; ++p)
              ohw_mma<N>(acc[T], af[T],
                         desc0 + (uint64_t)((p * b_bytes + kb * 32 * N) >> 4));
          }
        }
        ohw_commit();
        // A wgmma reads its A registers until its group completes, and the
        // compiler, which sees the asm read them at issue, may give them to
        // the next step's fragments: so wait for the group here.  The other
        // warpgroups' products fill the tensor cores meanwhile.
        ohw_wait();
      }
      // every group that read the other stage completed before the last
      // barrier, so it is free
      if (s + 1 < n_steps) store_step(cur ^ 1);
      if (s + 2 < n_steps) load_step(r_begin + (long long)(s + 2) * KS);
      ohw_fence_proxy();
      __syncthreads();
    }
  } else if constexpr (SMALL) {
    // The small-N form (T3, T2): a product is a few cycles of the tensor
    // cores, so a warpgroup builds the fragments of all its tiles for a k32
    // step into registers of their own, issues their products as one
    // group and waits once (the fragments stay untouched until then); a
    // tile past the block's share issues its product on a fragment of
    // zeros (initialised below), so every wgmma stays outside any branch
    uint32_t af[TW][4];
#pragma unroll
    for (int T = 0; T < TW; ++T)
#pragma unroll
      for (int i = 0; i < 4; ++i) af[T][i] = 0u;
    for (int s = 0; s < n_steps; ++s) {
      const int cur = s & 1;
      const uint32_t* wb = reinterpret_cast<const uint32_t*>(s_bin + cur * SB);
      const uint64_t desc0 = ohw_desc(b_base + cur * nb * b_bytes);
      for (int kb = 0; kb < (KS >> 5); ++kb) {
        const int w = kb * 8 + t;  // rows 32 kb + 4t..; w + 4: 16 rows on
#pragma unroll
        for (int T = 0; T < TW; ++T) {
          if (T < ntw) {
            // the 16 A bytes of M rows g, g + 8 from two words
            const uint32_t lo = wb[s_word[T] + w], hi = wb[s_word[T] + w + 4];
            const uint32_t k8 = s_key[T] + 0x08080808u;
            af[T][0] = ohw_hot_s8<AB>(lo, s_key[T]);
            af[T][1] = ohw_hot_s8<AB>(lo, k8);
            af[T][2] = ohw_hot_s8<AB>(hi, s_key[T]);
            af[T][3] = ohw_hot_s8<AB>(hi, k8);
          }
        }
        ohw_fence();
#pragma unroll
        for (int T = 0; T < TW; ++T)
          ohw_mma_s8n<N>(acc[T], af[T],
                         desc0 + (uint64_t)((kb * 32 * N) >> 4));
        ohw_commit();
        // one wait a k32 step for all the warpgroup's tiles
        ohw_wait();
      }
      // hand the stages over: step s + 1 into the other stage (its last
      // reader completed before the last barrier), step s + 2's loads
      if (s + 1 < n_steps) store_step(cur ^ 1);
      if (s + 2 < n_steps)
        load_step(r_begin + (long long)(s + 2) * KS);
      ohw_fence_proxy();
      __syncthreads();
    }
  } else {
    // levels: a step's products are issued at once from the stage's A and
    // B tiles; the block stages step s + 1 and builds its A meanwhile
    const uint32_t a_base = (uint32_t)__cvta_generic_to_shared(s_a);
    // every warpgroup issues its products, an idle one (past the last
    // tile or level) on tiles that exist and add nothing it flushes, so
    // the wgmma stay outside any branch
    for (int s = 0; s < n_steps; ++s) {
      const int cur = s & 1;
      const uint64_t da = ohw_desc(a_base + (cur * TPB + wt0) * a_bytes);
      const uint64_t db = ohw_desc(b_base + (cur * nb + wg / TPB) * b_bytes);
      ohw_fence();
      // not unrolled: ptxas crashes (segmentation fault) on this loop
      // unrolled, whose accumulators move between the unrolled body and
      // its remainder while the products run
#pragma unroll 1
      for (int kb = 0; kb < (KS >> 5); ++kb)
        ohw_mma_s8_ss(acc[0], da + (uint64_t)((kb * 2048) >> 4),
                      db + (uint64_t)((kb * 32 * N) >> 4));
      ohw_commit();
      // the other stage's A and B tiles were last read by step s - 1's
      // products, complete before the last barrier
      if (s + 1 < n_steps) store_step(cur ^ 1);
      if (s + 2 < n_steps) load_step(r_begin + (long long)(s + 2) * KS);
      __syncthreads();  // step s + 1's bins staged
      if (s + 1 < n_steps) build_a(cur ^ 1);
      ohw_fence_proxy();
      ohw_wait();  // step s's products done: its stage is free
      __syncthreads();
    }
  }
  ohw_wait();
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) ohw_fence_acc(acc[T][i]);
  if (!busy) return;

  // ---- flush: accumulator 4j + 2h + q is M row g + 8h, column 8j + 2t + q
#pragma unroll
  for (int T = 0; T < TW; ++T)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mt0 + wt0 + T) * 64 + wq * 16 + g + 8 * h;
      const int f = m / a.b_pad, b = m - f * a.b_pad;
      if (m >= m_rows || b >= a.n_bin || (SMALL && T >= ntw)) continue;
      Acc* cell = static_cast<Acc*>(a.out) + lv * a.s_lv + f * a.s_f +
                  b * a.s_b;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const Acc v = acc[T][4 * j + 2 * h + q];
          const int n = 8 * j + 2 * t + q;
          if (v == Acc(0) || n >= 2 * a.m_pad) continue;
          const int ch = n >= a.m_pad;
          const int node = node_base + n - ch * a.m_pad;
          if (node < a.n_node_out)
            atomicAdd(cell + ch * a.s_c + node * a.s_node, v);
        }
    }
}

// The launch's tiling as the kernel needs it: the wrapper's plan
// (wgmma_plan) gives it, and a launch that breaks it is refused.
inline bool ohw_tiling_ok(const WgmmaArgs* a, bool s8, bool lvl, int np,
                          int st) {
  const int ki = s8 ? 32 : 16;
  const bool small = ohw_small(a->n_col, s8, lvl);
  const int bq = small ? 16 : 8;  // Bp: B rounded up to this
  // row-major uint8 bins (s8 only) take RWORD or FEAT
  if (st != (a->vec              ? (a->fm ? OHW_ST_VEC : OHW_ST_RWORD)
             : a->fm || a->bin_bytes == 1 ? OHW_ST_FEAT
                                          : OHW_ST_ROWS))
    return false;
  if (a->n_bin < 1 || a->n_bin > 255 ||
      a->b_pad != (a->n_bin + bq - 1) / bq * bq || a->m_pad < 1 ||
      a->m_pad > 64 || 2 * a->m_pad > a->n_col ||
      (a->n_col != 8 && a->n_col != 16 && a->n_col != 32 && a->n_col != 64 &&
       a->n_col != 128) ||
      a->step < ki || a->step > 256 || a->step % ki ||
      a->rows_per_block % a->step || a->n_feat < 1 ||
      (a->bin_bytes != 4 && a->bin_bytes != 2 && a->bin_bytes != 1))
    return false;
  if ((a->fm ? a->bin_bytes == 2 : a->bin_bytes == 1 && !s8) ||
      (a->vec && a->fm &&
       (a->bin_bytes != 1 || a->bin_sr != 1 || a->bin_sf % 16 ||
        (reinterpret_cast<uintptr_t>(a->bins) & 15))) ||
      (a->vec && !a->fm &&
       (a->bin_bytes != 1 || a->bin_sf != 1 || a->bin_sr % 4 ||
        (reinterpret_cast<uintptr_t>(a->bins) & 3))))
    return false;
  if (lvl && (a->m_pad != 64 || a->n_levels < 2 ||
              (a->lv_block != 1 && a->lv_block != 2 && a->lv_block != 4) ||
              a->n_mt != (a->n_levels + a->lv_block - 1) / a->lv_block))
    return false;
  // M tiles a block: at most cap, and in the small-N form spread evenly
  const int cap = lvl ? OHW_WARPGROUPS / a->lv_block
                      : OHW_WARPGROUPS * ohw_tw(a->n_col, s8, lvl);
  const int m_rows = a->n_feat * a->b_pad;
  const int n_tiles = (m_rows + 63) / 64;
  if (a->n_mblk != (n_tiles + cap - 1) / cap) return false;
  const int tpb = small ? (n_tiles + a->n_mblk - 1) / a->n_mblk : cap;
  const int sb = ohw_stage_bins(a->n_col, s8, lvl);
  for (int blk = 0; blk < a->n_mblk; ++blk) {  // staged bins fit a stage
    const int m0 = blk * tpb * 64;
    const int m1 = m0 + tpb * 64 < m_rows ? m0 + tpb * 64 : m_rows;
    const int f0 = m0 / a->b_pad, nf = (m1 - 1) / a->b_pad - f0 + 1;
    const int n_el = st == OHW_ST_RWORD
                         ? (((f0 + nf - 1) >> 2) - (f0 >> 2) + 1) * a->step
                         : a->step * nf;
    if (a->step * nf > sb || n_el > ohw_slots(sb, st) * OHW_THREADS)
      return false;
  }
  return ohw_smem(a, s8, lvl, np) <= OHW_SMEM_MAX;
}

template <int N, int NP, int ET, int AB, bool LVL, int ST>
cudaError_t onehot_wgmma_launch_n(const WgmmaArgs* a, int n_row_blocks,
                                  cudaStream_t stream) {
  if (a->n_col != N || !ohw_tiling_ok(a, ET == OHW_S8, LVL, NP, ST))
    return cudaErrorInvalidValue;
  const int smem = ohw_smem(a, ET == OHW_S8, LVL, NP);
  const cudaError_t e = cudaFuncSetAttribute(
      onehot_wgmma_kernel<N, NP, ET, AB, LVL, ST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a->n_mblk, a->n_mt, n_row_blocks);
  onehot_wgmma_kernel<N, NP, ET, AB, LVL, ST>
      <<<grid, OHW_THREADS, smem, stream>>>(*a);
  return cudaGetLastError();
}

// One launch of feature-major bins (T6, T7) at N = 128: 16 rows a load
// where the wrapper found them aligned, else one element a load.
template <int ET, int AB, bool LVL>
cudaError_t onehot_wgmma_launch_fm(const WgmmaArgs* a, int n_row_blocks,
                                   cudaStream_t stream) {
  return a->vec ? onehot_wgmma_launch_n<128, 1, ET, AB, LVL, OHW_ST_VEC>(
                      a, n_row_blocks, stream)
                : onehot_wgmma_launch_n<128, 1, ET, AB, LVL, OHW_ST_FEAT>(
                      a, n_row_blocks, stream);
}

// One s8 launch of the bit-pattern one-hot without levels (T3, T2) at
// a->n_col columns, its bins staged as ST: the small-N form below N = 128,
// T7's instance at 128.
template <int ST>
cudaError_t onehot_wgmma_launch_s8(const WgmmaArgs* a, int n_row_blocks,
                                   cudaStream_t stream) {
  switch (a->n_col) {
    case 8:
      return onehot_wgmma_launch_n<8, 1, OHW_S8, OHW_A_BITS, false, ST>(
          a, n_row_blocks, stream);
    case 16:
      return onehot_wgmma_launch_n<16, 1, OHW_S8, OHW_A_BITS, false, ST>(
          a, n_row_blocks, stream);
    case 32:
      return onehot_wgmma_launch_n<32, 1, OHW_S8, OHW_A_BITS, false, ST>(
          a, n_row_blocks, stream);
    case 64:
      return onehot_wgmma_launch_n<64, 1, OHW_S8, OHW_A_BITS, false, ST>(
          a, n_row_blocks, stream);
    case 128:
      return onehot_wgmma_launch_n<128, 1, OHW_S8, OHW_A_BITS, false, ST>(
          a, n_row_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// One bf16 launch of the bit-pattern one-hot (T5, T1) with NP parts at
// a->n_col columns.
template <int NP>
cudaError_t onehot_wgmma_launch(const WgmmaArgs* a, int n_row_blocks,
                                cudaStream_t stream) {
  switch (a->n_col) {
    case 8:
      return onehot_wgmma_launch_n<8, NP, OHW_BF16, OHW_A_BITS, false,
                                   OHW_ST_ROWS>(a, n_row_blocks, stream);
    case 16:
      return onehot_wgmma_launch_n<16, NP, OHW_BF16, OHW_A_BITS, false,
                                   OHW_ST_ROWS>(a, n_row_blocks, stream);
    case 32:
      return onehot_wgmma_launch_n<32, NP, OHW_BF16, OHW_A_BITS, false,
                                   OHW_ST_ROWS>(a, n_row_blocks, stream);
    case 64:
      return onehot_wgmma_launch_n<64, NP, OHW_BF16, OHW_A_BITS, false,
                                   OHW_ST_ROWS>(a, n_row_blocks, stream);
    case 128:
      return onehot_wgmma_launch_n<128, NP, OHW_BF16, OHW_A_BITS, false,
                                   OHW_ST_ROWS>(a, n_row_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
