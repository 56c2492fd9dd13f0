// Fused LoRA matmul kernels for Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernels of src/repro/kernels/lora_matmul.py:
//   * lora_fused_kernel<false, .> <- _fwd_call / _fwd_kernel:
//       y = x@W + (x@A)@B, and writes the (M, r) panel xa = x@A once.
//   * lora_fused_kernel<true, .>  <- _dx_call / _dx_kernel:
//       dx = g@Wᵀ + (g@Bᵀ)@Aᵀ, reading W, A and B in their native layouts
//       (the contraction runs over N), and writes gb = g@Bᵀ once.
//   * lora_dw_kernel (+ dw_sum_kernel) <- _dw_call / _dw_kernel:
//       the dense dW = xᵀg, summed over M, on the tensor cores (wgmma,
//       3xTF32); it runs only where the base weight itself requires a
//       gradient.
//   * panel_grad_kernel (+ dw_sum_kernel) <- _panel_grad_call /
//       _panel_grad_kernel: (L, r) = lhsᵀ·panel, i.e. dA = xᵀ·gb and dB =
//       (gᵀ·xa)ᵀ, M split over blocks and summed in a fixed order;
//       with an example axis (lora_panel_examples), the same kernel with
//       one slice per example gives each example's (L, r) straight: the
//       form _panel_grad_call takes under the vmap of the DP-SGD step's
//       per-example loss (src/repro/core/fedavg.py); the step takes a
//       LoRA site's dA and dB in one launch (lora_panel_examples_pair).
//   * with a client axis (lora_fused_clients, lora_panel_clients): the
//       fused kernel and the panel gradient over stacked clients, W shared
//       and A, B per client, blockIdx.z the client: the forms _fwd_call,
//       _dx_call and _panel_grad_call take under the vmap over clients of
//       the stacked local update (src/repro/core/fed_spmd.py).  Each
//       client's outputs are the bits of a launch on its rows alone.
//
// The fused kernel runs its three products (x@W, the rank-r panel x@A and
// the epilogue (x@A)@B) on the tensor cores at fp32 accuracy: mma.sync
// m16n8k8 in TF32 with the 3xTF32 split of mma_tf32.cuh (small terms
// first, then big·big, into a fresh fragment per k step of 8 that is
// added to an fp32 partial).  What bounds it there is operations: at
// RecurrentGemma-2B's wq (M 1280, K = N = 2560, r 8) 16.8 GFLOP take
// 0.102 ms at a third of the card's TF32 rate (165 TFLOP/s), its 52.7 MB
// 0.0157 ms.  In practice it is bound by issue: each mma.sync needs its
// operands split by the warp that reads them and its fresh fragment
// added in fp32, about four other instructions an mma.  The design:
//   * one block of 4 warps per (TM x TN) = (64 x 64) output tile, each
//     warp 32 x 32 (2 m16 x 4 n8 fragments); the contraction is staged TK
//     = 32 at a time through a STAGES = 2 ring of cp.async copies (16-byte
//     copies where the base and the row stride are 16-byte aligned, else
//     4-byte ones, zero-filled past the edges), each thread copying at
//     fixed offsets from the tile's corner;
//   * both directions read their operands in their native layouts: the
//     forward's W (K, N) tile is kept as (contraction, column) rows, dx's
//     W (read as Wᵀ) as (column, contraction) rows; no transposed copy of
//     W is made.  Within each step of 8 the contraction is taken in the
//     order (0, 4, 1, 5, 2, 6, 3, 7) in both operands, so a fragment's k
//     pair is one 8-byte load, and the row strides make every fragment
//     load hit 32 different banks;
//   * operands are split at each fragment load by split_fast (an integer
//     round, no conversion instruction): splitting on staging would
//     double the bytes a stage and add a pass for elements that only two
//     warps read;
//   * the panel x@A is ceil(r/8) more n8 fragments on the same A
//     fragments, zero past r (rank 8: one); each warp computes it for
//     its own m16 fragments (FM / WARPS_N of them), so the warps share
//     its work evenly; its totals go through shared memory to every warp
//     for the epilogue, whose (x@A)@B takes ceil(r/8) k steps; only the
//     blocks of column tile 0 write the panel out.  Every block sums the
//     panel in the same order, so each writes the same bits;
//   * the contraction is summed in blocks of KB: a fresh partial a block,
//     added to the running total, for the main tile and for the panel.
//     The totals of a contraction longer than KB wait in shared memory
//     (18 KB a block at rank 8), not in registers: held in registers
//     they spill.  KB is 768: a product of K <= 768 (all of GPT-2's)
//     keeps one partial.
// 101-152 registers, no spills.  Blocks at M 1280 / 5120 / 80 (waves at
// 3 blocks an SM, 396 slots, where K > 768; 4, 528 slots, at 768): K = N
// = 768: 240 / 960 / 24 (0.45 / 1.82 / 0.05); K = N = 2560: 800 / 3200 /
// 80 (2.02 / 8.08 / 0.20); K = N = 2048: 640 / 2560 / 64 (1.62 / 6.46 /
// 0.16); (K, N) = (2560, 256): forward 80 / 320 / 8 (0.20 / 0.81 /
// 0.02), dx (output 2560 wide, contraction 256) 800 / 3200 / 80 (1.52 /
// 6.06 / 0.15).  No atomics: every output element is summed by one
// thread in a fixed order.
//
// What a later PR should change: the dW kernel below (wgmma, operands
// split once on staging and read by a whole warpgroup from shared memory)
// is the template: the forward's W (K, N) is N-major and would be
// transposed on staging as dW's operands are.  Grids that cannot fill
// the card (the (2560, 256) forward at M 1280: 80 blocks) want a split of
// the contraction with a fixed-order second pass, which needs a workspace
// argument.
//
// dW = xᵀg contracts over M, along which both x (M, K) and g (M, N) are
// laid out row by row: on the tensor cores each is an operand whose
// contraction is its slow axis.  What bounds it is operations: at
// RecurrentGemma-2B's (1280, 2560, 2560) 16.8 GFLOP take 0.102 ms at a
// third of the TF32 rate (3xTF32), its 52.4 MB 0.016 ms.  The design:
//   * a block of two warpgroups per 128 x 128 tile of dW, each warpgroup
//     64 rows, issuing wgmma m64n128k8 (TF32 in, fp32 sums) with both
//     operands in shared memory;
//   * tf32 wgmma takes K-major operands only, and TMA cannot transpose
//     4-byte elements, so each stage of DW_BK = 32 rows of M is loaded
//     through registers (4-byte loads, a warp's lanes along a row of x or
//     g: 128 contiguous bytes) and stored transposed, one 128-byte row of
//     the contraction per row of the tile, in the 128-byte swizzle (the
//     8 rows of a 16-byte store phase hit 8 different chunks: no bank
//     conflict).  Every element is split into big and small once, on
//     staging (split_fast), into two tiles per operand: no warp splits an
//     operand at each product, which holds the fused kernels' mma.sync
//     back;
//   * 3xTF32 as mma_tf32.cuh defines it: small·big, big·small, then
//     big·big per step of 8, all three into one accumulator;
//   * two stages of shared memory (64 KB each): while the wgmmas of one
//     stage are in flight, the next stage's values (loaded into registers
//     a stage earlier) are split and stored into the other, and the loads
//     of the stage after it are issued, so a load has a whole stage to
//     land;
//   * the contraction is summed in blocks of DW_BLOCK = 32 rows, each into
//     a fresh accumulator that is then added to the running fp32 total
//     (tests/test_torch_tf32_model.py ranks 8, 32 and 128 rows: 32 has
//     the smallest error in its model);
//   * where the tiles alone cannot fill the SMs (768² is 36 tiles on 132
//     SMs) M is split over gridDim.z into slices of whole blocks, one wave
//     of blocks, and dw_sum_kernel adds the slices in a fixed order: no
//     atomics, the same bits every run.
// Ragged K, N and M are zero-filled on staging and masked on the store;
// the 4-byte loads take any alignment.
//
// The panel gradient (L, r) = lhsᵀ·panel moves lhs once (10.5 MB at
// RWKV-6's (1280, 2048), 3.1 µs at the card's 3.35 TB/s) for 2·M·L·r
// operations, so it is bound by bytes and by filling the card.  A block
// of 4 warps owns 128 columns of lhs (4 a lane, one 16-byte load a lane
// a row where lhs is 16-byte aligned and L % 4 == 0, else four 4-byte
// ones, 8 rows in flight a warp) and one slice of M: the slices are read
// from the SM count (panel_split: PANEL_PER_SM blocks an SM, at least
// PANEL_MIN_ROWS rows a slice; at M 1280 and L 2048 on 132 SMs, 16 x 17
// = 272 blocks).  The slice's panel rows go through shared memory, read as
// broadcasts; ranks are taken 8 at a time (32 accumulators a thread),
// each group rereading the slice's rows.  Each warp sums its rows in
// order, the warps are added in order through shared memory, and with
// more than one slice each writes a partial into a (slices, L·r)
// workspace in the output's layout that dw_sum_kernel adds in order: no
// atomics, the same bits every run.  Ragged edges are masked in the
// loads.  With an example axis (the DP step) a slice is one example's S
// = 80 rows, 20 a warp: too few to hide a load's latency behind, so a
// block's time is a short chain of latencies (the panel, then three
// batches of 8 rows) that no width of grid shortens; one launch takes
// both of a site's products, dA's blocks and dB's side by side, so the
// two chains overlap and the second launch's floor is gone.  What keeps
// that one wave is the register count: at 96 (no spill) five blocks fit
// an SM, 660 on the card, so RecurrentGemma-2B's wq pair (640 blocks)
// runs in one wave; staging the panel by cp.async while each warp's
// first rows load took it to 128 registers and a spill, four blocks an
// SM and two waves, slower there than the two launches it replaces.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_tf32.cuh"

namespace {

constexpr int KB = 768;      // contraction summed into one partial
constexpr int R_MAX = 64;    // largest LoRA rank

// The fused kernel's tiles: WARPS_M x WARPS_N warps of FM m16 by FN n8
// fragments; TK of the contraction a stage.
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 2;
constexpr int FM = 2;
constexpr int FN = 4;
constexpr int TK = 32;
constexpr int STAGES = 2;
constexpr int TM = 16 * FM * WARPS_M;
constexpr int TN = 8 * FN * WARPS_N;
constexpr int FT = 32 * WARPS_M * WARPS_N;   // threads per fused block
// Each step of 8 of the contraction is stored in the order (0, 4, 1, 5,
// 2, 6, 3, 7): a fragment's k pair (t, t + 4) sits at columns (2t, 2t +
// 1), one 8-byte read, in both operands alike (the order within a step is
// the mma's own).  Row strides (floats): a tile whose rows run along the
// contraction is read in k pairs (stride = 8 mod 32), a tile whose rows
// are the contraction in rows 2t and 2t + 1 (stride = 4 mod 32); either
// way the 32 lanes of a fragment load hit different banks.
constexpr int pad_to(int n, int mod) { return n + ((mod - n) % 32 + 32) % 32; }
constexpr int LDC = pad_to(TK, 8);
constexpr int LDN = pad_to(TN, 4);
static_assert(KB % TK == 0, "a K block is whole stages");
static_assert(FM % WARPS_N == 0, "the panel's m16 fragments share out");

template <bool TRANS, int NR>
struct Fused {
  static constexpr int RP = 8 * NR;                   // rank, padded
  static constexpr int LDA = pad_to(RP, 4);           // A's rows: k
  static constexpr int LDR = pad_to(RP, 8);           // rows along j
  // the panel's m16 fragments a warp computes (all NR n8 fragments)
  static constexpr int PM = FM / WARPS_N;
  // one stage: the x tile (TM, TK), the W tile and the A tile
  static constexpr int XS = TM * LDC;
  static constexpr int WS = TRANS ? TN * LDC : TK * LDN;
  static constexpr int AS = TRANS ? RP * LDC : TK * LDA;
  static constexpr int STAGE = XS + WS + AS;
  // the epilogue's panel (TM, RP) and B operand, in the ring's place
  static constexpr int XAS = TM * LDR;
  static constexpr int BS = TRANS ? TN * LDR : RP * LDN;
  static constexpr int RING =
      STAGES * STAGE > XAS + BS ? STAGES * STAGE : XAS + BS;
  // each thread's running totals of a contraction over several K blocks
  // (main tile and panel), after the ring: slot q of thread i at q·FT + i
  static constexpr int TOTALS = (FM * FN + PM * NR) * 4;
  static constexpr size_t smem(bool blocks) {
    return sizeof(float) * (RING + (blocks ? TOTALS * FT : 0));
  }
};

// rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a row-major (rows,
// cols) matrix with row stride ld into a (ROWS, LD) tile, by the block's
// FT threads, each at fixed offsets: 16-byte copies where `vec` (src
// 16-byte aligned, ld and cols multiples of 4), else 4-byte ones;
// zero-filled past the edges
template <int ROWS, int COLS, int LD, int V>
__device__ __forceinline__ void tile_rows(float* dst, const float* src, int ld,
                                          int r0, int c0, int rows, int cols) {
  constexpr int PER_ROW = COLS / V, STEP = FT / PER_ROW;   // V floats a copy
  static_assert(FT % PER_ROW == 0 && ROWS % STEP == 0, "whole passes");
  const int rr = threadIdx.x / PER_ROW, cc = (threadIdx.x % PER_ROW) * V;
  const bool col_ok = c0 + cc < cols;
  const float* s = src + (size_t)(r0 + rr) * ld + c0 + cc;
  float* d = dst + rr * LD + cc;
  #pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const bool ok = col_ok && r0 + rr + i * STEP < rows;
    const float* from = ok ? s + (size_t)i * STEP * ld : src;
    if (V == 4) cp_async16(d + i * STEP * LD, from, ok);
    else cp_async4(d + i * STEP * LD, from, ok);
  }
}

template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void tile_async(float* dst, const float* src,
                                           int ld, int r0, int c0, int rows,
                                           int cols, bool vec) {
  if (vec) tile_rows<ROWS, COLS, LD, 4>(dst, src, ld, r0, c0, rows, cols);
  else tile_rows<ROWS, COLS, LD, 1>(dst, src, ld, r0, c0, rows, cols);
}

// The A fragment of rows [r0, r0 + 16) and the step of 8 at k0 of a
// row-major tile with row stride LD (the k pair (t, t + 4) at columns 2t,
// 2t + 1), split
template <int LD>
__device__ __forceinline__ FragA frag_a(const float* T, int r0, int k0,
                                        int g, int t) {
  FragA f;
  const float* p = T + (r0 + g) * LD + k0 + 2 * t;
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8 * LD);
  split_fast(lo.x, f.big.x, f.small.x);
  split_fast(hi.x, f.big.y, f.small.y);
  split_fast(lo.y, f.big.z, f.small.z);
  split_fast(hi.y, f.big.w, f.small.w);
  return f;
}

// The B fragment (the step of 8 at k0, n [n0, n0 + 8)) of a tile stored
// with rows along n (KMAJOR: T[n][k], the k pair at columns 2t, 2t + 1)
// or along k (T[k][n], the k pair in rows 2t, 2t + 1), row stride LD,
// split
template <bool KMAJOR, int LD>
__device__ __forceinline__ FragB frag_b(const float* T, int k0, int n0,
                                        int g, int t) {
  FragB f;
  float2 v;
  if (KMAJOR) {
    v = *reinterpret_cast<const float2*>(T + (n0 + g) * LD + k0 + 2 * t);
  } else {
    const float* p = T + (k0 + 2 * t) * LD + n0 + g;
    v = make_float2(p[0], p[LD]);
  }
  split_fast(v.x, f.big[0], f.small[0]);
  split_fast(v.y, f.big[1], f.small[1]);
  return f;
}

// out[m, n] = sum_c X[m, c] Wop[c, n] + sum_j XA[m, j] Bop[j, n],
// XA[m, j] = sum_c X[m, c] Aop[c, j];  X is (M, C) row-major.
//  TRANS = false (forward): C = K, Wop = W (K, N), Aop = A (K, r),
//                           Bop = B (r, N).
//  TRANS = true  (dx):      X = g (M, N), C = N, out width K,
//                           Wop[c, n] = W[n, c], Aop[c, j] = B[j, c],
//                           Bop[j, n] = A[n, j]; the launcher passes B as
//                           Aop and A as Bop.
// NR: the panel's n8 fragments, ceil(r / 8) rounded up to 1, 2, 4 or 8.
// vec_x, vec_w: 16-byte copies of X and of W (see tile_async).
// With a client axis (gridDim.z clients, blockIdx.z the client) X, out and
// xa_out hold the clients' M rows one after another, Aop and Bop their
// (C, r) and (r, Nout) factors one after another, and W is shared: client
// z's blocks compute what a launch on its rows and factors alone computes,
// in the same order.
template <bool TRANS, int NR>
__global__ void __launch_bounds__(FT)
lora_fused_kernel(const float* __restrict__ X, const float* __restrict__ W,
                  const float* __restrict__ Aop, const float* __restrict__ Bop,
                  float* __restrict__ out, float* __restrict__ xa_out,
                  int M, int C, int Nout, int r, int vec_x, int vec_w) {
  using F = Fused<TRANS, NR>;
  constexpr int PM = F::PM, RP = F::RP, KT = KB / TK;
  extern __shared__ __align__(16) float smem[];
  const size_t client = blockIdx.z;
  X += client * M * C;
  out += client * M * Nout;
  xa_out += client * M * r;
  Aop += client * C * r;
  Bop += client * r * Nout;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WARPS_N) * 16 * FM;   // the warp's first row
  const int wc = (warp % WARPS_N) * 8 * FN;    // and column in the tile
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int nk = (C + TK - 1) / TK;
  float* totals = smem + F::RING + threadIdx.x;   // used when nk > KT

  auto fetch = [&](int kt, int st) {
    float* xs = smem + st * F::STAGE;
    float* ws = xs + F::XS;
    float* as = ws + F::WS;
    const int c0 = kt * TK;
    tile_async<TM, TK, LDC>(xs, X, C, m0, c0, M, C, vec_x);
    if constexpr (TRANS) {
      // W's rows n0.. (the output columns), contraction along them
      tile_async<TN, TK, LDC>(ws, W, C, n0, c0, Nout, C, vec_w);
      // Aop = B (r, N): rows j, contraction along them
      tile_rows<RP, TK, LDC, 1>(as, Aop, C, 0, c0, r, C);
    } else {
      tile_async<TK, TN, LDN>(ws, W, Nout, c0, n0, C, Nout, vec_w);
      tile_rows<TK, RP, F::LDA, 1>(as, Aop, r, c0, 0, C, r);
    }
    cp_commit();
  };

  // the partials of the current K block (main tile; the panel's rows of
  // the m16 fragments i = wn mod WARPS_N); the running totals of earlier
  // K blocks wait in shared memory
  float part[FM][FN][4], ppart[PM][NR][4];

  #pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) fetch(s, s);
    else cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt % KT == 0) {
      #pragma unroll
      for (int i = 0; i < FM; ++i) {
        #pragma unroll
        for (int j = 0; j < FN; ++j)
          #pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
      }
      #pragma unroll
      for (int i = 0; i < PM; ++i)
        #pragma unroll
        for (int j = 0; j < NR; ++j)
          #pragma unroll
          for (int q = 0; q < 4; ++q) ppart[i][j][q] = 0.f;
    }
    cp_wait<STAGES - 2>();
    __syncthreads();
    // the stage read in the step before is free again
    const int next = kt + STAGES - 1;
    if (next < nk) fetch(next, next % STAGES);
    else cp_commit();
    const float* xs = smem + (kt % STAGES) * F::STAGE;
    const float* ws = xs + F::XS;
    const float* as = ws + F::WS;
    #pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      FragA a[FM];
      #pragma unroll
      for (int i = 0; i < FM; ++i)
        a[i] = frag_a<LDC>(xs, wr + 16 * i, kk, g, t);
      #pragma unroll
      for (int j = 0; j < FN; ++j) {
        const FragB b = TRANS ? frag_b<true, LDC>(ws, kk, wc + 8 * j, g, t)
                              : frag_b<false, LDN>(ws, kk, wc + 8 * j, g, t);
        #pragma unroll
        for (int i = 0; i < FM; ++i) mma3(part[i][j], a[i], b);
      }
      #pragma unroll
      for (int j = 0; j < NR; ++j) {
        const FragB b = TRANS ? frag_b<true, LDC>(as, kk, 8 * j, g, t)
                              : frag_b<false, F::LDA>(as, kk, 8 * j, g, t);
        #pragma unroll
        for (int i = 0; i < FM; ++i)
          if (i % WARPS_N == wn) mma3(ppart[i / WARPS_N][j], a[i], b);
      }
    }
    // the end of a K block of a contraction that has several: the first
    // block's partial is the total, later ones are added to it in order
    if (nk > KT && ((kt + 1) % KT == 0 || kt == nk - 1)) {
      const bool first = kt < KT;
      #pragma unroll
      for (int i = 0; i < FM; ++i) {
        #pragma unroll
        for (int j = 0; j < FN; ++j)
          #pragma unroll
          for (int q = 0; q < 4; ++q) {
            float* slot = totals + (((i * FN + j) * 4) + q) * FT;
            *slot = first ? part[i][j][q] : *slot + part[i][j][q];
          }
      }
      #pragma unroll
      for (int i = 0; i < PM; ++i)
        #pragma unroll
        for (int j = 0; j < NR; ++j)
          #pragma unroll
          for (int q = 0; q < 4; ++q) {
            float* slot = totals + ((FM * FN + i * NR + j) * 4 + q) * FT;
            *slot = first ? ppart[i][j][q] : *slot + ppart[i][j][q];
          }
    }
  }
  if (nk > KT) {
    // the totals back into the partials' registers
    #pragma unroll
    for (int i = 0; i < FM; ++i) {
      #pragma unroll
      for (int j = 0; j < FN; ++j)
        #pragma unroll
        for (int q = 0; q < 4; ++q)
          part[i][j][q] = totals[(((i * FN + j) * 4) + q) * FT];
    }
    #pragma unroll
    for (int i = 0; i < PM; ++i)
      #pragma unroll
      for (int j = 0; j < NR; ++j)
        #pragma unroll
        for (int q = 0; q < 4; ++q)
          ppart[i][j][q] = totals[((FM * FN + i * NR + j) * 4 + q) * FT];
  }
  cp_wait<0>();
  __syncthreads();

  // the panel's totals, (TM, RP), and the epilogue's B operand take the
  // ring's place: Bop[j][n] as B's rows (forward) or A's rows (dx), zero
  // past r and past the output's width
  float* xas = smem;
  float* bs = smem + F::XAS;
  #pragma unroll
  for (int i = 0; i < PM; ++i)
    #pragma unroll
    for (int j = 0; j < NR; ++j) {
      float* q = xas + (wr + 16 * (i * WARPS_N + wn) + g) * F::LDR + 8 * j
                 + 2 * t;
      q[0] = ppart[i][j][0];
      q[1] = ppart[i][j][1];
      q[8 * F::LDR] = ppart[i][j][2];
      q[8 * F::LDR + 1] = ppart[i][j][3];
    }
  if constexpr (TRANS) {
    for (int e = threadIdx.x; e < TN * RP; e += FT) {
      const int n = e / RP, j = e % RP;
      bs[n * F::LDR + j] = (n0 + n < Nout && j < r)
                               ? Bop[(size_t)(n0 + n) * r + j] : 0.f;
    }
  } else {
    for (int e = threadIdx.x; e < RP * TN; e += FT) {
      const int j = e / TN, n = e % TN;
      bs[j * LDN + n] = (j < r && n0 + n < Nout)
                            ? Bop[(size_t)j * Nout + n0 + n] : 0.f;
    }
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e < TM * r; e += FT) {
      const int m = e / r, j = e % r;
      if (m0 + m < M) xa_out[(size_t)(m0 + m) * r + j] = xas[m * F::LDR + j];
    }

  // low = (x@A)@B over the panel's RP columns, then out = total + low
  float low[FM][FN][4];
  #pragma unroll
  for (int i = 0; i < FM; ++i)
    #pragma unroll
    for (int j = 0; j < FN; ++j)
      #pragma unroll
      for (int q = 0; q < 4; ++q) low[i][j][q] = 0.f;
  #pragma unroll
  for (int kk = 0; kk < RP; kk += 8) {
    FragA a[FM];
    #pragma unroll
    for (int i = 0; i < FM; ++i)
      a[i] = frag_a<F::LDR>(xas, wr + 16 * i, kk, g, t);
    #pragma unroll
    for (int j = 0; j < FN; ++j) {
      const FragB b = TRANS ? frag_b<true, F::LDR>(bs, kk, wc + 8 * j, g, t)
                            : frag_b<false, LDN>(bs, kk, wc + 8 * j, g, t);
      #pragma unroll
      for (int i = 0; i < FM; ++i) mma3(low[i][j], a[i], b);
    }
  }
  const bool pairs = Nout % 2 == 0;   // (row, 2t) is 8-byte aligned
  #pragma unroll
  for (int i = 0; i < FM; ++i)
    #pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int col = n0 + wc + 8 * j + 2 * t;
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wr + 16 * i + g + 8 * h;
        if (row >= M) continue;
        const float v0 = part[i][j][2 * h] + low[i][j][2 * h];
        const float v1 = part[i][j][2 * h + 1] + low[i][j][2 * h + 1];
        float* o = out + (size_t)row * Nout + col;
        if (pairs && col + 1 < Nout) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < Nout) o[0] = v0;
          if (col + 1 < Nout) o[1] = v1;
        }
      }
    }
}

constexpr int PC = 128;          // lhs columns a block, 4 a lane
constexpr int PWARPS = 4;        // warps a block, over rows w, w + 4, ...
constexpr int PRG = 8;           // ranks a group (held in registers)
constexpr int PCH = 128;         // panel rows staged at a time
constexpr int P_UNROLL = 8;      // lhs rows in flight a warp
constexpr int PANEL_PER_SM = 2;  // blocks an SM the M split aims for
constexpr int PANEL_MIN_ROWS = 32;

// 4 adjacent columns [c, c + 4) of a row of lhs, zero past L: one
// 16-byte load where `vec` (lhs 16-byte aligned, L % 4 == 0), else four
__device__ __forceinline__ float4 lhs_quad(const float* row, int c, int L,
                                           bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (c < L) v = __ldg(reinterpret_cast<const float4*>(row + c));
  } else {
    if (c < L) v.x = __ldg(row + c);
    if (c + 1 < L) v.y = __ldg(row + c + 1);
    if (c + 2 < L) v.z = __ldg(row + c + 2);
    if (c + 3 < L) v.w = __ldg(row + c + 3);
  }
  return v;
}

// One product of the panel gradient: out = lhsᵀ·panel over slices of M,
// lhs (clients·M, L), panel (clients·M, r), out (clients·slices, L, r),
// or (.., r, L) where transpose_out.  `tiles` column tiles of PC.
struct PanelJob {
  const float* lhs;
  const float* panel;
  float* out;
  int L, tiles, transpose_out, vec;
};

// out[z][l, j] = sum over slice z of M of lhs[m, l] panel[m, j] (out[z][j,
// l] when transposed), slice z = rows [z·rows, (z+1)·rows) ∩ [0, M): one
// block per (128 columns, slice) of a job: blocks x < job0.tiles take job
// 0, the rest job 1, so one launch computes two products of the same
// rows (the DP step's dA and dB).  Warp w sums rows w, w + 4, ... of the
// slice in order, the warps are added in order through shared memory;
// ranks in groups of 8, each rereading the slice's rows (from L1/L2).
// With a client axis (gridDim.z clients, blockIdx.z the client) lhs and
// panel hold the clients' M rows one after another, and client c's slice
// z goes to out[c·gridDim.y + z]: what a launch on its rows alone writes
__global__ void __launch_bounds__(32 * PWARPS)
panel_grad_kernel(const PanelJob job0, const PanelJob job1, int M, int r,
                  int rows) {
  __shared__ __align__(16) float Ps[PCH][PRG];
  __shared__ __align__(16) float red[PWARPS][PRG][PC];

  const bool second = blockIdx.x >= job0.tiles;
  const int L = second ? job1.L : job0.L;
  const int transpose_out = second ? job1.transpose_out : job0.transpose_out;
  const bool vec = second ? job1.vec : job0.vec;
  const int tile = blockIdx.x - (second ? job0.tiles : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = tile * PC + 4 * lane;
  const int mbeg = blockIdx.y * rows, mend = min(M, mbeg + rows);
  const size_t client = blockIdx.z;
  const float* lhs = (second ? job1.lhs : job0.lhs) + client * M * L;
  const float* panel = (second ? job1.panel : job0.panel) + client * M * r;
  float* dst = (second ? job1.out : job0.out) +
               (client * gridDim.y + blockIdx.y) * L * r;

  for (int j0 = 0; j0 < r; j0 += PRG) {
    float acc[4][PRG];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < PRG; ++j) acc[i][j] = 0.f;
    for (int m0 = mbeg; m0 < mend; m0 += PCH) {
      const int n = min(PCH, mend - m0);
      __syncthreads();              // the last chunk's panel and red are read
      for (int e = threadIdx.x; e < PCH * PRG; e += 32 * PWARPS) {
        const int mm = e / PRG, jj = e % PRG;
        Ps[mm][jj] = (mm < n && j0 + jj < r)
                         ? panel[(size_t)(m0 + mm) * r + j0 + jj] : 0.f;
      }
      __syncthreads();
      for (int i0 = warp; i0 < n; i0 += PWARPS * P_UNROLL) {
        float4 x[P_UNROLL];
        #pragma unroll
        for (int u = 0; u < P_UNROLL; ++u) {
          const int mm = i0 + u * PWARPS;
          x[u] = mm < n ? lhs_quad(lhs + (size_t)(m0 + mm) * L, c, L, vec)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        #pragma unroll
        for (int u = 0; u < P_UNROLL; ++u) {
          const int mm = i0 + u * PWARPS;
          if (mm >= n) break;
          const float4 p0 = *reinterpret_cast<const float4*>(&Ps[mm][0]);
          const float4 p1 = *reinterpret_cast<const float4*>(&Ps[mm][4]);
          const float p[PRG] = {p0.x, p0.y, p0.z, p0.w,
                                p1.x, p1.y, p1.z, p1.w};
          #pragma unroll
          for (int j = 0; j < PRG; ++j) {
            acc[0][j] += x[u].x * p[j];
            acc[1][j] += x[u].y * p[j];
            acc[2][j] += x[u].z * p[j];
            acc[3][j] += x[u].w * p[j];
          }
        }
      }
    }
    #pragma unroll
    for (int j = 0; j < PRG; ++j)
      *reinterpret_cast<float4*>(&red[warp][j][4 * lane]) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    __syncthreads();
    // thread t sums column t's ranks over the warps, in order
    const int l = tile * PC + threadIdx.x;
    #pragma unroll
    for (int j = 0; j < PRG; ++j) {
      float s = red[0][j][threadIdx.x];
      #pragma unroll
      for (int w = 1; w < PWARPS; ++w) s += red[w][j][threadIdx.x];
      if (l < L && j0 + j < r) {
        if (transpose_out) dst[(size_t)(j0 + j) * L + l] = s;
        else dst[(size_t)l * r + j0 + j] = s;
      }
    }
  }
}

static_assert(PC == 32 * PWARPS, "one output column a thread");

constexpr int DW_T = 128;       // rows (K) and columns (N) of dW a block
constexpr int DW_BK = 32;       // rows of M a stage: one swizzled fp32 row
constexpr int DW_BLOCK = 32;    // rows of M summed into a fresh accumulator
constexpr int DW_THREADS = 256; // two warpgroups, 64 rows of the tile each
constexpr int DW_TILE = DW_T * DW_BK;   // floats of one operand part a stage
// a stage: x big, x small, g big, g small; two stages, and the slack that
// puts the first on a 1024-byte boundary
constexpr int DW_STAGE = 4 * DW_TILE;
constexpr size_t DW_SMEM = 2 * DW_STAGE * sizeof(float) + 1024;
constexpr int DW_PER_SM = 4;    // blocks an SM the fixed-order sum aims for
static_assert(DW_BLOCK % DW_BK == 0, "a block of M is whole stages");
static_assert(DW_BK == 32, "a stage is one 128-byte swizzle row");

// Thread t stages column c0 + t % 128 of rows [m0, m0 + 32) of a row-major
// (·, ld) matrix: the 4 rows of chunks t / 128 + 2j (j < 4), one 4-byte
// load each (a warp's 32 lanes read 128 contiguous bytes), zero past `cols`
// and `mend`.
__device__ __forceinline__ void dw_load(float (&v)[4][4], const float* src,
                                        int ld, int m0, int mend, int c0,
                                        int cols) {
  const int col = c0 + threadIdx.x % DW_T;
  const int cq = threadIdx.x / DW_T;
  #pragma unroll
  for (int j = 0; j < 4; ++j)
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + 4 * (cq + 2 * j) + q;
      v[j][q] = col < cols && m < mend ? __ldg(src + (size_t)m * ld + col)
                                       : 0.f;
    }
}

// ... and stores them transposed, split once, into the K-major big and
// small tiles: row t % 128, chunk t / 128 + 2j, one 16-byte store each (the
// 8 rows of a store phase fall in 8 different chunks of the swizzle: no
// bank conflict)
__device__ __forceinline__ void dw_store(const float (&v)[4][4], float* big,
                                         float* small) {
  const int row = threadIdx.x % DW_T;
  const int cq = threadIdx.x / DW_T;
  #pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint4 b, s;
    split_fast(v[j][0], b.x, s.x);
    split_fast(v[j][1], b.y, s.y);
    split_fast(v[j][2], b.z, s.z);
    split_fast(v[j][3], b.w, s.w);
    const int at = swizzle128(row, cq + 2 * j);
    *reinterpret_cast<uint4*>(big + at) = b;
    *reinterpret_cast<uint4*>(small + at) = s;
  }
}

// out[z][k, n] = sum over slice z of M of X[m, k] G[m, n]; X (M, K) and
// G (M, N) row-major, slice z = rows [z·rows, (z+1)·rows) ∩ [0, M), rows a
// multiple of DW_BLOCK.  Warpgroup h of the block owns rows [64h, 64h +
// 64) of its 128 x 128 tile.
__global__ void __launch_bounds__(DW_THREADS, 1)
lora_dw_kernel(const float* __restrict__ X, const float* __restrict__ G,
               float* __restrict__ out, int M, int K, int N, int rows) {
  extern __shared__ unsigned char dw_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(dw_raw);
  float* sm = reinterpret_cast<float*>(dw_raw + ((1024 - raw % 1024) % 1024));

  const int k0 = blockIdx.y * DW_T, n0 = blockIdx.x * DW_T;
  const int mbeg = blockIdx.z * rows;
  const int mend = min(M, mbeg + rows);
  const int stages = (mend - mbeg + DW_BK - 1) / DW_BK;
  const int wg = threadIdx.x / 128;

  float acc[64], tot[64];
  #pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  float xv[4][4], gv[4][4];

  // stage 0 into shared memory, stage 1 into registers
  dw_load(xv, X, K, mbeg, mend, k0, K);
  dw_load(gv, G, N, mbeg, mend, n0, N);
  dw_store(xv, sm, sm + DW_TILE);
  dw_store(gv, sm + 2 * DW_TILE, sm + 3 * DW_TILE);
  fence_async_shared();
  dw_load(xv, X, K, mbeg + DW_BK, mend, k0, K);
  dw_load(gv, G, N, mbeg + DW_BK, mend, n0, N);
  __syncthreads();

  for (int s = 0; s < stages; ++s) {
    const float* st = sm + (s & 1) * DW_STAGE;
    const float* xb = st + wg * 64 * DW_BK;
    const float* xs = xb + DW_TILE;
    const float* gb = st + 2 * DW_TILE;
    const float* gs = st + 3 * DW_TILE;
    // a block of M starts with a fresh accumulator and ends added to tot
    const bool fresh = (s * DW_BK) % DW_BLOCK == 0;
    const bool last = ((s + 1) * DW_BK) % DW_BLOCK == 0 || s + 1 == stages;
    wgmma_hold(acc);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < DW_BK / 8; ++kk) {
      // the small terms first, then big·big (mma_tf32.cuh's mma3 order)
      wgmma_tf32(acc, wgmma_desc(xs + 8 * kk), wgmma_desc(gb + 8 * kk),
                 fresh && kk == 0 ? 0 : 1);
      wgmma_tf32(acc, wgmma_desc(xb + 8 * kk), wgmma_desc(gs + 8 * kk), 1);
      wgmma_tf32(acc, wgmma_desc(xb + 8 * kk), wgmma_desc(gb + 8 * kk), 1);
    }
    wgmma_commit();
    // under this stage's products: the next stage, loaded into registers
    // one stage ago, goes to the other buffer (whose products finished
    // before the last barrier), and the loads of the stage after it start,
    // a whole stage ahead of their use
    if (s + 1 < stages) {
      float* nx = sm + ((s + 1) & 1) * DW_STAGE;
      dw_store(xv, nx, nx + DW_TILE);
      dw_store(gv, nx + 2 * DW_TILE, nx + 3 * DW_TILE);
      fence_async_shared();
      if (s + 2 < stages) {
        const int m0 = mbeg + (s + 2) * DW_BK;
        dw_load(xv, X, K, m0, mend, k0, K);
        dw_load(gv, G, N, m0, mend, n0, N);
      }
    }
    wgmma_wait<0>();
    wgmma_hold(acc);
    if (last) {
      #pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.z * K * N;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r0 = k0 + wg * 64 + warp * 16 + lane / 4;
  #pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= K) continue;
      if (c < N) dst[(size_t)r * N + c] = tot[4 * j + 2 * h];
      if (c + 1 < N) dst[(size_t)r * N + c + 1] = tot[4 * j + 2 * h + 1];
    }
  }
}

// For each of `count` sums c of n floats: dw[c][i] = ws[c][0][i] +
// ws[c][1][i] + ... + ws[c][splits-1][i], in that order (ws (count, splits,
// n), dw (count, n))
__global__ void dw_sum_kernel(const float* __restrict__ ws,
                              float* __restrict__ dw, size_t n, int splits,
                              int count) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       e < n * count; e += (size_t)gridDim.x * blockDim.x) {
    const size_t c = e / n, i = e - c * n;
    const float* src = ws + c * splits * n + i;
    float s = src[0];
    for (int z = 1; z < splits; ++z) s += src[(size_t)z * n];
    dw[e] = s;
  }
}

// Allows `kernel` `bytes` of dynamic shared memory (above 48 KB) at its
// first launch on each device (the attribute belongs to the device), one
// bit of `ready` a device.  Two threads may both set it; setting it twice
// is harmless.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  return cudaSuccess;
}

// Launches one instance, its dynamic shared memory the most it can take.
template <bool TRANS, int NR>
int launch_fused(dim3 grid, cudaStream_t s, const float* X, const float* W,
                 const float* Aop, const float* Bop, float* out, float* xa,
                 int M, int C, int Nout, int r, int vec_x, int vec_w) {
  using F = Fused<TRANS, NR>;
  static std::atomic<uint64_t> ready{0};
  const cudaError_t err =
      allow_smem(lora_fused_kernel<TRANS, NR>, F::smem(true), ready);
  if (err != cudaSuccess) return (int)err;
  // the running totals need shared memory only beyond one K block
  lora_fused_kernel<TRANS, NR><<<grid, FT, F::smem(C > KB), s>>>(
      X, W, Aop, Bop, out, xa, M, C, Nout, r, vec_x, vec_w);
  return (int)cudaGetLastError();
}

template <bool TRANS>
int launch_fused_rank(dim3 grid, cudaStream_t s, const float* X,
                      const float* W, const float* Aop, const float* Bop,
                      float* out, float* xa, int M, int C, int Nout, int r,
                      int vec_x, int vec_w) {
  const int nr = (r + 7) / 8;
  if (nr <= 1)
    return launch_fused<TRANS, 1>(grid, s, X, W, Aop, Bop, out, xa, M, C,
                                  Nout, r, vec_x, vec_w);
  if (nr <= 2)
    return launch_fused<TRANS, 2>(grid, s, X, W, Aop, Bop, out, xa, M, C,
                                  Nout, r, vec_x, vec_w);
  if (nr <= 4)
    return launch_fused<TRANS, 4>(grid, s, X, W, Aop, Bop, out, xa, M, C,
                                  Nout, r, vec_x, vec_w);
  return launch_fused<TRANS, 8>(grid, s, X, W, Aop, Bop, out, xa, M, C, Nout,
                                r, vec_x, vec_w);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int sm_count() {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  return sms;
}

// the blocks that fill the current device: DW_PER_SM on each SM
int dw_blocks() { return DW_PER_SM * sm_count(); }

// out[c][i] = ws[c][0][i] + ws[c][1][i] + ... over `splits` slices of n
// floats, for each of `count` sums
void sum_slices(const float* ws, float* out, size_t n, int splits,
                cudaStream_t s, int count = 1) {
  const size_t need = (n * count + 255) / 256;
  const size_t most = (size_t)dw_blocks();
  const int blocks = (int)(need < most ? need : most);
  dw_sum_kernel<<<blocks, 256, 0, s>>>(ws, out, n, splits, count);
}

// rows of M per panel slice (at least PANEL_MIN_ROWS, unless M is less)
// and the number of slices: enough blocks for PANEL_PER_SM on every SM
void panel_split(int M, int L, int* rows, int* splits) {
  const long tiles = (L + PC - 1) / PC;
  const int parts = (M + PANEL_MIN_ROWS - 1) / PANEL_MIN_ROWS;
  int want = (int)(((long)PANEL_PER_SM * sm_count() + tiles - 1) / tiles);
  want = want < 1 ? 1 : (want > parts ? parts : want);
  *rows = (M + want - 1) / want;
  *splits = (M + *rows - 1) / *rows;
}

// rows of M per slice (a multiple of DW_BLOCK) and the number of slices:
// one slice where the 128 x 128 tiles fill the SMs, else as many as keep
// every block in one wave (one block an SM)
void dw_split(int M, int K, int N, int* rows, int* splits) {
  const long tiles = (long)((K + DW_T - 1) / DW_T) * ((N + DW_T - 1) / DW_T);
  const int parts = (M + DW_BLOCK - 1) / DW_BLOCK;
  const long sms = sm_count();
  int want = tiles >= sms ? 1 : (int)(sms / tiles);
  want = want > parts ? parts : want;
  const int per = (parts + want - 1) / want;
  *rows = per * DW_BLOCK;
  *splits = (M + *rows - 1) / *rows;
}

// lora_fused and lora_fused_clients: `clients` stacked clients of M rows
int fused(const float* X, const float* W, const float* A, const float* B,
          float* out, float* xa, int clients, int M, int C, int Nout, int r,
          int trans, void* stream) {
  if (clients <= 0 || clients > 65535 || M <= 0 || C <= 0 || Nout <= 0 ||
      r < 1 || r > R_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Nout + TN - 1) / TN, (M + TM - 1) / TM, clients);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // W (K, N) has a row stride of N in both directions; a client's rows
  // start 16-byte aligned when the first's do and C % 4 == 0
  const int n = trans ? C : Nout;
  const int vec_x = aligned16(X) && C % 4 == 0;
  const int vec_w = aligned16(W) && n % 4 == 0;
  if (trans)
    return launch_fused_rank<true>(grid, s, X, W, B, A, out, xa, M, C, Nout,
                                   r, vec_x, vec_w);
  return launch_fused_rank<false>(grid, s, X, W, A, B, out, xa, M, C, Nout, r,
                                  vec_x, vec_w);
}

// one product of the panel gradient over `lhs` (·, L)
PanelJob panel_job(const float* lhs, const float* panel, float* out, int L,
                   int transpose_out) {
  const int vec = aligned16(lhs) && L % 4 == 0;
  return PanelJob{lhs, panel, out, L, (L + PC - 1) / PC, transpose_out, vec};
}

// job 0, then job 1's blocks (none where its tiles are 0), over `slices`
// slices of `rows` rows of M for each of `clients`
cudaError_t launch_panel(const PanelJob& job0, const PanelJob& job1, int M,
                         int r, int rows, int slices, int clients,
                         cudaStream_t s) {
  const dim3 grid(job0.tiles + job1.tiles, slices, clients);
  panel_grad_kernel<<<grid, 32 * PWARPS, 0, s>>>(job0, job1, M, r, rows);
  return cudaGetLastError();
}

// lora_panel_grad and lora_panel_clients: `clients` stacked clients of M
// rows, each split as one client's M is, its slices summed in order
int panel_grad(const float* lhs, const float* panel, float* out, float* ws,
               int clients, int M, int L, int r, int transpose_out,
               void* stream) {
  if (clients <= 0 || clients > 65535 || M <= 0 || L <= 0 || r < 1 ||
      r > R_MAX)
    return (int)cudaErrorInvalidValue;
  int rows, splits;
  panel_split(M, L, &rows, &splits);
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PanelJob none{};
  cudaError_t err = launch_panel(
      panel_job(lhs, panel, splits > 1 ? ws : out, L, transpose_out), none,
      M, r, rows, splits, clients, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  sum_slices(ws, out, (size_t)L * r, splits, s, clients);
  return (int)cudaGetLastError();
}

bool examples_ok(int B, int S, int r) {
  return B > 0 && B <= 65535 && S > 0 && r >= 1 && r <= R_MAX &&
         (long)B * S <= 0x7fffffffL;
}

}  // namespace

extern "C" {

// trans = 0: y (M, Nout=N) and xa (M, r) from x (M, C=K), W (K, N), A, B.
// trans = 1: dx (M, Nout=K) and gb (M, r) from g (M, C=N), W (K, N), A, B.
int lora_fused(const float* X, const float* W, const float* A, const float* B,
               float* out, float* xa, int M, int C, int Nout, int r, int trans,
               void* stream) {
  return fused(X, W, A, B, out, xa, 1, M, C, Nout, r, trans, stream);
}

// lora_fused with a client axis: X (clients, M, C), A (clients, K, r), B
// (clients, r, N), out (clients, M, Nout) and xa (clients, M, r), with W
// (K, N) shared.  One launch, a grid of (column tiles, M tiles, clients)
// in which no M tile straddles two clients; client c's blocks compute
// what lora_fused computes on client c's rows and factors, the same bits.
// The stacked clients' forward (trans = 0) and dx (trans = 1): the form
// _fwd_call and _dx_call take under the vmap over clients of the stacked
// local update (src/repro/core/fed_spmd.py).  At GPT-2's (3, 1280, 768,
// 768) that is 720 blocks in one launch in place of three of 240.
int lora_fused_clients(const float* X, const float* W, const float* A,
                       const float* B, float* out, float* xa, int clients,
                       int M, int C, int Nout, int r, int trans,
                       void* stream) {
  return fused(X, W, A, B, out, xa, clients, M, C, Nout, r, trans, stream);
}

// The number of M slices lora_panel_grad splits (M, L) into: with more
// than one, it needs a (splits, L, r) fp32 workspace.
int lora_panel_splits(int M, int L, int r) {
  if (M <= 0 || L <= 0 || r < 1 || r > R_MAX) return 0;
  int rows, splits;
  panel_split(M, L, &rows, &splits);
  return splits;
}

// (L, r) = lhsᵀ·panel from lhs (M, L) and panel (M, r); (r, L) if
// transpose_out; ws holds lora_panel_splits slices of it when that is
// above 1 (else unused).
int lora_panel_grad(const float* lhs, const float* panel, float* out,
                    float* ws, int M, int L, int r, int transpose_out,
                    void* stream) {
  return panel_grad(lhs, panel, out, ws, 1, M, L, r, transpose_out, stream);
}

// lora_panel_grad with a client axis: each client's (L, r) = lhs_cᵀ·panel_c
// from lhs (clients, M, L) and panel (clients, M, r) into out (clients, L,
// r), (clients, r, L) if transpose_out; ws holds (clients,
// lora_panel_splits(M, L, r)) slices of (L, r) when that is above 1.  A
// grid of (column tiles, slices, clients): each client's M is split as
// lora_panel_grad splits it, and one dw_sum_kernel adds every client's
// slices in the same order, so each client gets the bits of a
// lora_panel_grad launch on its rows.  The stacked clients' dA and dB:
// the form _panel_grad_call takes under the vmap over clients of the
// stacked local update (src/repro/core/fed_spmd.py).  At GPT-2's (3,
// 1280, 768) that is 6 x 40 x 3 = 720 blocks; its work is the bytes of
// lhs, so it is bound by bytes and by its two launches.
int lora_panel_clients(const float* lhs, const float* panel, float* out,
                       float* ws, int clients, int M, int L, int r,
                       int transpose_out, void* stream) {
  return panel_grad(lhs, panel, out, ws, clients, M, L, r, transpose_out,
                    stream);
}

// Each example's (L, r) = lhs_bᵀ·panel_b from lhs (B, S, L) and panel (B,
// S, r) into out (B, L, r); (B, r, L) if transpose_out: panel_grad_kernel
// with one slice of S rows per example, whose slice partials are then the
// answer, written straight to out (no workspace, no sum).  The same fixed
// summation order as lora_panel_grad's: the same bits on every run.
int lora_panel_examples(const float* lhs, const float* panel, float* out,
                        int B, int S, int L, int r, int transpose_out,
                        void* stream) {
  if (!examples_ok(B, S, r) || L <= 0) return (int)cudaErrorInvalidValue;
  const PanelJob none{};
  return (int)launch_panel(panel_job(lhs, panel, out, L, transpose_out), none,
                           B * S, r, S, B, 1,
                           static_cast<cudaStream_t>(stream));
}

// The DP-SGD step's per-example dA and dB of one LoRA site in one launch:
// da (B, K, r) = each x_bᵀ·gb_b and db (B, r, N) = each (g_bᵀ·xa_b)ᵀ, from
// x (B, S, K), gb (B, S, r), g (B, S, N) and xa (B, S, r).  The grid
// holds dA's column tiles over K, then dB's over N, by B examples, each
// block lora_panel_examples' block on its example: the bits of the two
// lora_panel_examples launches it replaces.  A site whose product fills
// few SMs on its own (RecurrentGemma-2B's wk/wv dB at N 256: 2 x 16
// blocks) shares one wave with the other (dA at K 2560: 20 x 16); at
// GPT-2's (16, 80, 768 | 768) 192 blocks in place of 96 + 96.
int lora_panel_examples_pair(const float* x, const float* gb, const float* g,
                             const float* xa, float* da, float* db, int B,
                             int S, int K, int N, int r, void* stream) {
  if (!examples_ok(B, S, r) || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_panel(panel_job(x, gb, da, K, 0),
                           panel_job(g, xa, db, N, 1), B * S, r, S, B, 1,
                           static_cast<cudaStream_t>(stream));
}

// The number of M slices lora_dw splits (M, K, N) into: with more than
// one, it needs a (splits, K, N) fp32 workspace.
int lora_dw_splits(int M, int K, int N) {
  if (M <= 0 || K <= 0 || N <= 0) return 0;
  int rows, splits;
  dw_split(M, K, N, &rows, &splits);
  return splits;
}

// dW (K, N) = xᵀ·g from x (M, K) and g (M, N); ws holds lora_dw_splits
// slices of (K, N) when that is above 1 (else unused).
int lora_dw(const float* X, const float* G, float* dw, float* ws, int M,
            int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  int rows, splits;
  dw_split(M, K, N, &rows, &splits);
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static std::atomic<uint64_t> ready{0};
  cudaError_t err = allow_smem(lora_dw_kernel, DW_SMEM, ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + DW_T - 1) / DW_T, (K + DW_T - 1) / DW_T, splits);
  lora_dw_kernel<<<grid, DW_THREADS, DW_SMEM, s>>>(
      X, G, splits > 1 ? ws : dw, M, K, N, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  sum_slices(ws, dw, (size_t)K * N, splits, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
