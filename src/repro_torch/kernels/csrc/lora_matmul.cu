// Fused LoRA matmul kernels for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of src/repro/kernels/lora_matmul.py:
//   * lora_fused_kernel<false, .> <- _fwd_call / _fwd_kernel:
//       y = x@W + (x@A)@B, and writes the (M, r) panel xa = x@A once.
//   * lora_fused_kernel<true, .>  <- _dx_call / _dx_kernel:
//       dx = g@Wᵀ + (g@Bᵀ)@Aᵀ, reading W, A and B in their native layouts
//       (the contraction runs over N), and writes gb = g@Bᵀ once.
//   * lora_dw_kernel (+ dw_sum_kernel) <- _dw_call / _dw_kernel:
//       the dense dW = xᵀg, summed over M; it runs only where the base
//       weight itself requires a gradient.
//   * panel_grad_kernel         <- _panel_grad_call / _panel_grad_kernel:
//       (L, r) = lhsᵀ·panel, i.e. dA = xᵀ·gb and dB = (gᵀ·xa)ᵀ.
//
// What bounds it on this card: at the main path's shapes (M=1280, K=N=768,
// r=8) the fused product is ~1.6 GFLOP over ~10 MB, so in fp32 on the FMA
// units (no tensor cores, no TF32) it is bound by operations, and so is
// dW (2·M·K·N, 1.5 GFLOP over ~10 MB); the panel reduction (~16 MFLOP
// over ~4 MB) is bound by bytes.
//
// The simple design: one 256-thread block per (64 x 64) output tile, the
// contraction streamed through shared memory 16 at a time, each thread
// owning a 4 x 4 register tile.  Each tile sums the contraction in blocks
// (KB of K, DW_PART of M): a block's products go into a fresh partial
// that is then added to the running total, so no FMA chain is longer
// than one block.  One chain over all of K = 2560 had 2.2 times cuBLAS's
// rms error against fp64; a chain of 768 has cuBLAS's.  KB is 768, not
// less: a product of K <= 768 (all of GPT-2's) then keeps its one chain,
// whose runs sit at the floor of the cuBLAS runs that the full-width
// gates measure from; with blocks of 128, more accurate than cuBLAS, the
// Split path's fp32 runs moved past that floor's limit.
//
// The fused block also accumulates the (64, r) x@A panel in registers
// next to its main tile (r <= 64), blocked the same way, so the rank-r
// path re-reads nothing from device memory; the epilogue stages that
// panel and the (r, 64) slice of B in shared memory and adds (x@A)@B to
// the tile.  Only the blocks of column tile 0 write the panel out.  dW
// tiles its (K, N) output the same way and streams M through shared
// memory, both operands read along their fast axis (coalesced); where
// the tiles alone would not fill the card (768² is 144 tiles on 132 SMs)
// M is split over gridDim.z into a workspace, and a second pass sums the
// slices in a fixed order: no atomics, so dW is deterministic.  The
// panel reduction gives each block 32 columns of lhs and 8 ranks; its 8
// warps stride over M and are summed in shared memory in a fixed order.
// Ragged edges are masked in the loads.
//
// What a later PR should change: the products belong on the tensor
// cores (wgmma fed by TMA, bf16 or TF32 where the reference allows it),
// with a persistent grid; the panel reduction should split M across more
// blocks (a second deterministic pass) to use all 132 SMs.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // rows of x per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 16;       // contraction step
constexpr int KB = 768;      // contraction summed into one partial
constexpr int NT = 256;      // threads per block
constexpr int R_MAX = 64;    // largest LoRA rank
constexpr int PAD = 4;

// out[m, n] = sum_c X[m, c] Wop[c, n] + sum_j XA[m, j] Bop[j, n],
// XA[m, j] = sum_c X[m, c] Aop[c, j];  X is (M, C) row-major.
//  TRANS = false (forward): C = K, Wop = W (K, N), Aop = A (K, r),
//                           Bop = B (r, N).
//  TRANS = true  (dx):      X = g (M, N), C = N, out width K,
//                           Wop[c, n] = W[n, c], Aop[c, j] = B[j, c],
//                           Bop[j, n] = A[n, j]; the launcher passes B as
//                           Aop and A as Bop.
// XS: slots of the (BM, r) panel each thread holds, XS * NT >= BM * r; the
// launcher takes the smallest of 2, 4, 8, 16 that covers r, so a rank-8
// run keeps 2 panel registers (and 2 partials), not R_MAX's 16.
template <bool TRANS, int XS>
__global__ void __launch_bounds__(NT)
lora_fused_kernel(const float* __restrict__ X, const float* __restrict__ W,
                  const float* __restrict__ Aop, const float* __restrict__ Bop,
                  float* __restrict__ out, float* __restrict__ xa_out,
                  int M, int C, int Nout, int r) {
  __shared__ float Xs[BK][BM + PAD];       // x tile, transposed
  __shared__ float Ws[BK][BN + PAD];
  __shared__ float As[BK][R_MAX];
  __shared__ float XAs[BM][R_MAX + 1];
  __shared__ float Bs[R_MAX][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // running totals, and the partials of the current K block
  float acc[4][4], part[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xa[XS], xap[XS];
  for (int t = 0; t < XS; ++t) xa[t] = 0.f;

  for (int kb = 0; kb < C; kb += KB) {
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    #pragma unroll
    for (int t = 0; t < XS; ++t) xap[t] = 0.f;
    const int kend = min(C, kb + KB);
    for (int c0 = kb; c0 < kend; c0 += BK) {
      // x tile (BM x BK), coalesced along c
      for (int e = tid; e < BM * BK; e += NT) {
        const int m = e / BK, c = e % BK;
        const int gm = m0 + m, gc = c0 + c;
        Xs[c][m] = (gm < M && gc < C) ? X[(size_t)gm * C + gc] : 0.f;
      }
      // W tile (BK x BN)
      for (int e = tid; e < BK * BN; e += NT) {
        int c, n;
        if (TRANS) { n = e / BK; c = e % BK; } else { c = e / BN; n = e % BN; }
        const int gc = c0 + c, gn = n0 + n;
        float val = 0.f;
        if (gc < C && gn < Nout)
          val = TRANS ? W[(size_t)gn * C + gc] : W[(size_t)gc * Nout + gn];
        Ws[c][n] = val;
      }
      // A tile (BK x r)
      for (int e = tid; e < BK * r; e += NT) {
        int c, j;
        if (TRANS) { j = e / BK; c = e % BK; } else { c = e / r; j = e % r; }
        const int gc = c0 + c;
        float val = 0.f;
        if (gc < C)
          val = TRANS ? Aop[(size_t)j * C + gc] : Aop[(size_t)gc * r + j];
        As[c][j] = val;
      }
      __syncthreads();

      #pragma unroll
      for (int c = 0; c < BK; ++c) {
        float xr[4], wr[4];
        #pragma unroll
        for (int i = 0; i < 4; ++i) xr[i] = Xs[c][ty + 16 * i];
        #pragma unroll
        for (int j = 0; j < 4; ++j) wr[j] = Ws[c][tx + 16 * j];
        #pragma unroll
        for (int i = 0; i < 4; ++i)
          #pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] += xr[i] * wr[j];
      }
      #pragma unroll
      for (int t = 0; t < XS; ++t) {
        const int idx = tid + NT * t;
        if (idx < BM * r) {
          const int m = idx / r, j = idx % r;
          float s = xap[t];
          #pragma unroll
          for (int c = 0; c < BK; ++c) s += Xs[c][m] * As[c][j];
          xap[t] = s;
        }
      }
      __syncthreads();
    }
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    #pragma unroll
    for (int t = 0; t < XS; ++t) xa[t] += xap[t];
  }

  // stage the x@A panel; column tile 0 writes it out
  #pragma unroll
  for (int t = 0; t < XS; ++t) {
    const int idx = tid + NT * t;
    if (idx < BM * r) {
      const int m = idx / r, j = idx % r;
      XAs[m][j] = xa[t];
      if (blockIdx.x == 0 && m0 + m < M) xa_out[(size_t)(m0 + m) * r + j] = xa[t];
    }
  }
  // B slice (r x BN)
  for (int e = tid; e < r * BN; e += NT) {
    int j, n;
    if (TRANS) { n = e / r; j = e % r; } else { j = e / BN; n = e % BN; }
    const int gn = n0 + n;
    float val = 0.f;
    if (gn < Nout)
      val = TRANS ? Bop[(size_t)gn * r + j] : Bop[(size_t)j * Nout + gn];
    Bs[j][n] = val;
  }
  __syncthreads();

  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    const int gm = m0 + m;
    #pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int n = tx + 16 * jn;
      const int gn = n0 + n;
      float low = 0.f;
      for (int j = 0; j < r; ++j) low += XAs[m][j] * Bs[j][n];
      if (gm < M && gn < Nout) out[(size_t)gm * Nout + gn] = acc[i][jn] + low;
    }
  }
}

constexpr int PL = 32;   // lhs columns per block (one per lane)
constexpr int PG = 8;    // row groups (one per warp)
constexpr int PR = 8;    // ranks per block
constexpr int PM = 64;   // rows per staged chunk

// out[l, j] = sum_m lhs[m, l] panel[m, j]  (or out[j, l] when transposed)
__global__ void __launch_bounds__(PL * PG)
panel_grad_kernel(const float* __restrict__ lhs,
                  const float* __restrict__ panel, float* __restrict__ out,
                  int M, int L, int r, int transpose_out) {
  __shared__ float Ps[PM][PR];
  __shared__ float red[PG][PL][PR + 1];

  const int tid = threadIdx.x;
  const int tl = tid % PL, tg = tid / PL;
  const int l = blockIdx.x * PL + tl;
  const int j0 = blockIdx.y * PR;

  float acc[PR];
  #pragma unroll
  for (int j = 0; j < PR; ++j) acc[j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += PM) {
    for (int e = tid; e < PM * PR; e += PL * PG) {
      const int mm = e / PR, jj = e % PR;
      Ps[mm][jj] = (m0 + mm < M && j0 + jj < r)
                       ? panel[(size_t)(m0 + mm) * r + j0 + jj] : 0.f;
    }
    __syncthreads();
    for (int mm = tg; mm < PM; mm += PG) {
      const float xv = (m0 + mm < M && l < L) ? lhs[(size_t)(m0 + mm) * L + l] : 0.f;
      #pragma unroll
      for (int j = 0; j < PR; ++j) acc[j] += xv * Ps[mm][j];
    }
    __syncthreads();
  }

  #pragma unroll
  for (int j = 0; j < PR; ++j) red[tg][tl][j] = acc[j];
  __syncthreads();
  // PL * PR == PL * PG threads: one output each, groups summed in order
  const int ol = tid / PR, oj = tid % PR;
  float s = 0.f;
  #pragma unroll
  for (int g = 0; g < PG; ++g) s += red[g][ol][oj];
  const int gl = blockIdx.x * PL + ol, gj = j0 + oj;
  if (gl < L && gj < r) {
    if (transpose_out) out[(size_t)gj * L + gl] = s;
    else out[(size_t)gl * r + gj] = s;
  }
}

static_assert(PL * PR == PL * PG, "one reduction output per thread");

constexpr int DW_BM = 16;      // rows of M staged per step
constexpr int DW_PART = 128;   // rows of M summed into one partial
constexpr int DW_PER_SM = 4;   // blocks an SM the M split aims for

// out[z][k, n] = sum over slice z of M of X[m, k] G[m, n]; X (M, K) and
// G (M, N) row-major, slice z = rows [z·rows, (z+1)·rows) ∩ [0, M).
__global__ void __launch_bounds__(NT)
lora_dw_kernel(const float* __restrict__ X, const float* __restrict__ G,
               float* __restrict__ out, int M, int K, int N, int rows) {
  __shared__ float Xs[DW_BM][BM + PAD];
  __shared__ float Gs[DW_BM][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int mbeg = blockIdx.z * rows;
  const int mend = min(M, mbeg + rows);

  float tot[4][4], part[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) tot[i][j] = 0.f;

  for (int p0 = mbeg; p0 < mend; p0 += DW_PART) {
    const int pend = min(mend, p0 + DW_PART);
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    for (int m0 = p0; m0 < pend; m0 += DW_BM) {
      // (DW_BM x 64) of x and of g, coalesced along k and n
      for (int e = tid; e < DW_BM * BM; e += NT) {
        const int m = e / BM, c = e % BM;
        const int gm = m0 + m;
        const bool row = gm < pend;
        Xs[m][c] = (row && k0 + c < K) ? X[(size_t)gm * K + k0 + c] : 0.f;
        Gs[m][c] = (row && n0 + c < N) ? G[(size_t)gm * N + n0 + c] : 0.f;
      }
      __syncthreads();
      #pragma unroll
      for (int m = 0; m < DW_BM; ++m) {
        float xr[4], gr[4];
        #pragma unroll
        for (int i = 0; i < 4; ++i) xr[i] = Xs[m][ty + 16 * i];
        #pragma unroll
        for (int j = 0; j < 4; ++j) gr[j] = Gs[m][tx + 16 * j];
        #pragma unroll
        for (int i = 0; i < 4; ++i)
          #pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] += xr[i] * gr[j];
      }
      __syncthreads();
    }
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) tot[i][j] += part[i][j];
  }

  float* dst = out + (size_t)blockIdx.z * K * N;
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty + 16 * i;
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gk < K && gn < N) dst[(size_t)gk * N + gn] = tot[i][j];
    }
  }
}

// dw[i] = ws[0][i] + ws[1][i] + ... + ws[splits-1][i], in that order
__global__ void dw_sum_kernel(const float* __restrict__ ws,
                              float* __restrict__ dw, size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[(size_t)z * n + i];
    dw[i] = s;
  }
}

template <int XS>
void launch_fused(int trans, dim3 grid, cudaStream_t s, const float* X,
                  const float* W, const float* A, const float* B, float* out,
                  float* xa, int M, int C, int Nout, int r) {
  if (trans)
    lora_fused_kernel<true, XS><<<grid, NT, 0, s>>>(X, W, B, A, out, xa, M,
                                                     C, Nout, r);
  else
    lora_fused_kernel<false, XS><<<grid, NT, 0, s>>>(X, W, A, B, out, xa, M,
                                                      C, Nout, r);
}

// the blocks that fill the current device: DW_PER_SM on each SM
int dw_blocks() {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  return DW_PER_SM * sms;
}

// rows of M per slice (a multiple of DW_PART) and the number of slices
void dw_split(int M, int K, int N, int* rows, int* splits) {
  const long tiles = (long)((K + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int parts = (M + DW_PART - 1) / DW_PART;
  int want = (int)((dw_blocks() + tiles - 1) / tiles);
  want = want < 1 ? 1 : (want > parts ? parts : want);
  const int per = (parts + want - 1) / want;
  *rows = per * DW_PART;
  *splits = (M + *rows - 1) / *rows;
}

}  // namespace

extern "C" {

// trans = 0: y (M, Nout=N) and xa (M, r) from x (M, C=K), W (K, N), A, B.
// trans = 1: dx (M, Nout=K) and gb (M, r) from g (M, C=N), W (K, N), A, B.
int lora_fused(const float* X, const float* W, const float* A, const float* B,
               float* out, float* xa, int M, int C, int Nout, int r, int trans,
               void* stream) {
  if (M <= 0 || C <= 0 || Nout <= 0 || r < 1 || r > R_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = (BM * r + NT - 1) / NT;
  if (slots <= 2)
    launch_fused<2>(trans, grid, s, X, W, A, B, out, xa, M, C, Nout, r);
  else if (slots <= 4)
    launch_fused<4>(trans, grid, s, X, W, A, B, out, xa, M, C, Nout, r);
  else if (slots <= 8)
    launch_fused<8>(trans, grid, s, X, W, A, B, out, xa, M, C, Nout, r);
  else
    launch_fused<16>(trans, grid, s, X, W, A, B, out, xa, M, C, Nout, r);
  return (int)cudaGetLastError();
}

// (L, r) = lhsᵀ·panel from lhs (M, L) and panel (M, r); (r, L) if transpose_out.
int lora_panel_grad(const float* lhs, const float* panel, float* out, int M,
                    int L, int r, int transpose_out, void* stream) {
  if (M <= 0 || L <= 0 || r < 1 || r > R_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + PL - 1) / PL, (r + PR - 1) / PR);
  panel_grad_kernel<<<grid, PL * PG, 0, static_cast<cudaStream_t>(stream)>>>(
      lhs, panel, out, M, L, r, transpose_out);
  return (int)cudaGetLastError();
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
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, splits);
  lora_dw_kernel<<<grid, NT, 0, s>>>(X, G, splits > 1 ? ws : dw, M, K, N,
                                     rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)K * N;
  const size_t need = (n + 255) / 256;
  const size_t most = (size_t)dw_blocks();
  const int blocks = (int)(need < most ? need : most);
  dw_sum_kernel<<<blocks, 256, 0, s>>>(ws, dw, n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
