// Fused LoRA matmul kernels for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of src/repro/kernels/lora_matmul.py:
//   * lora_fused_kernel<false>  <- _fwd_call / _fwd_kernel:
//       y = x@W + (x@A)@B, and writes the (M, r) panel xa = x@A once.
//   * lora_fused_kernel<true>   <- _dx_call / _dx_kernel:
//       dx = g@Wᵀ + (g@Bᵀ)@Aᵀ, reading W, A and B in their native layouts
//       (the contraction runs over N), and writes gb = g@Bᵀ once.
//   * panel_grad_kernel         <- _panel_grad_call / _panel_grad_kernel:
//       (L, r) = lhsᵀ·panel, i.e. dA = xᵀ·gb and dB = (gᵀ·xa)ᵀ.
//   (_dw_call, the dense dW = xᵀg, is not ported: the base is frozen.)
//
// What bounds it on this card: at the main path's shapes (M=1280, K=N=768,
// r=8) the fused product is ~1.6 GFLOP over ~10 MB, so in fp32 on the FMA
// units (no tensor cores, no TF32) it is bound by operations; the panel
// reduction (~16 MFLOP over ~4 MB) is bound by bytes.
//
// The simple design: one 256-thread block per (64 x 64) output tile, K
// streamed through shared memory 16 at a time, each thread owning a 4 x 4
// register tile.  The block also accumulates the (64, r) x@A panel in
// registers next to its main tile (r <= 64), so the rank-r path re-reads
// nothing from device memory; the epilogue stages that panel and the
// (r, 64) slice of B in shared memory and adds (x@A)@B to the tile.  Only
// the blocks of column tile 0 write the panel out.  The panel reduction
// gives each block 32 columns of lhs and 8 ranks; its 8 warps stride over
// M and are summed in shared memory in a fixed order, with no atomics, so
// the result is deterministic.  Ragged edges are masked in the loads.
//
// What a later PR should change: the fused product belongs on the tensor
// cores (wgmma fed by TMA, bf16 or TF32 where the reference allows it),
// with a persistent grid; the panel reduction should split M across more
// blocks (a second deterministic pass) to use all 132 SMs.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // rows of x per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 16;       // contraction step
constexpr int NT = 256;      // threads per block
constexpr int R_MAX = 64;    // largest LoRA rank
constexpr int XA_PER_THREAD = BM * R_MAX / NT;
constexpr int PAD = 4;

// out[m, n] = sum_c X[m, c] Wop[c, n] + sum_j XA[m, j] Bop[j, n],
// XA[m, j] = sum_c X[m, c] Aop[c, j];  X is (M, C) row-major.
//  TRANS = false (forward): C = K, Wop = W (K, N), Aop = A (K, r),
//                           Bop = B (r, N).
//  TRANS = true  (dx):      X = g (M, N), C = N, out width K,
//                           Wop[c, n] = W[n, c], Aop[c, j] = B[j, c],
//                           Bop[j, n] = A[n, j]; the launcher passes B as
//                           Aop and A as Bop.
template <bool TRANS>
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

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xa[XA_PER_THREAD];
  for (int t = 0; t < XA_PER_THREAD; ++t) xa[t] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
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
        for (int j = 0; j < 4; ++j) acc[i][j] += xr[i] * wr[j];
    }
    #pragma unroll
    for (int t = 0; t < XA_PER_THREAD; ++t) {
      const int idx = tid + NT * t;
      if (idx < BM * r) {
        const int m = idx / r, j = idx % r;
        float s = xa[t];
        #pragma unroll
        for (int c = 0; c < BK; ++c) s += Xs[c][m] * As[c][j];
        xa[t] = s;
      }
    }
    __syncthreads();
  }

  // stage the x@A panel; column tile 0 writes it out
  #pragma unroll
  for (int t = 0; t < XA_PER_THREAD; ++t) {
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
  if (trans)
    lora_fused_kernel<true><<<grid, NT, 0, s>>>(X, W, B, A, out, xa, M, C, Nout, r);
  else
    lora_fused_kernel<false><<<grid, NT, 0, s>>>(X, W, A, B, out, xa, M, C, Nout, r);
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

}  // extern "C"
