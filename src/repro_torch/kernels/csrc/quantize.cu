// Per-row symmetric int quantization kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/quantize.py:
//   * quantize_rows_kernel<.., false> <- quantize_rows (row 10): per row of
//       x (R, C), scale = max(absmax / qmax, 1e-12) and q = clamp(
//       round_half_even(x / scale), -qmax, qmax) in int8, qmax =
//       2^(bits-1) - 1.  Outputs q int8 (R, C) and scale fp32 (R, 1): the
//       Split-FedLLM boundary (c2 activations up, c4 gradients down).
//   * quantize_rows_kernel<.., true> <- quantize_pack4_rows (row 11): the
//       same at qmax 7, two levels a byte, the even column in the low
//       nibble (two's complement): q uint8 (R, C/2), C even.
//   * topk_quantize_kernel <- topk_quantize_rows / _topk_kernel (row 12):
//       per row, the k largest values (ties to the lower index, the order
//       of lax.top_k), then the same quantization over those k.  Outputs
//       q int8 (R, k), idx int32 (R, k), scale fp32 (R, 1): the KD b3
//       logit upload.
//
// What bounds them on this card: bytes.  quantize_rows reads x once in
// principle and writes C + 4 bytes a row: 4.92 MB at the Split path's
// (1280, 768), 0.0015 ms at 3.35 TB/s; a second pass over the row after
// its maximum is read from L1/L2.  At that size an eager call costs the
// host more than the device.  The simple design: one row per warp (C <=
// 2048) or per 256-thread block; an absmax in registers, a xor butterfly
// in the warp and, for a block, warp order through shared memory; then
// one pass that writes the levels, 16-byte loads and 4- (int8) or 2-byte
// (packed) stores where the row allows them.
//
// Top-k: the data is read once in principle (R*C*4 bytes in, R*k*5 +
// R*4 out): 39 KB at the KD path's (150, 77), 257 MB (0.077 ms) at
// (1280, 50257).  The selection does k passes over each row, k*C
// compares, served from L1/L2 after the first pass; at k = 64 over
// C = 50257 that re-reading, not device memory, is what this simple
// kernel spends its time on.  One row per warp (C <= 2048) or per
// 256-thread block.  Round t takes the maximum, in the order (value
// descending, index ascending), among the elements that come strictly
// after pick t-1 in that order, so the row needs no writable copy: it
// equals the reference's "first argmax, then overwrite it with -1e30"
// for every row with no entry <= -1e30.  A later PR should stage a row in
// shared memory (201 KB at C = 50257 fits in 227 KB) or select with a
// radix pass.
//
// Every quantization uses IEEE division and rintf (no fast math, no
// reciprocal), so q, idx and scale are bit-identical to the plain
// PyTorch versions (kernels/ref.py).
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int K_MAX = 512;       // largest k

struct Pick {
  float v;
  int j;
};

// a comes before b in the order (value descending, index ascending)
__device__ __forceinline__ bool before(float av, int aj, float bv, int bj) {
  return av > bv || (av == bv && aj < bj);
}

__device__ __forceinline__ Pick warp_best(Pick p) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, p.v, off);
    const int oj = __shfl_xor_sync(0xffffffffu, p.j, off);
    if (before(ov, oj, p.v, p.j)) p = Pick{ov, oj};
  }
  return p;
}

__device__ __forceinline__ float warp_max(float v) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int TPR>
__global__ void __launch_bounds__(NT)
topk_quantize_kernel(const float* __restrict__ X, int8_t* __restrict__ Q,
                     int* __restrict__ IDX, float* __restrict__ SCALE, int R,
                     int C, int k, float qmax) {
  constexpr int RPB = NT / TPR;          // rows per block
  constexpr int WPR = TPR / 32;          // warps per row
  __shared__ float pv[RPB][K_MAX];
  __shared__ int pj[RPB][K_MAX];
  __shared__ Pick red[RPB][WPR];
  __shared__ float redm[RPB][WPR];
  const int rb = threadIdx.x / TPR, tr = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + rb;
  const bool live = row < R;
  const float* x = X + (size_t)(live ? row : 0) * C;

  // the previous pick; the first round takes the row's first element in
  // the order, i.e. everything comes "after" (+inf, -1)
  float prev_v = INFINITY;
  int prev_j = -1;
  for (int t = 0; t < k; ++t) {
    Pick best{-INFINITY, INT_MAX};
    if (live) {
      for (int j = tr; j < C; j += TPR) {
        const float v = x[j];
        if (before(prev_v, prev_j, v, j) && before(v, j, best.v, best.j))
          best = Pick{v, j};
      }
    }
    best = warp_best(best);
    if constexpr (WPR > 1) {
      if (tr % 32 == 0) red[rb][tr / 32] = best;
      __syncthreads();
      best = red[rb][0];
      for (int w = 1; w < WPR; ++w)
        if (before(red[rb][w].v, red[rb][w].j, best.v, best.j))
          best = red[rb][w];
      __syncthreads();                   // red is rewritten next round
    }
    if (tr == 0) {
      pv[rb][t] = best.v;
      pj[rb][t] = best.j;
    }
    prev_v = best.v;
    prev_j = best.j;
  }
  __syncthreads();

  float am = 0.f;
  for (int t = tr; t < k; t += TPR) am = fmaxf(am, fabsf(pv[rb][t]));
  am = warp_max(am);
  if constexpr (WPR > 1) {
    if (tr % 32 == 0) redm[rb][tr / 32] = am;
    __syncthreads();
    am = redm[rb][0];
    for (int w = 1; w < WPR; ++w) am = fmaxf(am, redm[rb][w]);
  }
  if (!live) return;
  const float scale = fmaxf(am / qmax, 1e-12f);
  for (int t = tr; t < k; t += TPR) {
    const float q = fminf(fmaxf(rintf(pv[rb][t] / scale), -qmax), qmax);
    Q[(size_t)row * k + t] = (int8_t)q;
    IDX[(size_t)row * k + t] = pj[rb][t];
  }
  if (tr == 0) SCALE[row] = scale;
}

// the level of v at a row's scale: IEEE division, round half to even
__device__ __forceinline__ float level(float v, float scale, float qmax) {
  return fminf(fmaxf(rintf(v / scale), -qmax), qmax);
}

__device__ __forceinline__ uint8_t nibbles(float lo, float hi, float scale) {
  const int a = (int)level(lo, scale, 7.f), b = (int)level(hi, scale, 7.f);
  return (uint8_t)((a & 0xF) | ((b & 0xF) << 4));
}

// TPR threads per row; VEC: C % 4 == 0 and x 16-byte aligned, so a row is
// read as float4; PACK: int4 nibble pairs (qmax 7) instead of int8 levels
template <int TPR, bool PACK, bool VEC>
__global__ void __launch_bounds__(NT)
quantize_rows_kernel(const float* __restrict__ X, uint8_t* __restrict__ Q,
                     float* __restrict__ SCALE, int R, int C, float qmax) {
  constexpr int RPB = NT / TPR;          // rows per block
  constexpr int WPR = TPR / 32;          // warps per row
  __shared__ float redm[RPB][WPR];
  const int rb = threadIdx.x / TPR, tr = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + rb;
  const bool live = row < R;
  const float* x = X + (size_t)(live ? row : 0) * C;
  const float4* x4 = reinterpret_cast<const float4*>(x);

  float am = 0.f;
  if (live) {
    if constexpr (VEC) {
      for (int j = tr; j < C / 4; j += TPR) {
        const float4 v = x4[j];
        am = fmaxf(am, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
      }
    } else {
      for (int j = tr; j < C; j += TPR) am = fmaxf(am, fabsf(x[j]));
    }
  }
  am = warp_max(am);
  if constexpr (WPR > 1) {               // one row per block: uniform
    if (tr % 32 == 0) redm[rb][tr / 32] = am;
    __syncthreads();
    am = redm[rb][0];
    for (int w = 1; w < WPR; ++w) am = fmaxf(am, redm[rb][w]);
  }
  if (!live) return;
  const float scale = fmaxf(am / qmax, 1e-12f);
  if constexpr (PACK) {
    uint8_t* q = Q + (size_t)row * (C / 2);
    if constexpr (VEC) {
      for (int j = tr; j < C / 4; j += TPR) {
        const float4 v = x4[j];
        reinterpret_cast<uchar2*>(q)[j] =
            make_uchar2(nibbles(v.x, v.y, scale), nibbles(v.z, v.w, scale));
      }
    } else {
      for (int p = tr; p < C / 2; p += TPR)
        q[p] = nibbles(x[2 * p], x[2 * p + 1], scale);
    }
  } else {
    int8_t* q = reinterpret_cast<int8_t*>(Q) + (size_t)row * C;
    if constexpr (VEC) {
      for (int j = tr; j < C / 4; j += TPR) {
        const float4 v = x4[j];
        reinterpret_cast<char4*>(q)[j] = make_char4(
            (signed char)level(v.x, scale, qmax),
            (signed char)level(v.y, scale, qmax),
            (signed char)level(v.z, scale, qmax),
            (signed char)level(v.w, scale, qmax));
      }
    } else {
      for (int j = tr; j < C; j += TPR)
        q[j] = (int8_t)level(x[j], scale, qmax);
    }
  }
  if (tr == 0) SCALE[row] = scale;
}

template <bool PACK>
int launch_quantize(const float* x, uint8_t* q, float* scale, int R, int C,
                    float qmax, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (C <= 2048) {
    const int rpb = NT / 32, grid = (R + rpb - 1) / rpb;
    if (vec)
      quantize_rows_kernel<32, PACK, true><<<grid, NT, 0, s>>>(x, q, scale,
                                                               R, C, qmax);
    else
      quantize_rows_kernel<32, PACK, false><<<grid, NT, 0, s>>>(x, q, scale,
                                                                R, C, qmax);
  } else if (vec) {
    quantize_rows_kernel<NT, PACK, true><<<R, NT, 0, s>>>(x, q, scale, R, C,
                                                          qmax);
  } else {
    quantize_rows_kernel<NT, PACK, false><<<R, NT, 0, s>>>(x, q, scale, R, C,
                                                           qmax);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q int8 (R, C), scale fp32 (R,) from x fp32 (R, C); bits in [2, 8].
int quantize_rows(const float* x, int8_t* q, float* scale, int R, int C,
                  int bits, void* stream) {
  if (R <= 0 || C <= 0 || bits < 2 || bits > 8)
    return (int)cudaErrorInvalidValue;
  return launch_quantize<false>(x, reinterpret_cast<uint8_t*>(q), scale, R,
                                C, (float)((1 << (bits - 1)) - 1), stream);
}

// packed int4 uint8 (R, C/2), scale fp32 (R,) from x fp32 (R, C), C even.
int quantize_pack4(const float* x, uint8_t* q, float* scale, int R, int C,
                   void* stream) {
  if (R <= 0 || C <= 0 || C % 2) return (int)cudaErrorInvalidValue;
  return launch_quantize<true>(x, q, scale, R, C, 7.f, stream);
}

// q int8 (R, k), idx int32 (R, k), scale fp32 (R,) from x fp32 (R, C).
int topk_quantize(const float* x, int8_t* q, int* idx, float* scale, int R,
                  int C, int k, int bits, void* stream) {
  if (R <= 0 || C <= 0 || k < 1 || k > C || k > K_MAX || bits < 2 ||
      bits > 8)
    return (int)cudaErrorInvalidValue;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 2048) {
    const int rpb = NT / 32;
    topk_quantize_kernel<32><<<(R + rpb - 1) / rpb, NT, 0, s>>>(
        x, q, idx, scale, R, C, k, qmax);
  } else {
    topk_quantize_kernel<NT><<<R, NT, 0, s>>>(x, q, idx, scale, R, C, k,
                                              qmax);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
