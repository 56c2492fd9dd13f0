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
//   * quant_roundtrip_kernel <- quantize_rows and its dequantization, as
//       the reference's compression.quant_roundtrip runs them (the Split
//       boundary's straight-through quantizer, activations up and
//       gradients down): y = float(q) * scale of row 10's levels, written
//       in fp32 in the same pass (no levels in memory), and the scale
//       where asked.
//   * topk_quantize_kernel (C <= 2048) and topk_radix_kernel (longer
//       rows) <- topk_quantize_rows / _topk_kernel (row 12): per row, the
//       k largest values (ties to the lower index, the order of
//       lax.top_k), then the same quantization over those k.  Outputs
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
// The roundtrip reads x once and writes y once, 8 bytes an element: 7.9
// MB at (1280, 768), 0.0023 ms at 3.35 TB/s, where row 10 followed by
// the dequantization (q.float(), then * scale) moves about 18 bytes an
// element in three launches.  Each thread holds its share of the row in
// registers between the absmax and the levels: four warps a row up to C
// 1024 (8 floats a thread: at C 768 one or two float4), one 256-thread
// block a row above (16 floats a thread, so up to C 4096; a longer row's
// rest is read again from L1/L2).  A row is one link of a chain (load,
// reduce, levels, store), so what sets the time is how many threads
// share a row: on an H100 (80GB HBM3, 700 W) at (1280, 768), in a CUDA
// graph with its outputs rewritten in place, one warp a row took 0.0041
// ms, 2, 4 and 8 warps 0.0036, 0.0032 and 0.0034.
//
// Top-k: the data is read once in principle (R*C*4 bytes in, R*k*5 +
// R*4 out): 39 KB at the KD path's (150, 77), 257 MB (0.077 ms) at
// (1280, 50257).  Rows of C <= 2048 (the KD path's) take one warp a row,
// which makes k passes over its row, k*C compares from L1: round t takes
// the maximum, in the order (value descending, index ascending), among
// the elements that come strictly after pick t-1 in that order, so the
// row needs no writable copy.  Longer rows (a generative vocabulary)
// take topk_radix_kernel, one block of 1024 threads a row, which reads
// the row once: each value becomes an order-preserving 32-bit key (-0.0
// and +0.0 one key, as they are equal in the order; every NaN the
// largest key), staged in shared
// memory where the row fits (C <= ~52900: 201 KB at C = 50257, one block
// an SM; a longer row is read again from device memory each pass); a
// histogram of the top 12 bits is counted while the row is staged, then
// two of 10 bits among the keys of the chosen prefix, so three passes
// give the k-th key T; every key above T is picked, then the first
// (k - above) keys equal to T in index order (each thread scans a
// contiguous share of the row, shares ordered by a block-wide prefix
// sum); a bitonic sort puts the k picks in the order (value descending,
// index ascending).  The order of the picks is that of a stable
// descending sort for every row, -inf and -1e30 included: the reference's
// "first argmax, then overwrite it with -1e30" agrees for every row with
// no entry <= -1e30.
//
// Every quantization uses IEEE division and rintf (no fast math, no
// reciprocal), so q, idx and scale are bit-identical to the plain
// PyTorch versions (kernels/ref.py); the roundtrip's product is one
// __fmul_rn of the level, turned into an integer and back as the twin's
// int8 is (so -0 becomes +0), and the scale: y is bit-identical too.
// Non-finite rows keep what the twins keep: the absmax, the scale's clamp
// and the level's clamp carry a NaN through (nanmax below, where fmaxf
// would drop it), so a row holding a NaN gets a NaN scale and dequantizes
// to NaN, a row holding +-inf an inf scale; a NaN level becomes the
// integer 0.  The top-k order ranks every NaN above +inf, NaNs in index
// order, as torch.sort does.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int K_MAX = 512;       // largest k

struct Pick {
  uint32_t key;
  int j;
};

// the larger and the smaller of a and b, NaN where either is NaN (fmaxf
// and fminf drop a NaN operand; torch.amax, clamp_min and clamp keep it):
// one max.NaN / min.NaN instruction each (sm_80 and later)
__device__ __forceinline__ float nanmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nanmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// an order-preserving key: a > b as floats iff key(a) > key(b) as
// unsigned, with -0.0 taken as +0.0 (the two are equal in the order) and
// every NaN one key above +inf (torch.sort ranks NaN above +inf, NaNs
// equal to each other); no float maps to key 0
__device__ __forceinline__ uint32_t fkey(float x) {
  if (x != x) return 0xFFFFFFFFu;
  const uint32_t u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fval(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// a comes before b in the order (key descending, index ascending)
__device__ __forceinline__ bool before(uint32_t ak, int aj, uint32_t bk,
                                       int bj) {
  return ak > bk || (ak == bk && aj < bj);
}

// a row's scale: absmax / qmax by IEEE division, at least 1e-12; NaN
// where the absmax is NaN
__device__ __forceinline__ float row_scale(float am, float qmax) {
  return nanmax(am / qmax, 1e-12f);
}

// the level of v at a row's scale: IEEE division, round half to even,
// clamped to [-qmax, qmax]; a NaN quotient stays NaN, as torch.clamp keeps
// it (it becomes the integer 0)
__device__ __forceinline__ float level(float v, float scale, float qmax) {
  return nanmin(nanmax(rintf(v / scale), -qmax), qmax);
}

__device__ __forceinline__ Pick warp_best(Pick p) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint32_t ok = __shfl_xor_sync(0xffffffffu, p.key, off);
    const int oj = __shfl_xor_sync(0xffffffffu, p.j, off);
    if (before(ok, oj, p.key, p.j)) p = Pick{ok, oj};
  }
  return p;
}

__device__ __forceinline__ float warp_max(float v) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// one row a warp (C <= 2048)
__global__ void __launch_bounds__(NT)
topk_quantize_kernel(const float* __restrict__ X, int8_t* __restrict__ Q,
                     int* __restrict__ IDX, float* __restrict__ SCALE, int R,
                     int C, int k, float qmax) {
  constexpr int RPB = NT / 32;           // rows per block
  __shared__ float pv[RPB][K_MAX];
  __shared__ int pj[RPB][K_MAX];
  const int rb = threadIdx.x / 32, tr = threadIdx.x % 32;
  const int row = blockIdx.x * RPB + rb;
  const bool live = row < R;
  const float* x = X + (size_t)(live ? row : 0) * C;

  // the previous pick; the first round takes the row's first element in
  // the order, i.e. everything comes "after" (the largest key, -1); the
  // picks compare by key (NaN above +inf), and keep their values
  uint32_t prev_k = 0xFFFFFFFFu;
  int prev_j = -1;
  for (int t = 0; t < k; ++t) {
    Pick best{0u, INT_MAX};
    float best_v = 0.f;
    if (live) {
      for (int j = tr; j < C; j += 32) {
        const float v = x[j];
        const uint32_t key = fkey(v);
        if (before(prev_k, prev_j, key, j) && before(key, j, best.key,
                                                     best.j)) {
          best = Pick{key, j};
          best_v = v;
        }
      }
    }
    // the lane whose own best won stores it (its j is unique in the warp)
    const Pick win = warp_best(best);
    if (live && win.j == best.j) {
      pv[rb][t] = best_v;
      pj[rb][t] = best.j;
    }
    prev_k = win.key;
    prev_j = win.j;
  }
  __syncwarp();

  float am = 0.f;
  for (int t = tr; t < k; t += 32) am = nanmax(am, fabsf(pv[rb][t]));
  am = warp_max(am);
  if (!live) return;
  const float scale = row_scale(am, qmax);
  for (int t = tr; t < k; t += 32) {
    const float q = level(pv[rb][t], scale, qmax);
    Q[(size_t)row * k + t] = (int8_t)(int)q;
    IDX[(size_t)row * k + t] = pj[rb][t];
  }
  if (tr == 0) SCALE[row] = scale;
}

// ---- top-k of long rows (C > 2048) by radix selection, one block a row ----
constexpr int RNT = 1024;            // threads a block
constexpr int HIST = 4096;           // bins of the first digit (12 bits)
// dynamic shared memory beside the staged row: at most 227 KB a block
constexpr int SMEM_MAX = 232448;

// inclusive prefix sum of v over the block in thread order; *total gets
// the block's sum; ws holds RNT / 32 ints.  Ends with a barrier.
__device__ __forceinline__ int block_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  #pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = ws[lane];
    #pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    ws[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += ws[warp - 1];
  *total = ws[RNT / 32 - 1];
  __syncthreads();
  return v;
}

// the bin b of hist[0, nbins) (bins in key order) holding the need-th
// largest counted key: above = the count in bins above b, above < need <=
// above + hist[b].  Every thread gets both.
__device__ __forceinline__ void find_bin(const int* hist, int nbins,
                                         int need, int* ws, int* res,
                                         int* bin, int* above) {
  const int per = nbins / RNT, b0 = threadIdx.x * per;
  int s = 0;
  for (int i = 0; i < per; ++i) s += hist[b0 + i];
  int total;
  const int incl = block_scan(s, ws, &total);
  int a = total - incl;                  // counted in the bins above b0's
  if (a < need && need <= a + s) {
    for (int i = per - 1; i >= 0; --i) {
      const int c = hist[b0 + i];
      if (a + c >= need) {
        res[0] = b0 + i;
        res[1] = a;
        break;
      }
      a += c;
    }
  }
  __syncthreads();
  *bin = res[0];
  *above = res[1];
  __syncthreads();                       // hist and res are reused next
}

// STAGED: the row's keys are kept in dynamic shared memory (C * 4 bytes
// beside the static arrays); else each pass reads the row again from
// device memory (rows too long to stage)
template <bool STAGED>
__global__ void __launch_bounds__(RNT, 1)
topk_radix_kernel(const float* __restrict__ X, int8_t* __restrict__ Q,
                  int* __restrict__ IDX, float* __restrict__ SCALE, int C,
                  int k, float qmax) {
  extern __shared__ uint32_t keys[];
  __shared__ int hist[HIST];
  __shared__ uint32_t skey[K_MAX];
  __shared__ int sidx[K_MAX];
  __shared__ int ws[RNT / 32], res[2];
  __shared__ float redm[RNT / 32];
  const int tid = threadIdx.x, row = blockIdx.x;
  const float* x = X + (size_t)row * C;
  auto key_at = [&](int j) { return STAGED ? keys[j] : fkey(__ldg(x + j)); };

  // digit 1 (key bits 31..20), counted while the row is staged
  for (int i = tid; i < HIST; i += RNT) hist[i] = 0;
  __syncthreads();
  {
    constexpr int U = 8;                 // loads in flight a thread
    int j = tid;
    for (; j + (U - 1) * RNT < C; j += U * RNT) {
      float v[U];
      #pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldg(x + j + u * RNT);
      #pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t key = fkey(v[u]);
        if (STAGED) keys[j + u * RNT] = key;
        atomicAdd(&hist[key >> 20], 1);
      }
    }
    for (; j < C; j += RNT) {
      const uint32_t key = fkey(__ldg(x + j));
      if (STAGED) keys[j] = key;
      atomicAdd(&hist[key >> 20], 1);
    }
  }
  __syncthreads();
  int bin, a, above;
  find_bin(hist, HIST, k, ws, res, &bin, &above);
  uint32_t prefix = (uint32_t)bin;
  int need = k - above;
  // digits 2 and 3 (bits 19..10, 9..0) among the keys of the prefix
  #pragma unroll 1
  for (int shift = 10; shift >= 0; shift -= 10) {
    for (int i = tid; i < 1024; i += RNT) hist[i] = 0;
    __syncthreads();
    for (int j = tid; j < C; j += RNT) {
      const uint32_t key = key_at(j);
      if ((key >> (shift + 10)) == prefix)
        atomicAdd(&hist[(key >> shift) & 1023u], 1);
    }
    __syncthreads();
    find_bin(hist, 1024, need, ws, res, &bin, &a);
    prefix = (prefix << 10) | (uint32_t)bin;
    need -= a;
    above += a;
  }
  // the threshold key T = prefix: every key above it is picked (above of
  // them), then the first `need` keys equal to it in index order; each
  // thread takes a contiguous share of the row, so shares scan in index
  // order
  const uint32_t T = prefix;
  const int share = (C + RNT - 1) / RNT;
  const int j0 = min(C, tid * share), j1 = min(C, j0 + share);
  int gt = 0, eq = 0;
  for (int j = j0; j < j1; ++j) {
    const uint32_t key = key_at(j);
    gt += key > T;
    eq += key == T;
  }
  int total;
  int pg = block_scan(gt, ws, &total) - gt;
  int pe = block_scan(eq, ws, &total) - eq;
  for (int j = j0; j < j1 && (gt > 0 || pe < need); ++j) {
    const uint32_t key = key_at(j);
    if (key > T) {
      skey[pg] = key;
      sidx[pg++] = j;
      --gt;
    } else if (key == T) {
      if (pe < need) {
        skey[above + pe] = key;
        sidx[above + pe] = j;
      }
      ++pe;
    }
  }
  // sort the k picks by (value descending, index ascending): bitonic over
  // the next power of two, padded with picks that sort last
  int P = 1;
  while (P < k) P <<= 1;
  for (int i = k + tid; i < P; i += RNT) {
    skey[i] = 0u;
    sidx[i] = INT_MAX;
  }
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = tid; t < P / 2; t += RNT) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const uint32_t ki = skey[i], kj = skey[j];
        const int ii = sidx[i], ij = sidx[j];
        const bool j_first = kj > ki || (kj == ki && ij < ii);
        if (j_first == ((i & size) == 0)) {
          skey[i] = kj; skey[j] = ki;
          sidx[i] = ij; sidx[j] = ii;
        }
      }
    }
  }
  __syncthreads();
  float am = 0.f;
  for (int t = tid; t < k; t += RNT) am = nanmax(am, fabsf(fval(skey[t])));
  am = warp_max(am);
  if ((tid & 31) == 0) redm[tid >> 5] = am;
  __syncthreads();
  am = redm[0];
  for (int w = 1; w < RNT / 32; ++w) am = nanmax(am, redm[w]);
  const float scale = row_scale(am, qmax);
  for (int t = tid; t < k; t += RNT) {
    const float q = level(fval(skey[t]), scale, qmax);
    Q[(size_t)row * k + t] = (int8_t)(int)q;
    IDX[(size_t)row * k + t] = sidx[t];
  }
  if (tid == 0) SCALE[row] = scale;
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
        am = nanmax(am, nanmax(nanmax(fabsf(v.x), fabsf(v.y)),
                               nanmax(fabsf(v.z), fabsf(v.w))));
      }
    } else {
      for (int j = tr; j < C; j += TPR) am = nanmax(am, fabsf(x[j]));
    }
  }
  am = warp_max(am);
  if constexpr (WPR > 1) {               // one row per block: uniform
    if (tr % 32 == 0) redm[rb][tr / 32] = am;
    __syncthreads();
    am = redm[rb][0];
    for (int w = 1; w < WPR; ++w) am = nanmax(am, redm[rb][w]);
  }
  if (!live) return;
  const float scale = row_scale(am, qmax);
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
            (signed char)(int)level(v.x, scale, qmax),
            (signed char)(int)level(v.y, scale, qmax),
            (signed char)(int)level(v.z, scale, qmax),
            (signed char)(int)level(v.w, scale, qmax));
      }
    } else {
      for (int j = tr; j < C; j += TPR)
        q[j] = (int8_t)(int)level(x[j], scale, qmax);
    }
  }
  if (tr == 0) SCALE[row] = scale;
}

// the roundtrip value of v: its level, through an integer as the twin's
// int8 (so a level of -0 is +0), times the scale, rounded once
__device__ __forceinline__ float roundtrip(float v, float scale, float qmax) {
  return __fmul_rn((float)(int)level(v, scale, qmax), scale);
}

__device__ __forceinline__ float4 roundtrip(float4 v, float scale,
                                            float qmax) {
  return make_float4(roundtrip(v.x, scale, qmax), roundtrip(v.y, scale, qmax),
                     roundtrip(v.z, scale, qmax), roundtrip(v.w, scale, qmax));
}

__device__ __forceinline__ float absmax(float v) { return fabsf(v); }

__device__ __forceinline__ float absmax(float4 v) {
  return nanmax(nanmax(fabsf(v.x), fabsf(v.y)),
                nanmax(fabsf(v.z), fabsf(v.w)));
}

// TPR threads a row, each holding PER floats of it in registers (PER / 4
// float4 where VEC: C % 4 == 0, x and y 16-byte aligned); the elements a
// thread holds are j = tr + TPR·h (in float4 where VEC), those past them
// are read again for the levels.  SCALE may be null.
template <int TPR, int PER, bool VEC>
__global__ void __launch_bounds__(NT)
quant_roundtrip_kernel(const float* __restrict__ X, float* __restrict__ Y,
                       float* __restrict__ SCALE, int R, int C, float qmax) {
  using T = std::conditional_t<VEC, float4, float>;
  constexpr int RPB = NT / TPR;          // rows per block
  constexpr int WPR = TPR / 32;          // warps per row
  constexpr int NH = VEC ? PER / 4 : PER;   // loads a thread holds
  __shared__ float redm[RPB][WPR];
  const int rb = threadIdx.x / TPR, tr = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + rb;
  const bool live = row < R;
  const size_t off = (size_t)(live ? row : 0) * C;
  const T* x = reinterpret_cast<const T*>(X + off);
  T* y = reinterpret_cast<T*>(Y + off);
  const int n = VEC ? C / 4 : C;         // loads a row

  T v[NH] = {};                          // zeroed: no instance spills
  float am = 0.f;
  #pragma unroll
  for (int h = 0; h < NH; ++h) {
    const int j = tr + h * TPR;
    if (live && j < n) {
      v[h] = x[j];
      am = nanmax(am, absmax(v[h]));
    }
  }
  if (live)
    for (int j = tr + NH * TPR; j < n; j += TPR) am = nanmax(am, absmax(x[j]));
  am = warp_max(am);
  if constexpr (WPR > 1) {               // every thread reaches it
    if (tr % 32 == 0) redm[rb][tr / 32] = am;
    __syncthreads();
    am = redm[rb][0];
    for (int w = 1; w < WPR; ++w) am = nanmax(am, redm[rb][w]);
  }
  if (!live) return;
  const float scale = row_scale(am, qmax);
  #pragma unroll
  for (int h = 0; h < NH; ++h) {
    const int j = tr + h * TPR;
    if (j < n) y[j] = roundtrip(v[h], scale, qmax);
  }
  for (int j = tr + NH * TPR; j < n; j += TPR)
    y[j] = roundtrip(x[j], scale, qmax);
  if (SCALE != nullptr && tr == 0) SCALE[row] = scale;
}

// rows up to RT_WARP_MAX take RT_TPR threads, each holding RT_PER floats;
// longer ones a block of NT threads, each holding 16 (up to C 4096)
constexpr int RT_TPR = 128;
constexpr int RT_PER = 8;
constexpr int RT_WARP_MAX = RT_TPR * RT_PER;

template <int TPR, int PER>
void launch_roundtrip(bool vec, const float* x, float* y, float* scale, int R,
                      int C, float qmax, cudaStream_t s) {
  const int grid = (R + NT / TPR - 1) / (NT / TPR);
  if (vec)
    quant_roundtrip_kernel<TPR, PER, true><<<grid, NT, 0, s>>>(x, y, scale,
                                                               R, C, qmax);
  else
    quant_roundtrip_kernel<TPR, PER, false><<<grid, NT, 0, s>>>(x, y, scale,
                                                                R, C, qmax);
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

// y fp32 (R, C), each row's levels (quantize_rows') times its scale, and
// the scale fp32 (R,) where `scale` is not null, from x fp32 (R, C); bits
// in [2, 8].  One launch; no levels are written.
int quant_roundtrip_rows(const float* x, float* y, float* scale, int R, int C,
                         int bits, void* stream) {
  if (R <= 0 || C <= 0 || bits < 2 || bits > 8)
    return (int)cudaErrorInvalidValue;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (C <= RT_WARP_MAX)
    launch_roundtrip<RT_TPR, RT_PER>(vec, x, y, scale, R, C, qmax, s);
  else
    launch_roundtrip<NT, 16>(vec, x, y, scale, R, C, qmax, s);
  return (int)cudaGetLastError();
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
    topk_quantize_kernel<<<(R + rpb - 1) / rpb, NT, 0, s>>>(
        x, q, idx, scale, R, C, k, qmax);
    return (int)cudaGetLastError();
  }
  // the row staged where it fits beside the kernel's static arrays; the
  // dynamic shared memory that takes (above 48 KB) is allowed once a
  // device (the attribute belongs to the device), one bit of `ready` a
  // device
  static std::atomic<int> fixed{-1};
  static std::atomic<uint64_t> ready{0};
  cudaError_t err;
  if (fixed.load() < 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, topk_radix_kernel<true>);
    if (err != cudaSuccess) return (int)err;
    fixed.store((int)attr.sharedSizeBytes);
  }
  const size_t limit = (size_t)(SMEM_MAX - fixed.load());
  const size_t staged = (size_t)C * sizeof(uint32_t);
  if (staged <= limit) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (!(ready.load() & bit)) {
      err = cudaFuncSetAttribute(topk_radix_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)limit);
      if (err != cudaSuccess) return (int)err;
      ready.fetch_or(bit);
    }
    topk_radix_kernel<true><<<R, RNT, staged, s>>>(x, q, idx, scale, C, k,
                                                   qmax);
  } else {
    topk_radix_kernel<false><<<R, RNT, 0, s>>>(x, q, idx, scale, C, k,
                                               qmax);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
