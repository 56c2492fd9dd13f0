// Flash attention kernels for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   * flash_fwd_kernel  <- _fwd_call / _fwd_kernel: online-softmax attention
//       with causal masking, a sliding window, q_offset and GQA (kv head =
//       bh / G); writes o and the per-row logsumexp lse.
//   * flash_dq_kernel   <- _bwd_call / _dq_kernel: dq = scale·ds·k with
//       p = exp(s − lse) recomputed and ds = p(do·vᵀ − D).
//   * flash_dkv_kernel  <- _bwd_call / _dkv_kernel: dk = scale·dsᵀq and
//       dv = pᵀdo, summed over the G query heads of each kv head.
//   D = rowsum(do∘o) is computed outside the kernels, as in the reference.
//
// Layouts: q, o, do, dq (BH, Sq, D); k, v, dk, dv (BKV, Skv, D); lse and D
// (BH, Sq); all fp32 and contiguous.  NEG_INF = -1e30 marks masked scores
// and lse = m + log(max(l, 1e-30)), exactly as the reference.
//
// What bounds it on this card: at the main path's shapes (BH = 192,
// S = 80, D = 64, causal) every kernel moves a few tens of MB and does a
// few hundred MFLOP, so all three are bound by bytes; the work per block
// is small and launch latency matters as much as either.
//
// The simple design: 256 threads per block, four threads per row.  The
// forward and dq kernels take one block per (bh, 64-row q tile) and loop
// over 32-row kv tiles; the dk/dv kernel takes one block per (kv head,
// 64-row kv tile) and loops over the G query heads times 32-row q tiles,
// so the GQA sum stays in registers and no atomics are needed.  Tiles are
// staged in shared memory with an odd row stride (no bank conflicts); each
// thread computes a quarter of the scores of its row over the full head
// dim, the row statistics are combined with warp shuffles, and each thread
// then owns a quarter of the row's D outputs.  kv tiles that no query of
// the block can reach (causal, window) are skipped.  Rows and columns past
// the ragged edges are masked.  D <= 256 (instantiated for 32, 64, 128
// and 256).  At D = 256 (RecurrentGemma: 10 query heads of 256 over one
// kv head) each thread keeps 64 outputs (dk/dv: 128) in registers, and
// the tiles take 140 KB (fwd), 206 KB (dq) and 214.5 KB (dkv) of shared
// memory: one block per SM.
//
// What a later PR should change: move the two products per tile onto the
// tensor cores (wgmma, bf16 in, fp32 accumulate where the reference
// allows), load tiles with TMA in a ring, and fuse D = rowsum(do∘o) into
// the dq kernel.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;
constexpr int BQ = 64;     // q rows per block (fwd, dq)
constexpr int BKV = 32;    // kv rows per step (fwd, dq)
constexpr int BKV2 = 64;   // kv rows per block (dkv)
constexpr int BQ2 = 32;    // q rows per step (dkv)

__device__ __forceinline__ bool masked(int qpos, int kvpos, int causal,
                                       int window) {
  return (causal && kvpos > qpos) || (window > 0 && kvpos <= qpos - window);
}

// does any (q, kv) pair of a (q tile, kv tile) attend?
__device__ __forceinline__ bool reachable(int q_start, int kv_start, int bq,
                                          int bkv, int causal, int window) {
  bool ok = true;
  if (causal) ok = kv_start <= q_start + bq - 1;
  if (window > 0) ok = ok && (kv_start + bkv - 1 > q_start - window);
  return ok;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [r0, r0 + nrows) of a (S, D) slab into a (nrows, LD) smem tile,
// zero-filled past S and past D
template <int DT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int nrows, int S, int D,
                                          float mul) {
  constexpr int LD = DT + 1;
  for (int e = threadIdx.x; e < nrows * DT; e += NT) {
    const int rr = e / DT, d = e % DT;
    const int gr = r0 + rr;
    dst[rr * LD + d] = (gr < S && d < D) ? src[(size_t)gr * D + d] * mul : 0.f;
  }
}

template <int DT>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int G, int Sq, int Skv, int D,
                 float scale, int causal, int window, int q_offset) {
  constexpr int LD = DT + 1;
  constexpr int DPT = DT / 4;        // output columns per thread
  constexpr int JPT = BKV / 4;       // scores per thread per kv tile
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x LD (already scaled)
  float* Ks = Qs + BQ * LD;          // BKV x LD
  float* Vs = Ks + BKV * LD;         // BKV x LD
  float* Ps = Vs + BKV * LD;         // BQ x (BKV + 1)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)(bh / G) * Skv * D;
  const float* vb = v + (size_t)(bh / G) * Skv * D;
  const int q_start = q0 + q_offset;
  const int qpos = q_start + row;

  load_tile<DT>(Qs, qb, q0, BQ, Sq, D, scale);

  float acc[DPT];
  #pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    if (!reachable(q_start, kv0, BQ, BKV, causal, window)) continue;
    __syncthreads();                 // previous tile fully consumed
    load_tile<DT>(Ks, kb, kv0, BKV, Skv, D, 1.f);
    load_tile<DT>(Vs, vb, kv0, BKV, Skv, D, 1.f);
    __syncthreads();

    float s[JPT];
    float mx = NEG_INF;
    #pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int j = sub + 4 * jj;
      const int kvpos = kv0 + j;
      float dot = 0.f;
      #pragma unroll 8
      for (int d = 0; d < DT; ++d) dot += Qs[row * LD + d] * Ks[j * LD + d];
      if (kvpos >= Skv) dot = -INFINITY;
      else if (masked(qpos, kvpos, causal, window)) dot = NEG_INF;
      s[jj] = dot;
      mx = fmaxf(mx, dot);
    }
    const float m_new = fmaxf(m_i, quad_max(mx));
    float psum = 0.f;
    #pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const float p = expf(s[jj] - m_new);
      Ps[row * (BKV + 1) + sub + 4 * jj] = p;
      psum += p;
    }
    const float alpha = expf(m_i - m_new);
    l_i = l_i * alpha + quad_sum(psum);
    __syncwarp();
    #pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + 4 * i;
      float pv = 0.f;
      #pragma unroll 8
      for (int j = 0; j < BKV; ++j) pv += Ps[row * (BKV + 1) + j] * Vs[j * LD + d];
      acc[i] = acc[i] * alpha + pv;
    }
    m_i = m_new;
  }

  const int gq = q0 + row;
  if (gq < Sq) {
    const float inv_l = 1.f / fmaxf(l_i, 1e-30f);
    float* ob = o + ((size_t)bh * Sq + gq) * D;
    #pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + 4 * i;
      if (d < D) ob[d] = acc[i] * inv_l;
    }
    if (sub == 0) lse[(size_t)bh * Sq + gq] = m_i + logf(fmaxf(l_i, 1e-30f));
  }
}

template <int DT>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                float* __restrict__ dq, int G, int Sq, int Skv, int D,
                float scale, int causal, int window, int q_offset) {
  constexpr int LD = DT + 1;
  constexpr int DPT = DT / 4;
  constexpr int JPT = BKV / 4;
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x LD (scaled)
  float* dOs = Qs + BQ * LD;         // BQ x LD
  float* Ks = dOs + BQ * LD;         // BKV x LD
  float* Vs = Ks + BKV * LD;         // BKV x LD
  float* Ps = Vs + BKV * LD;         // BQ x (BKV + 1): ds

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const size_t qoff = (size_t)bh * Sq * D;
  const float* kb = k + (size_t)(bh / G) * Skv * D;
  const float* vb = v + (size_t)(bh / G) * Skv * D;
  const int q_start = q0 + q_offset;
  const int qpos = q_start + row;
  const int gq = q0 + row;
  const float lse_r = gq < Sq ? lse[(size_t)bh * Sq + gq] : 0.f;
  const float dd_r = gq < Sq ? dd[(size_t)bh * Sq + gq] : 0.f;

  load_tile<DT>(Qs, q + qoff, q0, BQ, Sq, D, scale);
  load_tile<DT>(dOs, dout + qoff, q0, BQ, Sq, D, 1.f);

  float acc[DPT];
  #pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    if (!reachable(q_start, kv0, BQ, BKV, causal, window)) continue;
    __syncthreads();
    load_tile<DT>(Ks, kb, kv0, BKV, Skv, D, 1.f);
    load_tile<DT>(Vs, vb, kv0, BKV, Skv, D, 1.f);
    __syncthreads();

    #pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int j = sub + 4 * jj;
      const int kvpos = kv0 + j;
      float ds = 0.f;
      if (kvpos < Skv && !masked(qpos, kvpos, causal, window)) {
        float sdot = 0.f, dp = 0.f;
        #pragma unroll 8
        for (int d = 0; d < DT; ++d) {
          sdot += Qs[row * LD + d] * Ks[j * LD + d];
          dp += dOs[row * LD + d] * Vs[j * LD + d];
        }
        const float p = expf(sdot - lse_r);
        ds = p * (dp - dd_r);
      }
      Ps[row * (BKV + 1) + j] = ds;
    }
    __syncwarp();
    #pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + 4 * i;
      float a = 0.f;
      #pragma unroll 8
      for (int j = 0; j < BKV; ++j) a += Ps[row * (BKV + 1) + j] * Ks[j * LD + d];
      acc[i] += a;
    }
  }

  if (gq < Sq) {
    float* out = dq + qoff + (size_t)gq * D;
    #pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + 4 * i;
      if (d < D) out[d] = acc[i] * scale;
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 float* __restrict__ dk, float* __restrict__ dv, int G,
                 int Sq, int Skv, int D, float scale, int causal, int window,
                 int q_offset) {
  constexpr int LD = DT + 1;
  constexpr int DPT = DT / 4;
  constexpr int IPT = BQ2 / 4;       // q rows per thread per step
  extern __shared__ float smem[];
  float* Ks = smem;                  // BKV2 x LD
  float* Vs = Ks + BKV2 * LD;        // BKV2 x LD
  float* Qs = Vs + BKV2 * LD;        // BQ2 x LD (unscaled)
  float* dOs = Qs + BQ2 * LD;        // BQ2 x LD
  float* Ps = dOs + BQ2 * LD;        // BKV2 x (BQ2 + 1): p
  float* DSs = Ps + BKV2 * (BQ2 + 1);  // BKV2 x (BQ2 + 1): ds
  float* lses = DSs + BKV2 * (BQ2 + 1);  // BQ2
  float* dds = lses + BQ2;           // BQ2

  const int b = blockIdx.y;          // kv head
  const int kv0 = blockIdx.x * BKV2;
  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int kvpos = kv0 + row;
  const size_t kvoff = (size_t)b * Skv * D;

  load_tile<DT>(Ks, k + kvoff, kv0, BKV2, Skv, D, 1.f);
  load_tile<DT>(Vs, v + kvoff, kv0, BKV2, Skv, D, 1.f);

  float acck[DPT], accv[DPT];
  #pragma unroll
  for (int i = 0; i < DPT; ++i) { acck[i] = 0.f; accv[i] = 0.f; }

  for (int g = 0; g < G; ++g) {
    const int bh = b * G + g;
    const size_t qoff = (size_t)bh * Sq * D;
    for (int qt0 = 0; qt0 < Sq; qt0 += BQ2) {
      const int q_start = qt0 + q_offset;
      if (!reachable(q_start, kv0, BQ2, BKV2, causal, window)) continue;
      __syncthreads();
      load_tile<DT>(Qs, q + qoff, qt0, BQ2, Sq, D, 1.f);
      load_tile<DT>(dOs, dout + qoff, qt0, BQ2, Sq, D, 1.f);
      if (threadIdx.x < BQ2) {
        const int gq = qt0 + threadIdx.x;
        lses[threadIdx.x] = gq < Sq ? lse[(size_t)bh * Sq + gq] : 0.f;
        dds[threadIdx.x] = gq < Sq ? dd[(size_t)bh * Sq + gq] : 0.f;
      }
      __syncthreads();

      #pragma unroll
      for (int ii = 0; ii < IPT; ++ii) {
        const int i = sub + 4 * ii;
        const int qpos = q_start + i;
        float p = 0.f, ds = 0.f;
        if (qt0 + i < Sq && kvpos < Skv &&
            !masked(qpos, kvpos, causal, window)) {
          float sdot = 0.f, dp = 0.f;
          #pragma unroll 8
          for (int d = 0; d < DT; ++d) {
            sdot += (Qs[i * LD + d] * scale) * Ks[row * LD + d];
            dp += dOs[i * LD + d] * Vs[row * LD + d];
          }
          p = expf(sdot - lses[i]);
          ds = p * (dp - dds[i]);
        }
        Ps[row * (BQ2 + 1) + i] = p;
        DSs[row * (BQ2 + 1) + i] = ds;
      }
      __syncwarp();
      #pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = sub + 4 * c;
        float av = 0.f, ak = 0.f;
        #pragma unroll 8
        for (int i = 0; i < BQ2; ++i) {
          av += Ps[row * (BQ2 + 1) + i] * dOs[i * LD + d];
          ak += DSs[row * (BQ2 + 1) + i] * Qs[i * LD + d];
        }
        accv[c] += av;
        acck[c] += ak;
      }
    }
  }

  if (kvpos < Skv) {
    float* dkb = dk + kvoff + (size_t)kvpos * D;
    float* dvb = dv + kvoff + (size_t)kvpos * D;
    #pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + 4 * c;
      if (d < D) {
        dkb[d] = acck[c] * scale;
        dvb[d] = accv[c];
      }
    }
  }
}

template <int DT> constexpr size_t fwd_smem() {
  return sizeof(float) * ((BQ + 2 * BKV) * (DT + 1) + BQ * (BKV + 1));
}
template <int DT> constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BKV) * (DT + 1) + BQ * (BKV + 1));
}
template <int DT> constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * BKV2 + 2 * BQ2) * (DT + 1) +
                          2 * BKV2 * (BQ2 + 1) + 2 * BQ2);
}

// Kernels above 48 KB of dynamic shared memory must opt in once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DT>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int BH, int G, int Sq, int Skv, int D, float scale,
               int causal, int window, int q_offset, cudaStream_t s) {
  const size_t smem = fwd_smem<DT>();
  cudaError_t err = allow_smem(flash_fwd_kernel<DT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<DT><<<grid, NT, smem, s>>>(q, k, v, o, lse, G, Sq, Skv, D,
                                              scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* dd, float* dq,
              int BH, int G, int Sq, int Skv, int D, float scale, int causal,
              int window, int q_offset, cudaStream_t s) {
  const size_t smem = dq_smem<DT>();
  cudaError_t err = allow_smem(flash_dq_kernel<DT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_dq_kernel<DT><<<grid, NT, smem, s>>>(q, k, v, dout, lse, dd, dq, G, Sq,
                                             Skv, D, scale, causal, window,
                                             q_offset);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* dd,
               float* dk, float* dv, int BKVH, int G, int Sq, int Skv, int D,
               float scale, int causal, int window, int q_offset,
               cudaStream_t s) {
  const size_t smem = dkv_smem<DT>();
  cudaError_t err = allow_smem(flash_dkv_kernel<DT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Skv + BKV2 - 1) / BKV2, BKVH);
  flash_dkv_kernel<DT><<<grid, NT, smem, s>>>(q, k, v, dout, lse, dd, dk, dv,
                                              G, Sq, Skv, D, scale, causal,
                                              window, q_offset);
  return (int)cudaGetLastError();
}

bool valid(int BH, int BKVH, int Sq, int Skv, int D) {
  return BH > 0 && BKVH > 0 && BH % BKVH == 0 && Sq > 0 && Skv > 0 && D > 0 &&
         D <= 256;
}

}  // namespace

extern "C" {

int flash_fwd(const float* q, const float* k, const float* v, float* o,
              float* lse, int BH, int BKVH, int Sq, int Skv, int D,
              float scale, int causal, int window, int q_offset,
              void* stream) {
  if (!valid(BH, BKVH, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const int G = BH / BKVH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_fwd<32>(q, k, v, o, lse, BH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 64)
    return launch_fwd<64>(q, k, v, o, lse, BH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 128)
    return launch_fwd<128>(q, k, v, o, lse, BH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  return launch_fwd<256>(q, k, v, o, lse, BH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
}

int flash_dq(const float* q, const float* k, const float* v,
             const float* dout, const float* lse, const float* dd, float* dq,
             int BH, int BKVH, int Sq, int Skv, int D, float scale,
             int causal, int window, int q_offset, void* stream) {
  if (!valid(BH, BKVH, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const int G = BH / BKVH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dq<32>(q, k, v, dout, lse, dd, dq, BH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 64)
    return launch_dq<64>(q, k, v, dout, lse, dd, dq, BH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 128)
    return launch_dq<128>(q, k, v, dout, lse, dd, dq, BH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  return launch_dq<256>(q, k, v, dout, lse, dd, dq, BH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
}

int flash_dkv(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* dd,
              float* dk, float* dv, int BH, int BKVH, int Sq, int Skv, int D,
              float scale, int causal, int window, int q_offset,
              void* stream) {
  if (!valid(BH, BKVH, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const int G = BH / BKVH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dkv<32>(q, k, v, dout, lse, dd, dk, dv, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, dd, dk, dv, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 128)
    return launch_dkv<128>(q, k, v, dout, lse, dd, dk, dv, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  return launch_dkv<256>(q, k, v, dout, lse, dd, dk, dv, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
}

}  // extern "C"
