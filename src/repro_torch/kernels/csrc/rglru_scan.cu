// RG-LRU linear recurrence kernels for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel of src/repro/kernels/rglru_scan.py (rglru_scan,
// row 15), the temporal loop of RecurrentGemma's recurrent block:
//   * rglru_scan_fwd_kernel: h_t = a_t * h_{t-1} + b_t over t = 0 .. S-1
//       from h_{-1} = h0 (zeros when h0 is null); writes every h_t and
//       h_final = h_{S-1}.
//   * rglru_scan_bwd_kernel: its gradient, the same recurrence run
//       backward in time.  With c the gradient that reaches h_t from later
//       steps (c = dh_final, or 0, before the last step):
//         g_t = dh_t + c,  c = a_t * g_t,  db_t = g_t,  da_t = g_t * h_{t-1}
//       and dh0 = c after step 0 (written only when dh0 is not null).
//       The reference differentiates lax.associative_scan through XLA;
//       this is the port's form of that same gradient.
//
// Layouts: a, b, h, dh, da, db (B, S, W); h0, h_final, dh_final, dh0
// (B, W); all fp32 and contiguous, channel fastest.
//
// Rounding: every update is __fmul_rn then __fadd_rn, so nvcc cannot
// contract it into an FMA, and the plain PyTorch versions (kernels/ref.py
// rglru_scan / rglru_scan_bwd: one multiply, then one add) give the same
// bits.
//
// What bounds it on this card: bytes.  The forward reads a and b and
// writes h (3·B·S·W·4 bytes: 39.3 MB, 11.7 us at 3.35 TB/s at the
// training shape (16, 80, 2560)); the backward reads dh, a and h and
// writes da and db (65.5 MB, 19.6 us).  Per element it does 2 (forward)
// or 3 (backward) flops for 12 or 20 bytes moved: far below the fp32
// rate.
//
// The simple design: one thread per (b, channel), or per four channels
// with 16-byte loads where W % 4 == 0 and every row is 16-byte aligned;
// the time loop is sequential with the state in registers.  Since a_t and
// b_t do not depend on h, each thread issues the loads of CH = 8 steps
// together before it runs their updates, so eight steps' latencies
// overlap.  At (16, 80, 2560) that is only 10,240 threads (80 blocks of
// 128 on 132 SMs): occupancy is low, and the 80 steps' dependent chain of
// load batches sets the time.  A later PR can split the time axis into
// chunks scanned in parallel (the associative form the reference uses on
// the TPU) and stage them through shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;   // threads per block
constexpr int CH = 8;     // time steps whose loads are issued together

template <int V>
__device__ __forceinline__ void load(float (&dst)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
    dst[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&src)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  } else {
    *p = src[0];
  }
}

template <int V>
__device__ __forceinline__ void zero(float (&dst)[V]) {
  #pragma unroll
  for (int k = 0; k < V; ++k) dst[k] = 0.f;
}

template <int V>
__global__ void __launch_bounds__(NT)
rglru_scan_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      float* __restrict__ hf, int B, int S, int W) {
  const int lanes = W / V;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= (long long)B * lanes) return;
  const int bi = (int)(idx / lanes);
  const int w = (int)(idx % lanes) * V;
  const size_t row = (size_t)bi * S * W + w;

  float hv[V];
  if (h0 != nullptr) load<V>(hv, h0 + (size_t)bi * W + w);
  else zero<V>(hv);

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int n = min(CH, S - t0);
    float av[CH][V], bv[CH][V];
    #pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < n) {
        const size_t off = row + (size_t)(t0 + j) * W;
        load<V>(av[j], a + off);
        load<V>(bv[j], b + off);
      }
    }
    #pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < n) {
        #pragma unroll
        for (int k = 0; k < V; ++k)
          hv[k] = __fadd_rn(__fmul_rn(av[j][k], hv[k]), bv[j][k]);
        store<V>(h + row + (size_t)(t0 + j) * W, hv);
      }
    }
  }
  store<V>(hf + (size_t)bi * W + w, hv);
}

template <int V>
__global__ void __launch_bounds__(NT)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ h0,
                      const float* __restrict__ dh,
                      const float* __restrict__ dhf, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ dh0, int B,
                      int S, int W) {
  const int lanes = W / V;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= (long long)B * lanes) return;
  const int bi = (int)(idx / lanes);
  const int w = (int)(idx % lanes) * V;
  const size_t row = (size_t)bi * S * W + w;
  const size_t state = (size_t)bi * W + w;

  float c[V];
  if (dhf != nullptr) load<V>(c, dhf + state);
  else zero<V>(c);

  for (int t1 = S; t1 > 0; t1 -= CH) {          // steps [t1 - n, t1)
    const int n = min(CH, t1);
    const int t0 = t1 - n;
    float av[CH][V], dv[CH][V], hp[CH][V];
    #pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < n) {
        const int t = t0 + j;
        const size_t off = row + (size_t)t * W;
        load<V>(av[j], a + off);
        load<V>(dv[j], dh + off);
        if (t > 0) load<V>(hp[j], h + off - W);
        else if (h0 != nullptr) load<V>(hp[j], h0 + state);
        else zero<V>(hp[j]);
      }
    }
    #pragma unroll
    for (int j = CH - 1; j >= 0; --j) {
      if (j < n) {
        float g[V], dav[V];
        #pragma unroll
        for (int k = 0; k < V; ++k) {
          g[k] = __fadd_rn(dv[j][k], c[k]);
          c[k] = __fmul_rn(av[j][k], g[k]);
          dav[k] = __fmul_rn(g[k], hp[j][k]);
        }
        const size_t off = row + (size_t)(t0 + j) * W;
        store<V>(db + off, g);
        store<V>(da + off, dav);
      }
    }
  }
  if (dh0 != nullptr) store<V>(dh0 + state, c);
}

unsigned blocks(int B, int W, int V) {
  const long long threads = (long long)B * (W / V);
  return (unsigned)((threads + NT - 1) / NT);
}

bool valid(int B, int S, int W, int vec) {
  return B > 0 && S > 0 && W > 0 && (!vec || W % 4 == 0);
}

}  // namespace

extern "C" {

// vec: 1 when W % 4 == 0 and every tensor is 16-byte aligned (float4 path)
int rglru_fwd(const float* a, const float* b, const float* h0, float* h,
              float* hf, int B, int S, int W, int vec, void* stream) {
  if (!valid(B, S, W, vec)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    rglru_scan_fwd_kernel<4><<<blocks(B, W, 4), NT, 0, s>>>(a, b, h0, h, hf,
                                                            B, S, W);
  else
    rglru_scan_fwd_kernel<1><<<blocks(B, W, 1), NT, 0, s>>>(a, b, h0, h, hf,
                                                            B, S, W);
  return (int)cudaGetLastError();
}

int rglru_bwd(const float* a, const float* h, const float* h0,
              const float* dh, const float* dhf, float* da, float* db,
              float* dh0, int B, int S, int W, int vec, void* stream) {
  if (!valid(B, S, W, vec)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    rglru_scan_bwd_kernel<4><<<blocks(B, W, 4), NT, 0, s>>>(
        a, h, h0, dh, dhf, da, db, dh0, B, S, W);
  else
    rglru_scan_bwd_kernel<1><<<blocks(B, W, 1), NT, 0, s>>>(
        a, h, h0, dh, dhf, da, db, dh0, B, S, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
