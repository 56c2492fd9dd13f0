// KD distillation loss kernels for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of src/repro/kernels/kd_loss.py:
//   * kd_fwd  <- _fwd_call / _fwd_kernel: per row of the (R, V) teacher
//       and student logits, KL(softmax(t/T) || softmax(s/T)) * T^2 and the
//       five row statistics the backward needs,
//         m_t, z_t   max and sum of exp(t/T - m_t)   (teacher logsumexp)
//         m_s, z_s   the same for the student
//         u          sum of exp(t/T - m_t) * ((t/T - m_t) - (s/T - m_s))
//       with KL = u/z_t - log z_t + log z_s.  The reference keeps
//       u_ref = sum exp(t/T - m_t) * (t/T - s/T) = u + z_t*(m_t - m_s) and
//       forms KL = u_ref/z_t - (m_t + log z_t) + (m_s + log z_s), which
//       subtracts numbers of the size of the logits: when a teacher row's
//       maximum sits near the top-k fill value (-1e9, as after averaging
//       top-k uploads whose supports differ) fp32 keeps nothing of the KL.
//       Keeping u relative to the two maxima avoids that.
//   * kd_bwd_kernel  <- _bwd_call / _bwd_kernel: from those statistics and
//       the upstream gradient g (R,) of the rows,
//         ds = g*T*(q - p),  dt = g*T*p*(log p - log q - KL)  (dt optional),
//       with log p = (t/T - m_t) - log z_t, log q = (s/T - m_s) - log z_s
//       rebuilt per element.
// Both scale the logits as the Pallas kernels do, by the reciprocal 1/T
// (one multiply an element, no division); at T = 1, 2, 4 that is exactly
// the division of the plain twins in kernels/ref.py.
//
// What bounds them on this card: bytes.  The forward reads the two logit
// tensors once (2*R*V*4 bytes: 514.6 MB at R=1280, V=50257, 0.154 ms at
// 3.35 TB/s) and does ~10 flops and two exps per element; the backward
// reads both and writes ds (3*R*V*4 bytes) or ds and dt (4*R*V*4).  At the
// classification shapes of the main path (R <= 64, V = 77) there are under
// 40 KB to move, so the launch and the latency of one row's chain set the
// pace.
//
// The forward has two regimes:
//   * narrow rows (V <= NARROW_MAX): kd_fwd_kernel_rows<PER> gives a
//     row a warp (8 or 16 lanes, with more values a lane, were slower at
//     V = 77) that holds its t and s in registers, PER values a lane, and
//     blocks of 64 threads, so a small R spreads over
//     many SMs (R = 64: 32 blocks).  Two passes over the registers: the
//     maxima (an fmaxf butterfly over the lanes), then exp(t - m_t),
//     exp(s - m_s) and the three sums (an add-only butterfly).  No exp in
//     any merge, no branch per element.  NARROW_MAX is where the register
//     budget ends it: 64 values a lane (V 2048) took 197 registers and
//     lost to one block a row streaming.
//   * wide rows: kd_fwd_kernel_wide<VEC> streams a row with a thread-block
//     cluster of up to WIDE_CLUSTER blocks, each at least WIDE_SPAN
//     elements (launch_wide: four at V 50257, so R = 1280 makes about ten
//     waves and no thin last one; one below V 16384, where at R = 1280
//     blocks of fewer elements lost 1.6-1.8x to a cluster's merges), each
//     block a contiguous share of the row's float4s, WIDE_UNROLL float4
//     loads of each tensor in flight a thread.  Rows of an odd V start unaligned:
//     a scalar head up to the first 16-byte boundary (cluster rank 0), the
//     float4 body, a scalar tail (the last rank); where t and s are not
//     equally aligned, scalar loads throughout (VEC false).  Each thread
//     keeps an online (m_t, z_t, u, m_s, z_s): per batch of loads it takes
//     the batch's maxima first and rescales at most once (an exp, rarely
//     taken once the row's maxima settle), so an element costs two exps.
//     The partials merge in a fixed order - a xor butterfly in the warp,
//     the warps in index order through shared memory, the cluster's
//     blocks in rank order through distributed shared memory - with
//       m = max(m1, m2), z = z1*e^(m1 - m) + z2*e^(m2 - m)
//     (u rescaled by the teacher's factor and shifted to the new maxima:
//     u1 -> e^(m_t1 - m_t) * (u1 - z_t1*((m_t - m_t1) - (m_s - m_s1)))).
// No atomics in either, so the results are deterministic.  Empty partials
// start at -1e30, as in the reference, not -inf, so a merge never forms
// inf - inf or 0 * inf.  Teacher entries that carry the top-k fill value
// (-1e9) give exp(...) = 0 exactly and stay finite.
// The backward is elementwise: one block column per 256 vocab entries and
// one block row per logit row, the row's statistics read once per thread.
// Ragged rows and columns are masked; nothing is padded.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block of the backward
constexpr float NEG_INIT = -1e30f;

constexpr int NARROW_THREADS = 64;  // threads per block of the narrow rows
constexpr int NARROW_MAX = 1024;    // the widest row held in registers

constexpr int WIDE_CLUSTER = 4;     // at most this many blocks a wide row
constexpr int WIDE_SPAN = 8192;     // and at least this many elements a block
constexpr int WIDE_THREADS = 256;   // threads a wide block
constexpr int WIDE_UNROLL = 4;      // float4 loads of each tensor in flight

struct Stats {
  float mt, zt, u, ms, zs;
};

// a logit over T, as both kernels form it: x * (1/T), rounded before any
// use (__fmul_rn is never contracted into an FMA), so the backward's
// t/T - m_t is 0 at the row's maximum, as in the forward.  Contracted,
// t * (1/T) - m_t keeps the product's rounding error, which at a teacher
// row near the top-k fill value (t/T ~ -7e8 at T 1.5) is units of the
// logit.
__device__ __forceinline__ float scaled(float x, float inv_temp) {
  return __fmul_rn(x, inv_temp);
}

__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  Stats o;
  o.mt = fmaxf(a.mt, b.mt);
  o.ms = fmaxf(a.ms, b.ms);
  const float at = expf(a.mt - o.mt), bt = expf(b.mt - o.mt);
  o.zt = a.zt * at + b.zt * bt;
  o.u = at * (a.u - a.zt * ((o.mt - a.mt) - (o.ms - a.ms))) +
        bt * (b.u - b.zt * ((o.mt - b.mt) - (o.ms - b.ms)));
  o.zs = a.zs * expf(a.ms - o.ms) + b.zs * expf(b.ms - o.ms);
  return o;
}

__device__ __forceinline__ Stats warp_merge(Stats st) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.mt = __shfl_xor_sync(0xffffffffu, st.mt, off);
    o.zt = __shfl_xor_sync(0xffffffffu, st.zt, off);
    o.u = __shfl_xor_sync(0xffffffffu, st.u, off);
    o.ms = __shfl_xor_sync(0xffffffffu, st.ms, off);
    o.zs = __shfl_xor_sync(0xffffffffu, st.zs, off);
    st = merge(st, o);
  }
  return st;
}

__device__ __forceinline__ void write_row(const Stats& st, int row,
                                          float t2, float* rows, float* mt,
                                          float* zt, float* ms, float* zs,
                                          float* u) {
  const float kl = st.u / st.zt - logf(st.zt) + logf(st.zs);
  rows[row] = kl * t2;
  mt[row] = st.mt;
  zt[row] = st.zt;
  ms[row] = st.ms;
  zs[row] = st.zs;
  u[row] = st.u;
}

// Narrow rows: a warp a row, PER values of t and of s a lane, element
// j = lane + i*32.  Every thread of a warp takes part in the butterflies;
// a row past R loads nothing and writes nothing.
template <int PER>
__global__ void __launch_bounds__(NARROW_THREADS)
kd_fwd_kernel_rows(const float* __restrict__ T, const float* __restrict__ S,
                   float* __restrict__ rows, float* __restrict__ mt_out,
                   float* __restrict__ zt_out, float* __restrict__ ms_out,
                   float* __restrict__ zs_out, float* __restrict__ u_out,
                   int R, int V, float inv_temp, float t2) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (NARROW_THREADS / 32) + threadIdx.x / 32;
  const bool live = row < R;
  const float* t_row = T + (size_t)row * V;
  const float* s_row = S + (size_t)row * V;
  float t[PER], s[PER];
  float mt = NEG_INIT, ms = NEG_INIT;
  #pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = lane + i * 32;
    const bool in = live && j < V;
    t[i] = in ? scaled(__ldg(t_row + j), inv_temp) : NEG_INIT;
    s[i] = in ? scaled(__ldg(s_row + j), inv_temp) : NEG_INIT;
    mt = fmaxf(mt, t[i]);
    ms = fmaxf(ms, s[i]);
  }
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    ms = fmaxf(ms, __shfl_xor_sync(0xffffffffu, ms, off));
  }
  float zt = 0.f, zs = 0.f, u = 0.f;
  #pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (lane + i * 32 < V) {
      const float tc = t[i] - mt, sc = s[i] - ms;
      const float et = expf(tc);
      zt += et;
      zs += expf(sc);
      u = fmaf(et, tc - sc, u);
    }
  }
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    zt += __shfl_xor_sync(0xffffffffu, zt, off);
    zs += __shfl_xor_sync(0xffffffffu, zs, off);
    u += __shfl_xor_sync(0xffffffffu, u, off);
  }
  if (live && lane == 0)
    write_row(Stats{mt, zt, u, ms, zs}, row, t2, rows, mt_out, zt_out,
              ms_out, zs_out, u_out);
}

// N values of t and s (already scaled by 1/T) into a thread's online
// statistics: the batch's maxima first, at most one rescale of each side,
// then two exps an element.
template <int N>
__device__ __forceinline__ void absorb(Stats& st, const float (&t)[N],
                                       const float (&s)[N]) {
  float lt = t[0], ls = s[0];
  #pragma unroll
  for (int k = 1; k < N; ++k) {
    lt = fmaxf(lt, t[k]);
    ls = fmaxf(ls, s[k]);
  }
  if (lt > st.mt) {                  // new teacher max: rescale, shift
    const float c = expf(st.mt - lt);
    st.u = c * (st.u - st.zt * (lt - st.mt));
    st.zt *= c;
    st.mt = lt;
  }
  if (ls > st.ms) {                  // new student max: shift, rescale
    st.u += st.zt * (ls - st.ms);
    st.zs *= expf(st.ms - ls);
    st.ms = ls;
  }
  #pragma unroll
  for (int k = 0; k < N; ++k) {
    const float tc = t[k] - st.mt, sc = s[k] - st.ms;
    const float et = expf(tc);
    st.zt += et;
    st.zs += expf(sc);
    st.u = fmaf(et, tc - sc, st.u);
  }
}

__device__ __forceinline__ void absorb_one(Stats& st, float t, float s) {
  const float tt[1] = {t}, ss[1] = {s};
  absorb<1>(st, tt, ss);
}

// Wide rows: row = blockIdx.y (and every gridDim.y-th after it), a cluster
// of CL = gridDim.x blocks a row (launch_wide), rank c = blockIdx.x.  VEC:
// t and s share their alignment, so the body between the scalar head and
// tail is read as float4s.
template <bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS)
kd_fwd_kernel_wide(const float* __restrict__ T, const float* __restrict__ S,
                   float* __restrict__ rows, float* __restrict__ mt_out,
                   float* __restrict__ zt_out, float* __restrict__ ms_out,
                   float* __restrict__ zs_out, float* __restrict__ u_out,
                   int R, int V, float inv_temp, float t2) {
  namespace cg = cooperative_groups;
  constexpr int NW = WIDE_THREADS / 32;
  constexpr int U = WIDE_UNROLL;
  __shared__ Stats warp_part[NW];
  __shared__ Stats block_part;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = gridDim.x, rank = blockIdx.x, tid = threadIdx.x;
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const float* t_row = T + (size_t)row * V;
    const float* s_row = S + (size_t)row * V;
    Stats st{NEG_INIT, 0.f, 0.f, NEG_INIT, 0.f};
    if constexpr (VEC) {
      const int head = min(V, (int)((16 - reinterpret_cast<uintptr_t>(t_row)
                                     % 16) % 16 / 4));
      const int n4 = (V - head) / 4;
      const int tail = V - head - 4 * n4;
      if (rank == 0 && tid < head)
        absorb_one(st, scaled(t_row[tid], inv_temp),
                   scaled(s_row[tid], inv_temp));
      if (rank == CL - 1 && tid < tail) {
        const int j = head + 4 * n4 + tid;
        absorb_one(st, scaled(t_row[j], inv_temp),
                   scaled(s_row[j], inv_temp));
      }
      const float4* t4 = reinterpret_cast<const float4*>(t_row + head);
      const float4* s4 = reinterpret_cast<const float4*>(s_row + head);
      const int share = (n4 + CL - 1) / CL;
      const int end = min(n4, (rank + 1) * share);
      int i = rank * share + tid;
      for (; i + (U - 1) * WIDE_THREADS < end; i += U * WIDE_THREADS) {
        float4 a[U], b[U];
        #pragma unroll
        for (int k = 0; k < U; ++k) {
          a[k] = __ldg(t4 + i + k * WIDE_THREADS);
          b[k] = __ldg(s4 + i + k * WIDE_THREADS);
        }
        float t[4 * U], s[4 * U];
        #pragma unroll
        for (int k = 0; k < U; ++k) {
          t[4 * k] = scaled(a[k].x, inv_temp);
          t[4 * k + 1] = scaled(a[k].y, inv_temp);
          t[4 * k + 2] = scaled(a[k].z, inv_temp);
          t[4 * k + 3] = scaled(a[k].w, inv_temp);
          s[4 * k] = scaled(b[k].x, inv_temp);
          s[4 * k + 1] = scaled(b[k].y, inv_temp);
          s[4 * k + 2] = scaled(b[k].z, inv_temp);
          s[4 * k + 3] = scaled(b[k].w, inv_temp);
        }
        absorb<4 * U>(st, t, s);
      }
      for (; i < end; i += WIDE_THREADS) {
        const float4 a = __ldg(t4 + i), b = __ldg(s4 + i);
        const float t[4] = {scaled(a.x, inv_temp), scaled(a.y, inv_temp),
                            scaled(a.z, inv_temp), scaled(a.w, inv_temp)};
        const float s[4] = {scaled(b.x, inv_temp), scaled(b.y, inv_temp),
                            scaled(b.z, inv_temp), scaled(b.w, inv_temp)};
        absorb<4>(st, t, s);
      }
    } else {
      constexpr int N = 4 * U;
      const int share = (V + CL - 1) / CL;
      const int end = min(V, (rank + 1) * share);
      int j = rank * share + tid;
      for (; j + (N - 1) * WIDE_THREADS < end; j += N * WIDE_THREADS) {
        float t[N], s[N];
        #pragma unroll
        for (int k = 0; k < N; ++k) {
          t[k] = scaled(__ldg(t_row + j + k * WIDE_THREADS), inv_temp);
          s[k] = scaled(__ldg(s_row + j + k * WIDE_THREADS), inv_temp);
        }
        absorb<N>(st, t, s);
      }
      for (; j < end; j += WIDE_THREADS)
        absorb_one(st, scaled(__ldg(t_row + j), inv_temp),
                   scaled(__ldg(s_row + j), inv_temp));
    }
    st = warp_merge(st);
    if (tid % 32 == 0) warp_part[tid / 32] = st;
    __syncthreads();
    if (tid == 0) {
      Stats b = warp_part[0];
      for (int w = 1; w < NW; ++w) b = merge(b, warp_part[w]);
      block_part = b;
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {
      Stats r = *cluster.map_shared_rank(&block_part, 0);
      for (int c = 1; c < CL; ++c)
        r = merge(r, *cluster.map_shared_rank(&block_part, c));
      write_row(r, row, t2, rows, mt_out, zt_out, ms_out, zs_out, u_out);
    }
    cluster.sync();                  // block_part is read until here
  }
}

__global__ void __launch_bounds__(NT)
kd_bwd_kernel(const float* __restrict__ T, const float* __restrict__ S,
              const float* __restrict__ mt, const float* __restrict__ zt,
              const float* __restrict__ ms, const float* __restrict__ zs,
              const float* __restrict__ u, const float* __restrict__ g,
              float* __restrict__ dt, float* __restrict__ ds, int R, int V,
              float temp, float inv_temp) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j >= V) return;
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const float lzt = logf(zt[row]), lzs = logf(zs[row]);
    const float gt = g[row] * temp;
    const size_t i = (size_t)row * V + j;
    const float logp = (scaled(T[i], inv_temp) - mt[row]) - lzt;
    const float logq = (scaled(S[i], inv_temp) - ms[row]) - lzs;
    const float p = expf(logp), q = expf(logq);
    ds[i] = gt * (q - p);
    if (dt != nullptr) {
      const float kl = u[row] / zt[row] - lzt + lzs;
      dt[i] = gt * p * (logp - logq - kl);
    }
  }
}

template <int PER>
void launch_rows(const float* t, const float* s, float* rows, float* mt,
                 float* zt, float* ms, float* zs, float* u, int R, int V,
                 float inv_temp, float t2, cudaStream_t st) {
  constexpr int RPB = NARROW_THREADS / 32;      // rows a block
  kd_fwd_kernel_rows<PER><<<(R + RPB - 1) / RPB, NARROW_THREADS, 0, st>>>(
      t, s, rows, mt, zt, ms, zs, u, R, V, inv_temp, t2);
}

// A wide row's cluster: the most blocks, a power of two up to
// WIDE_CLUSTER, that leave each at least WIDE_SPAN elements (two batches of
// loads a thread): one block a row to V 16383, four from V 32768.
template <bool VEC>
cudaError_t launch_wide(const float* t, const float* s, float* rows,
                        float* mt, float* zt, float* ms, float* zs, float* u,
                        int R, int V, float inv_temp, float t2,
                        cudaStream_t st) {
  int cl = 1;
  while (2 * cl <= WIDE_CLUSTER && V >= 2 * cl * WIDE_SPAN) cl *= 2;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, R < 65535 ? R : 65535);
  cfg.blockDim = dim3(WIDE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kd_fwd_kernel_wide<VEC>, t, s, rows, mt,
                            zt, ms, zs, u, R, V, inv_temp, t2);
}

}  // namespace

extern "C" {

// The widest row kd_fwd holds in registers: where its two regimes meet.
int kd_narrow_max(void) { return NARROW_MAX; }

// rows, m_t, z_t, m_s, z_s, u: each (R,) from teacher and student (R, V).
int kd_fwd(const float* teacher, const float* student, float* rows, float* mt,
           float* zt, float* ms, float* zs, float* u, int R, int V, float temp,
           void* stream) {
  if (R <= 0 || V <= 0 || !(temp > 0.f)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv = 1.f / temp, t2 = temp * temp;
  if (V > NARROW_MAX) {
    const bool vec = (reinterpret_cast<uintptr_t>(teacher) -
                      reinterpret_cast<uintptr_t>(student)) % 16 == 0;
    const cudaError_t err =
        vec ? launch_wide<true>(teacher, student, rows, mt, zt, ms, zs, u, R,
                                V, inv, t2, st)
            : launch_wide<false>(teacher, student, rows, mt, zt, ms, zs, u,
                                 R, V, inv, t2, st);
    if (err != cudaSuccess) return (int)err;
  } else if (V <= 32) {
    launch_rows<1>(teacher, student, rows, mt, zt, ms, zs, u, R, V, inv, t2,
                   st);
  } else if (V <= 128) {
    launch_rows<4>(teacher, student, rows, mt, zt, ms, zs, u, R, V, inv, t2,
                   st);
  } else if (V <= 256) {
    launch_rows<8>(teacher, student, rows, mt, zt, ms, zs, u, R, V, inv, t2,
                   st);
  } else if (V <= 512) {
    launch_rows<16>(teacher, student, rows, mt, zt, ms, zs, u, R, V, inv, t2,
                    st);
  } else {
    launch_rows<32>(teacher, student, rows, mt, zt, ms, zs, u, R, V, inv, t2,
                    st);
  }
  return (int)cudaGetLastError();
}

// ds (R, V), and dt (R, V) unless dt is null, from the forward's statistics
// and the upstream gradient g (R,) of the rows.
int kd_bwd(const float* teacher, const float* student, const float* mt,
           const float* zt, const float* ms, const float* zs, const float* u,
           const float* g, float* dt, float* ds, int R, int V, float temp,
           void* stream) {
  if (R <= 0 || V <= 0 || !(temp > 0.f)) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + NT - 1) / NT, R < 65535 ? R : 65535);
  kd_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      teacher, student, mt, zt, ms, zs, u, g, dt, ds, R, V, temp,
      1.f / temp);
  return (int)cudaGetLastError();
}

}  // extern "C"
