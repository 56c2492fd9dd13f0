// KD distillation loss kernels for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of src/repro/kernels/kd_loss.py:
//   * kd_fwd_kernel  <- _fwd_call / _fwd_kernel: per row of the (R, V)
//       teacher and student logits, KL(softmax(t/T) || softmax(s/T)) * T^2
//       and the five row statistics the backward needs,
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
//
// What bounds it on this card: both are bound by bytes.  The forward reads
// the two logit tensors once (2*R*V*4 bytes: 514.6 MB at R=1280, V=50257,
// 0.154 ms at 3.35 TB/s) and does ~10 flops and two exps per element; the
// backward reads both and writes ds (3*R*V*4 bytes) or ds and dt (4*R*V*4).
// At the classification shapes of the main path (R <= 64, V = 77) there
// are under 40 KB to move, so launch latency sets the pace.
//
// The simple design: the TPU kernel's sequential vocab grid becomes a loop
// inside one row's threads.  The forward gives each row one warp (V small)
// or one 256-thread block (V large); every thread keeps an online
// (m_t, z_t, u, m_s, z_s) over the columns it strides (coalesced loads),
// then the threads merge in a fixed order - a xor butterfly in the warp,
// then the warps in index order through shared memory - with
//   m = max(m1, m2), z = z1*e^(m1 - m) + z2*e^(m2 - m)
// (u rescaled by the teacher's factor and shifted to the new maxima:
// u1 -> e^(m_t1 - m_t) * (u1 - z_t1*((m_t - m_t1) - (m_s - m_s1)))).
// No atomics, so the result is deterministic.  Running maxima start at
// -1e30 as in the reference, not -inf, so an empty partial never forms
// inf - inf or 0 * inf.  Teacher entries that carry the top-k fill value
// (-1e9) give exp(...) = 0 exactly and stay finite.
// The backward is elementwise: one block column per 256 vocab entries and
// one block row per logit row, the row's statistics read once per thread.
// Ragged rows and columns are masked; nothing is padded.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr float NEG_INIT = -1e30f;

struct Stats {
  float mt, zt, u, ms, zs;
};

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

// TPR threads per row (32: one warp, NT: the whole block).
template <int TPR>
__global__ void __launch_bounds__(NT)
kd_fwd_kernel(const float* __restrict__ T, const float* __restrict__ S,
              float* __restrict__ rows, float* __restrict__ mt_out,
              float* __restrict__ zt_out, float* __restrict__ ms_out,
              float* __restrict__ zs_out, float* __restrict__ u_out, int R,
              int V, float temp) {
  constexpr int RPB = NT / TPR;            // rows per block
  constexpr int WPR = TPR / 32;            // warps per row
  __shared__ Stats part[RPB][WPR];
  const int rb = threadIdx.x / TPR, tr = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + rb;
  Stats st{NEG_INIT, 0.f, 0.f, NEG_INIT, 0.f};
  if (row < R) {
    const float* t_row = T + (size_t)row * V;
    const float* s_row = S + (size_t)row * V;
    for (int j = tr; j < V; j += TPR) {
      const float t = t_row[j] / temp, s = s_row[j] / temp;
      if (t > st.mt) {                   // new teacher max: rescale, shift
        const float c = expf(st.mt - t);
        st.u = c * (st.u - st.zt * (t - st.mt));
        st.zt *= c;
        st.mt = t;
      }
      if (s > st.ms) {                   // new student max: shift, rescale
        st.u += st.zt * (s - st.ms);
        st.zs *= expf(st.ms - s);
        st.ms = s;
      }
      const float et = expf(t - st.mt);
      st.zt += et;
      st.zs += expf(s - st.ms);
      st.u += et * ((t - st.mt) - (s - st.ms));
    }
  }
  st = warp_merge(st);
  if constexpr (WPR > 1) {
    if (tr % 32 == 0) part[rb][tr / 32] = st;
    __syncthreads();
    if (tr == 0) {
      st = part[rb][0];
      for (int w = 1; w < WPR; ++w) st = merge(st, part[rb][w]);
    }
  }
  if (tr == 0 && row < R) {
    const float kl = st.u / st.zt - logf(st.zt) + logf(st.zs);
    rows[row] = kl * temp * temp;
    mt_out[row] = st.mt;
    zt_out[row] = st.zt;
    ms_out[row] = st.ms;
    zs_out[row] = st.zs;
    u_out[row] = st.u;
  }
}

__global__ void __launch_bounds__(NT)
kd_bwd_kernel(const float* __restrict__ T, const float* __restrict__ S,
              const float* __restrict__ mt, const float* __restrict__ zt,
              const float* __restrict__ ms, const float* __restrict__ zs,
              const float* __restrict__ u, const float* __restrict__ g,
              float* __restrict__ dt, float* __restrict__ ds, int R, int V,
              float temp) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j >= V) return;
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const float lzt = logf(zt[row]), lzs = logf(zs[row]);
    const float gt = g[row] * temp;
    const size_t i = (size_t)row * V + j;
    const float logp = (T[i] / temp - mt[row]) - lzt;
    const float logq = (S[i] / temp - ms[row]) - lzs;
    const float p = expf(logp), q = expf(logq);
    ds[i] = gt * (q - p);
    if (dt != nullptr) {
      const float kl = u[row] / zt[row] - lzt + lzs;
      dt[i] = gt * p * (logp - logq - kl);
    }
  }
}

}  // namespace

extern "C" {

// rows, m_t, z_t, m_s, z_s, u: each (R,) from teacher and student (R, V).
int kd_fwd(const float* teacher, const float* student, float* rows, float* mt,
           float* zt, float* ms, float* zs, float* u, int R, int V, float temp,
           void* stream) {
  if (R <= 0 || V <= 0 || !(temp > 0.f)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V <= 2048) {
    const int rpb = NT / 32;
    kd_fwd_kernel<32><<<(R + rpb - 1) / rpb, NT, 0, s>>>(
        teacher, student, rows, mt, zt, ms, zs, u, R, V, temp);
  } else {
    kd_fwd_kernel<NT><<<R, NT, 0, s>>>(teacher, student, rows, mt, zt, ms,
                                       zs, u, R, V, temp);
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
      teacher, student, mt, zt, ms, zs, u, g, dt, ds, R, V, temp);
  return (int)cudaGetLastError();
}

}  // extern "C"
