// RWKV-6 WKV recurrence kernels for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel of src/repro/kernels/rwkv6_scan.py (rwkv6_scan,
// row 16).  Per batch·head bh, with w_t = exp(logw_t) and the (D, D)
// state S starting at 0:
//   * rwkv6_fwd_kernel:
//       y_t = r_t·S_{t-1} + (sum_d r_t[d] u[d] k_t[d]) · v_t
//       S_t = w_t (.)rows S_{t-1} + k_t v_t^T
//     writes y, S_final and, when a gradient will be taken, the state
//     before every BT-th step (ckpt, (BH, ceil(S/BT), D, D)).
//   * rwkv6_bwd_kernel: its gradient, backward in time carrying
//     G = dL/dS_t (dS_final, or 0, after the last step), c_t = v_t·dy_t:
//       dr_t    = S_{t-1}·dy_t + u (.) k_t c_t
//       dk_t    = G·v_t + r_t (.) u c_t
//       dv_t    = G^T·k_t + (sum_d r_t[d] u[d] k_t[d]) dy_t
//       dlogw_t = w_t (.) rowsum(G (.) S_{t-1})      (when dlogw is set)
//       du     += r_t (.) k_t c_t                      (when du is set)
//       G       = w_t (.)rows G + r_t dy_t^T
//     S_{t-1} is recomputed from the chunk's checkpoint: never S_t / w_t
//     (the model's decay allows w down to ~2e-9).  The reference
//     differentiates its WKV through XLA; this is the port's form of that
//     gradient.
//
// Layouts: r, k, v, logw, y, dy, dr, dk, dv, dlogw (BH, S, D); u (U, D)
// with U dividing BH, row bh mod U serving bh; S_final, dS_final (BH, D,
// D) with S[d][e] (d the key channel, e the value channel); du (BH, D),
// one row per bh (the wrapper sums rows of equal bh mod U); all fp32 and
// contiguous.  D is 16, 32 or 64.
//
// Rounding: the state update w*S + k*v is __fmul_rn, __fmul_rn, __fadd_rn
// (no FMA contraction) with w = expf(logw), as the plain version in
// kernels/ref.py rounds it, so S_final has its bits.  y and the gradients
// sum over D in this kernel's own order.
//
// What bounds it on this card: bytes.  At the training shape (BH 512, S
// 80, D 64) the forward reads r, k, v, logw and writes y and S_final
// (61 MB, 18 us at 3.35 TB/s), plus 84 MB of checkpoints when a gradient
// follows; the backward reads r, k, v, logw, dy and the checkpoints and
// writes dr, dk, dv, dlogw (178 MB).  The work, ~5·D² flops a step per
// bh, is 0.84 GFLOP forward: 13 us at the fp32 peak.
//
// The simple design: one block per bh, the state on chip for the whole
// sequence, 16 state elements a thread (D²/16 threads: 256 at D 64).
//   Forward: thread (g, e) holds rows [16g, 16g+16) of column e in
//   registers.  Each 16-step chunk's r, k, v and w are staged in shared
//   memory by the whole block before the dependent updates; the partial
//   r·S over each thread's rows goes to shared memory and is summed over
//   the D/16 row groups after the chunk.
//   Backward, per BT-step chunk in reverse: (1) thread (d, q) holds
//   columns q, q + Q, ... of row d (Q = D/16 lanes a row, adjacent), and
//   recomputes its part of S_{t-1} for the chunk's steps in registers;
//   walking the steps backward it carries its row of G and forms dr, dk
//   and dlogw (sums over e: in the thread, then over the Q lanes by
//   shuffles); (2) thread (g, e) carries rows [16g, 16g+16) of G's column
//   e and forms dv's partial sums over d, summed over the groups after
//   the chunk.  Both walks update G the same way.
#include <cuda_runtime.h>

namespace {

constexpr int RT = 16;   // state elements a thread holds
constexpr int CH = 16;   // forward: steps staged in shared memory together
constexpr int BT = 8;    // checkpoint interval = backward chunk

template <int D>
__global__ void __launch_bounds__(D * D / RT)
rwkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, float* __restrict__ y,
                 float* __restrict__ sf, float* __restrict__ ckpt, int S,
                 int U) {
  constexpr int NT = D * D / RT, NG = D / RT;
  __shared__ float sr[CH][D], sk[CH][D], sv[CH][D], sw[CH][D];
  __shared__ float part[CH][NG][D];
  __shared__ float su[D], sc[CH];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int g = tid / D, e = tid % D, d0 = g * RT;
  const size_t base = (size_t)bh * S * D;
  const int nck = (S + BT - 1) / BT;
  for (int i = tid; i < D; i += NT) su[i] = u[(size_t)(bh % U) * D + i];

  float st[RT];
  #pragma unroll
  for (int i = 0; i < RT; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int n = min(CH, S - t0);
    for (int i = tid; i < n * D; i += NT) {
      const int j = i / D, c = i % D;
      const size_t off = base + (size_t)(t0 + j) * D + c;
      sr[j][c] = r[off];
      sk[j][c] = k[off];
      sv[j][c] = v[off];
      sw[j][c] = expf(logw[off]);
    }
    __syncthreads();
    if (tid < n) {                       // sum_d r u k of step tid
      float acc = 0.f;
      for (int d = 0; d < D; ++d)
        acc = fmaf(__fmul_rn(sr[tid][d], su[d]), sk[tid][d], acc);
      sc[tid] = acc;
    }
    for (int j = 0; j < n; ++j) {
      const int t = t0 + j;
      if (ckpt != nullptr && t % BT == 0) {
        float* cp = ckpt + (((size_t)bh * nck + t / BT) * D + d0) * D + e;
        #pragma unroll
        for (int i = 0; i < RT; ++i) cp[(size_t)i * D] = st[i];
      }
      const float ve = sv[j][e];
      float acc = 0.f;
      #pragma unroll
      for (int i = 0; i < RT; ++i) {
        acc = fmaf(sr[j][d0 + i], st[i], acc);
        st[i] = __fadd_rn(__fmul_rn(sw[j][d0 + i], st[i]),
                          __fmul_rn(sk[j][d0 + i], ve));
      }
      part[j][g][e] = acc;
    }
    __syncthreads();
    for (int i = tid; i < n * D; i += NT) {
      const int j = i / D, c = i % D;
      float acc = 0.f;
      #pragma unroll
      for (int gg = 0; gg < NG; ++gg) acc += part[j][gg][c];
      y[base + (size_t)(t0 + j) * D + c] = fmaf(sc[j], sv[j][c], acc);
    }
    __syncthreads();
  }
  float* out = sf + ((size_t)bh * D + d0) * D + e;
  #pragma unroll
  for (int i = 0; i < RT; ++i) out[(size_t)i * D] = st[i];
}

template <int D>
__global__ void __launch_bounds__(D * D / RT, 1)
rwkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ ckpt,
                 const float* __restrict__ dy, const float* __restrict__ dsf,
                 float* __restrict__ dr, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dlogw,
                 float* __restrict__ du, int S, int U) {
  constexpr int NT = D * D / RT, Q = D / RT;
  constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  __shared__ float sr[BT][D], sk[BT][D], sv[BT][D], sw[BT][D], sdy[BT][D];
  __shared__ float part[BT][Q][D];
  __shared__ float su[D], scv[BT], sruk[BT];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int rd = tid / Q, q = tid % Q;            // row role
  const int g = tid / D, ce = tid % D, d0 = g * RT;  // column role
  const size_t base = (size_t)bh * S * D;
  const int nck = (S + BT - 1) / BT;
  for (int i = tid; i < D; i += NT) su[i] = u[(size_t)(bh % U) * D + i];

  float G[RT], Gc[RT];
  const float* gs = dsf != nullptr ? dsf + (size_t)bh * D * D : nullptr;
  #pragma unroll
  for (int c = 0; c < RT; ++c) {
    G[c] = gs != nullptr ? gs[(size_t)rd * D + q + Q * c] : 0.f;
    Gc[c] = gs != nullptr ? gs[(size_t)(d0 + c) * D + ce] : 0.f;
  }
  float du_acc = 0.f;

  for (int ci = nck - 1; ci >= 0; --ci) {
    const int t0 = ci * BT, n = min(BT, S - t0);
    for (int i = tid; i < n * D; i += NT) {
      const int j = i / D, c = i % D;
      const size_t off = base + (size_t)(t0 + j) * D + c;
      sr[j][c] = r[off];
      sk[j][c] = k[off];
      sv[j][c] = v[off];
      sw[j][c] = expf(logw[off]);
      sdy[j][c] = dy[off];
    }
    __syncthreads();
    if (tid < n) {                  // c_t = v·dy and sum_d r u k
      float cv = 0.f, ruk = 0.f;
      for (int d = 0; d < D; ++d) {
        cv = fmaf(sv[tid][d], sdy[tid][d], cv);
        ruk = fmaf(__fmul_rn(sr[tid][d], su[d]), sk[tid][d], ruk);
      }
      scv[tid] = cv;
      sruk[tid] = ruk;
    }
    __syncthreads();

    // (1) row walk: recompute this thread's part of S_{t-1} from the
    // checkpoint, then go backward through the chunk
    float sp[BT][RT];
    {
      const float* cp = ckpt + (((size_t)bh * nck + ci) * D + rd) * D + q;
      float s[RT];
      #pragma unroll
      for (int c = 0; c < RT; ++c) s[c] = cp[Q * c];
      #pragma unroll
      for (int j = 0; j < BT; ++j) {
        if (j < n) {
          const float wj = sw[j][rd], kj = sk[j][rd];
          #pragma unroll
          for (int c = 0; c < RT; ++c) {
            sp[j][c] = s[c];
            s[c] = __fadd_rn(__fmul_rn(wj, s[c]),
                             __fmul_rn(kj, sv[j][q + Q * c]));
          }
        }
      }
    }
    const float ud = su[rd];
    #pragma unroll
    for (int j = BT - 1; j >= 0; --j) {
      if (j < n) {
        float a1 = 0.f, a2 = 0.f, a3 = 0.f;
        #pragma unroll
        for (int c = 0; c < RT; ++c) {
          const int col = q + Q * c;
          a1 = fmaf(sp[j][c], sdy[j][col], a1);
          a2 = fmaf(G[c], sv[j][col], a2);
          a3 = fmaf(G[c], sp[j][c], a3);
        }
        #pragma unroll
        for (int off = 1; off < Q; off <<= 1) {
          a1 += __shfl_xor_sync(MASK, a1, off);
          a2 += __shfl_xor_sync(MASK, a2, off);
          a3 += __shfl_xor_sync(MASK, a3, off);
        }
        const float cv = scv[j], wj = sw[j][rd], rj = sr[j][rd],
                    kj = sk[j][rd];
        if (q == 0) {
          const size_t off = base + (size_t)(t0 + j) * D + rd;
          dr[off] = fmaf(__fmul_rn(ud, kj), cv, a1);
          dk[off] = fmaf(__fmul_rn(rj, ud), cv, a2);
          if (dlogw != nullptr) dlogw[off] = wj * a3;
        }
        du_acc = fmaf(__fmul_rn(rj, kj), cv, du_acc);
        #pragma unroll
        for (int c = 0; c < RT; ++c)
          G[c] = __fadd_rn(__fmul_rn(wj, G[c]),
                           __fmul_rn(rj, sdy[j][q + Q * c]));
      }
    }

    // (2) column walk: dv's partial sums over this thread's rows
    #pragma unroll
    for (int j = BT - 1; j >= 0; --j) {
      if (j < n) {
        float p = 0.f;
        const float dye = sdy[j][ce];
        #pragma unroll
        for (int i = 0; i < RT; ++i) {
          p = fmaf(Gc[i], sk[j][d0 + i], p);
          Gc[i] = __fadd_rn(__fmul_rn(sw[j][d0 + i], Gc[i]),
                            __fmul_rn(sr[j][d0 + i], dye));
        }
        part[j][g][ce] = p;
      }
    }
    __syncthreads();
    for (int i = tid; i < n * D; i += NT) {
      const int j = i / D, c = i % D;
      float acc = 0.f;
      #pragma unroll
      for (int gg = 0; gg < Q; ++gg) acc += part[j][gg][c];
      dv[base + (size_t)(t0 + j) * D + c] = fmaf(sruk[j], sdy[j][c], acc);
    }
    __syncthreads();
  }
  if (du != nullptr && q == 0) du[(size_t)bh * D + rd] = du_acc;
}

bool valid(int BH, int S, int U) {
  return BH > 0 && S > 0 && U > 0 && BH % U == 0;
}

}  // namespace

extern "C" {

// ckpt null: no checkpoints (no gradient will be taken)
int rwkv6_fwd(const float* r, const float* k, const float* v,
              const float* logw, const float* u, float* y, float* sf,
              float* ckpt, int BH, int S, int D, int U, void* stream) {
  if (!valid(BH, S, U)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      rwkv6_fwd_kernel<16><<<BH, 16 * 16 / RT, 0, s>>>(r, k, v, logw, u, y,
                                                       sf, ckpt, S, U);
      break;
    case 32:
      rwkv6_fwd_kernel<32><<<BH, 32 * 32 / RT, 0, s>>>(r, k, v, logw, u, y,
                                                       sf, ckpt, S, U);
      break;
    case 64:
      rwkv6_fwd_kernel<64><<<BH, 64 * 64 / RT, 0, s>>>(r, k, v, logw, u, y,
                                                       sf, ckpt, S, U);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dsf, dlogw, du may be null (no dS_final; dlogw or du not asked for)
int rwkv6_bwd(const float* r, const float* k, const float* v,
              const float* logw, const float* u, const float* ckpt,
              const float* dy, const float* dsf, float* dr, float* dk,
              float* dv, float* dlogw, float* du, int BH, int S, int D,
              int U, void* stream) {
  if (!valid(BH, S, U)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      rwkv6_bwd_kernel<16><<<BH, 16 * 16 / RT, 0, s>>>(
          r, k, v, logw, u, ckpt, dy, dsf, dr, dk, dv, dlogw, du, S, U);
      break;
    case 32:
      rwkv6_bwd_kernel<32><<<BH, 32 * 32 / RT, 0, s>>>(
          r, k, v, logw, u, ckpt, dy, dsf, dr, dk, dv, dlogw, du, S, U);
      break;
    case 64:
      rwkv6_bwd_kernel<64><<<BH, 64 * 64 / RT, 0, s>>>(
          r, k, v, logw, u, ckpt, dy, dsf, dr, dk, dv, dlogw, du, S, U);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
