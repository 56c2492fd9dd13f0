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
// writes dr, dk, dv, dlogw (178 MB, 53 us).  The work is ~5·D² flops a
// step per bh forward: 0.84 GFLOP, 13 us at the fp32 peak.
//
// Forward: one block per bh, the state on chip for the whole sequence,
// 16 state elements a thread (D²/16 threads: 256 at D 64): thread (g, e)
// holds rows [16g, 16g+16) of column e in registers.  Each 16-step
// chunk's r, k, v and w are staged in shared memory by the whole block
// before the dependent updates; the partial r·S over each thread's rows
// goes to shared memory and is summed over the D/16 row groups after the
// chunk.
//
// Backward: every state element evolves on its own (S_t[d][e] = w_t[d]
// S_{t-1}[d][e] + k_t[d] v_t[e], and G alike), so within a chunk of n <=
// BT steps both are closed forms of the chunk's ends.  With P_0 the
// checkpoint (the state before the chunk), H the G after its last step,
// T(a, b) = prod_{a<l<b} w_l (per channel d; 1 when empty), A_j = T(-1, j),
// C_j = T(j, n):
//   S_{j-1} = A_j P_0 + sum_{i<j} T(i, j) k_i v_i^T
//   G_j     = C_j H + sum_{i>j} T(j, i) r_i dy_i^T
// so each step's sums over e and d come from three small products,
// Y1[j] = P_0 dy_j, Y2[j] = H v_j, Y3[j] = H^T (C_j k_j), the row sums
// Z = rowsum(H (.) P_0), the Gram matrix v_a·dy_b and
// krk[i][j] = sum_d T(j, i) r_i k_j:
//   rowsum(S_{j-1} (.) dy_j) = A_j Y1[j] + sum_{i<j} T(i, j) k_i (v_i·dy_j)
//   rowsum(G_j (.) v_j)      = C_j Y2[j] + sum_{i>j} T(j, i) r_i (v_j·dy_i)
//   colsum(G_j (.) k_j)      = Y3[j] + sum_{i>j} krk[i][j] dy_i
//   rowsum(G_j (.) S_{j-1})  = C_j A_j Z + C_j sum_{i<j} T(i, j) k_i Y2[i]
//                              + A_j sum_{i>j} T(j, i) r_i Y1[i]
//                              + sum_{i>j} sum_{i'<j} T(j, i) T(i', j)
//                                r_i k_i' (v_i'·dy_i)
// and H before the chunk is A_n H + sum_i A_i r_i dy_i^T.  Only products
// of decays appear, never a quotient (w reaches ~2e-9), and no step waits
// on the one before: one block of 256 threads a bh (three an SM, 74 KB of
// shared memory each at D 64), every phase spread over the block, four
// barriers a chunk; Y1, Y2 and Y3 are (D x D)·(D x 8) products, run in
// 3xTF32 on the tensor cores (mma_tf32.cuh), an m16 tile of rows a warp.
// P_0 and H live in shared memory, their rows and the inputs' padded to
// D + 4 (a fragment's rows, the inputs' rows read by the lanes of a warp,
// each meet a bank once); the next chunk's inputs (earlier in time: r, k,
// logw, v, dy) are staged by cp.async into a second buffer while a chunk
// is worked on (16-byte copies where every input is 16-byte aligned,
// else 4-byte ones), its checkpoint into P_0 once P_0's last reader is
// done.  Every sum is taken in a fixed order: the same bits every run
// and every CUDA-graph replay.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_tf32.cuh"   // 3xTF32 mma.sync and cp.async staging

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

// ---- rwkv6_bwd: each BT-step chunk in closed form (see the head) ----
constexpr int BNT = 256;        // threads a backward block
static_assert(BT == 8, "a chunk is one n8 tile of the tensor cores");

template <int D> struct BwdSmem {
  static constexpr int LD = D + 4;        // padded rows of P0 and H
  static constexpr int LDI = D + 4;       // padded rows of the inputs
  float p0[D * LD];          // the chunk's checkpoint P_0
  float h[D * LD];           // H: dL/dS after the chunk's last step
  // the chunk's r, k, logw (w in place), v, dy: [step][channel],
  // double-buffered
  float in[2][5][BT][LDI];
  float dyT[D][BT], vT[D][BT];   // dy and v, [channel][step]
  float ckT[D][BT];              // C_j k_j, [channel][step]
  float arT[D][BT];              // A_j r_j, [channel][step]
  float a[BT + 1][D];            // A_j = prod_{l<j} w_l
  float y1[BT][D], y2[BT][D], y3[BT][D];
  float z[D], u[D];
  float gv[BT][BT];              // v_a · dy_b
  float krk[BT][BT];             // sum_d T(j, i) r_i k_j, at [i][j], i > j
  float ruk[BT];
};

// the chunk's rows [t0, t0 + n) of r, k, logw, v, dy into buffer b (zero
// past n)
template <int D, bool VEC>
__device__ __forceinline__ void stage_inputs(
    BwdSmem<D>& sm, int b, const float* r, const float* k, const float* logw,
    const float* v, const float* dy, size_t base, int t0, int n) {
  constexpr int LDI = BwdSmem<D>::LDI;
  const int tid = threadIdx.x;
  #pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float* src = (q == 0 ? r : q == 1 ? k : q == 2 ? logw : q == 3 ? v
                                                                    : dy)
                       + base + (size_t)t0 * D;
    float* dst = &sm.in[b][q][0][0];
    if constexpr (VEC) {
      for (int i = tid; i < BT * D / 4; i += BNT) {
        const int j = i / (D / 4), c = 4 * (i % (D / 4));
        cp_async16(dst + j * LDI + c, j < n ? src + j * D + c : r, j < n);
      }
    } else {
      for (int i = tid; i < BT * D; i += BNT) {
        const int j = i / D, c = i % D;
        cp_async4(dst + j * LDI + c, j < n ? src + j * D + c : r, j < n);
      }
    }
  }
  cp_commit();
}

// a checkpoint into P_0 (padded rows, 4-byte copies)
template <int D>
__device__ __forceinline__ void stage_ckpt(BwdSmem<D>& sm, const float* ck) {
  for (int i = threadIdx.x; i < D * D; i += BNT)
    cp_async4(&sm.p0[(i / D) * BwdSmem<D>::LD + i % D], ck + i, true);
  cp_commit();
}

template <int D, bool VEC>
__global__ void __launch_bounds__(BNT, 3)
rwkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ ckpt,
                 const float* __restrict__ dy, const float* __restrict__ dsf,
                 float* __restrict__ dr, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dlogw,
                 float* __restrict__ du, int S, int U) {
  constexpr int LD = BwdSmem<D>::LD, LDI = BwdSmem<D>::LDI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<D>& sm = *reinterpret_cast<BwdSmem<D>*>(smem_raw);
  const int bh = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)bh * S * D;
  const int nck = (S + BT - 1) / BT;
  const float* ckb = ckpt + (size_t)bh * nck * D * D;
  for (int i = tid; i < D; i += BNT) sm.u[i] = u[(size_t)(bh % U) * D + i];
  for (int i = tid; i < D * D; i += BNT)
    sm.h[(i / D) * LD + i % D] =
        dsf != nullptr ? dsf[(size_t)bh * D * D + i] : 0.f;
  float du_acc = 0.f;                    // thread d < D: du[d]
  {
    const int t0 = (nck - 1) * BT;
    stage_inputs<D, VEC>(sm, (nck - 1) & 1, r, k, logw, v, dy, base, t0,
                         min(BT, S - t0));
    stage_ckpt<D>(sm, ckb + (size_t)(nck - 1) * D * D);
  }
  for (int ci = nck - 1; ci >= 0; --ci) {
    const int b = ci & 1, t0 = ci * BT, n = min(BT, S - t0);
    float (*x)[BT][LDI] = sm.in[b];      // x[0] r, [1] k, [2] w, [3] v, [4] dy
    cp_wait<0>();
    __syncthreads();         // chunk ci landed; the last chunk's reads done
    if (ci > 0)
      stage_inputs<D, VEC>(sm, b ^ 1, r, k, logw, v, dy, base, t0 - BT, BT);
    // (1) w = exp(logw); dy and v by channel (zero past n)
    for (int i = tid; i < BT * D; i += BNT) {
      const int j = i / D, e = i % D;
      if (j < n) x[2][j][e] = expf(x[2][j][e]);
      sm.dyT[e][j] = x[4][j][e];
      sm.vT[e][j] = x[3][j][e];
    }
    __syncthreads();
    // (2) per channel d: A_j, A_j r_j, C_j k_j; v_a·dy_b and
    // sum_d r_j u k_j, a quarter of the channels a lane, in order
    for (int d = tid; d < D; d += BNT) {
      float p = 1.f;
      for (int j = 0; j < BT; ++j) {
        sm.a[j][d] = p;
        sm.arT[d][j] = p * x[0][j][d];
        if (j < n) p *= x[2][j][d];
      }
      sm.a[BT][d] = p;                   // A_n
      float q = 1.f;
      for (int j = BT - 1; j >= 0; --j) {
        sm.ckT[d][j] = q * x[1][j][d];
        if (j < n) q *= x[2][j][d];
      }
    }
    for (int item = tid; item < (BT * BT + BT) * 4; item += BNT) {
      const int pr = item >> 2, qt = item & 3;
      float acc = 0.f;
      if (pr < BT * BT) {
        const int ia = pr / BT, ib = pr % BT;
        for (int e = qt; e < D; e += 4)
          acc = fmaf(x[3][ia][e], x[4][ib][e], acc);
      } else {
        const int j = pr - BT * BT;
        for (int d = qt; d < D; d += 4)
          acc = fmaf(__fmul_rn(x[0][j][d], sm.u[d]), x[1][j][d], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (qt == 0) {
        if (pr < BT * BT) sm.gv[pr / BT][pr % BT] = acc;
        else sm.ruk[pr - BT * BT] = acc;
      }
    }
    __syncthreads();
    // (3) Y1[j][d] = P_0[d]·dy_j, Y2[j][d] = H[d]·v_j and Y3[j][e] =
    // sum_d C_j[d] k_j[d] H[d][e] in 3xTF32 on the tensor cores, an m16
    // tile of rows (d, or e for Y3) and the 8 steps a warp; Z[d] =
    // H[d]·P_0[d] and krk[i][j] = sum_d T(j, i)[d] r_i[d] k_j[d] for i > j,
    // with T(a, b) = prod_{a<l<b} w_l, in fp32 FMA
    {
      constexpr int MT = D / 16;
      const int lane = tid & 31, g = lane >> 2, t = lane & 3;
      for (int tile = tid >> 5; tile < 3 * MT; tile += BNT / 32) {
        const int which = tile / MT, r0 = (tile % MT) * 16;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        #pragma unroll
        for (int k0 = 0; k0 < D; k0 += 8) {
          FragA a;
          FragB b;
          if (which < 2) {               // rows d of P_0 or H, over e
            const float* m = (which == 0 ? sm.p0 : sm.h) + k0 + t;
            const float (*vec)[BT] = which == 0 ? sm.dyT : sm.vT;
            split(m[(r0 + g) * LD], a.big.x, a.small.x);
            split(m[(r0 + g + 8) * LD], a.big.y, a.small.y);
            split(m[(r0 + g) * LD + 4], a.big.z, a.small.z);
            split(m[(r0 + g + 8) * LD + 4], a.big.w, a.small.w);
            split(vec[k0 + t][g], b.big[0], b.small[0]);
            split(vec[k0 + t + 4][g], b.big[1], b.small[1]);
          } else {                       // rows e of H^T, over d
            const float* m = sm.h + (k0 + t) * LD + r0 + g;
            split(m[0], a.big.x, a.small.x);
            split(m[8], a.big.y, a.small.y);
            split(m[4 * LD], a.big.z, a.small.z);
            split(m[4 * LD + 8], a.big.w, a.small.w);
            split(sm.ckT[k0 + t][g], b.big[0], b.small[0]);
            split(sm.ckT[k0 + t + 4][g], b.big[1], b.small[1]);
          }
          mma3(acc, a, b);
        }
        float (*y)[D] = which == 0 ? sm.y1 : which == 1 ? sm.y2 : sm.y3;
        y[2 * t][r0 + g] = acc[0];
        y[2 * t + 1][r0 + g] = acc[1];
        y[2 * t][r0 + g + 8] = acc[2];
        y[2 * t + 1][r0 + g + 8] = acc[3];
      }
    }
    // the shuffles of Z and krk need whole warps in each kind of item
    static_assert(4 * D % 32 == 0, "warp-aligned items");
    for (int item = tid; item < 4 * D + BT * BT * 4; item += BNT) {
      if (item < 4 * D) {                // Z, a quarter of e a lane
        const int row = item >> 2, qt = item & 3;
        float acc = 0.f;
        for (int e = qt; e < D; e += 4)
          acc = fmaf(sm.h[row * LD + e], sm.p0[row * LD + e], acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (qt == 0) sm.z[row] = acc;
      } else {                           // krk, a quarter of d a lane
        const int rem = item - 4 * D, pr = rem >> 2, qt = rem & 3;
        const int i = pr / BT, j = pr % BT;
        float acc = 0.f;
        if (i > j && i < n) {
          for (int d = qt; d < D; d += 4) {
            float t = x[0][i][d] * x[1][j][d];
            for (int l = j + 1; l < i; ++l) t *= x[2][l][d];
            acc += t;
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (qt == 0) sm.krk[i][j] = acc;
      }
    }
    __syncthreads();
    // P_0's readers are done: the next checkpoint comes in while (4) runs
    if (ci > 0) stage_ckpt<D>(sm, ckb + (size_t)(ci - 1) * D * D);
    // (4) the outputs of each step, and H before the chunk
    for (int item = tid; item < n * D; item += BNT) {
      const int j = item / D, d = item % D;
      const float* w = &x[2][0][d];      // w_l[d] at w[l * LDI]
      const float A = sm.a[j][d];
      // sums over i < j of T(i, j) k_i (.): T(j-1, j) = 1, then times w_i
      float a1 = A * sm.y1[j][d], a3l = 0.f, t = 1.f;
      for (int i = j - 1; i >= 0; --i) {
        const float tk = t * x[1][i][d];
        a1 = fmaf(tk, sm.gv[i][j], a1);
        a3l = fmaf(tk, sm.y2[i][d], a3l);
        t *= w[i * LDI];
      }
      // sums over i > j of T(j, i) r_i (.); t ends as T(j, n) = C_j
      float a2 = 0.f, a3r = 0.f, a3x = 0.f;
      t = 1.f;
      for (int i = j + 1; i < n; ++i) {
        const float tr = t * x[0][i][d];
        a2 = fmaf(tr, sm.gv[j][i], a2);
        a3r = fmaf(tr, sm.y1[i][d], a3r);
        // sum over i' < j of T(i', j) k_i' (v_i'·dy_i)
        float s = 0.f, t2 = 1.f;
        for (int i2 = j - 1; i2 >= 0; --i2) {
          s = fmaf(t2 * x[1][i2][d], sm.gv[i2][i], s);
          t2 *= w[i2 * LDI];
        }
        a3x = fmaf(tr, s, a3x);
        t *= w[i * LDI];
      }
      const float C = t;
      a2 = fmaf(C, sm.y2[j][d], a2);
      const float a3 = fmaf(C * A, sm.z[d], fmaf(C, a3l, fmaf(A, a3r, a3x)));
      const float ud = sm.u[d], cv = sm.gv[j][j];
      const size_t off = base + (size_t)(t0 + j) * D + d;
      dr[off] = fmaf(__fmul_rn(ud, x[1][j][d]), cv, a1);
      dk[off] = fmaf(__fmul_rn(x[0][j][d], ud), cv, a2);
      if (dlogw != nullptr) dlogw[off] = w[j * LDI] * a3;
    }
    for (int item = tid; item < n * D; item += BNT) {
      const int j = item / D, e = item % D;
      float acc = sm.y3[j][e];
      for (int i = j + 1; i < n; ++i)
        acc = fmaf(sm.krk[i][j], x[4][i][e], acc);
      dv[base + (size_t)(t0 + j) * D + e] = fmaf(sm.ruk[j], x[4][j][e], acc);
    }
    if (tid < D)
      for (int j = 0; j < n; ++j)
        du_acc = fmaf(__fmul_rn(x[0][j][tid], x[1][j][tid]), sm.gv[j][j],
                      du_acc);
    // H = A_n H + sum_j A_j r_j dy_j^T (H's readers synced above): a
    // thread keeps one column e, its dy_j[e] in registers
    {
      const int e = tid % D;
      float dye[BT];
      #pragma unroll
      for (int j = 0; j < BT; ++j) dye[j] = sm.dyT[e][j];
      for (int d = tid / D; d < D; d += BNT / D) {
        float acc = sm.a[BT][d] * sm.h[d * LD + e];
        #pragma unroll
        for (int j = 0; j < BT; ++j) acc = fmaf(sm.arT[d][j], dye[j], acc);
        sm.h[d * LD + e] = acc;
      }
    }
  }
  if (du != nullptr && tid < D) du[(size_t)bh * D + tid] = du_acc;
}

bool valid(int BH, int S, int U) {
  return BH > 0 && S > 0 && U > 0 && BH % U == 0;
}

// one block a bh; its shared memory (above 48 KB at D 64) is allowed once
// a device (the attribute belongs to the device), one bit of `ready` a
// device
template <int D, bool VEC>
int launch_bwd_one(cudaStream_t s, const float* r, const float* k,
                   const float* v, const float* logw, const float* u,
                   const float* ckpt, const float* dy, const float* dsf,
                   float* dr, float* dk, float* dv, float* dlogw, float* du,
                   int BH, int S, int U) {
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  const int bytes = (int)sizeof(BwdSmem<D>);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(rwkv6_bwd_kernel<D, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  rwkv6_bwd_kernel<D, VEC><<<BH, BNT, bytes, s>>>(
      r, k, v, logw, u, ckpt, dy, dsf, dr, dk, dv, dlogw, du, S, U);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(bool vec, cudaStream_t s, const float* r, const float* k,
               const float* v, const float* logw, const float* u,
               const float* ckpt, const float* dy, const float* dsf,
               float* dr, float* dk, float* dv, float* dlogw, float* du,
               int BH, int S, int U) {
  return vec ? launch_bwd_one<D, true>(s, r, k, v, logw, u, ckpt, dy, dsf,
                                       dr, dk, dv, dlogw, du, BH, S, U)
             : launch_bwd_one<D, false>(s, r, k, v, logw, u, ckpt, dy, dsf,
                                        dr, dk, dv, dlogw, du, BH, S, U);
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
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(logw) |
                        reinterpret_cast<uintptr_t>(dy);
  const bool vec = any % 16 == 0;
  switch (D) {
    case 16: return launch_bwd<16>(vec, s, r, k, v, logw, u, ckpt, dy, dsf,
                                   dr, dk, dv, dlogw, du, BH, S, U);
    case 32: return launch_bwd<32>(vec, s, r, k, v, logw, u, ckpt, dy, dsf,
                                   dr, dk, dv, dlogw, du, BH, S, U);
    case 64: return launch_bwd<64>(vec, s, r, k, v, logw, u, ckpt, dy, dsf,
                                   dr, dk, dv, dlogw, du, BH, S, U);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
