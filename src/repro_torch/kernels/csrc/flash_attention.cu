// Flash attention kernels for Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   * flash_fwd_kernel  <- _fwd_call / _fwd_kernel: online-softmax attention
//       with causal masking, a sliding window, q_offset and GQA (kv head =
//       bh / G); writes o and the per-row logsumexp lse.
//   * flash_dq_kernel   <- _bwd_call / _dq_kernel: dq = scale·ds·k with
//       p = exp(s − lse) recomputed and ds = p(do·vᵀ − D).
//   * flash_dkv_kernel  <- _bwd_call / _dkv_kernel: dk = scale·dsᵀq and
//       dv = pᵀdo, summed over the G query heads of each kv head (with
//       dkv_sum_kernel where the group is split over blocks).
//   D = rowsum(do∘o) is computed outside the kernels, as in the reference.
//
// Layouts: q, o, do, dq (BH, Sq, D); k, v, dk, dv (BKV, Skv, D); lse and D
// (BH, Sq); all fp32 and contiguous.  NEG_INF = -1e30 marks masked scores
// and lse = m + log(max(l, 1e-30)), exactly as the reference.
//
// What bounds them on this card: at the main path's shapes (GPT-2: BH 192,
// S 80, D 64; RecurrentGemma-2B: BH 160 over 16 kv heads, S 80, D 256)
// each kernel moves 5-30 MB and does 0.1-1 GFLOP, so on the tensor cores
// all three are bound by bytes; the work per block is small and launch
// latency matters as much as either.
//
// All three run their products on the tensor cores at fp32 accuracy:
// mma.sync m16n8k8 in TF32 with the 3xTF32 split.  Each operand x is cut
// into big = tf32(x) and small = tf32(x − big) (round to nearest), and
// a·b ≈ small_a·big_b + big_a·small_b + big_a·big_b: the two small
// terms first, then big·big, into a fresh fragment per step of 8 that is
// added to the running sum in fp32 (mma3, in mma_tf32.cuh with the
// cp.async helpers, shared with lora_matmul.cu).  The dropped small·small term
// and the two roundings of the small parts are near 2^-22 of a product,
// below fp32's own summation error; one TF32 pass (2^-11) misses the
// port's fp32 gates by 100x.  mma.sync is used and not wgmma: tf32 wgmma
// needs both operands K-major and a 64-row tile, and at S = 80 a 64-row
// kv or q tile leaves the grid as thin as the FFMA kernels had it.  For
// long sequences the step is wgmma fed by TMA with a producer warp.
//
// flash_fwd (FlashAttention-2's layout): a block owns 4 q tiles of 16
// rows, each of one head, one warp a tile (two at D 256, below).  The
// tiles of a block are consecutive (16-row q tile, head) pairs of one kv
// head's GQA group, q tile first, so with G > 1 they share every K/V tile
// (RecurrentGemma-2B: 10 heads on one kv head, 13 blocks a kv head instead
// of 10 x 2 blocks of 64 rows).  Each Q tile is scaled, split and kept in
// shared memory in fragment order (one 16-byte load per fragment half); K and V tiles of
// BKV rows come through a 2-stage cp.async ring (16-byte copies, zero-fill
// past the edges).  S = QKᵀ stays in the accumulator fragments; the online
// softmax works on them with quad shuffles, and P is split in registers
// into the A fragments of O += P·V (the C fragment's column pair (2t,
// 2t+1) is read as the A fragment's k pair (t, t+4), and V's rows are
// loaded in the same order), with no trip through shared memory.  At D 256
// two warps share a q tile: each forms S over its half of D, the halves
// are added through shared memory (the same bits in both), both run the
// softmax, and each keeps O for its half of D's columns (16 x 128, 64
// registers a thread; 16 x 256 in one warp took all 255).  BKV is 16 at
// D >= 128.
//
// flash_dkv: a block of 8 warps owns 16 kv rows of one kv head and one
// chunk of its GQA group.  The chunk count is read from the SM count
// (dkv_chunks): RecurrentGemma-2B's 5 kv tiles x 16 kv heads = 80 blocks
// become 320.  Each chunk writes fp32 partial dK and dV into a workspace
// the wrapper allocates, and dkv_sum_kernel adds the chunks in order (no
// atomics: the same bits every run); with one chunk (G = 1, GPT-2) the
// block writes dk and dv itself.  K and V of the kv tile are loaded once,
// split, into fragment order.  Each step takes 32 query rows of one head:
// Q, dO, lse and D come through a 2-stage cp.async ring.  Sᵀ = K(scale·Q)ᵀ
// and dPᵀ = V·dOᵀ are computed once per step, each (16 x 8) tile by two
// warps over the two halves of D, summed in a fixed order through shared
// memory; the warp that sums a tile forms P and dS there and stores them
// split in fragment order.  Then warps 0-3 add Pᵀ·dO to dV and warps 4-7
// dSᵀ·Q to dK, each over a quarter of D's columns (at D 256: 32 registers
// of accumulators a thread).
//
// Shared-memory tiles have a row stride of D + 4 floats, so the 32-bit
// fragment loads of rows (g, column t) and of row pairs (2t, column g) hit
// 32 different banks.  kv (fwd) and q (dkv) tiles that no query of the
// block can reach (causal, window) are skipped.  D <= 256, instantiated
// for 32, 64, 128 and 256 and masked past D; rows past the ragged edges
// are zero-filled and masked.
//
// flash_dq takes flash_fwd's layout: the 16-row q tiles of a kv head's
// GQA group packed in a block (q tile first), K and V tiles of 16 rows
// through a 2-stage cp.async ring, kv tiles that no query of the block
// reaches skipped.  Each warp owns 64 columns of D at D 256 and 32 below
// (DqCfg): KS = D / columns warps share a q tile (4 at D 256, 2 at D 64).
// It keeps its A fragments of scale·Q and dO for those columns in
// registers, unsplit, and splits them at each use with split_fast; so no
// Q or dO tile takes shared memory, which holds the K/V ring and, where
// several warps share a q tile, their partial S and dP (83 KB a block at
// D 256).  Per kv
// tile: S = (scale·Q)Kᵀ and dP = dO·Vᵀ over the warp's columns, the
// partials added through shared memory in the order of the parts (the
// same bits in every warp of the tile); P = exp(S − lse), 0 where
// masked; dS = P∘(dP − D) in the C fragments; then dQ += dS·K over the
// warp's columns (dS read as the A fragment, K's rows in the same order,
// as flash_fwd's P·V); dq = scale·dQ at the end.  Registers (ptxas):
// 255 at D 256 (one block of 8 warps an SM), 190 at D 128, 128 at D 64
// (two blocks of 8 warps an SM), 203 at D 32; no spills.
//
// What a later PR should change: D = rowsum(do∘o) fused into flash_dq;
// wgmma + TMA for sequences long enough to fill 64-row tiles.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

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

// --------------------------------------------------------------------------
// 3xTF32 fragments (split, mma3 and cp.async: mma_tf32.cuh)
// --------------------------------------------------------------------------
// B fragment whose n index runs over the rows of a row-major tile X
// (stride LD): b0 = X[n0 + g][k0 + t], b1 = X[n0 + g][k0 + t + 4], times mul
template <int LD>
__device__ __forceinline__ FragB frag_b_rows(const float* X, int n0, int k0,
                                             int g, int t, float mul) {
  FragB f;
  const float* p = X + (n0 + g) * LD + k0 + t;
  split(p[0] * mul, f.big[0], f.small[0]);
  split(p[4] * mul, f.big[1], f.small[1]);
  return f;
}

// B fragment whose k index runs over the rows of X in the order of a C
// fragment read as an A fragment (k t <- row 2t, k t+4 <- row 2t+1):
// b0 = X[k0 + 2t][n0 + g], b1 = X[k0 + 2t + 1][n0 + g]
template <int LD>
__device__ __forceinline__ FragB frag_b_pairs(const float* X, int k0, int n0,
                                              int g, int t) {
  FragB f;
  const float* p = X + (k0 + 2 * t) * LD + n0 + g;
  split(p[0], f.big[0], f.small[0]);
  split(p[LD], f.big[1], f.small[1]);
  return f;
}

// A fragment from a C fragment of the same rows: k t <- column 2t (c0, c2),
// k t+4 <- column 2t+1 (c1, c3)
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  FragA f;
  split(c[0], f.big.x, f.small.x);
  split(c[2], f.big.y, f.small.y);
  split(c[1], f.big.z, f.small.z);
  split(c[3], f.big.w, f.small.w);
  return f;
}

// Element (r, c) of a 16-row A operand, split, into fragment order: the
// (k step c / 8, lane) slot of `big` and `small`, each (steps, 32) uint4.
__device__ __forceinline__ void put_a(uint4* big, uint4* small, int r, int c,
                                      float x) {
  const int slot = (c >> 3) * 32 + ((r & 7) << 2) + (c & 3);
  const int reg = (r >> 3) | (((c >> 2) & 1) << 1);
  uint32_t b, s;
  split(x, b, s);
  reinterpret_cast<uint32_t*>(big + slot)[reg] = b;
  reinterpret_cast<uint32_t*>(small + slot)[reg] = s;
}

// --------------------------------------------------------------------------
// cp.async staging
// --------------------------------------------------------------------------
// rows [r0, r0 + nrows) of a (S, D) slab into a (nrows, DT + 4) tile, as
// 16-byte copies where `vec` (D % 4 == 0, 16-byte aligned slab), else 4-byte
// ones; zero-filled past S and past D
template <int DT, int NTH>
__device__ __forceinline__ void async_tile(float* dst, const float* src,
                                           int r0, int nrows, int S, int D,
                                           bool vec) {
  constexpr int LD = DT + 4;
  if (vec) {
    for (int e = threadIdx.x; e < nrows * (DT / 4); e += NTH) {
      const int rr = e / (DT / 4), c = (e % (DT / 4)) * 4;
      const bool ok = r0 + rr < S && c < D;
      cp_async16(dst + rr * LD + c, ok ? src + (size_t)(r0 + rr) * D + c : src,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * DT; e += NTH) {
      const int rr = e / DT, c = e % DT;
      const bool ok = r0 + rr < S && c < D;
      cp_async4(dst + rr * LD + c, ok ? src + (size_t)(r0 + rr) * D + c : src,
                ok);
    }
  }
}

// [n0, n0 + n) of a length-S row into dst, zero-filled past S
template <int NTH>
__device__ __forceinline__ void async_row(float* dst, const float* src,
                                          int n0, int n, int S) {
  for (int e = threadIdx.x; e < n; e += NTH) {
    const bool ok = n0 + e < S;
    cp_async4(dst + e, ok ? src + n0 + e : src, ok);
  }
}

// 16 rows of a (S, D) slab from row r0, times mul, split into fragment
// order (the 16-row A operand), zero past S and D, by threads [0, NTH):
// four columns a load (one 16-byte load where `vec`), eight loads in
// flight a thread
template <int DT, int NTH>
__device__ __forceinline__ void load_frag_rows(uint4* big, uint4* small,
                                               const float* src, int r0,
                                               int S, int D, float mul,
                                               int tid, bool vec) {
  constexpr int N4 = 16 * DT / 4, ITER = (N4 + NTH - 1) / NTH, BATCH = 8;
  #pragma unroll
  for (int i0 = 0; i0 < ITER; i0 += BATCH) {
    float4 x[BATCH];
    #pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = tid + (i0 + j) * NTH;
      const int r = e / (DT / 4), c = (e % (DT / 4)) * 4;
      x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + j >= ITER || e >= N4 || r0 + r >= S) continue;
      const float* row = src + (size_t)(r0 + r) * D;
      if (vec) {
        if (c < D) x[j] = __ldg(reinterpret_cast<const float4*>(row + c));
      } else {
        if (c < D) x[j].x = row[c];
        if (c + 1 < D) x[j].y = row[c + 1];
        if (c + 2 < D) x[j].z = row[c + 2];
        if (c + 3 < D) x[j].w = row[c + 3];
      }
    }
    #pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = tid + (i0 + j) * NTH;
      if (i0 + j >= ITER || e >= N4) continue;
      const int r = e / (DT / 4), c = (e % (DT / 4)) * 4;
      put_a(big, small, r, c, x[j].x * mul);
      put_a(big, small, r, c + 1, x[j].y * mul);
      put_a(big, small, r, c + 2, x[j].z * mul);
      put_a(big, small, r, c + 3, x[j].w * mul);
    }
  }
}

// --------------------------------------------------------------------------
// flash_fwd: 3xTF32 tensor cores, FlashAttention-2 layout
// --------------------------------------------------------------------------
constexpr int FWD_TILES = 4;   // 16-row q tiles a block

template <int DT> struct FwdCfg {
  // warps a q tile: at D 256 two, each over half of D (S summed through
  // shared memory, O split by columns), so that O is 64 registers a thread
  static constexpr int KS = DT >= 256 ? 2 : 1;
  static constexpr int NT = 32 * FWD_TILES * KS;
  static constexpr int BKV = DT >= 128 ? 16 : 32;  // kv rows per stage
  static constexpr int LD = DT + 4;
  static constexpr int NKK = DT / 8;               // k steps over D
  static constexpr int NJ = BKV / 8;               // S column tiles
  static constexpr int NDN = DT / 8 / KS;          // O column tiles a warp
  static constexpr size_t smem() {
    return sizeof(uint4) * (2 * FWD_TILES * NKK * 32 +
                            (KS > 1 ? FWD_TILES * KS * NJ * 32 : 0)) +
           sizeof(float) * 2 * 2 * BKV * LD;
  }
};

template <int DT>
__global__ void __launch_bounds__(FwdCfg<DT>::NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int G, int Sq, int Skv, int D,
                 float scale, int causal, int window, int q_offset, int vec) {
  using C = FwdCfg<DT>;
  constexpr int KS = C::KS, NT = C::NT, BKV = C::BKV, LD = C::LD,
                NKK = C::NKK, NJ = C::NJ, NDN = C::NDN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* Qb = reinterpret_cast<uint4*>(smem_raw);   // [q tile][NKK][32]
  uint4* Qs = Qb + FWD_TILES * NKK * 32;
  float4* X = reinterpret_cast<float4*>(Qs + FWD_TILES * NKK * 32);
  // partial S: [q tile][part][NJ][32] where KS > 1
  float* KV = reinterpret_cast<float*>(
      X + (KS > 1 ? FWD_TILES * KS * NJ * 32 : 0));
  // stage st: K at KV + st * 2 * BKV * LD, V right after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp % FWD_TILES, h = warp / FWD_TILES;  // q tile, part
  const int b = blockIdx.y;                         // kv head
  const int nqt = (Sq + 15) / 16, tiles = G * nqt;  // (q tile, head) pairs
  const int w0 = blockIdx.x * FWD_TILES;
  const int w_last = min(tiles, w0 + FWD_TILES) - 1;
  const int wt = w0 + slot;
  const bool active = wt < tiles;
  const int qt = active ? wt / G : 0, bh = b * G + (active ? wt % G : 0);
  const int q0 = qt * 16;                           // this warp's first row
  const int wq_start = q0 + q_offset;
  // the block's query positions, for tile skipping
  const int bq_start = (w0 / G) * 16 + q_offset;
  const int bq_len = (w_last / G) * 16 + 16 + q_offset - bq_start;
  const float* kb = k + (size_t)b * Skv * D;
  const float* vb = v + (size_t)b * Skv * D;

  uint4* qb = Qb + slot * NKK * 32;
  uint4* qs = Qs + slot * NKK * 32;

  // the reachable kv tiles form one range [ka, kz)
  const int ntiles = (Skv + BKV - 1) / BKV;
  int ka = ntiles, kz = 0;
  for (int i = 0; i < ntiles; ++i)
    if (reachable(bq_start, i * BKV, bq_len, BKV, causal, window)) {
      ka = min(ka, i);
      kz = i + 1;
    }

  float acc[NDN][4];
  #pragma unroll
  for (int n = 0; n < NDN; ++n)
    #pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};

  auto fetch = [&](int tile, int st) {
    float* Ks = KV + st * 2 * BKV * LD;
    async_tile<DT, NT>(Ks, kb, tile * BKV, BKV, Skv, D, vec);
    async_tile<DT, NT>(Ks + BKV * LD, vb, tile * BKV, BKV, Skv, D, vec);
    cp_commit();
  };
  if (ka < kz) fetch(ka, 0);
  if (active)
    load_frag_rows<DT, 32 * KS>(qb, qs, q + (size_t)bh * Sq * D, q0, Sq, D,
                                scale, h * 32 + lane, vec);
  for (int it = ka; it < kz; ++it) {
    const int st = (it - ka) & 1;
    if (it + 1 < kz) {
      fetch(it + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kv0 = it * BKV;
    const bool work = active &&
                      reachable(wq_start, kv0, 16, BKV, causal, window);
    const float* Ks = KV + st * 2 * BKV * LD;
    const float* Vs = Ks + BKV * LD;
    // S = (scale·Q) Kᵀ: 16 x BKV in NJ fragments, this warp's part of D
    float s[NJ][4];
    #pragma unroll
    for (int j = 0; j < NJ; ++j)
      #pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    if (work) {
      #pragma unroll 4
      for (int kk = h * NKK / KS; kk < (h + 1) * NKK / KS; ++kk) {
        const FragA a = {qb[kk * 32 + lane], qs[kk * 32 + lane]};
        #pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma3(s[j], a, frag_b_rows<LD>(Ks, 8 * j, 8 * kk, g, t, 1.f));
      }
    }
    if constexpr (KS > 1) {         // S = part 0 + part 1, in both warps
      float4* xs = X + slot * KS * NJ * 32;
      if (work) {
        #pragma unroll
        for (int j = 0; j < NJ; ++j)
          xs[(h * NJ + j) * 32 + lane] =
              make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      }
      __syncthreads();
      if (work) {
        #pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 o4 = xs[((h ^ 1) * NJ + j) * 32 + lane];
          s[j][0] += o4.x; s[j][1] += o4.y; s[j][2] += o4.z; s[j][3] += o4.w;
        }
      }
    }
    if (work) {
      // mask, then the online softmax over rows g (c 0, 1) and g+8 (c 2, 3)
      float mx[2] = {NEG_INF, NEG_INF};
      #pragma unroll
      for (int j = 0; j < NJ; ++j)
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kvpos = kv0 + 8 * j + 2 * t + (i & 1);
          const int qpos = wq_start + g + 8 * (i >> 1);
          float x = s[j][i];
          if (kvpos >= Skv) x = -INFINITY;
          else if (masked(qpos, kvpos, causal, window)) x = NEG_INF;
          s[j][i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_i[r], quad_max(mx[r]));
        alpha[r] = expf(m_i[r] - m_new);
        m_i[r] = m_new;
      }
      FragA p[NJ];
      #pragma unroll
      for (int j = 0; j < NJ; ++j) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = expf(s[j][i] - m_i[i >> 1]);
          psum[i >> 1] += s[j][i];
        }
        p[j] = frag_a_from_c(s[j]);
      }
      #pragma unroll
      for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + quad_sum(psum[r]);
      // O = O·alpha + P V over this warp's columns of D
      #pragma unroll
      for (int n = 0; n < NDN; ++n) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
        #pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma3(acc[n], p[j],
               frag_b_pairs<LD>(Vs, 8 * j, 8 * (h * NDN + n), g, t));
      }
    }
    __syncthreads();                 // this stage is refilled next
  }

  if (!active) return;
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gq = q0 + g + 8 * r;
    if (gq >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l_i[r], 1e-30f);
    float* ob = o + ((size_t)bh * Sq + gq) * D;
    #pragma unroll
    for (int n = 0; n < NDN; ++n)
      #pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * (h * NDN + n) + 2 * t + c;
        if (d < D) ob[d] = acc[n][2 * r + c] * inv_l;
      }
    if (t == 0 && h == 0) lse[(size_t)bh * Sq + gq] = m_i[r] + logf(fmaxf(l_i[r], 1e-30f));
  }
}

// --------------------------------------------------------------------------
// flash_dq: 3xTF32 tensor cores, flash_fwd's layout
// --------------------------------------------------------------------------
// x split into an A fragment's element, behind an empty asm the compiler
// must assume changes it: the split of a register that no kv tile changes
// stays inside the kv loop (hoisted out of it, the split fragments of Q
// and dO would hold twice the registers of the unsplit ones)
__device__ __forceinline__ void split_here(float x, uint32_t& big,
                                          uint32_t& small) {
  asm volatile("" : "+f"(x));
  split_fast(x, big, small);
}

template <int DT> struct DqCfg {
  // each warp owns DW columns of D: its k steps of S and dP, its columns
  // of dQ; KS warps a q tile, S and dP partials summed through shared
  // memory.  Chosen on the H100 from ptxas -v and CUDA-event times: at
  // D 256, 64 columns (255 registers, one block of 8 warps an SM) ran
  // faster than 32 at two blocks an SM (128 registers); below 256, 64
  // columns spill and 32 do not; at D 64, two blocks an SM cost nothing
  static constexpr int DW = DT >= 256 ? 64 : 32;
  static constexpr int MINB = DT == 64 ? 2 : 1;    // blocks an SM
  static constexpr int KS = DT / DW;
  static constexpr int TILES = KS <= 2 ? 4 : 8 / KS;  // 16-row q tiles a block
  static constexpr int NT = 32 * TILES * KS;
  static constexpr int BKV = 16;                   // kv rows per stage
  static constexpr int LD = DT + 4;
  static constexpr int NKW = DW / 8;   // k steps of S, dP; dQ column tiles
  static constexpr int NJ = BKV / 8;   // S column tiles, k steps of dQ
  static constexpr size_t smem() {
    return sizeof(float4) * (KS > 1 ? TILES * KS * NJ * 2 * 32 : 0) +
           sizeof(float) * 2 * 2 * BKV * LD;
  }
};

template <int DT>
__global__ void __launch_bounds__(DqCfg<DT>::NT, DqCfg<DT>::MINB)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                float* __restrict__ dq, int G, int Sq, int Skv, int D,
                float scale, int causal, int window, int q_offset, int vec) {
  using C = DqCfg<DT>;
  constexpr int KS = C::KS, TILES = C::TILES, NT = C::NT, BKV = C::BKV,
                LD = C::LD, NKW = C::NKW, NJ = C::NJ, DW = C::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // partial S and dP: [q tile][part][NJ][S, dP][32] where KS > 1
  float4* X = reinterpret_cast<float4*>(smem_raw);
  float* KV = reinterpret_cast<float*>(
      X + (KS > 1 ? TILES * KS * NJ * 2 * 32 : 0));
  // stage st: K at KV + st * 2 * BKV * LD, V right after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp % TILES, h = warp / TILES;  // q tile, part of D
  const int d0 = h * DW;                            // this warp's columns
  const int b = blockIdx.y;                         // kv head
  const int nqt = (Sq + 15) / 16, tiles = G * nqt;  // (q tile, head) pairs
  const int w0 = blockIdx.x * TILES;
  const int w_last = min(tiles, w0 + TILES) - 1;
  const int wt = w0 + slot;
  const bool active = wt < tiles;
  const int qt = active ? wt / G : 0, bh = b * G + (active ? wt % G : 0);
  const int q0 = qt * 16;                           // this warp's first row
  const int wq_start = q0 + q_offset;
  const int bq_start = (w0 / G) * 16 + q_offset;
  const int bq_len = (w_last / G) * 16 + 16 + q_offset - bq_start;
  const float* kb = k + (size_t)b * Skv * D;
  const float* vb = v + (size_t)b * Skv * D;

  const int ntiles = (Skv + BKV - 1) / BKV;
  int ka = ntiles, kz = 0;
  for (int i = 0; i < ntiles; ++i)
    if (reachable(bq_start, i * BKV, bq_len, BKV, causal, window)) {
      ka = min(ka, i);
      kz = i + 1;
    }

  auto fetch = [&](int tile, int st) {
    float* Ks = KV + st * 2 * BKV * LD;
    async_tile<DT, NT>(Ks, kb, tile * BKV, BKV, Skv, D, vec);
    async_tile<DT, NT>(Ks + BKV * LD, vb, tile * BKV, BKV, Skv, D, vec);
    cp_commit();
  };
  if (ka < kz) fetch(ka, 0);

  // this warp's A fragments of scale·Q and dO over its columns, unsplit
  // (rows g, g+8; columns t, t+4 of each step of 8), and rows g, g+8's
  // lse and D
  float4 qf[NKW], df[NKW];
  float lse_r[2] = {0.f, 0.f}, dd_r[2] = {0.f, 0.f};
  {
    const size_t base = (size_t)bh * Sq * D;
    #pragma unroll
    for (int kk = 0; kk < NKW; ++kk) {
      float a[2][4];
      #pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float* src = w ? dout : q;
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + g + 8 * (i & 1);
          const int col = d0 + 8 * kk + t + 4 * (i >> 1);
          a[w][i] = (active && row < Sq && col < D)
                        ? __ldg(src + base + (size_t)row * D + col) : 0.f;
        }
      }
      qf[kk] = make_float4(a[0][0] * scale, a[0][1] * scale, a[0][2] * scale,
                           a[0][3] * scale);
      df[kk] = make_float4(a[1][0], a[1][1], a[1][2], a[1][3]);
    }
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (active && row < Sq) {
        lse_r[r] = lse[(size_t)bh * Sq + row];
        dd_r[r] = dd[(size_t)bh * Sq + row];
      }
    }
  }

  float acc[NKW][4];
  #pragma unroll
  for (int n = 0; n < NKW; ++n)
    #pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = ka; it < kz; ++it) {
    const int st = (it - ka) & 1;
    if (it + 1 < kz) {
      fetch(it + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kv0 = it * BKV;
    const bool work = active &&
                      reachable(wq_start, kv0, 16, BKV, causal, window);
    const float* Ks = KV + st * 2 * BKV * LD;
    const float* Vs = Ks + BKV * LD;
    // S = (scale·Q) Kᵀ and dP = dO Vᵀ over this warp's columns of D
    float s[NJ][4], dp[NJ][4];
    #pragma unroll
    for (int j = 0; j < NJ; ++j)
      #pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    if (work) {
      #pragma unroll
      for (int kk = 0; kk < NKW; ++kk) {
        FragA aq, ad;
        split_here(qf[kk].x, aq.big.x, aq.small.x);
        split_here(qf[kk].y, aq.big.y, aq.small.y);
        split_here(qf[kk].z, aq.big.z, aq.small.z);
        split_here(qf[kk].w, aq.big.w, aq.small.w);
        split_here(df[kk].x, ad.big.x, ad.small.x);
        split_here(df[kk].y, ad.big.y, ad.small.y);
        split_here(df[kk].z, ad.big.z, ad.small.z);
        split_here(df[kk].w, ad.big.w, ad.small.w);
        #pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma3(s[j], aq, frag_b_rows<LD>(Ks, 8 * j, d0 + 8 * kk, g, t, 1.f));
          mma3(dp[j], ad, frag_b_rows<LD>(Vs, 8 * j, d0 + 8 * kk, g, t, 1.f));
        }
      }
    }
    if constexpr (KS > 1) {
      // S and dP = part 0 + part 1 + ..., in that order in every warp of
      // the q tile (the same bits in all)
      float4* xs = X + slot * KS * NJ * 2 * 32;
      if (work) {
        #pragma unroll
        for (int j = 0; j < NJ; ++j) {
          xs[((h * NJ + j) * 2) * 32 + lane] =
              make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
          xs[((h * NJ + j) * 2 + 1) * 32 + lane] =
              make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
        }
      }
      __syncthreads();
      if (work) {
        #pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float4 a = xs[(j * 2) * 32 + lane], c = xs[(j * 2 + 1) * 32 + lane];
          #pragma unroll
          for (int part = 1; part < KS; ++part) {
            const float4 a2 = xs[((part * NJ + j) * 2) * 32 + lane];
            const float4 c2 = xs[((part * NJ + j) * 2 + 1) * 32 + lane];
            a.x += a2.x; a.y += a2.y; a.z += a2.z; a.w += a2.w;
            c.x += c2.x; c.y += c2.y; c.z += c2.z; c.w += c2.w;
          }
          s[j][0] = a.x; s[j][1] = a.y; s[j][2] = a.z; s[j][3] = a.w;
          dp[j][0] = c.x; dp[j][1] = c.y; dp[j][2] = c.z; dp[j][3] = c.w;
        }
      }
    }
    if (work) {
      // dS = P∘(dP − D), P = exp(S − lse) and 0 where masked; then dQ +=
      // dS·K over this warp's columns (dS's C fragment read as the A
      // fragment, K's rows in the same order)
      #pragma unroll
      for (int j = 0; j < NJ; ++j) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kvpos = kv0 + 8 * j + 2 * t + (i & 1);
          const int qpos = wq_start + g + 8 * (i >> 1);
          const bool ok = kvpos < Skv && !masked(qpos, kvpos, causal, window);
          const float p = ok ? expf(s[j][i] - lse_r[i >> 1]) : 0.f;
          s[j][i] = p * (dp[j][i] - dd_r[i >> 1]);
        }
        const FragA a = frag_a_from_c(s[j]);
        #pragma unroll
        for (int n = 0; n < NKW; ++n)
          mma3(acc[n], a, frag_b_pairs<LD>(Ks, 8 * j, d0 + 8 * n, g, t));
      }
    }
    __syncthreads();                 // this stage is refilled next
  }

  if (!active) return;
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gq = q0 + g + 8 * r;
    if (gq >= Sq) continue;
    float* out = dq + ((size_t)bh * Sq + gq) * D;
    #pragma unroll
    for (int n = 0; n < NKW; ++n)
      #pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = d0 + 8 * n + 2 * t + c;
        if (d < D) out[d] = acc[n][2 * r + c] * scale;
      }
  }
}

// --------------------------------------------------------------------------
// flash_dkv: 3xTF32 tensor cores, the GQA group split over blocks
// --------------------------------------------------------------------------
constexpr int DKV_WARPS = 8;
constexpr int DKV_NT = 32 * DKV_WARPS;
constexpr int DKV_BKV = 16;    // kv rows per block (one fragment of rows)
constexpr int DKV_BQ = 32;     // q rows per step
constexpr int DKV_NQ = DKV_BQ / 8;   // q column tiles of Sᵀ, k steps of dV
constexpr int DKV_PER_SM = 2;  // blocks an SM the head chunks aim for

template <int DT> struct DkvCfg {
  static constexpr int LD = DT + 4;
  static constexpr int NKK = DT / 8;           // k steps over D
  static constexpr int NKH = NKK / 2;          // per half of D
  static constexpr int NDN = DT / 8 / 4;       // dK/dV column tiles a warp
  static constexpr size_t smem() {
    return sizeof(uint4) * (4 * NKK * 32       // K, V: big and small
                            + 4 * DKV_NQ * 32  // P, dS: big and small
                            + 2 * DKV_NQ * 32) // partial S, dP (as float4)
           + sizeof(float) * (2 * 2 * DKV_BQ * LD + 2 * 2 * DKV_BQ);
  }
};

template <int DT>
__global__ void __launch_bounds__(DKV_NT)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ ws, int BKVH, int G, int Sq, int Skv,
                 int D, float scale, int causal, int window, int q_offset,
                 int vec) {
  using C = DkvCfg<DT>;
  constexpr int LD = C::LD, NKK = C::NKK, NKH = C::NKH, NDN = C::NDN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* Kb = reinterpret_cast<uint4*>(smem_raw);   // [NKK][32]
  uint4* Ksm = Kb + NKK * 32;
  uint4* Vb = Ksm + NKK * 32;
  uint4* Vsm = Vb + NKK * 32;
  uint4* Pb = Vsm + NKK * 32;                        // [DKV_NQ][32]
  uint4* Psm = Pb + DKV_NQ * 32;
  uint4* Db = Psm + DKV_NQ * 32;
  uint4* Dsm = Db + DKV_NQ * 32;
  float4* Xs = reinterpret_cast<float4*>(Dsm + DKV_NQ * 32);  // partial S
  float4* Xp = Xs + DKV_NQ * 32;                              // partial dP
  float* QD = reinterpret_cast<float*>(Xp + DKV_NQ * 32);
  // stage st: Q at QD + st * 2 * BQ * LD, dO right after it
  float* RW = QD + 2 * 2 * DKV_BQ * LD;
  // stage st: lse at RW + st * 2 * BQ, D right after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * DKV_BKV;
  const int b = blockIdx.y;                 // kv head
  const int nc = gridDim.z, c = blockIdx.z; // head chunk
  const int g0 = c * G / nc, g1 = (c + 1) * G / nc;
  const size_t kvoff = (size_t)b * Skv * D;

  // the reachable q tiles form one range [qa, qz)
  const int nqt = (Sq + DKV_BQ - 1) / DKV_BQ;
  int qa = nqt, qz = 0;
  for (int i = 0; i < nqt; ++i)
    if (reachable(i * DKV_BQ + q_offset, kv0, DKV_BQ, DKV_BKV, causal,
                  window)) {
      qa = min(qa, i);
      qz = i + 1;
    }
  const int per_head = max(qz - qa, 0);
  const int steps = (g1 - g0) * per_head;

  float acc[NDN][4];
  #pragma unroll
  for (int n = 0; n < NDN; ++n)
    #pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  auto fetch = [&](int step, int st) {
    const int bh = b * G + g0 + step / per_head;
    const int qt0 = (qa + step % per_head) * DKV_BQ;
    const size_t qoff = (size_t)bh * Sq * D;
    float* Qs = QD + st * 2 * DKV_BQ * LD;
    float* R = RW + st * 2 * DKV_BQ;
    async_tile<DT, DKV_NT>(Qs, q + qoff, qt0, DKV_BQ, Sq, D, vec);
    async_tile<DT, DKV_NT>(Qs + DKV_BQ * LD, dout + qoff, qt0, DKV_BQ, Sq, D,
                           vec);
    async_row<DKV_NT>(R, lse + (size_t)bh * Sq, qt0, DKV_BQ, Sq);
    async_row<DKV_NT>(R + DKV_BQ, dd + (size_t)bh * Sq, qt0, DKV_BQ, Sq);
    cp_commit();
  };

  // phase 1: warp w forms the (16 kv x 8 q) tile nq = w % 4 of Sᵀ and dPᵀ
  // over half h = w / 4 of D; phase 2: warps 0-3 add to dV, 4-7 to dK,
  // columns 8 (w % 4 + 4 n)
  const int nq = warp & 3, h = warp >> 2;
  if (steps > 0) fetch(0, 0);
  // K and V of this kv tile, split into fragment order, once
  load_frag_rows<DT, DKV_NT>(Kb, Ksm, k + kvoff, kv0, Skv, D, 1.f,
                             threadIdx.x, vec);
  load_frag_rows<DT, DKV_NT>(Vb, Vsm, v + kvoff, kv0, Skv, D, 1.f,
                             threadIdx.x, vec);
  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    if (step + 1 < steps) {
      fetch(step + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                // K/V fragments and this stage landed
    const float* Qs = QD + st * 2 * DKV_BQ * LD;
    const float* dOs = Qs + DKV_BQ * LD;
    const float* R = RW + st * 2 * DKV_BQ;
    const int qt0 = (qa + step % per_head) * DKV_BQ;

    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    #pragma unroll 4
    for (int kk = h * NKH; kk < (h + 1) * NKH; ++kk) {
      const FragA ak = {Kb[kk * 32 + lane], Ksm[kk * 32 + lane]};
      const FragA av = {Vb[kk * 32 + lane], Vsm[kk * 32 + lane]};
      mma3(s, ak, frag_b_rows<LD>(Qs, 8 * nq, 8 * kk, g, t, scale));
      mma3(dp, av, frag_b_rows<LD>(dOs, 8 * nq, 8 * kk, g, t, 1.f));
    }
    if (h == 1) {
      Xs[nq * 32 + lane] = make_float4(s[0], s[1], s[2], s[3]);
      Xp[nq * 32 + lane] = make_float4(dp[0], dp[1], dp[2], dp[3]);
    }
    __syncthreads();
    if (h == 0) {
      const float4 xs = Xs[nq * 32 + lane], xp = Xp[nq * 32 + lane];
      s[0] += xs.x; s[1] += xs.y; s[2] += xs.z; s[3] += xs.w;
      dp[0] += xp.x; dp[1] += xp.y; dp[2] += xp.z; dp[3] += xp.w;
      float p[4], ds[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kvpos = kv0 + g + 8 * (i >> 1);
        const int ql = 8 * nq + 2 * t + (i & 1);
        const bool ok = kvpos < Skv && qt0 + ql < Sq &&
                        !masked(qt0 + ql + q_offset, kvpos, causal, window);
        p[i] = ok ? expf(s[i] - R[ql]) : 0.f;
        ds[i] = p[i] * (dp[i] - R[DKV_BQ + ql]);
      }
      const FragA fp = frag_a_from_c(p), fd = frag_a_from_c(ds);
      Pb[nq * 32 + lane] = fp.big;
      Psm[nq * 32 + lane] = fp.small;
      Db[nq * 32 + lane] = fd.big;
      Dsm[nq * 32 + lane] = fd.small;
    }
    __syncthreads();
    // dV += Pᵀ·dO (warps 0-3), dK += dSᵀ·Q (warps 4-7)
    const uint4* Ab = h ? Db : Pb;
    const uint4* As = h ? Dsm : Psm;
    const float* Bsrc = h ? Qs : dOs;
    #pragma unroll
    for (int kq = 0; kq < DKV_NQ; ++kq) {
      const FragA a = {Ab[kq * 32 + lane], As[kq * 32 + lane]};
      #pragma unroll
      for (int n = 0; n < NDN; ++n)
        mma3(acc[n], a, frag_b_pairs<LD>(Bsrc, 8 * kq, 8 * (nq + 4 * n), g, t));
    }
    __syncthreads();                // this stage is refilled next
  }

  // dV (h 0) or dK (h 1): (kv g, d 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
  float* out;
  float mul = 1.f;
  if (nc == 1) {
    out = (h ? dk : dv) + kvoff;
    mul = h ? scale : 1.f;
  } else {
    out = ws + ((size_t)(h * nc + c) * BKVH + b) * Skv * D;
  }
  #pragma unroll
  for (int n = 0; n < NDN; ++n)
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kvpos = kv0 + g + 8 * (i >> 1);
      const int d = 8 * (nq + 4 * n) + 2 * t + (i & 1);
      if (kvpos < Skv && d < D) out[(size_t)kvpos * D + d] = acc[n][i] * mul;
    }
}

// dv = Σ_c ws[0][c], dk = scale · Σ_c ws[1][c], chunks c in order
__global__ void dkv_sum_kernel(const float* __restrict__ ws,
                               float* __restrict__ dk, float* __restrict__ dv,
                               size_t n, int nc, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float sv = ws[i], sk = ws[(size_t)nc * n + i];
    for (int c = 1; c < nc; ++c) {
      sv += ws[(size_t)c * n + i];
      sk += ws[(size_t)(nc + c) * n + i];
    }
    dv[i] = sv;
    dk[i] = sk * scale;
  }
}

int sm_count() {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  return sms;
}

// head chunks of the dkv grid: enough blocks for DKV_PER_SM on every SM,
// at most one chunk a head
int dkv_chunks(int BKVH, int G, int Skv) {
  const long base = (long)((Skv + DKV_BKV - 1) / DKV_BKV) * BKVH;
  const long want = ((long)DKV_PER_SM * sm_count() + base - 1) / base;
  return (int)(want < 1 ? 1 : (want > G ? G : want));
}

// Kernels above 48 KB of dynamic shared memory must opt in once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// 16-byte copies need D % 4 == 0 and 16-byte aligned tensors
bool vec_ok(int D, const void* a, const void* b, const void* c,
            const void* d = nullptr) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                         (uintptr_t)d;
  return D % 4 == 0 && (bits & 15) == 0;
}

template <int DT>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int BH, int BKVH, int G, int Sq, int Skv, int D,
               float scale, int causal, int window, int q_offset,
               cudaStream_t s) {
  const size_t smem = FwdCfg<DT>::smem();
  cudaError_t err = allow_smem(flash_fwd_kernel<DT>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = G * ((Sq + 15) / 16);
  const dim3 grid((tiles + FWD_TILES - 1) / FWD_TILES, BKVH);
  flash_fwd_kernel<DT><<<grid, FwdCfg<DT>::NT, smem, s>>>(
      q, k, v, o, lse, G, Sq, Skv, D, scale, causal, window, q_offset,
      (int)vec_ok(D, q, k, v));
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* dd, float* dq,
              int BKVH, int G, int Sq, int Skv, int D, float scale, int causal,
              int window, int q_offset, cudaStream_t s) {
  using C = DqCfg<DT>;
  const size_t smem = C::smem();
  cudaError_t err = allow_smem(flash_dq_kernel<DT>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = G * ((Sq + 15) / 16);
  const dim3 grid((tiles + C::TILES - 1) / C::TILES, BKVH);
  flash_dq_kernel<DT><<<grid, C::NT, smem, s>>>(
      q, k, v, dout, lse, dd, dq, G, Sq, Skv, D, scale, causal, window,
      q_offset, (int)vec_ok(D, k, v, k));
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* dd,
               float* dk, float* dv, float* ws, int BKVH, int G, int Sq,
               int Skv, int D, float scale, int causal, int window,
               int q_offset, cudaStream_t s) {
  const size_t smem = DkvCfg<DT>::smem();
  cudaError_t err = allow_smem(flash_dkv_kernel<DT>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = dkv_chunks(BKVH, G, Skv);
  if (nc > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((Skv + DKV_BKV - 1) / DKV_BKV, BKVH, nc);
  flash_dkv_kernel<DT><<<grid, DKV_NT, smem, s>>>(
      q, k, v, dout, lse, dd, dk, dv, ws, BKVH, G, Sq, Skv, D, scale, causal,
      window, q_offset, (int)vec_ok(D, q, k, v, dout));
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return (int)err;
  const size_t n = (size_t)BKVH * Skv * D;
  const size_t need = (n + 255) / 256;
  const size_t most = (size_t)4 * sm_count();
  dkv_sum_kernel<<<(int)(need < most ? need : most), 256, 0, s>>>(
      ws, dk, dv, n, nc, scale);
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
    return launch_fwd<32>(q, k, v, o, lse, BH, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 64)
    return launch_fwd<64>(q, k, v, o, lse, BH, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 128)
    return launch_fwd<128>(q, k, v, o, lse, BH, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  return launch_fwd<256>(q, k, v, o, lse, BH, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
}

int flash_dq(const float* q, const float* k, const float* v,
             const float* dout, const float* lse, const float* dd, float* dq,
             int BH, int BKVH, int Sq, int Skv, int D, float scale,
             int causal, int window, int q_offset, void* stream) {
  if (!valid(BH, BKVH, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const int G = BH / BKVH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dq<32>(q, k, v, dout, lse, dd, dq, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 64)
    return launch_dq<64>(q, k, v, dout, lse, dd, dq, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 128)
    return launch_dq<128>(q, k, v, dout, lse, dd, dq, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  return launch_dq<256>(q, k, v, dout, lse, dd, dq, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
}

// The number of head chunks flash_dkv splits each GQA group into: with
// more than one it needs a (2, chunks, BKVH, Skv, D) fp32 workspace.
int flash_dkv_chunks(int BH, int BKVH, int Skv) {
  if (BH <= 0 || BKVH <= 0 || BH % BKVH || Skv <= 0) return 0;
  return dkv_chunks(BKVH, BH / BKVH, Skv);
}

int flash_dkv(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* dd,
              float* dk, float* dv, float* ws, int BH, int BKVH, int Sq,
              int Skv, int D, float scale, int causal, int window,
              int q_offset, void* stream) {
  if (!valid(BH, BKVH, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const int G = BH / BKVH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dkv<32>(q, k, v, dout, lse, dd, dk, dv, ws, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, dd, dk, dv, ws, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  if (D <= 128)
    return launch_dkv<128>(q, k, v, dout, lse, dd, dk, dv, ws, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
  return launch_dkv<256>(q, k, v, dout, lse, dd, dk, dv, ws, BKVH, G, Sq, Skv, D, scale, causal, window, q_offset, s);
}

}  // extern "C"
