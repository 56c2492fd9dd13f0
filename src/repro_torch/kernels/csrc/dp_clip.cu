// DP-SGD clip-scale-accumulate kernels for Hopper (sm_90a).
//
// Replace the two TPU kernels of src/repro/kernels/dp_clip.py
// (dp_clip_mean_rows), which together turn a client's stacked
// per-example gradients g (B, P) fp32 into the mean of the rows clipped to
// L2 norm C:
//
//   * dp_clip_norms <- _norm_kernel: the squared norm of every row,
//       sq[b] = sum_p g[b, p]^2, accumulated in fp32;
//   * dp_clip_acc   <- _clip_acc_kernel: out[p] = (1/B) * sum_b g[b, p] *
//       min(1, C / max(sqrt(sq[b]), eps)), summed over b in order.
//   * dp_clip_acc_clients <- _clip_acc_kernel under the vmap over clients
//       of the spmd backend's stacked DP-SGD step: g (C, B, P), sq (C, B)
//       -> out (C, P), client c on grid row c, each client's output the
//       bits of the one-client launch on its rows (the same kernel: a
//       one-client launch is its grid row 0).
//
// What bounds them on this card: each reads g once (B*P*4 bytes) and does
// two operations per element, far below the ridge, so the bound is bytes:
// at the main path's (16, 442368) g is 28.3 MB, 0.0085 ms at 3.35 TB/s
// for each pass.  28.3 MB fits in the 50 MB L2, so the second pass may
// find g there.  With the spmd backend's client axis, (3, 16, 442368), g
// is 84.9 MB, 0.025 ms a pass, and the L2 no longer holds it.
//
// The design, for a card whose blocks run in parallel and in no order (the
// TPU's kernels carry the norms across a sequential grid instead):
//
//   * norms: one launch, one thread-block cluster of NORM_CLUSTER blocks a
//     row (grid (NORM_CLUSTER, B)), no scratch.  Block c sums the c-th
//     contiguous share of its row (a multiple of 4 floats) with float4
//     loads where the row allows them (P a multiple of 4 and a 16-byte
//     aligned base), NORM_UNROLL loads in flight a thread, each thread in
//     its own fixed order, then the block's warps butterfly and add in
//     warp order; after a cluster barrier block 0 reads the cluster's
//     partial sums from the other blocks' shared memory in rank order and
//     writes sq[row]; a second barrier keeps every block's shared memory
//     alive until then.  No atomics and no counter: the same bits on every
//     run and every CUDA-graph replay.  At the main path's B = 16 the grid
//     is 128 blocks of 512 threads, 32 KB of loads in flight on each SM;
//     one launch and one allocation a call keep an eager call's host time
//     near the device time.
//   * clip-accumulate: a 1-D grid over columns (4 per thread with float4);
//     every block first computes the B scales into dynamic shared memory
//     with IEEE division and sqrtf (no fast math), then each thread
//     reduces its columns over b = 0..B-1 in order and multiplies by 1/B.
//
// Ragged widths are masked (the scalar path handles any P).  eps is the
// caller's (repro_torch/optim/clip.EPS), so host, plain twin and kernel use
// one value.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int MAX_B = 12288;       // B scales in at most 48 KB of shared memory

constexpr int NORM_CLUSTER = 8;    // blocks a row: one cluster (portable)
constexpr int NORM_THREADS = 512;  // threads a norm block
constexpr int NORM_UNROLL = 4;     // loads in flight a thread

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the block's sum, in a fixed order (warp butterflies, then warps in order)
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[THREADS / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;                         // valid in thread 0 only
}

__device__ __forceinline__ float sq4(float acc, float4 v) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  return fmaf(v.w, v.w, acc);
}

// sq[row] for row = blockIdx.y; block c = blockIdx.x (its rank in the
// cluster) sums elements [c·share, (c+1)·share) ∩ [0, P) of the row;
// share is a multiple of 4
template <bool VEC>
__global__ void __cluster_dims__(NORM_CLUSTER, 1, 1)
__launch_bounds__(NORM_THREADS)
norm_kernel(const float* __restrict__ G, float* __restrict__ sq, int P,
            int share) {
  namespace cg = cooperative_groups;
  __shared__ float part;
  const float* g = G + (size_t)blockIdx.y * P;
  const int start = min(P, (int)blockIdx.x * share);
  const int end = min(P, start + share);
  constexpr int STEP = NORM_UNROLL * NORM_THREADS;
  float acc = 0.f;
  if constexpr (VEC) {
    // P, share and start are multiples of 4: whole float4s only
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int e4 = end / 4;
    int i = start / 4 + threadIdx.x;
    for (; i + (NORM_UNROLL - 1) * NORM_THREADS < e4; i += STEP) {
      float4 v[NORM_UNROLL];
      #pragma unroll
      for (int u = 0; u < NORM_UNROLL; ++u)
        v[u] = __ldg(g4 + i + u * NORM_THREADS);
      #pragma unroll
      for (int u = 0; u < NORM_UNROLL; ++u) acc = sq4(acc, v[u]);
    }
    for (; i < e4; i += NORM_THREADS) acc = sq4(acc, __ldg(g4 + i));
  } else {
    int j = start + threadIdx.x;
    for (; j + (NORM_UNROLL - 1) * NORM_THREADS < end; j += STEP) {
      float v[NORM_UNROLL];
      #pragma unroll
      for (int u = 0; u < NORM_UNROLL; ++u)
        v[u] = __ldg(g + j + u * NORM_THREADS);
      #pragma unroll
      for (int u = 0; u < NORM_UNROLL; ++u) acc = fmaf(v[u], v[u], acc);
    }
    for (; j < end; j += NORM_THREADS) {
      const float v = __ldg(g + j);
      acc = fmaf(v, v, acc);
    }
  }
  const float s = block_sum<NORM_THREADS>(acc);
  if (threadIdx.x == 0) part = s;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    float t = 0.f;
    for (int r = 0; r < NORM_CLUSTER; ++r)
      t += *cluster.map_shared_rank(&part, r);
    sq[blockIdx.y] = t;
  }
  cluster.sync();
}

// client c = blockIdx.y: its rows G[c] (B, P), norms sq[c] (B,) and
// output out[c] (P,); a one-client launch has one grid row
template <bool VEC>
__global__ void __launch_bounds__(NT)
clip_acc_kernel(const float* __restrict__ G, const float* __restrict__ sq,
                float* __restrict__ out, int B, int P, float clip, float eps,
                float inv_b) {
  extern __shared__ float scale[];   // B floats
  G += (size_t)blockIdx.y * B * P;
  sq += (size_t)blockIdx.y * B;
  out += (size_t)blockIdx.y * P;
  for (int b = threadIdx.x; b < B; b += NT)
    scale[b] = fminf(1.f, clip / fmaxf(sqrtf(sq[b]), eps));
  __syncthreads();
  if constexpr (VEC) {
    const int col4 = blockIdx.x * NT + threadIdx.x;
    if (col4 >= P / 4) return;
    const float4* g4 = reinterpret_cast<const float4*>(G);
    const size_t stride4 = (size_t)(P / 4);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < B; ++b) {
      const float4 v = g4[(size_t)b * stride4 + col4];
      const float s = scale[b];
      acc.x = fmaf(v.x, s, acc.x);
      acc.y = fmaf(v.y, s, acc.y);
      acc.z = fmaf(v.z, s, acc.z);
      acc.w = fmaf(v.w, s, acc.w);
    }
    reinterpret_cast<float4*>(out)[col4] =
        make_float4(acc.x * inv_b, acc.y * inv_b, acc.z * inv_b,
                    acc.w * inv_b);
  } else {
    const int col = blockIdx.x * NT + threadIdx.x;
    if (col >= P) return;
    float acc = 0.f;
    for (int b = 0; b < B; ++b)
      acc = fmaf(G[(size_t)b * P + col], scale[b], acc);
    out[col] = acc * inv_b;
  }
}

}  // namespace

extern "C" {

// sq fp32 (B,) from g fp32 (B, P): one launch, no scratch.  Rows are read
// as float4 where P % 4 == 0 and g is 16-byte aligned.
int dp_clip_norms(const float* g, float* sq, int B, int P, void* stream) {
  if (B <= 0 || B > 65535 || P <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (P + NORM_CLUSTER - 1) / NORM_CLUSTER;
  const int share = (per + 3) / 4 * 4;
  const dim3 grid(NORM_CLUSTER, B);
  if (P % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0)
    norm_kernel<true><<<grid, NORM_THREADS, 0, s>>>(g, sq, P, share);
  else
    norm_kernel<false><<<grid, NORM_THREADS, 0, s>>>(g, sq, P, share);
  return (int)cudaGetLastError();
}

// out fp32 (C, P): out[c] = (1/B) sum_b g[c, b] * min(1, clip /
// max(sqrt(sq[c, b]), eps)) for each of the C clients, one grid row a
// client.  vec: P % 4 == 0 and g, out 16-byte aligned (then every
// client's rows and output are too).
int dp_clip_acc_clients(const float* g, const float* sq, float* out, int C,
                        int B, int P, float clip, float eps, int vec,
                        void* stream) {
  if (C <= 0 || C > 65535 || B <= 0 || B > MAX_B || P <= 0 ||
      (vec && P % 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_b = 1.f / (float)B;
  const size_t smem = (size_t)B * sizeof(float);
  if (vec) {
    const int n = P / 4;
    clip_acc_kernel<true><<<dim3((n + NT - 1) / NT, C), NT, smem, s>>>(
        g, sq, out, B, P, clip, eps, inv_b);
  } else {
    clip_acc_kernel<false><<<dim3((P + NT - 1) / NT, C), NT, smem, s>>>(
        g, sq, out, B, P, clip, eps, inv_b);
  }
  return (int)cudaGetLastError();
}

// out fp32 (P,) = (1/B) sum_b g[b] * min(1, clip / max(sqrt(sq[b]), eps)):
// the launch of one client.  vec: P % 4 == 0 and g, out 16-byte aligned.
int dp_clip_acc(const float* g, const float* sq, float* out, int B, int P,
                float clip, float eps, int vec, void* stream) {
  return dp_clip_acc_clients(g, sq, out, 1, B, P, clip, eps, vec, stream);
}

}  // extern "C"
