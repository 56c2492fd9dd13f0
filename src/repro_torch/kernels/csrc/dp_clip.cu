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
//
// What bounds them on this card: each reads g once (B*P*4 bytes) and does
// two operations per element, far below the ridge, so the bound is bytes:
// at the main path's (16, 442368) g is 28.3 MB, 0.0085 ms at 3.35 TB/s
// for each pass.  28.3 MB fits in the 50 MB L2, so the second pass may
// find g there.
//
// The design, for a card whose blocks run in parallel and in no order (the
// TPU's kernels carry the norms across a sequential grid instead):
//
//   * norms: a grid of (chunks, B) blocks, each covering `chunk` contiguous
//     elements of one row with float4 loads where the row allows them (P a
//     multiple of 4 and a 16-byte aligned base), writing one partial sum of
//     squares; then one warp per row sums that row's partials in a fixed
//     order.  No atomics, so the result is the same on every run.
//   * clip-accumulate: a 1-D grid over columns (4 per thread with float4);
//     every block first computes the B scales into dynamic shared memory
//     with IEEE division and sqrtf (no fast math), then each thread
//     reduces its columns over b = 0..B-1 in order and multiplies by 1/B.
//
// Ragged widths are masked (the scalar path handles any P).  eps is the
// caller's (repro_torch/optim/clip.EPS), so host, plain twin and kernel use
// one value.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int MAX_B = 12288;       // B scales in at most 48 KB of shared memory

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the block's sum, in a fixed order (warp butterflies, then warps in order)
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[NT / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;                         // valid in thread 0 only
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
norm_partials_kernel(const float* __restrict__ G, float* __restrict__ part,
                     int P, int chunk, int n_chunks) {
  const int row = blockIdx.y, c = blockIdx.x;
  const float* g = G + (size_t)row * P;
  const int start = c * chunk;
  const int end = min(start + chunk, P);
  float acc = 0.f;
  if constexpr (VEC) {
    // P, chunk and start are multiples of 4: whole float4s only
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int i = start / 4 + threadIdx.x; i < end / 4; i += NT) {
      const float4 v = g4[i];
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
    }
  } else {
    for (int j = start + threadIdx.x; j < end; j += NT) {
      const float v = g[j];
      acc = fmaf(v, v, acc);
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) part[(size_t)row * n_chunks + c] = s;
}

// one warp per row: lane l sums partials l, l+32, ... in order, then a xor
// butterfly; the order depends only on n_chunks
__global__ void __launch_bounds__(NT)
norm_finish_kernel(const float* __restrict__ part, float* __restrict__ sq,
                   int B, int n_chunks) {
  const int row = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B) return;
  float acc = 0.f;
  for (int c = lane; c < n_chunks; c += 32)
    acc += part[(size_t)row * n_chunks + c];
  acc = warp_sum(acc);
  if (lane == 0) sq[row] = acc;
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
clip_acc_kernel(const float* __restrict__ G, const float* __restrict__ sq,
                float* __restrict__ out, int B, int P, float clip, float eps,
                float inv_b) {
  extern __shared__ float scale[];   // B floats
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

// sq fp32 (B,) from g fp32 (B, P); part is scratch of B * ceil(P / chunk)
// floats.  vec: P % 4 == 0, chunk % 4 == 0 and g 16-byte aligned.
int dp_clip_norms(const float* g, float* part, float* sq, int B, int P,
                  int chunk, int vec, void* stream) {
  if (B <= 0 || P <= 0 || chunk <= 0 || (vec && (P % 4 || chunk % 4)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (P + chunk - 1) / chunk;
  const dim3 grid(n_chunks, B);
  if (vec)
    norm_partials_kernel<true><<<grid, NT, 0, s>>>(g, part, P, chunk,
                                                   n_chunks);
  else
    norm_partials_kernel<false><<<grid, NT, 0, s>>>(g, part, P, chunk,
                                                    n_chunks);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int rows_per_block = NT / 32;
  norm_finish_kernel<<<(B + rows_per_block - 1) / rows_per_block, NT, 0,
                       s>>>(part, sq, B, n_chunks);
  return (int)cudaGetLastError();
}

// out fp32 (P,) = (1/B) sum_b g[b] * min(1, clip / max(sqrt(sq[b]), eps)).
// vec: P % 4 == 0 and g, out 16-byte aligned.
int dp_clip_acc(const float* g, const float* sq, float* out, int B, int P,
                float clip, float eps, int vec, void* stream) {
  if (B <= 0 || B > MAX_B || P <= 0 || (vec && P % 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_b = 1.f / (float)B;
  const size_t smem = (size_t)B * sizeof(float);
  if (vec) {
    const int n = P / 4;
    clip_acc_kernel<true><<<(n + NT - 1) / NT, NT, smem, s>>>(
        g, sq, out, B, P, clip, eps, inv_b);
  } else {
    clip_acc_kernel<false><<<(P + NT - 1) / NT, NT, smem, s>>>(
        g, sq, out, B, P, clip, eps, inv_b);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
