// An empty kernel for Hopper (sm_90a): the launch floor's yardstick.
//
// Replaces no TPU kernel and runs on no path.  chip_smoke.py times it
// eager, inside a CUDA graph (a launch among others) and as a graph of
// its own (a bare graph launch), and prints those floors beside the
// bounds of the kernels whose work is under them: no kernel of the port
// can take less time than its launch.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// One block of 32 threads that does nothing, on `stream`.
int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
