// An empty kernel: what one more launch on the stream costs the card, the
// floor under the time of every CUDA C++ kernel of the port (launched by the
// same route: nvcc, a plain C interface, ctypes).  chip_smoke.py times it
// back to back beside each kernel's bound; no solver calls it.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int floor_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
