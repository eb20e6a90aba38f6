// Direct (time-domain) circulant matvec for Hopper (sm_90a):
//     y[b, i] = sum_j C[i, j] x[b, j],   C[i, j] = col[(i - j) mod n]
// and, with `transpose`, the same with C^T[i, j] = col[(j - i) mod n].
//
// Replaces the TPU kernel `circulant_matvec_pallas`
// (src/repro/kernels/circulant_matvec/kernel.py), which builds each (BI, BJ)
// Toeplitz tile of C from a BI+BJ-1 window of the doubled `col` and feeds it
// to the MXU.  Here the design is the paper's own GPU scheme (Algs. 4-8):
// one thread per output row, and the sensing vector shared by the block
// de-duplicated on chip.  Grid (n / BI row tiles, batch); for each column
// tile the block stages the BI+BJ-1 window of `col` that generates the
// tile, and the BJ slice of x, in shared memory; each thread accumulates
// its row in an fp32 register.
//
// Bound on the H100: operations, 2 * batch * n^2 fp32 FLOPs on the CUDA
// cores (tensor cores would mean TF32 and other numbers).  Device memory
// traffic is O(n * batch * n / BI) and small; what limits this simple
// version is shared-memory issue: every FMA reads one window element and
// one (broadcast) x element.  Register blocking over rows and columns is
// the next step, left to a later change.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int BI = 128;  // output rows per block = threads per block
constexpr int BJ = 128;  // columns per staged tile
static_assert(BI == BJ, "each thread stages one x element per tile");

__global__ void __launch_bounds__(BI)
circulant_matvec_kernel(const float* __restrict__ col, const float* __restrict__ x,
                        float* __restrict__ y, int n, int transpose) {
  __shared__ float window[BI + BJ - 1];
  __shared__ float xs[BJ];
  const int a = threadIdx.x;
  const int i0 = blockIdx.x * BI;
  const float* xb = x + static_cast<size_t>(blockIdx.y) * n;
  float acc = 0.f;
  for (int j0 = 0; j0 < n; j0 += BJ) {
    // C   tile: C[i0+a, j0+b]   = w[(BJ-1) + a - b], w[t] = col[(i0 - j0 - (BJ-1) + t) mod n]
    // C^T tile: C^T[i0+a, j0+b] = w[(BI-1) + b - a], w[t] = col[(j0 - i0 - (BI-1) + t) mod n]
    const int base = transpose ? (j0 - i0 - (BI - 1)) : (i0 - j0 - (BJ - 1));
    for (int t = a; t < BI + BJ - 1; t += BI) {
      int idx = (base + t) % n;  // base + t lies in (-n, n)
      window[t] = col[idx < 0 ? idx + n : idx];
    }
    xs[a] = xb[j0 + a];
    __syncthreads();
    if (!transpose) {
#pragma unroll 16
      for (int b = 0; b < BJ; ++b) acc = fmaf(window[(BJ - 1) + a - b], xs[b], acc);
    } else {
#pragma unroll 16
      for (int b = 0; b < BJ; ++b) acc = fmaf(window[(BI - 1) + b - a], xs[b], acc);
    }
    __syncthreads();
  }
  y[static_cast<size_t>(blockIdx.y) * n + i0 + a] = acc;
}

}  // namespace

extern "C" int circulant_matvec_f32(const float* col, const float* x, float* y, int n,
                                    int batch, int transpose, void* stream) {
  const dim3 grid(n / BI, batch);
  circulant_matvec_kernel<<<grid, BI, 0, static_cast<cudaStream_t>(stream)>>>(
      col, x, y, n, transpose);
  return static_cast<int>(cudaGetLastError());
}
