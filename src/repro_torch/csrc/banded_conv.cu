// Banded circulant matvec (circular FIR, the Sec. 7 blur) for Hopper (sm_90a):
//     y[b, i] = sum_{t < L} taps[t] * x[b, (i + t) mod n]
// with first-row taps (a correlation), for any n and a leading batch.
//
// Replaces the TPU kernel `banded_circulant_matvec`
// (src/repro/kernels/banded_conv/kernel.py), which concatenates an (L-1)-
// element halo onto a 1-D x and needs n % 1024 == 0.  Here the design is the
// paper's shared-memory window (Algs. 4-6) specialised to an order-L band:
// grid (ceil(n / TILE) output tiles, batch); each block stages the circular
// window x[i0 .. i0 + TILE + L - 2] of its signal in shared memory, the wrap
// done by index arithmetic (no concatenated copy), then each thread keeps
// PER_THREAD outputs in registers and walks the taps once, holding the tap
// it works on in a register (a warp-uniform load served from L1).
//
// Bound on the H100: bytes.  x is read once (plus L - 1 halo elements per
// tile) and y written once, 8 B per element; 2 L FLOPs per output are
// negligible for the paper's L = 5.  Shared-memory reads are conflict-free
// (neighbouring threads read neighbouring words).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;  // outputs per block

__global__ void __launch_bounds__(THREADS)
banded_conv_kernel(const float* __restrict__ taps, const float* __restrict__ x,
                   float* __restrict__ y, int n, int order) {
  extern __shared__ float window[];  // TILE + order - 1 elements
  const int i0 = blockIdx.x * TILE;
  const size_t row = static_cast<size_t>(blockIdx.y) * n;
  const int span = TILE + order - 1;
  for (int t = threadIdx.x; t < span; t += THREADS) {
    window[t] = x[row + static_cast<int>((static_cast<long long>(i0) + t) % n)];
  }
  __syncthreads();
  float acc[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) acc[r] = 0.f;
  for (int t = 0; t < order; ++t) {
    const float w = __ldg(taps + t);
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      acc[r] = fmaf(w, window[threadIdx.x + r * THREADS + t], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int i = i0 + threadIdx.x + r * THREADS;
    if (i < n) y[row + i] = acc[r];
  }
}

}  // namespace

extern "C" int banded_conv_f32(const float* taps, const float* x, float* y, int n, int batch,
                               int order, void* stream) {
  const dim3 grid((n + TILE - 1) / TILE, batch);
  const size_t smem = static_cast<size_t>(TILE + order - 1) * sizeof(float);
  banded_conv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      taps, x, y, n, order);
  return static_cast<int>(cudaGetLastError());
}
