// Direct (time-domain) circulant matvec for Hopper (sm_90a), on the tensor cores:
//     y[b, i] = sum_j C[i, j] x[b, j],   C[i, j] = col[(i - j) mod n]
// and, with `transpose`, the same with C^T[i, j] = col[(j - i) mod n].
//
// Replaces the TPU kernel `circulant_matvec_pallas`
// (src/repro/kernels/circulant_matvec/kernel.py), which builds each (BI, BJ)
// Toeplitz tile of C from a BI+BJ-1 window of the doubled `col` and feeds it
// to the MXU.  Here the product is a GEMM of the implicit n x n Toeplitz
// matrix with the n x B block of signals on `mma.sync.m16n8k16` (bf16 in,
// fp32 accumulate): a slice of 8 signals is exactly the instruction's N.
//
// Bound on the H100: operations.  2 B n^2 FLOPs: at n = 16384, B = 8, 0.064
// ms in fp32 on the CUDA cores.  One bf16 (or TF32) product keeps ~8 (~11)
// bits, too few for the fp32 tolerance (5e-5 of the largest |y|), so each
// operand is split into hi = bf16(a) and lo = bf16(a - hi) (16 bits) and
// acc += hi*lo + lo*hi + hi*hi, the lo*lo term (~2^-18 of a product)
// dropped: three bf16 passes, ~5e-6 norm-relative against fp32 on random
// data.  3xTF32 on `mma.sync.m16n8k8` (hi = tf32(a), 22 bits, the same
// three passes) is ~100x more accurate but does half the work per
// instruction and ran at about twice this kernel's time; `wgmma` m64n8k8
// in TF32 was slower still (PERF.md).
//
// The design:
//  * A block owns 64 output rows (4 groups of 16) and one slice of 8 signals
//    (two slices, 16 signals, when the batch is larger; grid.y runs over such
//    groups).  Its 8 warps split the columns: per staged chunk of 512
//    columns each warp takes 64 (4 steps of k = 16), and after the last chunk
//    the 8 partial sums are reduced in shared memory in a fixed order: no
//    atomics, the same result on every run.
//  * Per chunk the block stages, already split into bf16 hi and lo, the
//    window of `col` that generates every Toeplitz tile of the chunk (as
//    pairs (w[q], w[q - 1]), the two neighbouring k of an A register;
//    reversed for C^T) and the 512 x 8 slice of x (a batch that is not a
//    multiple of 8 is zero-padded); the next chunk's global loads are issued
//    before the current chunk's products.
//  * An A fragment of a 16x16 tile at diagonal d = i0 - j0 is pairs q, q + 8,
//    q - 8 and q again (q = d + g - 2t, g = lane / 4, t = lane % 4): 14
//    distinct, broadcast addresses a load.  It depends only on d, so the 15
//    window pairs a lane needs for its 4 row groups x 4 column steps are
//    loaded once per chunk into registers, and every fragment of the chunk
//    is read from them; B fragments are conflict-free 32-bit loads.
//  * Each chunk's products go into fresh accumulators, added to fp32 totals
//    at the chunk's end: the tensor cores' fp32 accumulation over all n / 16
//    steps would add rounding a few times the split's own; per chunk it stays
//    well below it.
//  * Launch bound of one block an SM: at two, the 128-register cap spills,
//    and n <= 8192, where the dispatch runs this kernel, ran ~10% slower
//    (n = 16384 ran faster at two).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 64;                  // output rows per block
constexpr int R = BM / 16;              // 16-row groups per warp
constexpr int WCOLS = 64;               // columns per warp per chunk: 4 steps of 16
constexpr int STEPS = WCOLS / 16;
constexpr int CB = WARPS * WCOLS;       // columns per staged chunk
constexpr int WIN = BM + CB;            // window pairs per chunk (BM + CB - 2 used)
constexpr int KLO = 2 * (STEPS - 1) + 1;  // window pairs V(k) per lane: k = -KLO .. KHI
constexpr int KHI = 2 * (R - 1) + 1;
constexpr int NV = KLO + KHI + 1;       // 15
constexpr int LDX = CB / 2 + 4;         // words (bf16 pairs) per signal row of an x tile
constexpr int WIN_PER_THREAD = (WIN + THREADS - 1) / THREADS;
constexpr int X_PER_THREAD = CB * 2 / THREADS;  // float4 loads of one 8-signal slice

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// {hi, lo} as bf16 pairs of (a, b): hi = bf16(a), lo = bf16(a - hi)
__device__ __forceinline__ uint2 split2(float a, float b) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(hi);
  return make_uint2(bits(hi), bits(__floats2bfloat162_rn(a - hf.x, b - hf.y)));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int NS>
__device__ __forceinline__ void zero(float (&a)[R][NS][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < NS; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[r][q][e] = 0.f;
}

// NS slices of 8 signals per block.  Shared memory: the window's hi and lo
// pairs (WIN words each; pair p holds w(q) in its low half and w(q - 1) in
// its high half, q = I - J - (CB - 2) + p), then the x tiles' hi and lo
// (NS x 8 signal rows of LDX words; word j / 2 of a row holds columns j, j + 1).
template <int NS>
__global__ void __launch_bounds__(THREADS, 1)
circulant_matvec_kernel(const float* __restrict__ col, const float* __restrict__ x,
                        float* __restrict__ y, int n, int batch, int transpose) {
  extern __shared__ uint4 smem4[];
  uint32_t* pw_hi = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* pw_lo = pw_hi + WIN;
  uint32_t* x_hi = pw_lo + WIN;
  uint32_t* x_lo = x_hi + NS * 8 * LDX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int I = blockIdx.x * BM;
  const int sig0 = blockIdx.y * 8 * NS;

  // w(q) = col[q mod n] (C) or col[-q mod n] (C^T)
  auto w = [&](int q) {
    int u = q % n;  // in (-n, n)
    if (transpose) u = -u;
    return col[u < 0 ? u + n : u];
  };
  // a chunk's raw global values, held in registers while the previous chunk
  // is multiplied: window pair p = threadIdx.x + i * THREADS, and float4 f =
  // threadIdx.x + i * THREADS of the x slices (slice f / (2 CB), signal
  // (f % (2 CB)) / (CB / 4), columns 4 (f % (CB / 4)) + [0, 4))
  float w_raw[WIN_PER_THREAD][2];
  float4 x_raw[NS * X_PER_THREAD];
  auto load = [&](int J) {
#pragma unroll
    for (int i = 0; i < WIN_PER_THREAD; ++i) {
      const int p = threadIdx.x + i * THREADS, q = I - J - (CB - 2) + p;
      if (p < WIN) {
        w_raw[i][0] = w(q);
        w_raw[i][1] = w(q - 1);
      }
    }
#pragma unroll
    for (int i = 0; i < NS * X_PER_THREAD; ++i) {
      const int f = threadIdx.x + i * THREADS;
      const int sig = sig0 + 8 * (f / (2 * CB)) + (f % (2 * CB)) / (CB / 4);
      const int j = J + 4 * (f % (CB / 4));
      x_raw[i] = (sig < batch && j < n)
                     ? *reinterpret_cast<const float4*>(x + static_cast<size_t>(sig) * n + j)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < WIN_PER_THREAD; ++i) {
      const int p = threadIdx.x + i * THREADS;
      if (p < WIN) {
        const uint2 v = split2(w_raw[i][0], w_raw[i][1]);
        pw_hi[p] = v.x;
        pw_lo[p] = v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < NS * X_PER_THREAD; ++i) {
      const int f = threadIdx.x + i * THREADS;
      const int row = 8 * (f / (2 * CB)) + (f % (2 * CB)) / (CB / 4);
      const int at = row * LDX + 2 * (f % (CB / 4));
      const uint2 v01 = split2(x_raw[i].x, x_raw[i].y), v23 = split2(x_raw[i].z, x_raw[i].w);
      *reinterpret_cast<uint2*>(x_hi + at) = make_uint2(v01.x, v23.x);
      *reinterpret_cast<uint2*>(x_lo + at) = make_uint2(v01.y, v23.y);
    }
  };

  float total[R][NS][4];
  zero(total);
  load(0);
  for (int J = 0; J < n; J += CB) {
    __syncthreads();  // the previous chunk is read
    store();
    __syncthreads();
    if (J + CB < n) load(J + CB);
    if (J + WCOLS * warp >= n) continue;  // a ragged last chunk: this warp's columns lie past n

    // V(k) = the window pair at q = d0 + g - 2t + 8k, d0 = I - (J + WCOLS warp)
    // this warp's first diagonal.  Tile (r, s) (rows I + 16r,
    // columns J + WCOLS warp + 16s) has diagonal d0 + 16(r - s), so its A registers
    // are V(2(r - s)), V(2(r - s) + 1), V(2(r - s) - 1) and V(2(r - s)) again.
    const int v0 = (CB - 2) - WCOLS * warp + g - 2 * t;
    uint32_t v_hi[NV], v_lo[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v_hi[k] = pw_hi[v0 + 8 * (k - KLO)];
      v_lo[k] = pw_lo[v0 + 8 * (k - KLO)];
    }
    float acc[R][NS][4];
    zero(acc);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      uint32_t b_hi[NS][2], b_lo[NS][2];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        // B registers: signal g, columns 2t + {0, 1} and 2t + 8 + {0, 1} of the step
        const int at = (8 * q + g) * LDX + (WCOLS * warp + 16 * s) / 2 + t;
        b_hi[q][0] = x_hi[at];
        b_hi[q][1] = x_hi[at + 4];
        b_lo[q][0] = x_lo[at];
        b_lo[q][1] = x_lo[at + 4];
      }
      // hi * lo, lo * hi, then hi * hi; the tiles' independent products back to back
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int k = 2 * (r - s) + KLO;
#pragma unroll
          for (int q = 0; q < NS; ++q) {
            if (pass == 0) {
              mma(acc[r][q], v_hi[k], v_hi[k + 1], v_hi[k - 1], v_hi[k], b_lo[q][0], b_lo[q][1]);
            } else if (pass == 1) {
              mma(acc[r][q], v_lo[k], v_lo[k + 1], v_lo[k - 1], v_lo[k], b_hi[q][0], b_hi[q][1]);
            } else {
              mma(acc[r][q], v_hi[k], v_hi[k + 1], v_hi[k - 1], v_hi[k], b_hi[q][0], b_hi[q][1]);
            }
          }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < NS; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[r][q][e] += acc[r][q][e];
  }

  // the 8 warps' partial sums, red[warp][signal][row], summed in warp order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < NS; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * r + g + 8 * (e / 2), s = 8 * q + 2 * t + e % 2;
        red[(warp * 8 * NS + s) * BM + row] = total[r][q][e];
      }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 8 * NS * BM; idx += THREADS) {
    const int s = idx / BM, row = idx % BM;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) sum += red[(wp * 8 * NS + s) * BM + row];
    if (sig0 + s < batch) y[static_cast<size_t>(sig0 + s) * n + I + row] = sum;
  }
}

template <int NS>
cudaError_t launch(const float* col, const float* x, float* y, int n, int batch, int transpose,
                   cudaStream_t stream) {
  auto kernel = circulant_matvec_kernel<NS>;
  constexpr size_t tiles = (2 * WIN + 2 * NS * 8 * LDX) * sizeof(uint32_t);
  constexpr size_t reduce = WARPS * 8 * NS * BM * sizeof(float);
  constexpr size_t bytes = tiles > reduce ? tiles : reduce;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BM, (batch + 8 * NS - 1) / (8 * NS));
  kernel<<<grid, THREADS, bytes, stream>>>(col, x, y, n, batch, transpose);
  return cudaGetLastError();
}

}  // namespace

// n % 128 == 0, 1 <= batch, x and y contiguous (batch, n) and 16-byte aligned:
// the wrapper checks.  A batch of up to 8 signals takes one 8-signal slice a
// block, a larger one two.
extern "C" int circulant_matvec_f32(const float* col, const float* x, float* y, int n,
                                    int batch, int transpose, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = batch <= 8 ? launch<1>(col, x, y, n, batch, transpose, s)
                                     : launch<2>(col, x, y, n, batch, transpose, s);
  return static_cast<int>(err);
}
