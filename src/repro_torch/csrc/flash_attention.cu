// Flash attention forward for Hopper (sm_90a):
//     o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * D^-1/2 [masked]) v[b, j, h / G]
// in the (B, S, H, D) GQA layout, G = H / KH query heads per KV head.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`), with
// its wrapper's GQA head repeat and (B, H) fold (ops.py) done by index
// arithmetic here: the kernel reads q, k and v in place by strides, so no
// repeated or transposed copy is made.  What it computes is the TPU
// kernel's: q, k, v converted to float32, q scaled by D^-1/2 after the
// conversion; scores, running max and sum and the P.V accumulator in
// float32; masked scores filled with -1e30; the causal mask q_pos >= kv_pos
// (Sq == Sk, checked by the wrapper); KV tiles wholly above the diagonal
// never read; the output written in q's dtype.  Unlike the TPU kernel it
// takes any S (the ragged last tiles are masked) and keeps only one KV tile
// on chip at a time, not the whole sequence.
//
// The wrapper routes float32 operands here, and bf16 at a head size the
// tensor-core kernel (flash_attention_sm90.cu, which takes bf16 LM prefills)
// has no instance for: D = 8, 16 (the SMOKE configs' heads) and 32.  Bound on the H100: operations.  4 B H Sq Sk D FLOPs
// (halved when causal) against (q + k + v + o) bytes read and written once:
// at the LM prefill's shape in float32 (B = 4, S = 2048, H = 24, KH = 8, D =
// 128) 1.03e11 FLOP, 1.54 ms at the fp32 CUDA-core rate (67 TFLOP/s): it
// runs in float32 on the CUDA cores (tensor-core products in fp32 would be
// TF32, other numbers).  The design: one block of 256 threads per (64-row q
// tile, head, batch); the q tile and one 64-row K and V tile staged in shared
// memory as float32; each thread owns 4 rows x 4 score columns of Q.K^T and
// 4 rows x D/16 columns of the float32 output accumulator in registers (at
// D = 8 half the threads of a row hold no output column); the
// online softmax's row max and sum are reduced across the 16 threads of a
// row by warp shuffles, and P goes through shared memory to the P.V product.
// Its limit is shared-memory issue (about one load per two FMAs).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a head size or dtype it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per staged tile
constexpr int TX = 16;  // threads across a row (score columns / output columns)
constexpr int TY = 16;  // thread rows
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;  // rows per thread
constexpr int CPT = BK / TX;  // score columns per thread
constexpr int LDP = BK + 1;   // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "the causal tile count assumes square tiles");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
struct Smem {
  static constexpr int LDQ = D + 1;  // padded: a warp reads 16 rows of one column
  static constexpr int LDK = D + 1;
  static constexpr int LDV = D;      // a warp reads one row, 16 consecutive columns
  static constexpr size_t floats = static_cast<size_t>(BQ) * LDQ + BK * LDK + BK * LDV + BQ * LDP;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Rows [row0, row0 + 64) of head `head` of a (B, S, NH, D) tensor, batch b,
// into shared memory as float32 times `mul`, row stride `ld`; rows >= S are
// zero.  16-byte vector loads along D.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ src, int b,
                                      int row0, int S, int nh, int head, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC, s = row0 + r;
    float* out = dst + r * ld + c;
    if (s < S) {
      const T* p = src + ((static_cast<size_t>(b) * S + s) * nh + head) * D + c;
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < VEC; ++t) out[t] = to_float(e[t]) * mul;
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) out[t] = 0.f;
    }
  }
}

// max / sum over the 16 threads of one row (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Sk, int H, int KH, int causal, float scale) {
  using L = Smem<D>;
  constexpr int DPT = (D + TX - 1) / TX;  // output columns per thread
  constexpr bool RAGGED = D % TX != 0;    // D = 8: columns tx + TX j >= D are not there
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * L::LDQ;
  float* Vs = Ks + BK * L::LDK;
  float* Ps = Vs + BK * L::LDV;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  stage<T, D>(Qs, L::LDQ, q, b, q0, Sq, H, h, scale);

  float acc[RPT][DPT], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, qt + 1);  // tiles wholly above the diagonal are skipped
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are read
    stage<T, D>(Ks, L::LDK, k, b, k0, Sk, KH, kh, 1.f);
    stage<T, D>(Vs, L::LDV, v, b, k0, Sk, KH, kh, 1.f);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RPT], kb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = Qs[(ty + TY * i) * L::LDQ + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kb[j] = Ks[(tx + TX * j) * L::LDK + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + TX * j;
        if (kp >= Sk || (causal && qp < kp)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + TY * i) * LDP + tx + TX * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[RPT], vb[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = Ps[(ty + TY * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        vb[j] = (!RAGGED || tx + TX * j < D) ? Vs[c * L::LDV + tx + TX * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + TY * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (!RAGGED || tx + TX * j < D) out[tx + TX * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KH, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t bytes = Smem<D>::bytes;
  // above 48 KB of dynamic shared memory only after this (per device: set at every launch)
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), Sq,
                                           Sk, H, KH, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int KH, int D, int causal, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, stream);
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bf16 (q, k, v and o alike).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Sk, int H, int KH, int D, int dtype, int causal,
                                   float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(q, k, v, o, B, Sq, Sk, H, KH, D, causal, scale, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, D, causal, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
