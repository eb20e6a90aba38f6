// Flash attention forward for Hopper (sm_90a), on the tensor cores through
// mma.sync:
//     o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * D^-1/2 [masked]) v[b, j, h / G]
// in the (B, S, H, D) GQA layout, G = H / KH query heads per KV head.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:72, body `_flash_kernel`), with
// its wrapper's GQA head repeat and (B, H) fold (ops.py) done by index
// arithmetic here: the kernel reads q, k and v in place by strides, so no
// repeated or transposed copy is made.  What it computes is the TPU kernel's:
// q, k, v converted to float32, q scaled by D^-1/2; scores, running max and
// sum and the P.V accumulator in float32; masked scores -1e30; the causal
// mask q_pos >= kv_pos (Sq == Sk, checked by the wrapper); KV tiles wholly
// above the diagonal never read; the output o / max(l, 1e-30) written in q's
// dtype.  Unlike the TPU kernel it takes any S (the ragged last tiles are
// masked) and keeps only a ring of KV tiles on chip, not the whole sequence.
//
// The wrapper routes float32 operands here, at every D in {8, ..., 256}, and
// bf16 at the head sizes the wgmma kernel (flash_attention_sm90.cu, bf16 at
// D = 64, 128, 256) has no instance for: D = 8, 16 (the SMOKE configs'
// heads) and 32.
//
// Bound on the H100: operations.  4 B H Sq Sk D FLOPs (halved when causal)
// against (q + k + v + o) bytes read and written once.  float32 runs as
// 3xTF32 on the tensor cores (below), three TF32 products for each product
// of the function: at the LM prefill's shape in float32 (B = 4, S = 2048, H =
// 24, KH = 8, D = 128) 3 x 1.03e11 FLOP at 495 TFLOP/s, 0.625 ms (1.54 ms
// for one product at the fp32 CUDA-core rate, 67 TFLOP/s).  bf16 runs one
// bf16 product for Q.K^T and two for P.V; its bound is taken as the
// function's FLOPs at 989 TFLOP/s, as for the wgmma kernel.
//
// The design:
//  * One block of 4 warps per (64-row q tile, head, batch), the longest
//    causal rows launched first.  Each warp owns 16 query rows: S = Q K^T and
//    the O accumulator live in its registers in mma.sync fragment layout, the
//    online softmax's row max is reduced over the 4 lanes of a quad by
//    shuffles, the row sum kept per lane and reduced once at the end.  No
//    block-wide barrier separates Q K^T, the softmax and P.V: one barrier a
//    KV tile guards the shared-memory ring.  A warp whose rows all lie above
//    a causal tile skips it; only a tile that crosses the diagonal or the
//    ragged end of S is masked element by element.
//  * K and V tiles stream through a 2-stage ring by cp.async (16 bytes a
//    thread, rows past S zero-filled, the copy loops unrolled): tile j + 1 is
//    in flight while tile j is computed.  Q is staged once with tile 0.
//  * float32 (mma m16n8k8 .tf32): each operand x is split into hi, x rounded
//    as cvt.rna.tf32.f32 rounds (to nearest, ties away, 10 mantissa bits),
//    and lo = x - hi cut to TF32 (the tensor core reads the top 19 bits of an
//    operand register), and a.b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi with
//    float32 accumulation (the lo.lo term, ~2^-21 of a product, dropped).
//    One TF32 product (~11 bits) is ~5e-4 of the output, beyond TOL_FLASH
//    (2e-5).  hi is rounded on the int32 view ((x + 0x1000) & ~0x1fff): ptxas
//    expands cvt.rna.tf32.f32 into a longer sequence that guards NaN and
//    infinity, which cost the LM prefill's shape markedly more time in a
//    probe; rounding lo to nearest as well cost a few percent there and
//    moved no error measurably.
//    Q is scaled by D^-1/2 log2(e) (the softmax runs on ex2.approx) before
//    its split: once into registers at D <= 64, at each use from shared
//    memory at D = 128, 256.  The contraction is permuted inside each 8-wide
//    step so that no fragment moves between lanes: for Q.K^T, A column t and
//    t + 4 take d = 2t and 2t + 1 (Q and K fragments are float2 loads); for
//    P.V, A column t and t + 4 take keys 2t and 2t + 1, which are where S's
//    accumulator fragment already holds them, so P is split in registers and
//    never goes through shared memory.  V's B column g is d = 16c + 2g of
//    n-tile 2c and 16c + 2g + 1 of n-tile 2c + 1, so one float2 load feeds
//    two n-tiles and a lane's four output columns 16c + 4t .. + 3 leave as
//    one float4.  Row strides are padded so every fragment load is free of
//    bank conflicts (K, Q: = 8 mod 16 floats; V: = 4 mod 16).
//  * A tile's P.V goes into fresh accumulators, added to O by one FMA (the
//    softmax's rescale folded in) at the tile's end, D <= 128: the tensor
//    core's float32 accumulation does not round to nearest, and in a probe a
//    2048-key row summed into one accumulator drifted to near TOL_FLASH
//    (2e-5) of the output's scale, several times what it drifts a tile at a
//    time.  At D = 256 the second accumulator does not fit in registers.
//  * bf16 (D = 8, 16, 32): Q.K^T on mma m16n8k16 (m16n8k8 at D = 8) with Q's
//    fragments loaded once by ldmatrix and K's by ldmatrix, the D^-1/2
//    log2(e) scale on the float32 scores; P.V on m16n8k16 with S's
//    accumulator fragment reused as the A fragment and V's B fragments by
//    ldmatrix.trans.  P is split into bf16 hi + lo (lo = bf16(p - hi)) and
//    multiplied twice, into two accumulators: a single bf16 P moves a row by
//    ~5e-3 of its largest value, beyond the 2^-8 + 1e-4 of TOL_FLASH_ROW.
//  * Keys a tile, shared memory, blocks an SM (the launch bound) and the
//    registers a thread ptxas gave each instance (no spills; `-Xptxas -v`, in
//    the build log that chip_smoke.py prints; CUDA 12.8):
//      float32 D = 8: 64 keys, 12 KB, 4, 126;  D = 16: 64, 28 KB, 4, 128;
//              D = 32: 64, 48 KB, 3, 166;  D = 64: 64, 88 KB, 2, 255;
//              D = 128: 32, 101 KB, 2, 238;  D = 256: 32, 197 KB, 1, 206
//      bf16    D = 8: 64 keys, 5 KB, 4, 78;  D = 16: 15 KB, 93;  D = 32: 25 KB, 126
//    Slower at D = 128, measured: a 64-key tile (one
//    block an SM), a 16-key tile at three blocks an SM, and K and V split once
//    a tile by the whole block into hi and lo planes (16-key tiles under 4
//    warps, or 32-key tiles under 8 warps and 128 query rows), though that cut
//    the instructions a tile by about a quarter.
//  * What limits it: the rate of mma.sync on the tensor cores and the issue
//    slots beside it.  At the LM prefill's shape the kernel issues 1.5e8 TF32
//    m16n8k8 products (three a product of the function) in ~1.9 ms, one
//    every ~11 cycles of each SM sub-partition at 1.75 GHz, and
//    each carries the split of its B operand (three instructions a value), a
//    shared-memory load and register moves; wgmma's TF32 rate is out of this
//    design's reach.  At D <= 32 in bf16 the latency of a short KV loop and
//    the MUFU's ex2 lead.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a head size or dtype it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block, 16 a warp
constexpr int STAGES = 2;       // the K / V ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int D>
struct Cfg;

template <int D>
struct Cfg<float, D> {
  static constexpr int BK = D >= 128 ? 32 : 64;   // keys per staged tile
  static constexpr int LDK = D + ((8 - D) & 15);  // row strides in floats: K and Q = 8 mod 16,
  static constexpr int LDQ = LDK;                 // V = 4 mod 16 (conflict-free fragment loads)
  static constexpr int LDV = D + 4;
  static constexpr bool QREG = D <= 64;   // Q split once into registers, else at each use
  static constexpr bool FRESH = D <= 128;  // a tile's P.V in fresh accumulators (registers)
  static constexpr int MIN_BLOCKS = D >= 256 ? 1 : D >= 64 ? 2 : D == 32 ? 3 : 4;
  static constexpr size_t bytes =
      (static_cast<size_t>(BQ) * LDQ + STAGES * BK * (LDK + LDV)) * sizeof(float);
};

template <int D>
struct Cfg<__nv_bfloat16, D> {
  static constexpr int BK = 64;
  static constexpr int LD = D == 8 ? 8 : D + 8;  // bf16 row stride: ldmatrix rows conflict-free
  static constexpr int MIN_BLOCKS = 4;
  static constexpr size_t bytes =
      (static_cast<size_t>(BQ) * LD + STAGES * BK * 2 * LD) * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of head `head` of a (B, S, NH, D) tensor, batch b,
// into shared memory at row stride `ld` (elements); rows >= S are zeros.
// Chunk i = threadIdx.x + THREADS * it is row i / CPR, 16-byte column i % CPR.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ src, int b, int row0,
                                      int S, int nh, int head) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;  // 16-byte chunks a row
  constexpr int TOTAL = ROWS * CPR;
  const size_t stride = static_cast<size_t>(nh) * D;  // elements from one row to the next
  const T* base = src + static_cast<size_t>(b) * S * stride + static_cast<size_t>(head) * D;
#pragma unroll 8
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (TOTAL % THREADS == 0 || i < TOTAL) {
      const int r = i / CPR, c = (i % CPR) * VEC, s = row0 + r;
      const bool valid = s < S;
      cp_async16(smem_u32(dst + r * ld + c), base + (valid ? s : 0) * stride + c, valid);
    }
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- float32: 3xTF32 on mma.sync m16n8k8 ----

// x rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero, 10
// mantissa bits), on the int32 view: two integer instructions, where ptxas
// expands the cvt into a longer sequence that special-cases NaN
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, each a TF32 value: hi rounded to nearest, lo = x - hi (exact)
// cut to its top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// The TF32 hi and lo of the two floats at p
__device__ __forceinline__ void load_split(const float* p, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(x.y, hi[1], lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// ---- bf16: mma.sync m16n8k16 / m16n8k8, ldmatrix ----

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// {hi, lo} bf16 pairs of (a, b): hi = bf16(a), lo = bf16(a - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ void mma_bf16_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// ---- shared by both ----

// Masks a tile's scores (accumulator layout: s[j][0..1] row `row`, keys key0 +
// 8j + {0, 1}; s[j][2..3] row `row` + 8, the same keys).
template <int NT>
__device__ __forceinline__ void mask(float (&s)[NT][4], int row, int key0, int Sk, int causal) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * j + (e & 1), r = row + 8 * (e >> 1);
      if (key >= Sk || (causal && key > r)) s[j][e] = NEG_INF;
    }
}

// One tile of the online softmax on scores in the log2 domain: s becomes p in
// place; m is the running max of rows g and g + 8 (reduced over the quad),
// l the lane's share of their running sums.  Returns the factors that
// rescale what was accumulated before this tile.
template <int NT>
__device__ __forceinline__ float2 softmax_step(float (&s)[NT][4], float (&m)[2], float (&l)[2]) {
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
  }
  const float2 corr = make_float2(exp2_approx(m[0] - mx0), exp2_approx(m[1] - mx1));
  m[0] = mx0;
  m[1] = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = exp2_approx(s[j][0] - mx0);
    s[j][1] = exp2_approx(s[j][1] - mx0);
    s[j][2] = exp2_approx(s[j][2] - mx1);
    s[j][3] = exp2_approx(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
  l[0] = l[0] * corr.x + sum0;
  l[1] = l[1] * corr.y + sum1;
  return corr;
}

template <int NA, int DN>
__device__ __forceinline__ void rescale(float (&acc)[NA][DN][4], float2 corr) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      acc[a][n][0] *= corr.x;
      acc[a][n][1] *= corr.x;
      acc[a][n][2] *= corr.y;
      acc[a][n][3] *= corr.y;
    }
}

// o[rows g, g + 8 of the warp] = (sum of the NA accumulators) / l.  A lane's
// columns of n-tile n: 8n + 2t, + 1; PAIRED (the float32 P.V), n-tiles 2c and
// 2c + 1 interleaved: 16c + 4t + {0, 2} and 16c + 4t + {1, 3}
template <typename T, int NA, int DN, int D, bool PAIRED>
__device__ __forceinline__ void store_out(T* __restrict__ o, const float (&acc)[NA][DN][4],
                                          float (&l)[2], int b, int row, int Sq, int H, int h) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* out = o + ((static_cast<size_t>(b) * Sq + r) * H + h) * D;
    float x[DN][2];
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      x[n][0] = x[n][1] = 0.f;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        x[n][0] += acc[a][n][2 * i];
        x[n][1] += acc[a][n][2 * i + 1];
      }
    }
    if constexpr (PAIRED) {
#pragma unroll
      for (int c = 0; c < DN / 2; ++c)
        *reinterpret_cast<float4*>(out + 16 * c + 4 * t) =
            make_float4(x[2 * c][0] * inv, x[2 * c + 1][0] * inv, x[2 * c][1] * inv,
                        x[2 * c + 1][1] * inv);
    } else {
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
              make_float2(x[n][0] * inv, x[n][1] * inv);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * t) =
              __floats2bfloat162_rn(x[n][0] * inv, x[n][1] * inv);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<float, D>::MIN_BLOCKS)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
                  int KH, int causal, float qscale) {
  using C = Cfg<float, D>;
  constexpr int BK = C::BK, NT = BK / 8, DN = D / 8, LDK = C::LDK, LDV = C::LDV;
  constexpr int NA = DN >= 4 ? 1 : 4 / DN;  // independent O accumulators at small D
  extern __shared__ uint4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * C::LDQ;
  float* Vs = Ks + STAGES * BK * LDK;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;  // the warp's first row
  float* Qw = Qs + 16 * warp * C::LDQ;

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);  // tiles above the diagonal skipped

  stage<float, D, BQ>(Qs, C::LDQ, q, b, q0, Sq, H, h);
  stage<float, D, BK>(Ks, LDK, k, b, 0, Sk, KH, kh);
  stage<float, D, BK>(Vs, LDV, v, b, 0, Sk, KH, kh);
  cp_async_commit();

  uint32_t qh[C::QREG ? DN : 1][4], ql[C::QREG ? DN : 1][4];
  float acc[NA][DN][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1's stage
    if (kt + 1 < n_kt) {
      stage<float, D, BK>(Ks + (1 - st) * BK * LDK, LDK, k, b, (kt + 1) * BK, Sk, KH, kh);
      stage<float, D, BK>(Vs + (1 - st) * BK * LDV, LDV, v, b, (kt + 1) * BK, Sk, KH, kh);
    }
    cp_async_commit();
    if (kt == 0) {
      // the warp's own 16 rows of Q (read by this warp alone), scaled by
      // D^-1/2 log2(e): split once into registers, or scaled in place
      if constexpr (C::QREG) {
#pragma unroll
        for (int kk = 0; kk < DN; ++kk) {
          const float2 x0 = *reinterpret_cast<const float2*>(Qw + g * LDK + 8 * kk + 2 * t);
          const float2 x1 = *reinterpret_cast<const float2*>(Qw + (g + 8) * LDK + 8 * kk + 2 * t);
          split_tf32(x0.x * qscale, qh[kk][0], ql[kk][0]);
          split_tf32(x1.x * qscale, qh[kk][1], ql[kk][1]);
          split_tf32(x0.y * qscale, qh[kk][2], ql[kk][2]);
          split_tf32(x1.y * qscale, qh[kk][3], ql[kk][3]);
        }
      } else {
        for (int i = lane; i < 16 * D; i += 32) Qw[(i / D) * LDK + i % D] *= qscale;
      }
      __syncwarp();
    }
    const int k0 = kt * BK;
    if (causal && k0 > r0 + 15) continue;  // every key of the tile is above the warp's rows
    const float* Kt = Ks + st * BK * LDK;
    const float* Vt = Vs + st * BK * LDV;

    // S = Q K^T; A column t / t + 4 <-> d = 2t / 2t + 1 of the step
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DN; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (C::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[kk][e];
          al[e] = ql[kk][e];
        }
      } else {
        const float2 x0 = *reinterpret_cast<const float2*>(Qw + g * LDK + 8 * kk + 2 * t);
        const float2 x1 = *reinterpret_cast<const float2*>(Qw + (g + 8) * LDK + 8 * kk + 2 * t);
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
        load_split(Kt + (8 * j + g) * LDK + 8 * kk + 2 * t, bh, bl);
        mma_3xtf32(s[j], ah, al, bh, bl);
      }
    }
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > r0)) mask(s, r0 + g, k0 + 2 * t, Sk, causal);
    const float2 corr = softmax_step(s, m, l);
    if constexpr (!C::FRESH) rescale(acc, corr);
    float pv[NA][DN][4];  // the tile's P.V (FRESH), added to O at its end
    if constexpr (C::FRESH) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int n = 0; n < DN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[a][n][e] = 0.f;
    }
    auto& dst = C::FRESH ? pv : acc;

    // O += P V; A column t / t + 4 <-> key 2t / 2t + 1 of the step: S's
    // accumulator fragment as it stands.  Output n-tiles 2c, 2c + 1 take
    // columns 16c + 2g and 16c + 2g + 1 (B column g), so one float2 load
    // serves both (D = 8: the one n-tile's column g)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const float* vr = Vt + (8 * j + 2 * t) * LDV;
      if constexpr (DN == 1) {
        uint32_t bh[2], bl[2];
        split_tf32(vr[g], bh[0], bl[0]);
        split_tf32(vr[LDV + g], bh[1], bl[1]);
        mma_3xtf32(dst[j % NA][0], ah, al, bh, bl);
      } else {
#pragma unroll
        for (int c = 0; c < DN / 2; ++c) {
          const float* vp = vr + 16 * c + 2 * g;
          uint32_t h0[2], l0[2], h1[2], l1[2];  // keys 2t, 2t + 1 x columns (n-tiles) 2c, 2c + 1
          load_split(vp, h0, l0);
          load_split(vp + LDV, h1, l1);
          const uint32_t bh[2][2] = {{h0[0], h1[0]}, {h0[1], h1[1]}};
          const uint32_t bl[2][2] = {{l0[0], l1[0]}, {l0[1], l1[1]}};
          mma_3xtf32(dst[j % NA][2 * c], ah, al, bh[0], bl[0]);
          mma_3xtf32(dst[j % NA][2 * c + 1], ah, al, bh[1], bl[1]);
        }
      }
    }
    if constexpr (C::FRESH) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          acc[a][n][0] = fmaf(acc[a][n][0], corr.x, pv[a][n][0]);
          acc[a][n][1] = fmaf(acc[a][n][1], corr.x, pv[a][n][1]);
          acc[a][n][2] = fmaf(acc[a][n][2], corr.y, pv[a][n][2]);
          acc[a][n][3] = fmaf(acc[a][n][3], corr.y, pv[a][n][3]);
        }
    }
  }
  store_out<float, NA, DN, D, (DN > 1)>(o, acc, l, b, r0 + g, Sq, H, h);
}

template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<__nv_bfloat16, D>::MIN_BLOCKS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                  int Sk, int H, int KH, int causal, float sscale) {
  using C = Cfg<__nv_bfloat16, D>;
  constexpr int BK = C::BK, NT = BK / 8, DN = D / 8, LD = C::LD;
  constexpr int KS = D / 16;  // k16 steps of Q K^T (0 at D = 8: one k8 step)
  static_assert(NT % 4 == 0 && (DN == 1 || DN % 2 == 0), "fragment grouping");
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + STAGES * BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  stage<__nv_bfloat16, D, BQ>(Qs, LD, q, b, q0, Sq, H, h);
  stage<__nv_bfloat16, D, BK>(Ks, LD, k, b, 0, Sk, KH, kh);
  stage<__nv_bfloat16, D, BK>(Vs, LD, v, b, 0, Sk, KH, kh);
  cp_async_commit();

  // Q's A fragments, loaded once: qa[kk] for k16 step kk (D = 8: qa[0][0..1])
  uint32_t qa[KS > 0 ? KS : 1][4];
  // two accumulators: P_hi V and P_lo V
  float acc[2][DN][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kt) {
      const int st = (kt + 1) % STAGES;
      stage<__nv_bfloat16, D, BK>(Ks + st * BK * LD, LD, k, b, (kt + 1) * BK, Sk, KH, kh);
      stage<__nv_bfloat16, D, BK>(Vs + st * BK * LD, LD, v, b, (kt + 1) * BK, Sk, KH, kh);
    }
    cp_async_commit();
    if (kt == 0) {
      if constexpr (KS == 0) {  // rows 0-7 and 8-15 of the warp's 8 columns
        uint32_t r[2];
        ldsm_x2(r, smem_u32(Qs + (16 * warp + (lane & 15)) * LD));
        qa[0][0] = r[0];
        qa[0][1] = r[1];
      } else {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)  // (rows 0-7, 8-15) x (columns 0-7, 8-15) of the step
          ldsm_x4(qa[kk], smem_u32(Qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                   16 * kk + 8 * (lane >> 4)));
      }
    }
    const int k0 = kt * BK;
    if (causal && k0 > r0 + 15) continue;
    const __nv_bfloat16* Kt = Ks + (kt % STAGES) * BK * LD;
    const __nv_bfloat16* Vt = Vs + (kt % STAGES) * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (KS == 0) {
#pragma unroll
      for (int j = 0; j < NT; j += 4) {  // four key n-tiles a load: rows 8 (j + lane / 8) + lane % 8
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(Kt + (8 * j + lane) * LD));
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16_k8(s[j + i], qa[0][0], qa[0][1], kb[i]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int j = 0; j < NT; j += 2) {  // n-tiles j, j + 1 x columns 16kk + {0, 8}
          uint32_t kb[4];
          ldsm_x4(kb, smem_u32(Kt + (8 * j + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                               8 * ((lane >> 3) & 1)));
          mma_bf16_k16(s[j], qa[kk], kb[0], kb[1]);
          mma_bf16_k16(s[j + 1], qa[kk], kb[2], kb[3]);
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sscale;
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > r0)) mask(s, r0 + g, k0 + 2 * t, Sk, causal);
    rescale(acc, softmax_step(s, m, l));

    // O += P_hi V + P_lo V over k16 steps of keys: S's n-tiles 2jj, 2jj + 1
    // are the A fragment
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * jj][0], s[2 * jj][1], ph[0], pl[0]);
      split_bf16(s[2 * jj][2], s[2 * jj][3], ph[1], pl[1]);
      split_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3], ph[3], pl[3]);
      if constexpr (DN == 1) {
        uint32_t vb[2];
        ldsm_x2_trans(vb, smem_u32(Vt + (16 * jj + (lane & 15)) * LD));
        mma_bf16_k16(acc[0][0], ph, vb[0], vb[1]);
        mma_bf16_k16(acc[1][0], pl, vb[0], vb[1]);
      } else {
#pragma unroll
        for (int n = 0; n < DN; n += 2) {  // keys 16jj + (0-7, 8-15) x columns 8n, 8n + 8
          uint32_t vb[4];
          ldsm_x4_trans(vb, smem_u32(Vt + (16 * jj + (lane & 15)) * LD + 8 * (n + (lane >> 4))));
          mma_bf16_k16(acc[0][n], ph, vb[0], vb[1]);
          mma_bf16_k16(acc[1][n], pl, vb[0], vb[1]);
          mma_bf16_k16(acc[0][n + 1], ph, vb[2], vb[3]);
          mma_bf16_k16(acc[1][n + 1], pl, vb[2], vb[3]);
        }
      }
    }
  }
  store_out<__nv_bfloat16, 2, DN, D, false>(o, acc, l, b, r0 + g, Sq, H, h);
}

template <typename T, int D, typename Kernel>
cudaError_t launch(Kernel kernel, const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KH, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Cfg<T, D>::bytes;
  // above 48 KB of dynamic shared memory only after this (per device: set at every launch)
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), Sq,
                                           Sk, H, KH, causal, scale * LOG2E);
  return cudaGetLastError();
}

#define FLASH_CASE(T, KERNEL, D)                                                           \
  case D:                                                                                  \
    return launch<T, D>(KERNEL<D>, q, k, v, o, B, Sq, Sk, H, KH, causal, scale, stream);

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Sk, int H, int KH, int D, int causal, float scale,
                         cudaStream_t stream) {
  switch (D) {
    FLASH_CASE(float, flash_tf32_kernel, 8)
    FLASH_CASE(float, flash_tf32_kernel, 16)
    FLASH_CASE(float, flash_tf32_kernel, 32)
    FLASH_CASE(float, flash_tf32_kernel, 64)
    FLASH_CASE(float, flash_tf32_kernel, 128)
    FLASH_CASE(float, flash_tf32_kernel, 256)
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                          int Sk, int H, int KH, int D, int causal, float scale,
                          cudaStream_t stream) {
  switch (D) {
    FLASH_CASE(__nv_bfloat16, flash_bf16_kernel, 8)
    FLASH_CASE(__nv_bfloat16, flash_bf16_kernel, 16)
    FLASH_CASE(__nv_bfloat16, flash_bf16_kernel, 32)
    default: return cudaErrorInvalidValue;
  }
}

#undef FLASH_CASE

}  // namespace

// dtype: 0 = float32 (D in 8 ... 256), 1 = bf16 (D = 8, 16, 32); q, k, v and o alike.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Sk, int H, int KH, int D, int dtype, int causal,
                                   float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_f32(q, k, v, o, B, Sq, Sk, H, KH, D, causal, scale, s);
  } else if (dtype == 1) {
    err = dispatch_bf16(q, k, v, o, B, Sq, Sk, H, KH, D, causal, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
