// Flash attention forward for Hopper (sm_90a), bf16 on the tensor cores:
//     o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * D^-1/2 [masked]) v[b, j, h / G]
// in the (B, S, H, D) GQA layout, G = H / KH query heads per KV head; bf16
// q, k, v and o, D in {64, 128, 256}.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`) for
// bf16 operands; float32 operands, and head sizes this kernel has no
// instance for, go to csrc/flash_attention.cu (SIMT, float32 inside).  It
// computes what the TPU kernel computes: scores, running max and sum and the
// P.V accumulator in float32, masked scores -1e30, the causal mask q_pos >=
// kv_pos (Sq == Sk, checked by the wrapper), KV tiles wholly above the
// diagonal never read, any S (the ragged last tiles are masked).
//
// Bound on the H100: operations.  4 B H Sq Sk D FLOPs (halved when causal):
// at the LM prefill's shape (B = 4, S = 2048, H = 24, KH = 8, D = 128) 1.03e11
// FLOP, 0.104 ms at the bf16 tensor-core rate (989 TFLOP/s); its 134 MB of
// q, k, v and o take 0.040 ms.  The design:
//  * One block per (128-row q tile, head, batch), the longest causal tiles
//    first: two consumer warpgroups of 64 q rows each and a producer
//    warpgroup, one warp of which issues the copies; the producer gives its
//    registers to the consumers (setmaxnreg 40 / 232), whose fp32 S and O
//    accumulators and bf16 P take ~200 a thread at D = 128 (at D = 256 the
//    128-register O accumulator does not fit beside them, and ptxas spills
//    a few hundred bytes).
//  * The producer stages Q once and keeps a 2-stage ring of K and V tiles
//    (128 keys x D; 64 keys at D = 256) in flight with TMA (4-D tensor maps
//    over the (D, heads, S, B) strides, 128-byte swizzle, rows past S filled
//    with zeros) and mbarriers: 160 KB of shared memory at D = 128.
//  * S = Q K^T: wgmma m64nBKk16, bf16 -> fp32, Q and K from shared memory
//    (K stored (S, D) is K-major for operand B).
//  * The D^-1/2 scale goes onto the fp32 scores, folded with log2(e) into
//    one FMA before ex2.approx (2^-3.5 is not exact in bf16, so Q is not
//    scaled).  The row max and sum stay in registers; the max is reduced
//    over the 4 threads that share a row of the accumulator, the sum (taken
//    from the fp32 p, before any rounding) once at the end.  The bf16
//    conversions go two values an instruction.
//  * P.V: P = P_hi + P_lo, both bf16 (P_lo = bf16(p - P_hi)), two wgmma
//    m64nDk16 with P as the register A operand (the fp32 accumulator layout
//    of the first product is the A layout of the second, so P never goes
//    through shared memory) and V as the MN-major B operand.  A single bf16
//    P moves each output row by up to ~5e-3 of its largest value against
//    the float32 softmax, beyond the 2^-8 + 1e-4 the output's own rounding
//    leaves room for; the split keeps p to ~2^-17 and costs 1.5x the
//    function's FLOPs (a ceiling of 0.156 ms at the prefill's shape).
//  * The two consumer warpgroups take turns issuing their products (two
//    named barriers): while one runs its softmax on the CUDA cores, the
//    other's products have the tensor cores.
//  * The output is divided by the row sum and written as bf16 from
//    registers.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a head size it has no instance for or a
// tensor map the driver refuses, cudaErrorNotSupported when the driver does
// not give cuTensorMapEncodeTiled (fetched with cudaGetDriverEntryPoint, so
// the library links no -lcuda).

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                   // q rows per block
constexpr int CONSUMERS = 256;            // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (one warp works)
// registers per thread after the split (setmaxnreg): the producer gives up
// what the consumers' accumulators need (2 x 128 x 232 + 128 x 40 <= 65536)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;  // keys per staged tile
  static constexpr int CBLK = D / 64;             // 128-byte (64-column) swizzle blocks of a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` of the barrier has completed; a
// completion that never comes (a refused copy) traps rather than hanging the
// card: the launch then fails with an error
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box {64, 1, rows, 1} of the (D, heads, S, B) map at (d0, head, row0, b)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int head, int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head), "r"(row0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x, one MUFU op (2 ulp; flushes subnormal results to zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two consumer warpgroups take turns issuing products: while one runs
// its softmax on the CUDA cores the other's products have the tensor cores
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(CONSUMERS) : "memory");
}

// d[0..32) (+)= A B: m64n64k16, bf16 A and B from shared memory (K-major), fp32 d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..64) (+)= A B: m64n128k16, bf16 A and B from shared memory (K-major), fp32 d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..32) += A B: m64n64k16, bf16 A from registers (a0..a3), B from shared
// memory, MN-major (transposed); fp32 d
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[0..64) += A B: m64n128k16, bf16 A from registers (a0..a3), B from shared
// memory, MN-major (transposed); fp32 d
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[0..128) += A B: m64n256k16, bf16 A from registers (a0..a3), B from shared
// memory, MN-major (transposed); fp32 d
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      int Sq, int Sk, int H, int KH, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t bar_q = base + C::BAR_OFF;
  auto s_k = [&](int s) { return base + C::Q_BYTES + s * 2 * C::KV_BYTES; };
  auto s_v = [&](int s) { return s_k(s) + C::KV_BYTES; };
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int n_kt = ((causal ? min(q0 + BQ, Sk) : Sk) + BK - 1) / BK;  // none wholly above the diagonal

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMERS / 32) {
    // producer: Q once, then K and V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int c = 0; c < C::CBLK; ++c) tma_load(s_q + c * BQ * 128, &tm_q, bar_q, 64 * c, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES, use = kt / STAGES;
        mbar_wait(bar_empty(s), (use & 1) ^ 1);  // the first use of a stage passes at once
        mbar_expect_tx(bar_full(s), 2 * C::KV_BYTES);
        for (int c = 0; c < C::CBLK; ++c) {
          tma_load(s_k(s) + c * BK * 128, &tm_k, bar_full(s), 64 * c, kh, kt * BK, b);
          tma_load(s_v(s) + c * BK * 128, &tm_v, bar_full(s), 64 * c, kh, kt * BK, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64 wg + [0, 64); this thread
    // rows r0 and r0 + 8 of its warp's 16, columns 8j + 2t + {0, 1} of each
    // accumulator (j = 0, 1, ...)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp / 4, wq = warp % 4, t = lane % 4;
    const int row_w = q0 + 64 * wg + 16 * wq;  // this warp's first row
    const int r0 = row_w + lane / 4;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // raw-score max, sum of p

    mbar_wait(bar_q, 0);
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES, k0 = kt * BK;
      mbar_wait(bar_full(s), (kt / STAGES) & 1);

      // S = Q K^T over D in steps of 16 (32 bytes inside a 128-byte swizzle row)
      float sc[BK / 2];
      turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = smem_desc(s_q + (kk / 4) * BQ * 128 + wg * 64 * 128 + off, 16, 1024);
        const uint64_t db = smem_desc(s_k(s) + (kk / 4) * BK * 128 + off, 16, 1024);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait_all();
      reg_fence(sc);

      // mask, then the running max of the raw scores (over the 4 threads of a row)
      if (k0 + BK > Sk || (causal && k0 + BK - 1 > row_w)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * t + i % 2;
          if (key >= Sk || (causal && key > r0 + 8 * ((i / 2) % 2))) sc[i] = NEG_INF;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float corr[2], shift[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        corr[hr] = exp2_approx((m[hr] - mx[hr]) * scale_log2);
        m[hr] = mx[hr];
        shift[hr] = -mx[hr] * scale_log2;
        l[hr] *= corr[hr];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];

      // p = 2^(s c - m c) in fp32 (summed before rounding), split into bf16
      // hi + lo in the register A layout: for keys 16kk + [0, 16), a0..a3 are
      // the accumulator pairs 8kk + {0, 2, 4, 6}
      uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int hr = (i / 2) % 2;
        const float p0 = exp2_approx(fmaf(sc[i], scale_log2, shift[hr]));
        const float p1 = exp2_approx(fmaf(sc[i + 1], scale_log2, shift[hr]));
        l[hr] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[i / 2] = bits(hi);
        p_lo[i / 2] = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }

      // O += P_hi V + P_lo V over the tile's keys in steps of 16 (16 rows of
      // V: 2048 bytes); V is (keys, D), D contiguous: the MN-major operand,
      // its 64-column blocks BK * 128 bytes apart
      turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = smem_desc(s_v(s) + kk * 2048, BK * 128, 1024);
        wgmma_rs(acc, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3], dv);
        wgmma_rs(acc, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3], dv);
      }
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait_all();
      reg_fence(acc);
      mbar_arrive(bar_empty(s));  // this thread's reads of the stage are done
    }
    if (wg == 0) turn_wait(wg);  // warpgroup 1's last turn_pass

    // the row sums over the 4 threads of a row, then o / l in bf16
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      l[hr] = 1.f / fmaxf(l[hr], 1e-30f);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row >= Sq) continue;
      __nv_bfloat16* out = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hr] * l[hr], acc[4 * j + 2 * hr + 1] * l[hr]);
      }
    }
  }
}

// the (D, heads, S, B) view of a contiguous (B, S, heads, D) bf16 tensor,
// boxes of {64, 1, rows, 1} with the 128-byte swizzle
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KH, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, B, Sq, H, D, BQ) ||
      !make_map(encode, &tm_k, k, B, Sk, KH, D, C::BK) ||
      !make_map(encode, &tm_v, v, B, Sk, KH, D, C::BK)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_sm90_kernel<D>;
  // above 48 KB of dynamic shared memory only after this (per device: set at every launch)
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
                                             Sq, Sk, H, KH, causal, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v and o, contiguous and 16-byte aligned (the wrapper checks)
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        int B, int Sq, int Sk, int H, int KH, int D, int causal,
                                        float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = launch<64>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s); break;
    case 128: err = launch<128>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s); break;
    case 256: err = launch<256>(q, k, v, o, B, Sq, Sk, H, KH, causal, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
