// Hopper (sm_90a) building blocks of the port's wgmma kernels: K2 and K3f
// (paper_chain.cuh), K1 / K3b (paper_train.cuh), K4f / K4b
// (fused_flex.cu) and the design probes P1 / P2 (probes.cu).
//
// - wgmma.mma_async m64n256k16 / m64n128k16, bf16 operands, f32
//   accumulators in registers: A from shared memory (`wgmma_ss_*`, a matrix
//   descriptor) or from registers (`wgmma_rs_*`); B always from shared
//   memory.
// - The operand layout in shared memory is the 128-byte swizzle: a row of
//   64 bf16 (128 bytes) whose eight 16-byte groups sit at position
//   group ^ (row % 8), eight rows to a 1024-byte atom. K-major (`desc_k`):
//   a row holds 64 consecutive k of one m or n, so a 64-deep K chunk of an
//   (K, N) weight is N such rows (`KCH` · N · 2 bytes) and the k16 slice kk
//   starts 32·kk bytes into the row. MN-major (`desc_mn`, the probes'
//   transposed operands): a row holds 64 consecutive m or n of one k.
//   `pack_sm90_chunks` in ops/kernels/fused_mlp.py writes the same bytes
//   on the host.
// - An m64nN accumulator's element i sits in row 16·warp + lane/4 +
//   8·((i >> 1) & 1) and column 8·(i >> 2) + 2·(lane % 4) + (i & 1) of the
//   warpgroup's tile. So pair p = (acc[2p], acc[2p+1]) rounded to a bf16x2
//   register is exactly register p of wgmma's A fragment for the product
//   that reads these columns as its K: k16 slice s is a[4s .. 4s + 3]
//   (`acc_to_a`). A layer's output becomes the next layer's A without
//   leaving the registers.
// - mbarrier waits, 1-D bulk copies (`cp.async.bulk`, multicast to the CTAs
//   of a cluster), named barriers, setmaxnreg and cluster helpers. A wait
//   that has not completed after WATCHDOG_NS traps, so a protocol fault
//   ends the launch with an error instead of hanging the card. No function
//   here calls out (printf is an extern call): ptxas serializes every
//   wgmma of a kernel that contains one.
// - A debug build (-DNERFACE_WATCHDOG_REPORT, `build.py`'s
//   NERFACE_KERNEL_DEFINES) also writes the first trapping wait's block,
//   warpgroup, thread, barrier address and parity to host-mapped words
//   (`nerface_watchdog_arm`) before the trap, where the host reads them
//   after the launch has failed. The production build carries none of it:
//   the report changes ptxas's registers, spills and wgmma serialisation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerface {

typedef __nv_bfloat16 bf16;

namespace sm90 {

constexpr int KCH = 64;            // K rows of one weight chunk (one 128-byte row)
constexpr int ROW_BYTES = 128;     // a swizzled row: 64 bf16
constexpr int ATOM_BYTES = 1024;   // 8 rows
constexpr unsigned long long WATCHDOG_NS = 4000000000ull;

// Byte offset of element (row, col < 64) in a 128-byte-swizzled tile whose
// rows are 128 bytes apart.
__host__ __device__ __forceinline__ int sw128(int row, int col) {
  return row * ROW_BYTES + ((((col >> 3) ^ (row & 7))) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Matrix descriptor of a 128-byte-swizzled operand at shared address
// `addr` (1024-byte aligned atoms): K-major, consecutive 8-row atoms
// `sbo` bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, uint32_t sbo = ATOM_BYTES) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// MN-major: 64-wide column blocks `lbo` bytes apart along M or N, 8-row
// groups along K `sbo` bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching registers an in-flight wgmma reads or
// writes: call after the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n256(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// m64n8k16, A from registers: the heads' products against zero-padded
// 8-column weights (4 accumulators: rows lane/4 and lane/4 + 8, columns
// 2·(lane % 4) and + 1).
__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// m64nNk16 with A from shared memory (K-major unless TRANS_A) or from
// registers; B from shared memory (K-major unless TRANS_B); d += A·B, or
// d = A·B when scale_d is 0.
template <int N, int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(N == 256 || N == 128, "N");
  if constexpr (N == 256) {
    wgmma_ss_n256<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_ss_n128<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  }
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  static_assert(N == 256 || N == 128, "N");
  if constexpr (N == 256) {
    wgmma_rs_n256(d, a, desc_b, scale_d);
  } else {
    wgmma_rs_n128(d, a, desc_b, scale_d);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// relu, then the rounding: one instruction (rounding to nearest keeps the
// sign, so relu before or after it gives the same bits but for -0)
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// The m64nN accumulator through `epi(h, col, v0, v1)` (h: the thread's
// row lane/4 + 8h; columns col, col + 1), then relu when RELU, into bf16
// A-fragment registers: a[p] holds pair p, so the N columns become the
// next product's K.
template <int N, bool RELU, class Epi>
__device__ __forceinline__ void acc_to_a(const float* acc, uint32_t* a, const Epi& epi) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int p = 0; p < N / 4; ++p) {
    const float2 v = epi(p & 1, 8 * (p >> 1) + c2, acc[2 * p], acc[2 * p + 1]);
    a[p] = RELU ? pack_bf16_relu(v.x, v.y) : pack_bf16(v.x, v.y);
  }
}

// -- barriers, copies, clusters ------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive on the barrier at the same offset in CTA `cta` of the cluster. It
// orders nothing but this thread's own earlier accesses at CTA scope (no
// cluster-wide fence): what it releases is a stage whose wgmma reads have
// completed.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

#ifdef NERFACE_WATCHDOG_REPORT
// Host-mapped report words: [0] WATCHDOG_MAGIC once the rest is written,
// [1] blockIdx.x, [2] warpgroup, [3] threadIdx.x, [4] the barrier's shared
// address, [5] its parity, [6] the dynamic shared memory's size (which
// names the kernel), [7] that memory's shared address (a kernel's carve
// starts there, rounded up to 1024). One trapping wait of the launch
// writes them; the other waits that time out spin until its trap ends the
// launch, so they do not end it before the words are out.
constexpr unsigned int WATCHDOG_MAGIC = 0x57a7c400u;
__device__ unsigned int* g_watchdog_words = nullptr;
__device__ unsigned int g_watchdog_claimed = 0;
extern __shared__ unsigned char watchdog_dynamic_smem[];

__device__ __forceinline__ void watchdog_report(uint32_t addr, uint32_t parity) {
  volatile unsigned int* w = g_watchdog_words;
  if (w == nullptr) return;
  if (atomicCAS(&g_watchdog_claimed, 0u, 1u) != 0u) {
    for (;;) __nanosleep(1000);
  }
  uint32_t dyn_size;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(dyn_size));
  w[1] = blockIdx.x;
  w[2] = threadIdx.x / 128;
  w[3] = threadIdx.x;
  w[4] = addr;
  w[5] = parity;
  w[6] = dyn_size;
  w[7] = smem_u32(watchdog_dynamic_smem);
  __threadfence_system();
  w[0] = WATCHDOG_MAGIC;
  __threadfence_system();
}
#endif

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  unsigned long long t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 255) == 0) {
      const unsigned long long t = global_ns();
      if (t0 == 0) {
        t0 = t;
      } else if (t - t0 > WATCHDOG_NS) {
#ifdef NERFACE_WATCHDOG_REPORT
        watchdog_report(addr, parity);
#endif
        asm volatile("trap;\n");
      }
    }
  }
}

// `bytes` from global `src` into shared `dst` of this CTA, completing on
// `bar`; with a mask, into the same offset of every CTA of the cluster
// whose bit is set, completing on each one's barrier at `bar`'s offset.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, "
      "[%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// A ring of shared-memory stages: the stage and the parity of its round.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

}  // namespace sm90
}  // namespace nerface

#ifdef NERFACE_WATCHDOG_REPORT
// Allocates the report words in host-mapped memory, zeroes them and points
// this library's kernels at them; `*host_words` receives their host address.
// Returns a cudaError_t.
extern "C" int nerface_watchdog_arm(void** host_words) {
  using namespace nerface::sm90;
  unsigned int* h = nullptr;
  cudaError_t e = cudaHostAlloc(reinterpret_cast<void**>(&h), 8 * sizeof(unsigned int),
                                cudaHostAllocMapped);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int i = 0; i < 8; ++i) h[i] = 0;
  unsigned int* d = nullptr;
  const unsigned int zero = 0;
  e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&d), h, 0);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_watchdog_words, &d, sizeof(d));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_watchdog_claimed, &zero, sizeof(zero));
  if (e != cudaSuccess) return static_cast<int>(e);
  *host_words = h;
  return 0;
}

// A wait that never completes: one CTA of 4 warps waits on a barrier no
// thread arrives at, so the watchdog traps and reports block 0 (the first
// thread to claim the words). It ends the process's CUDA context.
__global__ void watchdog_selftest_kernel() {
  using namespace nerface::sm90;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  mbar_wait(&bar, 0);
}

extern "C" int nerface_watchdog_selftest(void* stream) {
  watchdog_selftest_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
#endif
