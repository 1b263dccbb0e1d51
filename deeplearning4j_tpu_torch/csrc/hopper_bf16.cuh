// PTX wrappers for the bf16 forms of the kernels that multiply on Hopper's
// tensor cores (sm_90a): bf16 <-> f32 by bits, an 8-byte cp.async, and the
// wgmma.m64nNk16.f32.bf16.bf16 products with A in registers (WgmmaBf16, N =
// 32, 64, 128) or in shared memory (WgmmaBf16SS, N = 32, 64), B in shared
// memory, both K-major (no transpose flag set); and, for the conv's GEMM
// route, an m64n64k16 product whose B is MN-major (WgmmaBf16SSTransB, the
// transpose bit set) with its descriptor (sw128_mn_desc).  The copies,
// fences and the K-major swizzled descriptor are hopper_tf32.cuh's: a
// 16-deep bf16 K step is 32 bytes, the byte depth of an 8-deep tf32 step,
// so the same 128-byte-swizzle tiles and descriptors serve both.
//
// Included by conv_bias_act.cu, lstm_step.cu and flash_attention.cu;
// ops/cuda_kernels.py hashes this header with each source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A bf16's bits as the f32 of the same value (exact).
__device__ __forceinline__ float bf16_bits_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// An f32 rounded to the nearest bf16, ties to even, as its bits.
__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 8 bytes, or zeros when src_bytes is 0 (nothing is read then); src and the
// shared-memory destination 8-byte aligned.
__device__ __forceinline__ void cp_async8_zfill(uint32_t dst, const void* src,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// D[64 x BN] = A[64 x 16] (bf16, registers) * B[16 x BN] (bf16, shared
// memory, K-major, described by desc_b) + (scale_d ? D : 0), f32 D; init
// is D = A * B with D an output only (no earlier value of d kept alive).  A's
// fragment, two bf16 a register (the lower K in the low half): a[0] (row g,
// K 2t, 2t+1), a[1] (row g+8, K 2t, 2t+1), a[2] (row g, K 2t+8, 2t+9), a[3]
// (row g+8, K 2t+8, 2t+9), with g = lane/4 + 16*warp-in-warpgroup, t =
// lane%4.  D's element i: row g + 8 * ((i / 2) % 2), column 8 (i / 4) + 2 t
// + i % 2, as for the tf32 products.  The three immediates after the
// predicate: A and B not negated, B not transposed (K-major).
template <int BN>
struct WgmmaBf16;

template <>
struct WgmmaBf16<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  static __device__ __forceinline__ void init(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  }
};

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  static __device__ __forceinline__ void init(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  }
};


template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

// D[64 x BN] = A[64 x 16] * B[16 x BN] + (scale_d ? D : 0), A and B both
// bf16 in shared memory, K-major (described by desc_a, desc_b); D's layout
// as WgmmaBf16's.  init(d, ...) is D = A * B with D an output only.
template <int BN>
struct WgmmaBf16SS;

template <>
struct WgmmaBf16SS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  static __device__ __forceinline__ void init(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(0));
  }
};

template <>
struct WgmmaBf16SS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  static __device__ __forceinline__ void init(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(0));
  }
};

// D[64 x N] = A[64 x 16] * B[16 x N] + (scale_d ? D : 0), N = 64, A and B
// bf16 in shared memory: A K-major (desc_a, as WgmmaBf16SS), B
// MN-major (the transpose bit set; desc_b from sw128_mn_desc): B's columns,
// not its K rows, are contiguous, as an NCHW image's pixels are.  D's
// layout as WgmmaBf16's.
template <int N>
struct WgmmaBf16SSTransB;

template <>
struct WgmmaBf16SSTransB<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// Descriptor of an MN-major bf16 tile with the 128-byte swizzle: atoms of 8
// K rows by 64 contiguous MN elements (1,024 bytes, row r's 16-byte chunk c
// at r * 128 + ((c ^ r) << 4) from a 1,024-byte-aligned base); the next 8 K
// rows 1,024 bytes on (SBO), the next 64 MN elements `lbo` bytes on (LBO).
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr,
                                                  uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// x0, x1 as bf16 hi and lo pairs (x0 in the low half): hi = x to the
// nearest bf16, lo = x - hi (exact in f32) to the nearest bf16, two
// conversions a cvt.rn.bf16x2.f32 (which puts its first source high).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(hi) : "f"(x1), "f"(x0));
  const float h0 = __uint_as_float(hi << 16);
  const float h1 = __uint_as_float(hi & 0xFFFF0000u);
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(lo) : "f"(x1 - h1), "f"(x0 - h0));
}

// Keeps the compiler from moving accesses of an A-fragment register across
// the wgmma fence/wait around the product that reads it.
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

}  // namespace
