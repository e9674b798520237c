// Register-A wgmma at every N the kernels take (16 to 128 in steps of 16):
//
//   WgmmaRS<N>  wgmma.mma_async m64nNk16, f32 sums of bf16 products, A
//               (64x16) from registers in the mma.m16n8k16 A-fragment layout
//               (warp w of the warpgroup holds rows 16w..16w+15), B (16xN)
//               K-major in shared memory through a descriptor.
//   WgmmaS8<N>  wgmma.mma_async m64nNk32, exact s32 sums of s8 x s8 products
//               (no .satfinite: |sum| <= 127^2 * 9 * 256 < 2^31 never
//               clips), A (64x32 bytes) from registers in the mma.m16n8k32
//               s8 A-fragment layout -- byte for byte the bf16 k16 fragment,
//               so one ldmatrix.x4 loads either -- and B (32xN) K-major in
//               shared memory through the same descriptor.
//
// scale-d is true: the accumulator is always added to.  Each thread holds
// N / 2 accumulators, the asm's operands %0 .. %(N/2 - 1); A, the
// descriptor and scale-d follow them.

#pragma once

#include <stdint.h>

namespace scm {

template <int N>
struct WgmmaRS;

template <int N>
struct WgmmaS8;

// d[0] .. d[N/2 - 1] as asm operands with constraint C, and their names.
#define SCM_D8(C, i)                                                            \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]),    \
      C(d[i + 6]), C(d[i + 7])
#define SCM_D16(C) SCM_D8(C, 0)
#define SCM_D32(C) SCM_D16(C), SCM_D8(C, 8)
#define SCM_D48(C) SCM_D32(C), SCM_D8(C, 16)
#define SCM_D64(C) SCM_D48(C), SCM_D8(C, 24)
#define SCM_D80(C) SCM_D64(C), SCM_D8(C, 32)
#define SCM_D96(C) SCM_D80(C), SCM_D8(C, 40)
#define SCM_D112(C) SCM_D96(C), SCM_D8(C, 48)
#define SCM_D128(C) SCM_D112(C), SCM_D8(C, 56)
#define SCM_R16 "%0, %1, %2, %3, %4, %5, %6, %7"
#define SCM_R32 SCM_R16 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define SCM_R48 SCM_R32 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define SCM_R64 SCM_R48 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define SCM_R80 SCM_R64 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define SCM_R96 SCM_R80 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define SCM_R112 SCM_R96 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define SCM_R128 SCM_R112 ", %56, %57, %58, %59, %60, %61, %62, %63"

// One specialization; A0-A3, DESC and PRED number the operands after the
// accumulators (N/2 .. N/2 + 5).
#define SCM_WGMMA(STRUCT, N, T, C, SHAPE, TAIL, A0, A1, A2, A3, DESC, PRED)      \
  template <>                                                                   \
  struct STRUCT<N> {                                                            \
    __device__ __forceinline__ static void run(T (&d)[N / 2],                   \
                                               const uint32_t (&a)[4],          \
                                               uint64_t desc) {                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #PRED ", 0;\n"           \
                   "wgmma.mma_async.sync.aligned.m64n" #N SHAPE " "              \
                   "{" SCM_R##N "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3        \
                   "}, %" #DESC ", p" TAIL ";\n}\n"                              \
                   : SCM_D##N(C)                                                \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),      \
                     "r"(1));                                                   \
    }                                                                           \
  };
#define SCM_WGMMA_N(N, ...)                                                     \
  SCM_WGMMA(WgmmaRS, N, float, "+f", "k16.f32.bf16.bf16", ", 1, 1, 0",          \
            __VA_ARGS__)                                                        \
  SCM_WGMMA(WgmmaS8, N, int, "+r", "k32.s32.s8.s8", "", __VA_ARGS__)

SCM_WGMMA_N(16, 8, 9, 10, 11, 12, 13)
SCM_WGMMA_N(32, 16, 17, 18, 19, 20, 21)
SCM_WGMMA_N(48, 24, 25, 26, 27, 28, 29)
SCM_WGMMA_N(64, 32, 33, 34, 35, 36, 37)
SCM_WGMMA_N(80, 40, 41, 42, 43, 44, 45)
SCM_WGMMA_N(96, 48, 49, 50, 51, 52, 53)
SCM_WGMMA_N(112, 56, 57, 58, 59, 60, 61)
SCM_WGMMA_N(128, 64, 65, 66, 67, 68, 69)

#undef SCM_WGMMA_N
#undef SCM_WGMMA
#undef SCM_D8
#undef SCM_D16
#undef SCM_D32
#undef SCM_D48
#undef SCM_D64
#undef SCM_D80
#undef SCM_D96
#undef SCM_D112
#undef SCM_D128
#undef SCM_R16
#undef SCM_R32
#undef SCM_R48
#undef SCM_R64
#undef SCM_R80
#undef SCM_R96
#undef SCM_R112
#undef SCM_R128

}  // namespace scm
