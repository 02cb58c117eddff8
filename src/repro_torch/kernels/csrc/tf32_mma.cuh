// 3xTF32 on Hopper's tensor cores: a float32 product carried by three TF32
// passes, for kernels whose float32 operands must keep ~20 of float32's 24
// bits (one TF32 pass keeps ~11). The split is shared by ssd_chunk.cu
// (mma.sync, below) and the float32 many-row tiles of swiglu_tiles.cuh
// (wgmma).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {   // internal linkage: each library has its own copy

// v = big + small: big is v with the 13 low mantissa bits cleared (a TF32
// value), small = v - big exactly (|small| < 2^-10 |v|), passed whole: the
// tensor core reads the top 19 bits of a TF32 operand, so small enters
// with a relative error below 2^-10 and big*small + small*big + big*big
// carries v*w to ~2^-20.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// d += a * b on one 16x8x8 TF32 fragment, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
