// a * b + c as XLA:CPU computes the reference's contracted `a * b + c`:
// one fused multiply-add, rounded once, with subnormals as x86's
// denormals-are-zero and flush-to-zero give them.  Shared by fma.cu
// (the elementwise kernel) and calib.cu (the calibration's miscoverage
// test and adaptive quantile step).  Its plain version is
// repro_torch/kernels/ref.py:fma_f32.
//
// An input below 2^-126 in magnitude is read as a zero of its sign, and
// a result is flushed to a zero of its sign when it is tiny after
// rounding, i.e. when the exact value rounded to 24 bits with no lower
// limit on the exponent lies below 2^-126 (2^-126 - 2^-150 is flushed; a
// value a quarter of an ulp below 2^-126 rounds up to it and is kept).
// Only a nonzero result of at most 2^-126 can be tiny; then |a| <= 2^48
// and |c| <= 2^-77, so the FMA of a * 2^64 and c * 2^64 is exact in its
// scaling and rounds 2^64 times the exact value in the normal range,
// which decides.  Explicit here (each input by a .ftz multiply, each
// result by that test), not by -ftz: the flags build every kernel of the
// package, and the others keep IEEE subnormals.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace xla {

constexpr float kTiny = 0x1p-126f;   // the least normal float32

// x read as XLA:CPU reads it: a subnormal as a zero of its sign (a
// multiply by 1 that flushes its input; exact for every other x)
__device__ __forceinline__ float daz(float x) {
  float r;
  asm("mul.ftz.f32 %0, %1, 0f3F800000;" : "=f"(r) : "f"(x));
  return r;
}

// a, b, c already read through daz
__device__ __forceinline__ float fma_flushed(float x, float y, float z) {
  float r = __fmaf_rn(x, y, z);
  if (r != 0.f && fabsf(r) <= kTiny) {
    const float scaled = __fmaf_rn(x * 0x1p64f, y, z * 0x1p64f);
    if (fabsf(scaled) < 0x1p-62f) r = copysignf(0.f, scaled);
  }
  return r;
}

__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return fma_flushed(daz(a), daz(b), daz(c));
}

}  // namespace xla
