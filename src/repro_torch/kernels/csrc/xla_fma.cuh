// XLA:CPU's float32 arithmetic as the reference's compiled tick runs it
// on x86, for the kernels that must equal it to the bit.  Shared by fma.cu
// (the elementwise kernel), calib.cu, control.cu and obs.cu.
//
// a * b + c as XLA:CPU computes the reference's contracted `a * b + c`:
// one fused multiply-add, rounded once, with subnormals as x86's
// denormals-are-zero and flush-to-zero give them.  Its plain version is
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

// ---- the other operations (ref.py:add_xla, sub_xla, mul_xla, div_xla,
// fmax, nan_x86) ----

// A NaN result of an x86 add, product or quotient: the first NaN operand,
// quieted; else (inf - inf, 0 * inf, 0 / 0) x86's default NaN.  CUDA's
// arithmetic returns its canonical NaN 0x7fffffff instead.
constexpr unsigned kDefaultNaN = 0xffc00000u;
__device__ __forceinline__ float quiet(float a) {
  return __uint_as_float(__float_as_uint(a) | 0x400000u);
}
__device__ __forceinline__ float nan_x86(float a, float b) {
  return a != a ? quiet(a) : b != b ? quiet(b) : __uint_as_float(kDefaultNaN);
}

// a + b with subnormals read and flushed as zeros of their signs (a sum
// below 2^-126 is exact, so the flush after rounding is x86's); a NaN as
// CUDA's: the chains below fix it where one ends in a NaN
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add(float a, float b) {
  const float r = add_ftz(a, b);
  return r == r ? r : nan_x86(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r == r ? r : nan_x86(a, b);
}
// a * b: the product rounded once, flushed where it is tiny after rounding
// to 24 bits (decided, without a branch, on the product scaled by 2^64:
// where it is not tiny the card's rounding, gradual below 2^-126, gives the
// same bits)
__device__ __forceinline__ float mul(float a, float b) {
  const float x = daz(a), y = daz(b);
  const float r = __fmul_rn(x, y), scaled = __fmul_rn(x * 0x1p64f, y);
  const float f = fabsf(scaled) < 0x1p-62f ? copysignf(0.f, scaled) : r;
  return f == f ? f : nan_x86(a, b);
}
// a / b: a quotient tiny after rounding to 24 bits (decided on the
// quotient scaled by 2^64, exact) flushed to a zero of its sign
__device__ __forceinline__ float div(float a, float b) {
  const float x = daz(a), y = daz(b);
  float r = __fdiv_rn(x, y);
  if (r != r) return nan_x86(a, b);
  if (r != 0.f && fabsf(r) <= kTiny && fabsf(__fdiv_rn(x * 0x1p64f, y)) < 0x1p-62f)
    r = copysignf(0.f, r);
  return r;
}
// The reference's max, a select: a NaN operand (of two, the first where
// its sign bit is set, else the second; neither quieted), +0 above -0
__device__ __forceinline__ float fmax(float a, float b) {
  if (a != a && (b == b || signbit(a))) return a;
  if (b != b) return b;
  return a == b ? __int_as_float(__float_as_int(a) & __float_as_int(b)) : fmaxf(a, b);
}

// A sum in the reference's order, `run(add)` folding two sums side by
// side with `add`: first on the card's adds; where either ends in a NaN,
// again with x86's, whose NaN is the first one the chain met.
struct AddFtz {
  __device__ __forceinline__ float operator()(float a, float b) const { return add_ftz(a, b); }
};
struct AddX86 {
  __device__ __forceinline__ float operator()(float a, float b) const { return add(a, b); }
};
template <class Run>
__device__ __forceinline__ float2 fold(const Run& run) {
  float2 r = run(AddFtz{});
  if (r.x != r.x || r.y != r.y) r = run(AddX86{});
  return r;
}

// XLA:CPU's tree over n terms (ref.py:xla_sum): over more than 32 the axis
// padded to a multiple of 32 (lo of the padding before the first term),
// each window of 32 summed in order from its first term, then the
// windows' sums; 32 or fewer, one window
constexpr int kWindow = 32;
struct Windows {
  int lo, count;
  __device__ __host__ __forceinline__ explicit Windows(int n)
      : lo(n <= kWindow ? 0 : ((n + kWindow - 1) / kWindow * kWindow - n) / 2),
        count(n <= kWindow ? 1 : (n + kWindow - 1) / kWindow) {}
  // window w's terms [first(w), end(w, n))
  __device__ __forceinline__ int first(int w) const { return w * kWindow - lo > 0 ? w * kWindow - lo : 0; }
  __device__ __forceinline__ int end(int w, int n) const {
    return w * kWindow + kWindow - lo < n ? w * kWindow + kWindow - lo : n;
  }
};

}  // namespace xla
