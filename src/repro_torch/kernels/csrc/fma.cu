// out = a * b + c rounded once to float32: the fused multiply-add that
// XLA:CPU makes of the reference's `a * b + c`, elementwise.
//
// Replaces: XLA's contraction of `a * b + c` into one FMA in the
// reference's tick (repro/sim/step.py: the usage interpolation, the
// progress update, the oracle's look-ahead, the safeguard's
// k1 * request + dynamic term), XLA code, not a Pallas kernel.  Its
// plain version is repro_torch/kernels/ref.py:fma_f32, which rounds to
// odd in float64 to reach the same bits on the CPU.
//
// What bounds it: bytes, (2 or 3 reads + 1 write) x 4 B per element;
// at the engine's sizes (a few thousand elements) a launch is all
// latency.  The design: one thread per element in a grid-stride loop,
// __fmaf_rn (the correctly rounded FMA by definition), and b either a
// tensor of the output's shape or one scalar passed by value.
//
// Subnormals as XLA:CPU treats them (x86's denormals-are-zero and
// flush-to-zero): an input below 2^-126 in magnitude is read as a zero
// of its sign, and a result is flushed to a zero of its sign when it is
// tiny after rounding, i.e. when the exact value rounded to 24 bits with
// no lower limit on the exponent lies below 2^-126 (2^-126 - 2^-150 is
// flushed; a value a quarter of an ulp below 2^-126 rounds up to it and
// is kept).  Only a nonzero result of at most 2^-126 can be tiny; then
// |a| <= 2^48 and |c| <= 2^-77, so the FMA of a * 2^64 and c * 2^64 is
// exact in its scaling and rounds 2^64 times the exact value in the
// normal range, which decides.  Explicit here, not by -ftz: the flags
// build every kernel of the package, and the others keep IEEE
// subnormals.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kTiny = 0x1p-126f;   // the least normal float32

__device__ __forceinline__ float daz(float x) {
  return fabsf(x) < kTiny ? copysignf(0.f, x) : x;
}

__global__ void __launch_bounds__(256) fma_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float b_scalar,
    const float* __restrict__ c, float* __restrict__ out, int64_t n) {
  const float bs = daz(b_scalar);
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const float x = daz(a[i]), y = b ? daz(b[i]) : bs, z = daz(c[i]);
    float r = __fmaf_rn(x, y, z);
    if (r != 0.f && fabsf(r) <= kTiny) {
      const float scaled = __fmaf_rn(x * 0x1p64f, y, z * 0x1p64f);
      if (fabsf(scaled) < 0x1p-62f) r = copysignf(0.f, scaled);
    }
    out[i] = r;
  }
}

}  // namespace

// a, c, out: n contiguous float32; b: n contiguous float32, or null for
// the scalar b_scalar.
extern "C" int fma_f32(const void* a, const void* b, float b_scalar,
                       const void* c, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fma_f32_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), threads,
                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), b_scalar,
      static_cast<const float*>(c), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
