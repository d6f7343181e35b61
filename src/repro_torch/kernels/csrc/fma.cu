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
// latency, so the design keeps each thread's path short: one element
// per thread with a 32-bit index and no grid-stride loop; __fmaf_rn (the
// correctly rounded FMA by definition); a scalar b (passed by value) and
// a tensor b of the output's shape as two instances of one template, so
// no element branches on which it is; and each input's flush one
// instruction, a multiply by 1 with .ftz.  Four elements per thread
// (one float4 load per operand) measured slower at 3,072 elements: the
// launch has too few elements to hide a thread's four chains, and the
// port launches nothing larger.
//
// Subnormals as XLA:CPU treats them (x86's denormals-are-zero and
// flush-to-zero), by xla::fma_flushed (xla_fma.cuh): each input flushed
// by one .ftz multiply, each result tested after rounding.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_fma.cuh"

namespace {

constexpr int kThreads = 128;

// b is read only when kTensorB
template <bool kTensorB>
__global__ void __launch_bounds__(kThreads) fma_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float b_scalar,
    const float* __restrict__ c, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = xla::fma_flushed(xla::daz(a[i]), xla::daz(kTensorB ? b[i] : b_scalar),
                            xla::daz(c[i]));
}

}  // namespace

// a, c, out: n contiguous float32, n < 2^31; b: n contiguous float32, or
// null for the scalar b_scalar.
extern "C" int fma_f32(const void* a, const void* b, float b_scalar,
                       const void* c, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  if (n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  if (b)
    fma_f32_kernel<true><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), 0.f,
        static_cast<const float*>(c), static_cast<float*>(out), static_cast<int>(n));
  else
    fma_f32_kernel<false><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), nullptr, b_scalar,
        static_cast<const float*>(c), static_cast<float*>(out), static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}
