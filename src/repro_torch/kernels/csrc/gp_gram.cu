// Batched history-kernel Gram matrix (paper Eq. 6) and its gradient with
// respect to the per-series hyper-parameters (ell, sf), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gp_gram.py:gp_gram (body
// _gram_kernel), which the GP forecaster runs under vmap over the fleet's
// series, and the gradient JAX derived from it for the evidence loop
// (src/repro/core/forecast/gp.py:88-128).
//
//   K[b,i,j] = sf_b^2 * exp(-r / ell_b)            kind 0 ("exp")
//   K[b,i,j] = sf_b^2 * exp(-d2 / (2 ell_b^2))     kind 1 ("rbf")
//   d2 = max(|a|^2 + |b|^2 - 2 a.b, 0),  r = sqrt(d2 + 1e-12)
//
// What bounds it: on the main path a tick holds B = 64..512 series of
// (10 x 11) patterns.  At B = 512 the forward pass reads ~0.45 MB and
// writes ~0.2 MB (about 0.2 us at 3.35 TB/s) and does ~1.5 MFLOP, so the
// card could finish it in a fraction of a microsecond: the kernel is
// bound by its launch, not by bytes or operations.  The design is the
// simplest one that is right: one thread block per series, threads
// striding over the (i, j) pairs, plain fp32 loops over D, no padding
// (the loops mask their own edges), no shared-memory tiling.
//
// Numerics: d2 uses the same identity as the reference (not sum (a-b)^2,
// which would move the diagonal and with it the GP's results), and every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction), in the order of the plain PyTorch version in
// repro_torch/kernels/ref.py.  So |a|^2 and a.a cancel exactly on the
// diagonal of K(X, X), and kernel and plain version agree to the rounding
// of exp.  The per-series sums of the backward pass are a block
// reduction, so they differ from the plain version in summation order
// only.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError(); the caller allocates every output.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // power of two: the backward tree reduction needs it

__device__ __forceinline__ float sq_dist(const float* __restrict__ a,
                                         const float* __restrict__ b, int D) {
  float na = 0.f, nb = 0.f, ab = 0.f;
  for (int k = 0; k < D; ++k) {
    const float x = a[k], y = b[k];
    na = __fadd_rn(na, __fmul_rn(x, x));
    nb = __fadd_rn(nb, __fmul_rn(y, y));
    ab = __fadd_rn(ab, __fmul_rn(x, y));
  }
  const float d2 = __fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.f, ab));
  return d2 < 0.f ? 0.f : d2;  // keeps a NaN, as the plain version's clamp does
}

// exp(-r / ell) or exp(-d2 / (2 ell^2)); *t receives r or d2, the factor
// that the derivative with respect to ell multiplies K by.
__device__ __forceinline__ float unit_kernel(float d2, float ell, int kind,
                                             float* t) {
  if (kind == 0) {
    const float r = __fsqrt_rn(__fadd_rn(d2, 1e-12f));
    *t = r;
    return expf(__fdiv_rn(-r, ell));
  }
  *t = d2;
  return expf(__fdiv_rn(__fmul_rn(-0.5f, d2), __fmul_rn(ell, ell)));
}

__global__ void __launch_bounds__(kThreads)
gram_fwd_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                const float* __restrict__ ell, const float* __restrict__ sf,
                float* __restrict__ out, int M, int N, int D, int kind) {
  const int b = blockIdx.x;
  const float* A = xa + static_cast<size_t>(b) * M * D;
  const float* X = xb + static_cast<size_t>(b) * N * D;
  float* K = out + static_cast<size_t>(b) * M * N;
  const float l = ell[b], s = sf[b];
  const float s2 = __fmul_rn(s, s);
  for (int p = threadIdx.x; p < M * N; p += kThreads) {
    const int i = p / N, j = p - i * N;
    float t;
    K[p] = __fmul_rn(s2, unit_kernel(sq_dist(A + i * D, X + j * D, D), l,
                                     kind, &t));
  }
}

// d_ell[b] = sum_ij G K r / ell^2   (exp)   or   sum_ij G K d2 / ell^3 (rbf)
// d_sf[b]  = 2 sf sum_ij G k        (k = K / sf^2)
__global__ void __launch_bounds__(kThreads)
gram_bwd_kernel(const float* __restrict__ grad, const float* __restrict__ xa,
                const float* __restrict__ xb, const float* __restrict__ ell,
                const float* __restrict__ sf, float* __restrict__ d_ell,
                float* __restrict__ d_sf, int M, int N, int D, int kind) {
  __shared__ float red_l[kThreads];
  __shared__ float red_s[kThreads];
  const int b = blockIdx.x;
  const float* A = xa + static_cast<size_t>(b) * M * D;
  const float* X = xb + static_cast<size_t>(b) * N * D;
  const float* G = grad + static_cast<size_t>(b) * M * N;
  const float l = ell[b], s = sf[b];
  const float s2 = __fmul_rn(s, s);
  float acc_l = 0.f, acc_s = 0.f;
  for (int p = threadIdx.x; p < M * N; p += kThreads) {
    const int i = p / N, j = p - i * N;
    float t;
    const float k = unit_kernel(sq_dist(A + i * D, X + j * D, D), l, kind, &t);
    const float gk = __fmul_rn(G[p], k);
    acc_s = __fadd_rn(acc_s, gk);
    acc_l = __fadd_rn(acc_l, __fmul_rn(__fmul_rn(gk, s2), t));
  }
  red_l[threadIdx.x] = acc_l;
  red_s[threadIdx.x] = acc_s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      red_l[threadIdx.x] += red_l[threadIdx.x + w];
      red_s[threadIdx.x] += red_s[threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float l2 = __fmul_rn(l, l);
    d_ell[b] = __fdiv_rn(red_l[0], kind == 0 ? l2 : __fmul_rn(l2, l));
    d_sf[b] = __fmul_rn(__fmul_rn(2.f, s), red_s[0]);
  }
}

}  // namespace

extern "C" int gp_gram_fwd(const float* xa, const float* xb, const float* ell,
                           const float* sf, float* out, int B, int M, int N,
                           int D, int kind, void* stream) {
  gram_fwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xa, xb, ell, sf, out, M, N, D, kind);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gp_gram_bwd(const float* grad, const float* xa, const float* xb,
                           const float* ell, const float* sf, float* d_ell,
                           float* d_sf, int B, int M, int N, int D, int kind,
                           void* stream) {
  gram_bwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grad, xa, xb, ell, sf, d_ell, d_sf, M, N, D, kind);
  return static_cast<int>(cudaGetLastError());
}
