// The GP forecaster's whole per-series program after its patterns are
// built: the evidence loop (Adam on the log marginal likelihood, its
// gradient in closed form), the fit and the iterated horizon, in one
// launch, for Hopper (sm_90a).
//
// Replaces, on the simulation's main path, the Pallas TPU kernel
// src/repro/kernels/gp_gram.py:gp_gram (body _gram_kernel) together with
// the work JAX wrapped around it in src/repro/core/forecast/gp.py
// (_neg_log_marginal, _optimize_evidence under jax.grad, the fit and the
// horizon loop of GPForecaster.forecast), which the reference vmaps over
// the fleet's series.  Its plain PyTorch version is
// repro_torch/kernels/ref.py:gp_fit_forecast (autograd through ref.gram,
// torch.linalg.cholesky_ex and cholesky_solve); ref.gp_evidence_grad
// writes this kernel's gradient out in PyTorch.
//
// Per series b, with N patterns X (N, D), targets y, valid rows m:
//
//   K = sf^2 k(X, X) + diag(m ? sn^2 + jitter : 1e6),  K = L L^T
//   k = exp(-r / ell) ("exp") or exp(-d2 / (2 ell^2)) ("rbf"),
//   d2 = max(|a|^2 + |b|^2 - 2 a.b, 0), r = sqrt(d2 + 1e-12)
//   loss = 0.5 y^T K^-1 y + sum_{m_i} log L_ii + const
//   dloss/dK = G = 0.5 (L^-T diag(m) L^-1 - alpha alpha^T), alpha = K^-1 y
//
// G holds for any mask m (the logdet sums only the valid rows' log L_ii;
// reverse mode through the factor gives L^-T diag(m / 2) L^-1), so rows
// that are all invalid, or valid in no prefix, get the gradient autograd
// gives.  d/d log ell, d/d log sf and d/d log sn follow from G as in
// gp_gram.cu's backward kernel.  A factor that is not positive definite
// is NaN, as the plain version's; its gradient is then NaN, and Adam
// zeroes each non-finite entry, as the reference does.  Then Adam
// (b1 0.9, b2 0.999, eps 1e-8, bias corrections passed in as the float32
// powers the reference uses), clipped to [-6, 6]; the fit at the final
// parameters; and per horizon step the posterior mean and variance (the
// variance clamped at 1e-9, a NaN kept) of the query [t, last values],
// with the mean fed back into the history.
//
// What bounds it: at B = 512 series of N = 10 patterns of D = 11 (the
// default simulation's largest forecast batch) a call moves 289,792 B
// (0.09 us at 3.35 TB/s) and its function needs ~11 MFLOP as
// chip_smoke.py's gp_flops counts them (0.17 us at fp32's 67 TFLOP/s;
// symmetric halves, N^3 / 3 per factor), but each series is a chain
// of 11 N x N factorizations, each N pivots long, with solves, an
// inverse and reductions between: the kernel is bound by that chain's
// latency, not by bytes or operations.  What it removes is the host's
// part: the plain version issues ~1,400 launches per batch.  On the device
// engine's bucketed path a launch covers 2 x A x C = 3,072 rows of which
// only the ready ones run (a few hundred at most at the default config);
// the launch still takes about one series' chain, however few run.
//
// Design: one warp per series, 4 warps per block (fewer when N is large);
// lane i owns rows i and i + 32 of every N x N matrix (N <= 64); the
// distances d2 (and r) are computed once per series, each step only
// re-evaluates the exponential.  Matrices live in the warp's slice of
// shared memory (row stride N | 1, odd, so the lanes' rows fall in distinct
// banks); the Cholesky factor is left-looking, one column per step with
// the pivot passed by a shuffle and its reciprocal kept, so the solves
// multiply; triangular solves keep the vector in registers and shuffle
// each solved entry to the other lanes; lane c computes column c of L^-1.  Only __syncwarp orders a warp's accesses,
// so warps never wait on each other.  The Gram arithmetic is gp_gram.cu's
// (|a|^2, |b|^2 and a.b summed by one loop, each product and sum rounded
// on its own), so the diagonal cancels exactly, as in the plain version;
// the Adam update rounds each operation in the plain version's order.
//
// Ready mask: the device engine passes, in device memory, one byte per
// series that says whether it is forecast-ready.  A warp whose series is
// not ready writes zeros and returns before it stages anything, so the
// launch stays one node of a captured graph and a mask that changes from
// tick to tick needs no host read.  A launch still costs about one
// series' chain whatever the number that run, not in proportion to them.
// Without a mask every series runs.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the caller allocates every output.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxD = 128;
constexpr int kMaxSteps = 256;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSmem = 227 * 1024;   // a block's shared memory on sm_90
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float bc1[kMaxSteps];  // 1 - 0.9^(i+1), float32 powers
  float bc2[kMaxSteps];  // 1 - 0.999^(i+1)
  float init[3];         // log(1), log(1), log(0.3) as float32
  float lr, jitter;
  int B, N, D, H, steps, kind, T;
};

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

// the factor the kernel's exponent divides by ell (r for "exp", d2 for "rbf")
__device__ __forceinline__ float kernel_t(float d2, int kind) {
  return kind == 0 ? __fsqrt_rn(__fadd_rn(d2, 1e-12f)) : d2;
}

// exp(-r / ell) or exp(-d2 / (2 ell^2)) from t = r or d2
__device__ __forceinline__ float unit_kernel(float t, float ell, int kind) {
  if (kind == 0) return expf(__fdiv_rn(-t, ell));
  return expf(__fdiv_rn(__fmul_rn(-0.5f, t), __fmul_rn(ell, ell)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// shared memory per warp, in bytes, for N patterns of D features: at most
// 100,864 B (N = 64, D = 128)
__host__ __device__ int smem_per_warp(int N, int D) {
  const int ld = N | 1;
  return static_cast<int>(sizeof(float)) * (N * D + 4 * N * ld + 4 * N + D);
}

// one warp's slice of shared memory
struct Series {
  float* X;   // (N, D)
  float* Tm;  // (N, ld): r or d2 between patterns
  float* U;   // (N, ld): the unit kernel k at the current ell
  float* L;   // (N, ld): the Cholesky factor (lower)
  float* W;   // (N, ld): L^-1 (lower); W[i][c] is column c's row i
  float* al;  // (N): alpha
  float* mv;  // (N): the valid mask, 1 or 0
  float* id;  // (N): 1 / L_ii
  float* q;   // (D): the horizon's query
  int N, D, ld, lane;
};

// Build K = sf^2 U + diag(noise) and factor it in place into L.  Returns
// false (and fills L with NaN) when a pivot is not > 0 or is NaN.
__device__ bool factor(const Series& s, float ell, float sf, float sn,
                       float jitter, int kind) {
  const int N = s.N, ld = s.ld, lane = s.lane;
  const float s2 = __fmul_rn(sf, sf);
  const float noise_v = __fadd_rn(__fmul_rn(sn, sn), jitter);
  for (int p = lane; p < N * N; p += 32) {
    const int i = p / N, j = p - i * N;
    s.U[i * ld + j] = unit_kernel(s.Tm[i * ld + j], ell, kind);
  }
  __syncwarp();
  bool ok = true;
  for (int j = 0; j < N; ++j) {
    // acc[r]: row lane + 32 r of column j before the division
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = lane + 32 * r;
      if (i < N && i >= j) {
        float a = __fmul_rn(s2, s.U[i * ld + j]);
        if (i == j) a = __fadd_rn(a, s.mv[i] != 0.f ? noise_v : 1e6f);
        for (int k = 0; k < j; ++k) a = fmaf(-s.L[i * ld + k], s.L[j * ld + k], a);
        acc[r] = a;
      }
    }
    const float d = __shfl_sync(kFull, j < 32 ? acc[0] : acc[1], j & 31);
    ok = ok && d > 0.f;
    const float dj = sqrtf(d), inv = __frcp_rn(dj);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = lane + 32 * r;
      if (i < N && i > j) s.L[i * ld + j] = acc[r] * inv;
      if (i == j) {
        s.L[i * ld + j] = dj;
        s.id[j] = inv;
      }
    }
    __syncwarp();
  }
  if (!ok) {
    for (int p = lane; p < N * N; p += 32) {
      const int i = p / N, j = p - i * N;
      s.L[i * ld + j] = NAN;
    }
    for (int i = lane; i < N; i += 32) s.id[i] = NAN;
    __syncwarp();
  }
  return ok;
}

// Solve L L^T x = b for a vector held as b[r] = entry lane + 32 r; the
// result comes back the same way.
__device__ void chol_solve(const Series& s, float b[2]) {
  const int N = s.N, ld = s.ld, lane = s.lane;
  for (int j = 0; j < N; ++j) {  // L z = b
    const float zj = __shfl_sync(kFull, j < 32 ? b[0] : b[1], j & 31) * s.id[j];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = lane + 32 * r;
      if (i > j && i < N) b[r] = fmaf(-s.L[i * ld + j], zj, b[r]);
      if (i == j) b[r] = zj;
    }
  }
  for (int j = N - 1; j >= 0; --j) {  // L^T x = z
    const float xj = __shfl_sync(kFull, j < 32 ? b[0] : b[1], j & 31) * s.id[j];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = lane + 32 * r;
      if (i < j) b[r] = fmaf(-s.L[j * ld + i], xj, b[r]);
      if (i == j) b[r] = xj;
    }
  }
}

__device__ __forceinline__ void load_vec(const Series& s, const float* v, float b[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = s.lane + 32 * r;
    b[r] = i < s.N ? v[i] : 0.f;
  }
}

// The gradient of the loss with respect to (log ell, log sf, log sn) at the
// factor just computed; y is the target vector.
__device__ void evidence_grad(const Series& s, const float* y, float ell,
                              float sf, float sn, int kind, float g[3]) {
  const int N = s.N, ld = s.ld, lane = s.lane;
  float a[2];
  load_vec(s, y, a);
  chol_solve(s, a);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (lane + 32 * r < N) s.al[lane + 32 * r] = a[r];
  // column c of L^-1, for c = lane and lane + 32
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = lane + 32 * r;
    if (c >= N) continue;
    for (int i = c; i < N; ++i) {
      float acc = i == c ? 1.f : 0.f;
      for (int k = c; k < i; ++k) acc = fmaf(-s.L[i * ld + k], s.W[k * ld + c], acc);
      s.W[i * ld + c] = acc * s.id[i];
    }
  }
  __syncwarp();
  // G_ij = 0.5 (sum_k m_k W_ki W_kj - alpha_i alpha_j), k >= max(i, j)
  float sum_l = 0.f, sum_s = 0.f, sum_n = 0.f;
  for (int p = lane; p < N * N; p += 32) {
    const int i = p / N, j = p - i * N;
    float w = 0.f;
    for (int k = max(i, j); k < N; ++k)
      w = fmaf(s.mv[k] * s.W[k * ld + i], s.W[k * ld + j], w);
    const float G = 0.5f * (w - s.al[i] * s.al[j]);
    const float gk = G * s.U[i * ld + j];
    sum_s += gk;
    sum_l += gk * s.Tm[i * ld + j];
    if (i == j) sum_n += G * s.mv[i];
  }
  sum_l = warp_sum(sum_l);
  sum_s = warp_sum(sum_s);
  sum_n = warp_sum(sum_n);
  const float s2 = sf * sf, l2 = ell * ell;
  const float d_ell = sum_l * s2 / (kind == 0 ? l2 : l2 * ell);
  g[0] = d_ell * ell;
  g[1] = 2.f * sf * sum_s * sf;
  g[2] = 2.f * sn * sum_n * sn;
  __syncwarp();  // al and W are rewritten at the next step
}

// Whether series b is not ready; if so, write its outputs as zeros.  Not
// inlined: inlined, ptxas held the whole kernel to 64 registers and
// spilled, and every series ran slower.
__device__ __noinline__ bool skip_series(int b, int lane, const unsigned char* ready,
                                         int H, float* mean, float* var, float* logp) {
  if (ready[b]) return false;
  for (int k = lane; k < H; k += 32) {
    mean[static_cast<size_t>(b) * H + k] = 0.f;
    var[static_cast<size_t>(b) * H + k] = 0.f;
  }
  if (lane < 3) logp[static_cast<size_t>(b) * 3 + lane] = 0.f;
  return true;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gp_forecast_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ hist, float* __restrict__ mean,
                   float* __restrict__ var, float* __restrict__ logp,
                   const unsigned char* __restrict__ ready, const Params P,
                   int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (warp >= warps || b >= P.B) return;
  if (ready != nullptr && skip_series(b, lane, ready, P.H, mean, var, logp)) return;
  const int N = P.N, D = P.D, ld = N | 1, kind = P.kind;
  const int per_warp = smem_per_warp(N, D) / static_cast<int>(sizeof(float));
  Series s;
  s.X = smem + warp * per_warp;
  s.Tm = s.X + N * D;
  s.U = s.Tm + N * ld;
  s.L = s.U + N * ld;
  s.W = s.L + N * ld;
  s.al = s.W + N * ld;
  s.mv = s.al + N;
  s.id = s.mv + N;
  float* y = s.id + N;
  s.q = y + N;
  s.N = N;
  s.D = D;
  s.ld = ld;
  s.lane = lane;

  const float* Xb = X + static_cast<size_t>(b) * N * D;
  for (int e = lane; e < N * D; e += 32) s.X[e] = Xb[e];
  for (int i = lane; i < N; i += 32) {
    y[i] = Y[static_cast<size_t>(b) * N + i];
    s.mv[i] = valid[static_cast<size_t>(b) * N + i] ? 1.f : 0.f;
  }
  __syncwarp();
  for (int p = lane; p < N * N; p += 32) {
    const int i = p / N, j = p - i * N;
    s.Tm[i * ld + j] = kernel_t(sq_dist(s.X + i * D, s.X + j * D, D), kind);
  }
  __syncwarp();

  // the evidence loop: every lane holds the same parameters and moments
  float p[3], m[3] = {0.f, 0.f, 0.f}, v[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = P.init[c];
  const float c1 = 0.1f, c2 = 0.001f;  // float32(1 - 0.9), float32(1 - 0.999)
  for (int it = 0; it < P.steps; ++it) {
    const float ell = expf(p[0]), sf = expf(p[1]), sn = expf(p[2]);
    factor(s, ell, sf, sn, P.jitter, kind);
    float g[3];
    evidence_grad(s, y, ell, sf, sn, kind, g);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gc = isfinite(g[c]) ? g[c] : 0.f;
      m[c] = __fadd_rn(__fmul_rn(0.9f, m[c]), __fmul_rn(c1, gc));
      v[c] = __fadd_rn(__fmul_rn(0.999f, v[c]), __fmul_rn(__fmul_rn(c2, gc), gc));
      const float mh = __fdiv_rn(m[c], P.bc1[it]);
      const float vh = __fdiv_rn(v[c], P.bc2[it]);
      const float step = __fdiv_rn(__fmul_rn(P.lr, mh),
                                   __fadd_rn(__fsqrt_rn(vh), 1e-8f));
      const float pc = __fsub_rn(p[c], step);
      p[c] = pc < -6.f ? -6.f : (pc > 6.f ? 6.f : pc);
    }
  }

  // the fit at the final parameters
  const float ell = expf(p[0]), sf = expf(p[1]), sn = expf(p[2]);
  factor(s, ell, sf, sn, P.jitter, kind);
  float alpha[2];
  load_vec(s, y, alpha);
  chol_solve(s, alpha);
  const float s2 = __fmul_rn(sf, sf);
  const float prior = __fadd_rn(s2, __fmul_rn(sn, sn));

  // the horizon: query [t, last D - 1 values], mean fed back
  const int h = D - 1;
  for (int e = lane; e < h; e += 32) s.q[1 + e] = hist[static_cast<size_t>(b) * h + e];
  for (int k = 0; k < P.H; ++k) {
    if (lane == 0)
      s.q[0] = static_cast<float>(static_cast<double>(P.T + k) /
                                  static_cast<double>(P.T - 1 > 1 ? P.T - 1 : 1));
    __syncwarp();
    float ks[2], kv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = lane + 32 * r;
      ks[r] = j < N ? __fmul_rn(s2, unit_kernel(
                                        kernel_t(sq_dist(s.q, s.X + j * D, D), kind),
                                        ell, kind))
                    : 0.f;
      kv[r] = ks[r];
    }
    const float mk = warp_sum(ks[0] * alpha[0] + ks[1] * alpha[1]);
    chol_solve(s, kv);
    const float vk = __fsub_rn(prior, warp_sum(ks[0] * kv[0] + ks[1] * kv[1]));
    if (lane == 0) {
      mean[static_cast<size_t>(b) * P.H + k] = mk;
      var[static_cast<size_t>(b) * P.H + k] = vk < 1e-9f ? 1e-9f : vk;  // NaN stays
    }
    // shift the history by one and append the mean
    float nxt[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = 1 + lane + 32 * r;
      nxt[r] = e < h ? s.q[e + 1] : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = 1 + lane + 32 * r;
      if (e < h) s.q[e] = nxt[r];
    }
    if (lane == 0) s.q[h] = mk;
    __syncwarp();
  }
  if (lane < 3) logp[static_cast<size_t>(b) * 3 + lane] = p[lane];
}

}  // namespace

// Allow the kernel its opt-in shared memory on the current device: once,
// before the first launch (never inside one, so a captured CUDA graph
// holds launches only).  A large GP config (N, D) takes more than the
// default 48 KB per block.
extern "C" int gp_forecast_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      gp_forecast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

// X (B,N,D), y (B,N) float32; valid (B,N) bool; hist (B,D-1) float32;
// bc1, bc2 (steps) and init (3) host float32 arrays.  Outputs mean and
// var (B,H), logp (B,3).  kind: 0 = "exp", 1 = "rbf".  ready: null, or
// B device bytes (series b runs iff ready[b] != 0).  Sizes are checked
// by the Python wrapper; the checks here only keep a bad call from
// launching.
extern "C" int gp_forecast(const float* X, const float* y,
                           const unsigned char* valid, const float* hist,
                           float* mean, float* var, float* logp, int B, int N,
                           int D, int H, int T, int steps, int kind, float lr,
                           float jitter, const float* bc1, const float* bc2,
                           const float* init, const unsigned char* ready,
                           void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || D < 2 || D > kMaxD || H < 1 || T < 1 ||
      steps < 0 || steps > kMaxSteps || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  for (int i = 0; i < steps; ++i) {
    P.bc1[i] = bc1[i];
    P.bc2[i] = bc2[i];
  }
  for (int c = 0; c < 3; ++c) P.init[c] = init[c];
  P.lr = lr;
  P.jitter = jitter;
  P.B = B;
  P.N = N;
  P.D = D;
  P.H = H;
  P.steps = steps;
  P.kind = kind;
  P.T = T;
  const int per_warp = smem_per_warp(N, D);
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * per_warp > kMaxSmem) --warps;
  const int smem = warps * per_warp;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + warps - 1) / warps;
  gp_forecast_kernel<<<blocks, 32 * kWarpsPerBlock, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      X, y, valid, hist, mean, var, logp, ready, P, warps);
  return static_cast<int>(cudaGetLastError());
}
