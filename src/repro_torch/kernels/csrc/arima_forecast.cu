// ARIMA forecasts of a batch of series (paper §3.1.1): for each series,
// the scale normalisation, the Hannan-Rissanen fit of every candidate
// order (p, d, q), their AICs, the choice of the first least AIC, and the
// chosen order's k-step recursion and psi-weight variance, or the
// last-value fallback of a window with too few valid samples.
//
// Replaces: the reference's ARIMAForecaster.forecast (plain JAX, no
// Pallas kernel: repro/core/forecast/arima.py:140-212), which XLA fuses
// into one program; written as plain PyTorch it would put hundreds of
// small kernels into every captured tick of the device engine (two small
// solves and a recursion for each of 22 candidates).  Its plain version
// is repro_torch/kernels/ref.py:arima_select, which performs the same
// float32 operations in the same order: every product, sum and quotient
// here is one IEEE operation (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn: never contracted into a fused multiply-add), square roots
// are correctly rounded and logarithms are taken in double and rounded
// once, so the kernel gives the plain version's bits.
//
// Design: one warp per series, one lane per candidate order (22 of 32 at
// the default orders; lanes beyond the candidates compute a dummy fit
// and drop out of the choice).  The series, its first difference and the
// two stage-1 innovation series live in the warp's shared memory; each
// lane sums its own normal equations in registers (the stage-1 long AR
// of its d, 7 x 7, then its stage-2 6 x 6), stores them to a per-lane
// column of shared memory (element (i, j) of lane l at (i n + j) 32 + l,
// so the lanes never share a bank) and solves them there by LU with
// partial pivoting (the first row of largest magnitude).  The lanes of
// one d compute the same stage-1 fit; the first of them writes its
// innovations.  A warp argmin (ties to the lowest index, as jnp.argmin)
// picks the order; the winning lane runs the recursion and writes the
// series' (mean, var) rows.  An unmarked series (ready mask) writes
// zeros and returns, so one launch a forecasting tick serves the device
// engine's ready rows.  Excluded regressors are pinned (identity row and
// column) at fixed places of the 7 x 7 and 6 x 6 layouts, which leaves
// the active unknowns' arithmetic that of the reference's smaller
// systems (pinned rows and columns add and subtract exact zeros).
//
// What bounds it: operations.  A series with T samples costs each lane
// about T (28 + 21) multiply-adds of normal equations, two LU solves
// (~150 operations) and 2 T (7 + 6) for the residuals: ~1,500
// dependent operations a lane at T = 24, latency rather than issue bound
// at the device engine's 3,072 rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                     // series per block
constexpr int kMaxP = 3, kMaxQ = 2, kMaxM = 6;
constexpr int kN1 = kMaxM + 1;                // stage 1: intercept + long AR lags
constexpr int kN2 = 1 + kMaxP + kMaxQ;        // stage 2: intercept + z lags + e lags
constexpr int kLu = kN1 * kN1 + kN1;          // floats of a lane's system
constexpr float kRidge = 1e-4f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
// max(v, floor) that keeps a NaN, as torch.maximum and jnp.maximum do
__device__ __forceinline__ float at_least(float v, float floor) {
  return v < floor ? floor : v;
}

// Store the lane's summed normal equations (upper triangle of g, and b)
// to its shared-memory column with the ridge on the active diagonal and
// the excluded columns pinned, then solve them: x = G^-1 b (LU with
// partial pivoting, then back substitution), times the column mask.
template <int n>
__device__ void masked_solve(const float (&g)[n][n], const float (&b)[n],
                             const float (&cm)[n], float* lu, int lane, float (&x)[n]) {
#define G(i, j) lu[((i) * n + (j)) * 32 + lane]
#define R(i) lu[(n * n + (i)) * 32 + lane]
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const float gij = j >= i ? g[i][j] : g[j][i];
      const bool active = cm[i] > 0.f && cm[j] > 0.f;
      G(i, j) = active ? (i == j ? add(gij, kRidge) : gij) : (i == j ? 1.f : 0.f);
    }
    R(i) = b[i];
  }
  for (int k = 0; k < n; ++k) {
    int piv = k;
    float best = fabsf(G(k, k));
    for (int i = k + 1; i < n; ++i) {
      const float v = fabsf(G(i, k));
      if (v > best) {
        best = v;
        piv = i;
      }
    }
    if (piv != k) {
      for (int j = 0; j < n; ++j) {
        const float t = G(k, j);
        G(k, j) = G(piv, j);
        G(piv, j) = t;
      }
      const float t = R(k);
      R(k) = R(piv);
      R(piv) = t;
    }
    const float gkk = G(k, k), bk = R(k);
    for (int i = k + 1; i < n; ++i) {
      const float l = quo(G(i, k), gkk);
      for (int j = k + 1; j < n; ++j) G(i, j) = sub(G(i, j), mul(l, G(k, j)));
      R(i) = sub(R(i), mul(l, bk));
    }
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    float acc = R(i);
#pragma unroll
    for (int j = i + 1; j < n; ++j) acc = sub(acc, mul(G(i, j), x[j]));
    x[i] = quo(acc, G(i, i));
  }
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = mul(x[i], cm[i]);
#undef G
#undef R
}

// g += a a^T (upper triangle) and b += a z, one product and one sum each
template <int n>
__device__ __forceinline__ void accumulate(float (&g)[n][n], float (&b)[n],
                                           const float (&a)[n], float z) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = i; j < n; ++j) g[i][j] = add(g[i][j], mul(a[i], a[j]));
    b[i] = add(b[i], mul(a[i], z));
  }
}

template <int n>
__device__ __forceinline__ float dot(const float (&a)[n], const float (&x)[n]) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < n; ++j) acc = add(acc, mul(a[j], x[j]));
  return acc;
}

__global__ void __launch_bounds__(kWarps * 32) arima_forecast_kernel(
    const float* __restrict__ windows, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ ready, float* __restrict__ mean_out,
    float* __restrict__ var_out, int B, int T, int H, int P, int Q, int D, int M) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= B) return;
  float* mo = mean_out + static_cast<size_t>(s) * H;
  float* vo = var_out + static_cast<size_t>(s) * H;
  if (ready != nullptr && !ready[s]) {
    for (int j = lane; j < H; j += 32) mo[j] = vo[j] = 0.f;
    return;
  }
  // the warp's shared memory: y (the window, then normalised in place),
  // its first difference, the stage-1 innovations of d = 0 and 1, the
  // lanes' systems, the valid flags
  float* y = smem + static_cast<size_t>(warp) * (4 * T + kLu * 32);
  float* z1 = y + T;
  float* e0 = z1 + T;
  float* e1 = e0 + T;
  float* lu = e1 + T;
  uint8_t* vs = reinterpret_cast<uint8_t*>(smem + static_cast<size_t>(kWarps) * (4 * T + kLu * 32))
                + warp * ((T + 15) / 16 * 16);
  const float* w = windows + static_cast<size_t>(s) * T;
  for (int t = lane; t < T; t += 32) {
    y[t] = w[t];
    vs[t] = valid[static_cast<size_t>(s) * T + t] != 0;
  }
  __syncwarp();

  // scale normalisation: every lane sums the same terms in the same order
  float cnt = 0.f, sum = 0.f;
  for (int t = 0; t < T; ++t) {
    const float wt = vs[t] ? 1.f : 0.f;
    cnt = add(cnt, wt);
    sum = add(sum, mul(y[t], wt));
  }
  const float den = at_least(cnt, 1.f);
  const float mu = quo(sum, den);
  float ss = 0.f;
  for (int t = 0; t < T; ++t) {
    const float dv = sub(y[t], mu);
    ss = add(ss, mul(mul(dv, dv), vs[t] ? 1.f : 0.f));
  }
  const float sd = __fsqrt_rn(at_least(quo(ss, den), 1e-8f));
  const float last = w[T - 1];
  if (cnt < static_cast<float>(M + P + 2)) {       // too few samples: the last value
    const float u = add(mul(0.5f, fabsf(last)), 1.f);
    const float v = at_least(mul(u, u), 1e-9f);
    for (int j = lane; j < H; j += 32) {
      mo[j] = last;
      vo[j] = v;
    }
    return;
  }
  __syncwarp();
  for (int t = lane; t < T; t += 32) y[t] = quo(sub(y[t], mu), sd);
  __syncwarp();
  for (int t = lane; t < T; t += 32) z1[t] = t == 0 ? 0.f : sub(y[t], y[t - 1]);
  __syncwarp();

  // this lane's candidate: (d, p, q) in the reference's order
  const int per_d = (P + 1) * (Q + 1) - 1;
  const int n_cand = (D + 1) * per_d;
  const bool real = lane < n_cand;
  const int c = real ? lane : 0;
  const int d = c / per_d;
  int p = 0, q = 0;
  for (int k = c % per_d + 1, i = 0; i <= P; ++i)   // skip (0, 0)
    for (int j = 0; j <= Q; ++j)
      if (i + j > 0 && --k == 0) {
        p = i;
        q = j;
      }
  const float* z = d ? z1 : y;
  float* e = d ? e1 : e0;
  auto zm = [&](int t) { return d ? (t > 0 && vs[t] && vs[t - 1]) : vs[t] != 0; };
  auto rows1 = [&](int t) { return zm(t) && t >= M; };

  // stage 1: the long AR(M) of this d
  float x1[kN1];
  {
    float g[kN1][kN1] = {}, b[kN1] = {}, cm[kN1];
#pragma unroll
    for (int j = 0; j < kN1; ++j) cm[j] = j <= M ? 1.f : 0.f;
    for (int t = M; t < T; ++t) {
      if (!zm(t)) continue;
      float a[kN1];
      a[0] = 1.f;
#pragma unroll
      for (int j = 1; j < kN1; ++j) a[j] = j <= M ? z[t - j] : 0.f;
      accumulate(g, b, a, z[t]);
    }
    masked_solve(g, b, cm, lu, lane, x1);
  }
  if (real && c % per_d == 0) {        // the first lane of its d writes the innovations
    for (int t = 0; t < T; ++t) {
      float a[kN1];
      a[0] = 1.f;
#pragma unroll
      for (int j = 1; j < kN1; ++j) a[j] = j <= M && t - j >= 0 ? z[t - j] : 0.f;
      e[t] = rows1(t) ? sub(z[t], dot(a, x1)) : 0.f;
    }
  }
  __syncwarp();

  // stage 2: z on [1, p lags of z, q lags of e]; rows need every one of
  // the reference's max_p and max_q lag columns active and in sample
  float cm[kN2];
  cm[0] = 1.f;
#pragma unroll
  for (int j = 0; j < kMaxP; ++j) cm[1 + j] = j < p ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < kMaxQ; ++j) cm[1 + kMaxP + j] = j < q ? 1.f : 0.f;
  const bool full = p == P && q == Q;
  auto rows2 = [&](int t) {
    return zm(t) && full && t >= P && t >= Q && (q == 0 || rows1(t == 0 ? T - 1 : t - 1));
  };
  auto regressors = [&](int t, float (&a)[kN2]) {
    a[0] = 1.f;
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) a[1 + j] = t - 1 - j >= 0 ? z[t - 1 - j] : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxQ; ++j) a[1 + kMaxP + j] = t - 1 - j >= 0 ? e[t - 1 - j] : 0.f;
  };
  float beta[kN2];
  {
    float g[kN2][kN2] = {}, b[kN2] = {};
    for (int t = 0; t < T; ++t) {
      if (!rows2(t)) continue;
      float a[kN2];
      regressors(t, a);
#pragma unroll
      for (int j = 0; j < kN2; ++j) a[j] = mul(a[j], cm[j]);
      accumulate(g, b, a, z[t]);
    }
    masked_solve(g, b, cm, lu, lane, beta);
  }
  float ssq = 0.f, r_last[kMaxQ] = {};
  int n_rows = 0;
  for (int t = 0; t < T; ++t) {
    float r = 0.f;
    if (rows2(t)) {
      float a[kN2];
      regressors(t, a);
      r = sub(z[t], dot(a, beta));
      ++n_rows;
    }
    ssq = add(ssq, mul(r, r));
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i)
      if (t == T - 1 - i) r_last[i] = r;
  }
  const float n_eff = at_least(static_cast<float>(n_rows), 1.f);
  const float sig2 = at_least(quo(ssq, n_eff), 1e-10f);
  float aic = add(mul(n_eff, static_cast<float>(log(static_cast<double>(sig2)))),
                  static_cast<float>(2 * (p + q + 2)));
  if (!isfinite(aic) || !real) aic = INFINITY;

  // the first least AIC over the warp
  float best = aic;
  int arg = lane;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
    if (ob < best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if (lane != arg) return;

  // the chosen order's k-step recursion (future innovations 0) and its
  // psi-weight variance, integrated when d = 1
  const float delta = beta[0];
  float zl[kMaxP], el[kMaxQ], psi[kMaxP];
#pragma unroll
  for (int i = 0; i < kMaxP; ++i) {
    zl[i] = T - 1 - i >= 0 ? z[T - 1 - i] : 0.f;
    psi[i] = 0.f;                                  // psi_{j-1-i}, none before j = 0
  }
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i) el[i] = r_last[i];
  const float y_last = y[T - 1], sd2 = mul(sd, sd);
  float csum = 0.f, pint = 0.f, cs2 = 0.f;
  for (int j = 0; j < H; ++j) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) s1 = add(s1, mul(beta[1 + i], zl[i]));
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i) s2 = add(s2, mul(beta[1 + kMaxP + i], el[i]));
    const float zt = add(add(delta, s1), s2);
#pragma unroll
    for (int i = kMaxP - 1; i > 0; --i) zl[i] = zl[i - 1];
    zl[0] = zt;
#pragma unroll
    for (int i = kMaxQ - 1; i > 0; --i) el[i] = el[i - 1];
    el[0] = 0.f;
    csum = add(csum, zt);
    const float m = d ? add(y_last, csum) : zt;

    float ps = 1.f;                                // psi_0
    if (j > 0) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxP; ++i) acc = add(acc, mul(beta[1 + i], psi[i]));
      float th = 0.f;                              // theta_{j-1} for j <= Q
#pragma unroll
      for (int i = 0; i < kMaxQ; ++i)
        if (j == i + 1 && j <= Q) th = beta[1 + kMaxP + i];
      ps = add(th, acc);
    }
#pragma unroll
    for (int i = kMaxP - 1; i > 0; --i) psi[i] = psi[i - 1];
    psi[0] = ps;
    pint = add(pint, ps);
    const float pj = d ? pint : ps;
    cs2 = add(cs2, mul(pj, pj));
    mo[j] = add(mul(m, sd), mu);
    vo[j] = at_least(mul(mul(sig2, cs2), sd2), 1e-9f);
  }
}

}  // namespace

size_t arima_smem(int T) {
  return static_cast<size_t>(kWarps) * ((4 * T + kLu * 32) * sizeof(float) + (T + 15) / 16 * 16);
}

// windows (B, T) float32, valid (B, T) bool, ready (B,) bool or null;
// out: mean, var (B, H) float32.  Orders: 0 <= P <= 3, 0 <= Q <= 2,
// 0 <= D <= 1, 0 <= M <= 6, P + Q > 0; 1 <= T <= 256.
extern "C" int arima_forecast(const void* windows, const void* valid, const void* ready,
                              void* mean, void* var, int B, int T, int H, int P, int Q,
                              int D, int M, void* stream) {
  if (B <= 0 || T <= 0 || T > 256 || H <= 0 || P < 0 || P > kMaxP || Q < 0 ||
      Q > kMaxQ || D < 0 || D > 1 || M < 0 || M > kMaxM || P + Q == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  arima_forecast_kernel<<<blocks, kWarps * 32, arima_smem(T),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(windows), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(ready), static_cast<float*>(mean),
      static_cast<float*>(var), B, T, H, P, Q, D, M);
  return static_cast<int>(cudaGetLastError());
}
