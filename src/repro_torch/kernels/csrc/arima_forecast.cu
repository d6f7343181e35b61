// ARIMA forecasts of a batch of series (paper §3.1.1): for each series,
// the scale normalisation, the Hannan-Rissanen fit of every candidate
// order (p, d, q), their AICs, the choice of the first least AIC, and the
// chosen order's k-step recursion and psi-weight variance, or the
// last-value fallback of a window with too few valid samples.
//
// Replaces: the reference's ARIMAForecaster.forecast (plain JAX, no
// Pallas kernel: repro/core/forecast/arima.py:140-212), which XLA fuses
// into one program; written as plain PyTorch it would put hundreds of
// small kernels into every captured tick of the device engine.  Its
// plain version is repro_torch/kernels/ref.py:arima_select, which
// performs the same float32 operations in the same order: every product,
// sum and quotient here is one IEEE operation (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: never contracted into a fused multiply-add),
// square roots are correctly rounded and logarithms are taken in double
// and rounded once, so the kernel gives the plain version's bits.
//
// What bounds it: one series' chain of dependent steps, at about two
// cycles an instruction for a lone warp.  The device engine runs ~122 of
// its 3,072 rows a tick, about one an SM, so a launch lasts as long as one
// series: two sums over the window, then for each d two least-squares
// fits (7 x 7 and 6 x 6), each a sum over the window, an LU of seven
// dependent pivot steps (a shuffle max and a division each) and a back
// substitution of seven dependent divisions (~50 cycles each); the
// bytes (91 KB) would take 0.03 us.
//
// Design: one fit per distinct system, lanes over the data.  Of the 22
// candidates at the default orders only (max_p, d, max_q) has stage-2
// rows (the reference's rows need every max_p and max_q lag active); the
// other 20 have n_rows 0, ssq 0 and beta = +0 whatever the data (an LU of
// the ridge alone with a zero right-hand side), so they are not solved:
// their AIC is the same expression at n_eff = 1 and sigma^2 at its 1e-10
// floor.  So a series needs D + 1 stage-1 fits and D + 1 stage-2 fits: a
// block of two warps a series, warp d fitting the series differenced d
// times (a block a series, so the ready rows, which come in runs of an
// app's components, fall on different SMs).  Thread 0 takes the
// normalisation's sums, four samples a load.  A warp's two stages are two
// passes of one loop: the stage's design matrix in shared memory (a
// column a regressor, zero off the rows, so a sum needs no test: the +0
// of a sample that is not a row leaves it as skipping would, a sum from
// +0 never being -0); the normal equations a lane an entry (the upper
// triangle of G and b, each summed in t order, one product and one sum a
// term, four samples a load); the LU a lane a row, in registers, the
// pivot the first row of largest magnitude by a shuffle max over packed
// (magnitude, row), row k read by every lane and divided by meanwhile, the
// swap made where the pivot is another row; the back substitution in
// every lane; the innovations or residuals a lane a sample; the sum of
// squares one lane's, in t order.  A warp argmin over the candidates
// (ties to the lowest index, as jnp.argmin) picks the order; the winning
// lane runs the recursion and writes the series' (mean, var) rows.  An
// unmarked series (ready mask) writes zeros and returns, so one launch a
// forecasting tick serves the device engine's ready rows.
//
// Measured on an H100 (PERF.md, profile_port.py --path arima): 11.66-12.11
// us a launch at the device engine's 3,072 rows with 122 ready, against
// 43.99-44.11 for the earlier design in the same call (a warp a series, a
// lane a candidate order, each lane its own two fits in shared memory);
// one ready series 17,309-17,412 cycles against 68,342-68,350.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;                  // a series a block, a warp per d
constexpr int kMaxP = 3, kMaxQ = 2, kMaxM = 6;
constexpr int kN1 = kMaxM + 1;                // stage 1: intercept + long AR lags
constexpr int kN2 = 1 + kMaxP + kMaxQ;        // stage 2: intercept + z lags + e lags
constexpr int kW = kN1 + 1;                   // a system's row: G, then b at kN1
constexpr int kAug = kN1 * kW;                // floats of a warp's system
constexpr int kRes = 2 + kN2;                 // a warp's results: aic, sig2, beta
constexpr float kRidge = 1e-4f;
constexpr int kMaxT = 256;                    // samples a window

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// a / b rounded once; a zero numerator is given its quotient by a select
// (a zero of the quotient's sign over a number, else CUDA's NaN), so it
// never takes __fdiv_rn's slow path
__device__ __forceinline__ float quo(float a, float b) {
  const float q = __fdiv_rn(a == 0.f ? 1.f : a, b);
  const float zero = b != 0.f && b == b
                         ? __uint_as_float((__float_as_uint(a) ^ __float_as_uint(b)) & 0x80000000u)
                         : __uint_as_float(0x7fffffffu);
  return a == 0.f ? zero : q;
}
// max(v, floor) that keeps a NaN, as torch.maximum and jnp.maximum do
__device__ __forceinline__ float at_least(float v, float floor) {
  return v < floor ? floor : v;
}

// A warp sums the normal equations of one least-squares system from its
// design matrix X (column j of sample t at X[j Tp + t], zero where t is
// not a row or t >= T; column n the regressand) into aug (n rows of kW: G,
// then b at column kN1) with the ridge on the diagonal: entry (i, j) of
// the upper triangle is the sum over t, in t order from 0, of X_i(t)
// X_j(t), one product and one sum a term.  A sample that is not a row adds
// +0, which leaves the sum as skipping it would (a sum from +0 is never
// -0).  Lane l takes entries l and l + 32, counted row by row.
__device__ __forceinline__ void normal_equations(const float* X, int Tp, int n, float* aug,
                                                 int lane) {
  int ii[2], jj[2];
  bool on[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int rem = lane + 32 * h, i = 0;
    while (i < n && rem >= n + 1 - i) rem -= n + 1 - i++;
    on[h] = i < n;
    ii[h] = on[h] ? i : 0;
    jj[h] = on[h] ? i + rem : 0;
  }
  const float4* x0 = reinterpret_cast<const float4*>(X + ii[0] * Tp);
  const float4* y0 = reinterpret_cast<const float4*>(X + jj[0] * Tp);
  const float4* x1 = reinterpret_cast<const float4*>(X + ii[1] * Tp);
  const float4* y1 = reinterpret_cast<const float4*>(X + jj[1] * Tp);
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 2
  for (int t4 = 0; t4 < Tp / 4; ++t4) {
    const float4 a = x0[t4], b = y0[t4], c = x1[t4], e = y1[t4];
    acc0 = add(acc0, mul(a.x, b.x));
    acc1 = add(acc1, mul(c.x, e.x));
    acc0 = add(acc0, mul(a.y, b.y));
    acc1 = add(acc1, mul(c.y, e.y));
    acc0 = add(acc0, mul(a.z, b.z));
    acc1 = add(acc1, mul(c.z, e.z));
    acc0 = add(acc0, mul(a.w, b.w));
    acc1 = add(acc1, mul(c.w, e.w));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!on[h]) continue;
    const int i = ii[h], j = jj[h];
    const float acc = h ? acc1 : acc0;
    if (j == n) {
      aug[i * kW + kN1] = acc;
    } else {
      aug[i * kW + j] = i == j ? add(acc, kRidge) : acc;
      if (j != i) aug[j * kW + i] = acc;
    }
  }
  __syncwarp();
}

// a pivot candidate's key: its magnitude's bits; a NaN at row k keeps k
// (all ones), a NaN below it is passed over (0)
__device__ __forceinline__ unsigned pivot_key(float v, bool at_k) {
  const float a = fabsf(v);
  return a != a ? (at_k ? 0xffffffffu : 0u) : __float_as_uint(a);
}

// A warp's LU with partial pivoting of aug (n <= kN1 rows of kW, b at
// column kN1), eliminating into b: lane i < n holds row i in registers.
// At step k the pivot is the first row at or below k of largest
// magnitude, a max over (key, 7 - row) packed, by shuffles among lanes
// 0..7; meanwhile every lane reads row k and divides by its entry k (row
// k is most often the pivot); where the pivot is another row, rows k and
// piv swap and the division is made again; each row i below k then loses
// l = A[i][k] / A[k][k] times row k.  The rows go back to aug.
__device__ __forceinline__ void warp_lu(float* aug, int n, int lane) {
  float g[kW];
#pragma unroll
  for (int j = 0; j < kW; ++j)
    g[j] = lane < n && (j < n || j == kN1) ? aug[lane * kW + j] : 0.f;
#pragma unroll
  for (int k = 0; k < kN1; ++k) {
    if (k >= n) break;
    unsigned long long best =
        lane >= k && lane < n
            ? static_cast<unsigned long long>(pivot_key(g[k], lane == k)) << 3 | (7 - lane)
            : 0ull;
    best = max(best, __shfl_xor_sync(0xffffffffu, best, 1));
    best = max(best, __shfl_xor_sync(0xffffffffu, best, 2));
    best = max(best, __shfl_xor_sync(0xffffffffu, best, 4));
    float rk[kW];
#pragma unroll
    for (int j = k; j < kW; ++j) rk[j] = __shfl_sync(0xffffffffu, g[j], k);
    float l = quo(g[k], rk[k]);              // row k the pivot, as it most often is
    const int piv = 7 - static_cast<int>(__shfl_sync(0xffffffffu, static_cast<unsigned>(best), 0) & 7u);
    if (piv != k) {
#pragma unroll
      for (int j = k; j < kW; ++j) {
        const float rp = __shfl_sync(0xffffffffu, g[j], piv);
        if (lane == piv) g[j] = rk[j];
        if (lane == k) g[j] = rp;
        rk[j] = rp;
      }
      l = quo(g[k], rk[k]);
    }
    if (lane > k && lane < n) {
#pragma unroll
      for (int j = k + 1; j < kW; ++j) g[j] = sub(g[j], mul(l, rk[j]));
    }
  }
  __syncwarp();
  if (lane < n) {
#pragma unroll
    for (int j = 0; j < kW; ++j) aug[lane * kW + j] = g[j];
  }
  __syncwarp();
}

// x = the back substitution of the eliminated aug (n unknowns; the rest
// of x zero), in every lane
__device__ __forceinline__ void back_substitute(const float* aug, int n, float (&x)[kN1]) {
#pragma unroll
  for (int i = kN1 - 1; i >= 0; --i) {
    x[i] = 0.f;
    if (i < n) {
      float acc = aug[i * kW + kN1];
#pragma unroll
      for (int j = i + 1; j < kN1; ++j)
        if (j < n) acc = sub(acc, mul(aug[i * kW + j], x[j]));
      x[i] = quo(acc, aug[i * kW + i]);
    }
  }
}

// floats of a block's shared memory (T rounded up to Tp, a multiple of
// 4), then 5 T flags
__host__ __device__ constexpr int round4(int T) { return (T + 3) / 4 * 4; }
__host__ __device__ constexpr int smem_floats(int T) {
  return 2 * round4(T) + 2 * (kW * round4(T) + kAug + 2 * round4(T)) + 2 * kRes + 4;
}

__global__ void __launch_bounds__(kThreads) arima_forecast_kernel(
    const float* __restrict__ windows, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ ready, float* __restrict__ mean_out,
    float* __restrict__ var_out, int B, int T, int H, int P, int Q, int D, int M) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, d = tid >> 5, lane = tid & 31;
  const int s = blockIdx.x, Tp = round4(T);
  float* mo = mean_out + static_cast<size_t>(s) * H;
  float* vo = var_out + static_cast<size_t>(s) * H;
  if (ready != nullptr && !ready[s]) {
    for (int j = tid; j < H; j += 64) mo[j] = vo[j] = 0.f;
    return;
  }
  // shared memory: y (the window, then normalised) and its first
  // difference; each d's design matrix, system, innovations and residuals;
  // each d's results and the normalisation; then the valid flags and each
  // d's stage-1 and 2 rows
  const int part = kW * Tp + kAug + 2 * Tp;     // floats of a d's part
  float* y = smem;
  float* z1 = y + Tp;
  float* X = z1 + Tp + d * part;
  float* aug = X + kW * Tp;
  float* e = aug + kAug;
  float* r = e + Tp;
  float* res_of = z1 + Tp + 2 * part;           // [2][kRes]
  float* norm = res_of + 2 * kRes;              // mu, sd, count
  uint8_t* vs = reinterpret_cast<uint8_t*>(smem + smem_floats(T));
  uint8_t* rows1 = vs + T + d * T;
  uint8_t* rows2 = vs + 3 * T + d * T;
  const float* w = windows + static_cast<size_t>(s) * T;
  float* wv = z1;                              // the valid weights (1 or 0) until z1 is made
  for (int t = tid; t < Tp; t += 64) {
    const bool v = t < T && valid[static_cast<size_t>(s) * T + t] != 0;
    y[t] = t < T ? w[t] : 0.f;
    wv[t] = v ? 1.f : 0.f;
    if (t < T) vs[t] = v;
  }
  __syncthreads();

  // phase: normalisation, the sums in t order by one thread (four samples
  // a load; the padding past T adds +0)
  if (tid == 0) {
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const float4* w4 = reinterpret_cast<const float4*>(wv);
    float cnt = 0.f, sum = 0.f;
#pragma unroll 2
    for (int t4 = 0; t4 < Tp / 4; ++t4) {
      const float4 a = y4[t4], b = w4[t4];
      cnt = add(add(add(add(cnt, b.x), b.y), b.z), b.w);
      sum = add(sum, mul(a.x, b.x));
      sum = add(sum, mul(a.y, b.y));
      sum = add(sum, mul(a.z, b.z));
      sum = add(sum, mul(a.w, b.w));
    }
    const float den = at_least(cnt, 1.f);
    const float mu = quo(sum, den);
    // (y - mu)^2 w, and +0 past T (where the square of -mu could overflow)
    auto sq = [&](float v, float wt, int t) {
      const float dv = sub(v, mu);
      return t < T ? mul(mul(dv, dv), wt) : 0.f;
    };
    float ss = 0.f;
#pragma unroll 2
    for (int t4 = 0; t4 < Tp / 4; ++t4) {
      const float4 a = y4[t4], b = w4[t4];
      ss = add(ss, sq(a.x, b.x, 4 * t4));
      ss = add(ss, sq(a.y, b.y, 4 * t4 + 1));
      ss = add(ss, sq(a.z, b.z, 4 * t4 + 2));
      ss = add(ss, sq(a.w, b.w, 4 * t4 + 3));
    }
    norm[0] = mu;
    norm[1] = __fsqrt_rn(at_least(quo(ss, den), 1e-8f));
    norm[2] = cnt;
  }
  __syncthreads();
  const float mu = norm[0], sd = norm[1];
  if (norm[2] < static_cast<float>(M + P + 2)) {   // too few samples: the last value
    const float last = w[T - 1];
    const float u = add(mul(0.5f, fabsf(last)), 1.f);
    const float v = at_least(mul(u, u), 1e-9f);
    for (int j = tid; j < H; j += 64) {
      mo[j] = last;
      vo[j] = v;
    }
    return;
  }
  // y normalised in place and its first difference, from the raw values
  // in shared memory (all read before any is written)
  float raw[kMaxT / 64], prev[kMaxT / 64];
#pragma unroll
  for (int h = 0; h < kMaxT / 64; ++h) {
    const int t = tid + 64 * h;
    raw[h] = t < T ? y[t] : 0.f;
    prev[h] = t > 0 && t < T ? y[t - 1] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kMaxT / 64; ++h) {
    const int t = tid + 64 * h;
    if (t < T) {
      const float yt = quo(sub(raw[h], mu), sd);
      y[t] = yt;
      z1[t] = t == 0 ? 0.f : sub(yt, quo(sub(prev[h], mu), sd));
    }
  }
  __syncthreads();

  if (d <= D) {
    const float* z = d ? z1 : y;
    auto zm = [&](int t) { return d ? (t > 0 && vs[t] && vs[t - 1]) : vs[t] != 0; };
    for (int t = lane; t < T; t += 32) {
      const int u = t == 0 ? T - 1 : t - 1;        // e_rows: rows1 rolled by one
      rows1[t] = zm(t) && t >= M;
      rows2[t] = zm(t) && t >= P && t >= Q && (Q == 0 || (zm(u) && u >= M));
    }
    __syncwarp();

    // stage 1, the long AR(M) of this d, whose innovations feed only the
    // e lags (so there is none without them); then stage 2, the one order
    // with rows: z on [1, P lags of z, Q of e].  The same code, a pass each.
    float beta[kN1];
    int n_rows = 0;
    for (int stage = Q > 0 ? 1 : 2; stage <= 2; ++stage) {
      // phase: stage 1 or 2 (this pass)
      const int n = stage == 1 ? M + 1 : 1 + P + Q;
      const uint8_t* rows = stage == 1 ? rows1 : rows2;
      // the design matrix: column 0 the intercept, j < n a lag of z (stage
      // 1, or j <= P) or of e, n the regressand; zeros off the rows
      for (int t = lane; t < Tp; t += 32) {
        const bool row = t < T && rows[t];
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          if (j > n) break;
          const bool of_e = stage == 2 && j > P && j < n;
          const int lag = j == n ? 0 : of_e ? j - P : j;
          const float v = (of_e ? e : z)[max(min(t, T - 1) - lag, 0)];
          X[j * Tp + t] = row ? (j == 0 ? 1.f : v) : 0.f;
        }
      }
      __syncwarp();
      normal_equations(X, Tp, n, aug, lane);
      warp_lu(aug, n, lane);
      float x[kN1];
      back_substitute(aug, n, x);
      // stage 1: the innovations; stage 2: the residuals, a lane a sample
      float* out = stage == 1 ? e : r;
      for (int t0 = 0; t0 < Tp; t0 += 32) {
        const int t = t0 + lane;
        const bool row = t < T && rows[t];
        if (t < T) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < kN1; ++j)
            if (j < n) acc = add(acc, mul(X[j * Tp + t], x[j]));
          const float v = sub(z[t], acc);
          out[t] = row ? v : 0.f;
        } else if (t < Tp) {
          out[t] = 0.f;
        }
        if (stage == 2) n_rows += __popc(__ballot_sync(0xffffffffu, row));
      }
      __syncwarp();
      if (stage == 2) {
#pragma unroll
        for (int j = 0; j < kN1; ++j) beta[j] = x[j];
      }
    }

    // phase: residuals and AIC
    if (lane == 0) {
      const float4* r4 = reinterpret_cast<const float4*>(r);
      float ssq = 0.f;
#pragma unroll 2
      for (int t4 = 0; t4 < Tp / 4; ++t4) {
        const float4 a = r4[t4];
        ssq = add(add(add(add(ssq, mul(a.x, a.x)), mul(a.y, a.y)), mul(a.z, a.z)), mul(a.w, a.w));
      }
      const float n_eff = at_least(static_cast<float>(n_rows), 1.f);
      const float sig2 = at_least(quo(ssq, n_eff), 1e-10f);
      const float aic = add(mul(n_eff, static_cast<float>(log(static_cast<double>(sig2)))),
                            static_cast<float>(2 * (P + Q + 2)));
      float* res = res_of + d * kRes;
      res[0] = isfinite(aic) ? aic : INFINITY;
      res[1] = sig2;
#pragma unroll
      for (int j = 0; j < kN2; ++j) res[2 + j] = beta[j];
    }
  }
  __syncthreads();
  if (d != 0) return;

  // the first least AIC over the candidates (d, p, q) in the reference's
  // order; only (P, d, Q) was fitted, the others score n_eff = 1 and
  // sigma^2 = 1e-10
  const int per_d = (P + 1) * (Q + 1) - 1;
  const int n_cand = (D + 1) * per_d;
  const int c = lane < n_cand ? lane : 0;
  const int cd = c / per_d, pq = c % per_d + 1;      // (p, q) after (0, 0), p major
  const int p = pq / (Q + 1), q = pq % (Q + 1);
  const bool full = p == P && q == Q;
  float aic = full ? res_of[cd * kRes]
                   : add(mul(1.f, static_cast<float>(log(static_cast<double>(1e-10f)))),
                         static_cast<float>(2 * (p + q + 2)));
  if (lane >= n_cand) aic = INFINITY;
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

  // phase: recursion, the chosen order's k-step forecast (future
  // innovations 0) and its psi-weight variance, integrated when d = 1;
  // an order that was not fitted runs on beta = +0
  const float* res = res_of + cd * kRes;
  const float* z = cd ? z1 : y;
  float beta[kN2] = {}, r_last[kMaxQ] = {};
  float sig2 = 1e-10f;
  if (full) {
    sig2 = res[1];
    beta[0] = res[2];
#pragma unroll
    for (int i = 0; i < kMaxP; ++i)
      if (i < P) beta[1 + i] = res[3 + i];
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i) {
      if (i < Q) beta[1 + kMaxP + i] = res[3 + P + i];
      if (T - 1 - i >= 0) r_last[i] = r[cd * part + T - 1 - i];   // d = 0 here
    }
  }
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
    const float m = cd ? add(y_last, csum) : zt;

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
    const float pj = cd ? pint : ps;
    cs2 = add(cs2, mul(pj, pj));
    mo[j] = add(mul(m, sd), mu);
    vo[j] = at_least(mul(mul(sig2, cs2), sd2), 1e-9f);
  }
}

}  // namespace

size_t arima_smem(int T) { return smem_floats(T) * sizeof(float) + 5 * T; }

// windows (B, T) float32, valid (B, T) bool, ready (B,) bool or null;
// out: mean, var (B, H) float32.  Orders: 0 <= P <= 3, 0 <= Q <= 2,
// 0 <= D <= 1, 0 <= M <= 6, P + Q > 0; 1 <= T <= 256.
extern "C" int arima_forecast(const void* windows, const void* valid, const void* ready,
                              void* mean, void* var, int B, int T, int H, int P, int Q,
                              int D, int M, void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || H <= 0 || P < 0 || P > kMaxP || Q < 0 ||
      Q > kMaxQ || D < 0 || D > 1 || M < 0 || M > kMaxM || P + Q == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  arima_forecast_kernel<<<B, kThreads, arima_smem(T),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(windows), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(ready), static_cast<float*>(mean),
      static_cast<float*>(var), B, T, H, P, Q, D, M);
  return static_cast<int>(cudaGetLastError());
}
