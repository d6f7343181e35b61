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
// Caller: the GP's Gram route (repro_torch/core/forecast/gp.py), which
// takes every configuration the fused GP program (gp_forecast.cu) cannot:
// more than 64 patterns, more than 128 features or more than 256 Adam
// steps.  Each forecast launches the forward opt_steps + 1 + horizon times
// (K(X, X) per Adam step and for the fit, then a (1 x N) cross-Gram per
// horizon step) and the gradient opt_steps times.  The device engine does
// so every tick over its whole batch of 3,072 series.
//
// What bounds it there: at (B, M, N, D) = (3,072, 128, 128, 41), K(X, X)
// passed as one tensor, the forward reads X once (64.5 MB) and writes
// 201 MB (~79 us at 3.35 TB/s); the gradient reads G and X as much.  The
// arithmetic must stay the parent kernel's: every product and sum of
// |a|^2, |b|^2 and a.b rounded on its own (__fmul_rn, __fadd_rn, no FMA
// contraction) in k order from 0, then __fsub_rn, the clamp, __fsqrt_rn,
// __fdiv_rn and expf.  So the dot products take two fp32 instructions a
// term (~2.1 G over the micro-tiles on and above the diagonal), and an
// entry's sqrt, divide and exp ~30 more.  Measured (H100 80GB HBM3, 700 W;
// profile_port.py --path gram): that arithmetic, with the staging and the
// norms, takes ~154 us of the forward's ~183 (a build without its
// stores), so the kernels are bound by fp32 issue, not by bytes: 43% of
// the bound.  The stores add the rest: a transpose's 16-byte stores fill
// half a 32-byte sector.  Deals of the micro-tiles whose stores fill whole
// sectors made them cheap but cost more arithmetic than they saved.  The
// parent recomputed both row norms for every entry and read its rows with
// a warp's lanes 41 floats apart: 5.5 and 2.9 ms a launch.
//
// The design: a block a series, and the shape picks how (plan_of):
//   * K(X, X) at the route's width (a block a series whose rows fit in
//     110 KB of shared memory): the rows are staged once by 16-byte
//     cp.async copies (4-byte ones only at the span's unaligned ends),
//     transposed once so that a thread reads four rows' feature k as one
//     float4, and their norms summed once.  K(X, X) is symmetric to the
//     bit (the (j, i) entry comes from the same three sums in the same
//     order), so only its 4 x 4 micro-tiles on and above the diagonal run
//     (528 of 1,024 at N = 128), each above it also writing its transpose.
//     They are dealt to the block's 256 threads in order, neighbouring
//     lanes on neighbouring micro-tiles, with no barrier between them: a
//     term costs 2 fp32 instructions and 1/8 of a 16-byte shared load.
//     The gradient copies each micro-tile's G[i][j] and G[j][i] into the
//     thread's shared-memory slots (over the staged rows, by cp.async)
//     while it sums the dot products, multiplies G[i][j] + G[j][i] by the
//     one k of both entries, and keeps its sums in registers across the
//     micro-tiles;
//   * series of at most 256 entries (a horizon step's cross-Gram, the
//     host engine's small patterns): a thread an entry, the rows staged
//     by 16-byte copies (read where they lie when the series is tiny),
//     each row's norm summed in the loop of the dot products that read it;
//   * larger series: a block a 64 x 64 tile (those on and above the
//     diagonal for K(X, X)), D taken 44 features a chunk, the gradient's
//     tiles summed by a second pass in tile order;
//   * stores and G's loads are 16 bytes a lane, neighbouring lanes on
//     neighbouring addresses, where N is a multiple of 4;
//   * the gradient's sums go thread, warp (a fixed shuffle tree), block in
//     a fixed order, with no float atomics: the result depends neither on
//     B nor on which block finishes first, and two runs give the same bits.
//
// So the forward's output equals the parent kernel's bit for bit on every
// shape, and the diagonal of K(X, X) still cancels exactly.  The gradient's
// sums run in another order than the plain PyTorch version's
// (repro_torch/kernels/ref.py) and agree with it to rounding.  Measured
// (H100 80GB HBM3, 700 W; profile_port.py --path gram): 183 and 185 us at
// the device engine's shape.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError(); the caller allocates every output and the gradient's
// scratch (gp_gram_parts() partial pairs a series).  gp_gram_init() allows
// the kernels their dynamic shared memory above 48 KB; call it once per
// device before the first launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKC = 44;        // features staged per chunk
constexpr int kRaw = 52;       // a staged row's stride (floats): 16-byte units, an odd count
constexpr int kPad = 4;        // the transposed chunk's row padding (floats)

// ---------------------------------------------------------------------------
// A block a tile of T x T entries, for series whose rows do not fit in a
// block's shared memory whole: D goes kKC features a chunk, and a series'
// gradient sums its tiles' partial sums in a second pass.
// ---------------------------------------------------------------------------

// threads and shared memory of a tile of T x T entries
template <int T>
struct Tile {
  static constexpr int kSide = T / 4;                 // threads along a side
  static constexpr int kThreads = kSide * kSide;
  static constexpr int kStride = T + kPad;            // transposed row stride
  static constexpr int kRawFloats = 2 * T * kRaw;
  static constexpr int kChunkFloats = 2 * kKC * kStride;
  static constexpr size_t kSmem = sizeof(float) * (kRawFloats + kChunkFloats + 2 * T);
};

__device__ __forceinline__ void cp_async16(float* smem, const float* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// a row piece's float offset modulo 4: its place in a 16-byte unit
__device__ __forceinline__ int shift_of(const float* g) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// Features [k0, k0 + kc) of rows [0, rows) of the row-major (., D) matrix at
// src into raw: row r's feature k0 + k lands at raw[r * kRaw + s + k], s =
// shift_of(the piece), so that the piece's aligned interior goes by 16-byte
// copies.
template <int NT>
__device__ __forceinline__ void stage(float* raw, const float* src, int rows, int D,
                                      int k0, int kc, int tid) {
  constexpr int U = kRaw / 4;
  for (int u = tid; u < rows * U; u += NT) {
    const int r = u / U, q = u - r * U;
    const float* g = src + static_cast<size_t>(r) * D + k0;
    const int lo = 4 * q - shift_of(g);      // the unit's first feature
    if (lo >= kc) continue;
    float* d = raw + r * kRaw + 4 * q;
    if (lo >= 0 && lo + 4 <= kc) {
      cp_async16(d, g + lo);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (lo + e >= 0 && lo + e < kc) cp_async4(d + e, g + lo + e);
    }
  }
}

// raw (stage's layout) to chunk[k * stride + r], rows past `rows` zero.  A
// warp moves 8 rows x 4 features at a time: conflict-free reads of raw.
template <int T, int NT>
__device__ __forceinline__ void transpose(float* chunk, const float* raw, const float* src,
                                          int rows, int D, int k0, int kc, int tid) {
  constexpr int S = Tile<T>::kStride;
  const int groups = (T / 8) * ((kc + 3) / 4);
  for (int e = tid; e < groups * 32; e += NT) {
    const int lane = e & 31, g = e >> 5;
    const int r = (g % (T / 8)) * 8 + (lane & 7);
    const int k = (g / (T / 8)) * 4 + (lane >> 3);
    if (k >= kc) continue;
    float x = 0.f;
    if (r < rows) x = raw[r * kRaw + shift_of(src + static_cast<size_t>(r) * D + k0) + k];
    chunk[k * S + r] = x;
  }
}

// exp(-r / ell) or exp(-d2 / (2 ell^2)); *t receives r or d2, the factor
// that the derivative with respect to ell multiplies K by
template <int KIND>
__device__ __forceinline__ float unit_kernel(float d2, float ell, float* t) {
  if (KIND == 0) {
    const float r = __fsqrt_rn(__fadd_rn(d2, 1e-12f));
    *t = r;
    return expf(__fdiv_rn(-r, ell));
  }
  *t = d2;
  return expf(__fdiv_rn(__fmul_rn(-0.5f, d2), __fmul_rn(ell, ell)));
}

constexpr int kTile = 64;     // the tile kernels' T

__host__ __device__ __forceinline__ int tiles_of(int M, int N, bool sym) {
  constexpr int t = kTile;
  const int tm = (M + t - 1) / t, tn = (N + t - 1) / t;
  return sym ? tn * (tn + 1) / 2 : tm * tn;
}

// The tile (ti, tj) of block tile index p: row-major over all tiles, or
// over the tiles on and above the diagonal when sym.
__device__ __forceinline__ void tile_pos(int p, int N, int T, bool sym, int* ti, int* tj) {
  const int tn = (N + T - 1) / T;
  if (!sym) {
    *ti = p / tn;
    *tj = p - *ti * tn;
    return;
  }
  int i = 0;
  while (p >= tn - i) {
    p -= tn - i;
    ++i;
  }
  *ti = i;
  *tj = i + p;
}

// What the forward and the gradient share: the block's tile, its staged
// rows' norms and each thread's 4 x 4 dot products.
template <int T>
struct TileDots {
  int b, ti, tj, i0, j0, mi, nj, r0, c0;
  bool one;         // a diagonal tile of K(X, X): its two row sets are the same rows
  bool live;        // this warp's rows hold a valid row
  const float* na;  // norms of the tile's xa rows (shared memory)
  const float* nb;  // ... and of its xb rows
  float acc[4][4];

  __device__ __forceinline__ void run(const float* __restrict__ xa, const float* __restrict__ xb,
                                      int M, int N, int D, bool sym, int tiles, float* smem) {
    constexpr int NT = Tile<T>::kThreads;
    constexpr int S = Tile<T>::kStride;
    const int tid = threadIdx.x;
    b = blockIdx.x / tiles;
    tile_pos(blockIdx.x - b * tiles, N, T, sym, &ti, &tj);
    i0 = ti * T;
    j0 = tj * T;
    mi = min(T, M - i0);
    nj = min(T, N - j0);
    one = sym && ti == tj;
    r0 = (tid / Tile<T>::kSide) * 4;
    c0 = (tid % Tile<T>::kSide) * 4;
    live = (tid / 32) * (32 / Tile<T>::kSide) * 4 < mi;   // warp-uniform
    float* raw_a = smem;
    float* raw_b = smem + T * kRaw;
    float* as = smem + Tile<T>::kRawFloats;
    float* bs = as + kKC * S;
    float* norm = bs + kKC * S;
    const float* A = xa + (static_cast<size_t>(b) * M + i0) * D;
    const float* X = xb + (static_cast<size_t>(b) * N + j0) * D;
    const float* bt = one ? as : bs;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float nrm = 0.f;   // thread t < T: xa row t's norm; T <= t < 2T: xb row t - T's
    for (int k0 = 0; k0 < D; k0 += kKC) {
      const int kc = min(kKC, D - k0);
      stage<NT>(raw_a, A, mi, D, k0, kc, tid);
      if (!one) stage<NT>(raw_b, X, nj, D, k0, kc, tid);
      cp_async_wait_all();
      __syncthreads();
      transpose<T, NT>(as, raw_a, A, mi, D, k0, kc, tid);
      if (!one) transpose<T, NT>(bs, raw_b, X, nj, D, k0, kc, tid);
      __syncthreads();
      if (tid < T || (!one && tid < 2 * T)) {
        const float* col = tid < T ? as + tid : bs + (tid - T);
        for (int k = 0; k < kc; ++k) {
          const float x = col[k * S];
          nrm = __fadd_rn(nrm, __fmul_rn(x, x));
        }
      }
      if (live) {
#pragma unroll 4
        for (int k = 0; k < kc; ++k) {
          const float4 a4 = *reinterpret_cast<const float4*>(as + k * S + r0);
          const float4 b4 = *reinterpret_cast<const float4*>(bt + k * S + c0);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
        }
      }
      __syncthreads();
    }
    if (tid < 2 * T) norm[tid] = nrm;
    __syncthreads();
    na = norm;
    nb = one ? norm : norm + T;
  }

  // d2 of the micro-tile's entry (i, j), as the parent's sq_dist
  __device__ __forceinline__ float d2(int i, int j) const {
    const float v = __fsub_rn(__fadd_rn(na[r0 + i], nb[c0 + j]), __fmul_rn(2.f, acc[i][j]));
    return v < 0.f ? 0.f : v;   // keeps a NaN, as the plain version's clamp does
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int T, int KIND>
__global__ void __launch_bounds__(Tile<T>::kThreads)
gram_fwd_tiles(const float* __restrict__ xa, const float* __restrict__ xb,
                const float* __restrict__ ell, const float* __restrict__ sf,
                float* __restrict__ out, int M, int N, int D, int sym, int tiles) {
  extern __shared__ __align__(16) float smem[];
  TileDots<T> t;
  t.run(xa, xb, M, N, D, sym != 0, tiles, smem);
  if (!t.live) return;
  const float l = ell[t.b], s = sf[t.b];
  const float s2 = __fmul_rn(s, s);
  float v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float unused;
      v[i][j] = __fmul_rn(s2, unit_kernel<KIND>(t.d2(i, j), l, &unused));
    }
  float* K = out + static_cast<size_t>(t.b) * M * N;
  const bool vec = (N & 3) == 0 && aligned16(out);
  // the tile: rows i0 + r0 + i, columns j0 + c0 + j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (t.r0 + i >= t.mi) break;
    float* row = K + static_cast<size_t>(t.i0 + t.r0 + i) * N + t.j0 + t.c0;
    if (vec && t.c0 + 3 < t.nj) {
      *reinterpret_cast<float4*>(row) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t.c0 + j < t.nj) row[j] = v[i][j];
    }
  }
  if (!sym || t.one) return;
  // its transpose: rows j0 + c0 + j, columns i0 + r0 + i
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (t.c0 + j >= t.nj) break;
    float* row = K + static_cast<size_t>(t.j0 + t.c0 + j) * N + t.i0 + t.r0;
    if (vec && t.r0 + 3 < t.mi) {
      *reinterpret_cast<float4*>(row) = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t.r0 + i < t.mi) row[i] = v[i][j];
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies issued so far, landed
__device__ __forceinline__ void cp_async_wait_mine() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the first n (up to 4) floats of src into dst (16-byte aligned) by
// cp.async: one 16-byte copy where it can
__device__ __forceinline__ void copy4(float* dst, const float* src, int n, bool vec) {
  if (vec && n >= 4) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) cp_async4(dst + e, src + e);
  }
}

// four entries of a row of G from column c of `row`, 16 bytes where it can
__device__ __forceinline__ void load4(const float* row, int n, bool vec, float g[4]) {
  if (vec && n >= 4) {
    const float4 x = *reinterpret_cast<const float4*>(row);
    g[0] = x.x; g[1] = x.y; g[2] = x.z; g[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = e < n ? row[e] : 0.f;
  }
}

// d_ell[b] = sum_ij G K r / ell^2   (exp)   or   sum_ij G K d2 / ell^3 (rbf)
// d_sf[b]  = 2 sf sum_ij G k        (k = K / sf^2)
template <int T, int KIND>
__global__ void __launch_bounds__(Tile<T>::kThreads)
gram_bwd_tiles(const float* __restrict__ grad, const float* __restrict__ xa,
                const float* __restrict__ xb, const float* __restrict__ ell,
                const float* __restrict__ sf, float* __restrict__ d_ell,
                float* __restrict__ d_sf, float* __restrict__ part, int M, int N, int D,
                int sym, int tiles) {
  constexpr int NT = Tile<T>::kThreads;
  extern __shared__ __align__(16) float smem[];
  __shared__ float2 red[NT / 32];
  TileDots<T> t;
  t.run(xa, xb, M, N, D, sym != 0, tiles, smem);
  const float l = ell[t.b], s = sf[t.b];
  const float s2 = __fmul_rn(s, s);
  const bool mirror = sym && !t.one;
  float acc_l = 0.f, acc_s = 0.f;
  if (t.live) {
    float kv[4][4], fv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[i][j] = unit_kernel<KIND>(t.d2(i, j), l, &fv[i][j]);
    const float* G = grad + static_cast<size_t>(t.b) * M * N;
    const bool vec = (N & 3) == 0 && aligned16(grad);
    // G[i][j] over the tile, a row of the micro-tile at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (t.r0 + i >= t.mi) break;
      float g[4];
      const int n = t.nj - t.c0;
      load4(G + static_cast<size_t>(t.i0 + t.r0 + i) * N + t.j0 + t.c0, n, vec, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= n) break;
        const float gk = __fmul_rn(g[j], kv[i][j]);
        acc_s = __fadd_rn(acc_s, gk);
        acc_l = __fadd_rn(acc_l, __fmul_rn(__fmul_rn(gk, s2), fv[i][j]));
      }
    }
    // and G[j][i] over its transpose, where only the tile above runs
    if (mirror) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t.c0 + j >= t.nj) break;
        float h[4];
        const int n = t.mi - t.r0;
        load4(G + static_cast<size_t>(t.j0 + t.c0 + j) * N + t.i0 + t.r0, n, vec, h);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= n) break;
          const float hk = __fmul_rn(h[i], kv[i][j]);
          acc_s = __fadd_rn(acc_s, hk);
          acc_l = __fadd_rn(acc_l, __fmul_rn(__fmul_rn(hk, s2), fv[i][j]));
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc_l = __fadd_rn(acc_l, __shfl_xor_sync(0xffffffffu, acc_l, o));
    acc_s = __fadd_rn(acc_s, __shfl_xor_sync(0xffffffffu, acc_s, o));
  }
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) red[tid >> 5] = make_float2(acc_l, acc_s);
  __syncthreads();
  if (tid != 0) return;
  float sum_l = red[0].x, sum_s = red[0].y;
  for (int w = 1; w < NT / 32; ++w) {
    sum_l = __fadd_rn(sum_l, red[w].x);
    sum_s = __fadd_rn(sum_s, red[w].y);
  }
  if (tiles > 1) {
    part[2 * static_cast<size_t>(blockIdx.x)] = sum_l;
    part[2 * static_cast<size_t>(blockIdx.x) + 1] = sum_s;
    return;
  }
  const float l2 = __fmul_rn(l, l);
  d_ell[t.b] = __fdiv_rn(sum_l, KIND == 0 ? l2 : __fmul_rn(l2, l));
  d_sf[t.b] = __fmul_rn(__fmul_rn(2.f, s), sum_s);
}

// a series' tiles' partial sums in tile order, then the parameters' factors
__global__ void gram_tile_sums(const float* __restrict__ part, const float* __restrict__ ell,
                                const float* __restrict__ sf, float* __restrict__ d_ell,
                                float* __restrict__ d_sf, int B, int tiles, int kind) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* p = part + 2 * static_cast<size_t>(b) * tiles;
  float sum_l = p[0], sum_s = p[1];
  for (int t = 1; t < tiles; ++t) {
    sum_l = __fadd_rn(sum_l, p[2 * t]);
    sum_s = __fadd_rn(sum_s, p[2 * t + 1]);
  }
  const float l = ell[b], s = sf[b];
  const float l2 = __fmul_rn(l, l);
  d_ell[b] = __fdiv_rn(sum_l, kind == 0 ? l2 : __fmul_rn(l2, l));
  d_sf[b] = __fmul_rn(__fmul_rn(2.f, s), sum_s);
}

template <int T, int KIND>
cudaError_t fwd(const float* xa, const float* xb, const float* ell, const float* sf, float* out,
                int B, int M, int N, int D, int sym, int tiles, cudaStream_t st) {
  gram_fwd_tiles<T, KIND><<<B * tiles, Tile<T>::kThreads, Tile<T>::kSmem, st>>>(
      xa, xb, ell, sf, out, M, N, D, sym, tiles);
  return cudaGetLastError();
}

template <int T, int KIND>
cudaError_t bwd(const float* grad, const float* xa, const float* xb, const float* ell,
                const float* sf, float* d_ell, float* d_sf, float* part, int B, int M, int N,
                int D, int sym, int tiles, cudaStream_t st) {
  gram_bwd_tiles<T, KIND><<<B * tiles, Tile<T>::kThreads, Tile<T>::kSmem, st>>>(
      grad, xa, xb, ell, sf, d_ell, d_sf, part, M, N, D, sym, tiles);
  return cudaGetLastError();
}

template <int T, int KIND>
cudaError_t allow() {
  cudaError_t e = cudaFuncSetAttribute(gram_fwd_tiles<T, KIND>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Tile<T>::kSmem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(gram_bwd_tiles<T, KIND>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Tile<T>::kSmem));
}

bool symmetric(const float* xa, const float* xb, int M, int N) { return xa == xb && M == N; }

// ---------------------------------------------------------------------------
// A block a series: where the series' rows fit in shared memory whole (the
// Gram route's shapes), a thread an entry or a block of 4 x 4 micro-tiles;
// the gradient's sums stay in the block, so one kernel gives the result.
// Larger series take the tile kernels above.
// ---------------------------------------------------------------------------

constexpr int kSeriesSmemMax = 110 * 1024;   // two blocks an SM at least
constexpr int kSeriesThreads = 256;          // a block a series, 4 x 4 micro-tiles
constexpr int kEntryThreads = 256;           // a thread an entry, rows staged
constexpr int kDirectThreads = 128;          // a thread an entry, rows read where they lie

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// float offsets of a series block's shared memory: the transposes of its
// xb and xa rows (one when sym; feature k of row r at [k * stride + r],
// strides rounded up to whole micro-tiles), their norms, then the raw
// copies of the rows, which the gradient's slots of G reuse once the rows
// are transposed (8 float4 a thread)
constexpr int kGradSlotFloats = 32 * kSeriesThreads;

struct SeriesLayout {
  int xt, at, sn, sa, nb, na, raw_b, raw_a, total;
};

__host__ __device__ __forceinline__ SeriesLayout series_layout(int M, int N, int D, bool sym,
                                                               bool grad) {
  SeriesLayout l;
  l.sn = round_up(N, 4);
  l.sa = sym ? l.sn : round_up(M, 4);
  int off = 0;
  l.xt = off;
  off += D * l.sn;
  l.at = sym ? l.xt : off;
  if (!sym) off += D * l.sa;
  l.nb = off;
  off += l.sn;
  l.na = sym ? l.nb : off;
  if (!sym) off += l.sa;
  l.raw_b = off;
  int raw = round_up(N * D + 4, 4);
  l.raw_a = off + raw;
  if (!sym) raw += round_up(M * D + 4, 4);
  l.total = off + (grad && raw < kGradSlotFloats ? kGradSlotFloats : raw);
  return l;
}

// A contiguous span of n floats at src into raw[shift_of(src) + e], its
// aligned interior by 16-byte copies, its edges by 4-byte ones.
template <int NT>
__device__ __forceinline__ void stage_span(float* raw, const float* src, int n, int tid) {
  const int sh = shift_of(src);
  const float* base = src - sh;                 // 16-byte aligned
  const int units = (sh + n + 3) / 4;
  for (int q = tid; q < units; q += NT) {
    const int lo = 4 * q - sh;                  // the unit's first float of the span
    if (lo >= 0 && lo + 4 <= n) {
      cp_async16(raw + 4 * q, base + 4 * q);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (lo + e >= 0 && lo + e < n) cp_async4(raw + 4 * q + e, base + 4 * q + e);
    }
  }
}

// rows [0, rows) of a row-major (rows, D) copy at raw into dst[k * stride
// + r]: a warp moves 32 consecutive rows of one feature (conflict-free for
// an odd D)
template <int NT>
__device__ __forceinline__ void transpose_span(float* dst, int stride, const float* raw,
                                               int rows, int D, int tid) {
  constexpr int NW = NT / 32;
  const int lane = tid & 31;
  for (int k = tid >> 5; k < D; k += NW)
    for (int r = lane; r < rows; r += 32) dst[k * stride + r] = raw[r * D + k];
}

// sum of squares of each row, in k order from 0, as the parent's sq_dist
template <int NT>
__device__ __forceinline__ void row_norms(float* norm, const float* t, int stride, int rows,
                                          int D, int tid) {
  for (int r = tid; r < rows; r += NT) {
    float nrm = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float x = t[k * stride + r];
      nrm = __fadd_rn(nrm, __fmul_rn(x, x));
    }
    norm[r] = nrm;
  }
}

__device__ __forceinline__ float clamp_d2(float na, float nb, float ab) {
  const float v = __fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.f, ab));
  return v < 0.f ? 0.f : v;   // keeps a NaN, as the plain version's clamp does
}

// the 4 x 4 micro-tile's entries v[i][j] into rows i0.. and columns j0..,
// of which mi rows and nj columns are valid
__device__ __forceinline__ void store4x4(float* K, int N, int i0, int j0, int mi, int nj,
                                         const float v[4][4], bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= mi) break;
    float* row = K + static_cast<size_t>(i0 + i) * N + j0;
    if (vec && nj >= 4) {
      *reinterpret_cast<float4*>(row) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nj) row[j] = v[i][j];
    }
  }
}

// ... and their transpose into rows j0.., columns i0..
__device__ __forceinline__ void store4x4_t(float* K, int N, int i0, int j0, int mi, int nj,
                                           const float v[4][4], bool vec) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= nj) break;
    float* row = K + static_cast<size_t>(j0 + j) * N + i0;
    if (vec && mi >= 4) {
      *reinterpret_cast<float4*>(row) = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < mi) row[i] = v[i][j];
    }
  }
}

// the block's gradient sums in a fixed order: lanes by a shuffle tree,
// then warps in order; thread 0 writes (d_ell, d_sf)
template <int NT, int KIND>
__device__ __forceinline__ void finish_grad(float acc_l, float acc_s, float l, float s,
                                            float* d_ell, float* d_sf, int b) {
  __shared__ float2 red[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc_l = __fadd_rn(acc_l, __shfl_xor_sync(0xffffffffu, acc_l, o));
    acc_s = __fadd_rn(acc_s, __shfl_xor_sync(0xffffffffu, acc_s, o));
  }
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) red[tid >> 5] = make_float2(acc_l, acc_s);
  __syncthreads();
  if (tid != 0) return;
  float sum_l = red[0].x, sum_s = red[0].y;
  for (int w = 1; w < NT / 32; ++w) {
    sum_l = __fadd_rn(sum_l, red[w].x);
    sum_s = __fadd_rn(sum_s, red[w].y);
  }
  const float l2 = __fmul_rn(l, l);
  d_ell[b] = __fdiv_rn(sum_l, KIND == 0 ? l2 : __fmul_rn(l2, l));
  d_sf[b] = __fmul_rn(__fmul_rn(2.f, s), sum_s);
}

// A block a series, a thread an entry, for series of at most NT entries (a
// horizon step's cross-Gram, the host engine's small patterns).  STAGE:
// the series' rows go once from device memory to shared memory by 16-byte
// copies (rows read at a stride of D floats: conflict-free for an odd D,
// D = h + 1 for an even h); otherwise, for a tiny series, they are read
// where they lie (a few cache lines).  A row's norm is summed in the same
// loop as the dot products that read the row.
__host__ __device__ __forceinline__ int entries_smem_floats(int M, int N, int D, bool sym,
                                                            bool stage) {
  return (stage ? round_up(N * D + 4, 4) + (sym ? 0 : round_up(M * D + 4, 4)) : 0) + M + N;
}

template <int NT, int KIND, bool GRAD, bool STAGE>
__device__ __forceinline__ void entries_body(const float* __restrict__ grad,
                                             const float* __restrict__ xa,
                                             const float* __restrict__ xb,
                                             const float* __restrict__ ell,
                                             const float* __restrict__ sf,
                                             float* __restrict__ out, float* __restrict__ d_ell,
                                             float* __restrict__ d_sf, int M, int N, int D,
                                             bool sym) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const float* Xb = xb + static_cast<size_t>(b) * N * D;
  const float* Xa = xa + static_cast<size_t>(b) * M * D;
  const float* rb = Xb;
  const float* ra = Xa;
  float* nb = smem;
  if (STAGE) {
    const int off_a = round_up(N * D + 4, 4);
    stage_span<NT>(smem, Xb, N * D, tid);
    if (!sym) stage_span<NT>(smem + off_a, Xa, M * D, tid);
    cp_async_wait_all();
    __syncthreads();
    rb = smem + shift_of(Xb);
    ra = sym ? rb : smem + off_a + shift_of(Xa);
    nb = smem + off_a + (sym ? 0 : round_up(M * D + 4, 4));
  }
  float* na = sym ? nb : nb + N;
  const int entries = M * N;
  const int i = tid / N, j = tid - (tid / N) * N;
  float ab = 0.f;
  if (tid < entries) {
    // the two rows' norms ride in the dot product's loop, off its chain,
    // and are kept by the entry of column 0 (xa's row) and of row 0 (xb's)
    const float* a = ra + i * D;
    const float* x = rb + j * D;
    float sa = 0.f, sb = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float av = a[k], xv = x[k];
      ab = __fadd_rn(ab, __fmul_rn(av, xv));
      sa = __fadd_rn(sa, __fmul_rn(av, av));
      sb = __fadd_rn(sb, __fmul_rn(xv, xv));
    }
    if (i == 0) nb[j] = sb;
    if (j == 0 && !sym) na[i] = sa;
  }
  __syncthreads();
  const float l = ell[b], s = sf[b];
  const float s2 = __fmul_rn(s, s);
  const size_t at = static_cast<size_t>(b) * entries + tid;
  float acc_l = 0.f, acc_s = 0.f;
  if (tid < entries) {
    float f;
    const float k = unit_kernel<KIND>(clamp_d2(na[i], nb[j], ab), l, &f);
    if (GRAD) {
      const float gk = __fmul_rn(grad[at], k);
      acc_s = gk;
      acc_l = __fmul_rn(__fmul_rn(gk, s2), f);
    } else {
      out[at] = __fmul_rn(s2, k);
    }
  }
  if (GRAD) finish_grad<NT, KIND>(acc_l, acc_s, l, s, d_ell, d_sf, b);
}

// the unit u's micro-tile (p, q) of a P x Q grid of 4 x 4 micro-tiles:
// row-major over all of them, or over those on and above the diagonal when
// sym (P == Q; row p holds P - p of them, S(p) = p P - p (p - 1) / 2 before it)
__device__ __forceinline__ void unit_pos(int u, int P, int Q, bool sym, int* p, int* q) {
  if (!sym) {
    *p = u / Q;
    *q = u - *p * Q;
    return;
  }
  const float c = 2.f * P + 1.f;
  int r = static_cast<int>((c - sqrtf(c * c - 8.f * u)) * 0.5f);
  r = max(0, min(r, P - 1));
  while (r > 0 && r * P - r * (r - 1) / 2 > u) --r;
  while (r + 1 < P && (r + 1) * P - (r + 1) * r / 2 <= u) ++r;
  *p = r;
  *q = r + (u - (r * P - r * (r - 1) / 2));
}

// A block a series whose rows fit in shared memory whole (the Gram route's
// K(X, X)): staged once, transposed once, their norms summed once.  The
// series' 4 x 4 micro-tiles (those on and above the diagonal when sym: 528
// of 1,024 at N = 128, each above it also writing its transpose) are dealt
// to the threads in order, neighbouring lanes on neighbouring micro-tiles,
// with no barrier between them; the gradient's sums stay in registers.
template <int KIND, bool GRAD>
__device__ __forceinline__ void series_body(const float* __restrict__ grad,
                                            const float* __restrict__ xa,
                                            const float* __restrict__ xb,
                                            const float* __restrict__ ell,
                                            const float* __restrict__ sf,
                                            float* __restrict__ out, float* __restrict__ d_ell,
                                            float* __restrict__ d_sf, int M, int N, int D,
                                            bool sym) {
  constexpr int NT = kSeriesThreads;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const SeriesLayout L = series_layout(M, N, D, sym, GRAD);
  const float* Xb = xb + static_cast<size_t>(b) * N * D;
  const float* Xa = xa + static_cast<size_t>(b) * M * D;
  stage_span<NT>(smem + L.raw_b, Xb, N * D, tid);
  if (!sym) stage_span<NT>(smem + L.raw_a, Xa, M * D, tid);
  cp_async_wait_all();
  __syncthreads();
  transpose_span<NT>(smem + L.xt, L.sn, smem + L.raw_b + shift_of(Xb), N, D, tid);
  if (!sym) transpose_span<NT>(smem + L.at, L.sa, smem + L.raw_a + shift_of(Xa), M, D, tid);
  __syncthreads();
  row_norms<NT>(smem + L.nb, smem + L.xt, L.sn, N, D, tid);
  if (!sym) row_norms<NT>(smem + L.na, smem + L.at, L.sa, M, D, tid);
  __syncthreads();

  const float* xt = smem + L.xt;
  const float* at = smem + L.at;
  const float* nb = smem + L.nb;
  const float* na = smem + L.na;
  float* gbuf = smem + L.raw_b;   // GRAD: 8 float4 slots a thread, over the raw rows
  const float l = ell[b], s = sf[b];
  const float s2 = __fmul_rn(s, s);
  const size_t base = static_cast<size_t>(b) * M * N;
  const bool vec = (N & 3) == 0 && (GRAD ? aligned16(grad) : aligned16(out));
  float acc_l = 0.f, acc_s = 0.f;
  const int P = (M + 3) / 4, Q = (N + 3) / 4;
  const int units = sym ? P * (P + 1) / 2 : P * Q;
  for (int u = tid; u < units; u += NT) {
    int p, q;
    unit_pos(u, P, Q, sym, &p, &q);
    const int r0 = 4 * p, c0 = 4 * q;
    const int mi = M - r0, nj = N - c0;   // valid rows, columns (4 or more: all)
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const bool mirror = sym && p != q;
    if (GRAD) {
      // the gradient's G[i][j] and, where only the micro-tile above runs,
      // G[j][i], copied into this thread's slots of shared memory while it
      // sums the dot products (slot e of thread t: float4 e * NT + t)
      const float* G = grad + base;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < mi) copy4(gbuf + 4 * (i * NT + tid), G + static_cast<size_t>(r0 + i) * N + c0, nj, vec);
      if (mirror) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj) copy4(gbuf + 4 * ((4 + j) * NT + tid), G + static_cast<size_t>(c0 + j) * N + r0, mi, vec);
      }
      cp_async_commit();
    }
    const float* pa = at + r0;
    const float* pb = xt + c0;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(pa + k * L.sa);
      const float4 b4 = *reinterpret_cast<const float4*>(pb + k * L.sn);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
    }
    if (GRAD) {
      cp_async_wait_mine();
      float h[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(gbuf + 4 * ((4 + j) * NT + tid));
        h[j][0] = x.x; h[j][1] = x.y; h[j][2] = x.z; h[j][3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= mi) break;
        const float4 x = *reinterpret_cast<const float4*>(gbuf + 4 * (i * NT + tid));
        const float g[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= nj) break;
          float f;
          const float k = unit_kernel<KIND>(clamp_d2(na[r0 + i], nb[c0 + j], acc[i][j]), l, &f);
          // G[i][j] + G[j][i] multiplies the one k of both entries; sf^2
          // multiplies acc_l once, after the loop
          const float gk = __fmul_rn(mirror ? __fadd_rn(g[j], h[j][i]) : g[j], k);
          acc_s = __fadd_rn(acc_s, gk);
          acc_l = __fadd_rn(acc_l, __fmul_rn(gk, f));
        }
      }
    } else {
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float unused;
          v[i][j] = __fmul_rn(s2, unit_kernel<KIND>(clamp_d2(na[r0 + i], nb[c0 + j], acc[i][j]),
                                                    l, &unused));
        }
      float* K = out + base;
      store4x4(K, N, r0, c0, mi, nj, v, vec);
      if (mirror) store4x4_t(K, N, r0, c0, mi, nj, v, vec);
    }
  }
  if (GRAD) finish_grad<NT, KIND>(__fmul_rn(acc_l, s2), acc_s, l, s, d_ell, d_sf, b);
}

#define GRAM_ARGS const float* __restrict__ grad, const float* __restrict__ xa, \
    const float* __restrict__ xb, const float* __restrict__ ell, const float* __restrict__ sf, \
    float* __restrict__ out, float* __restrict__ d_ell, float* __restrict__ d_sf, int M, int N, \
    int D, int sym
#define GRAM_PASS grad, xa, xb, ell, sf, out, d_ell, d_sf, M, N, D, sym != 0

template <int NT, int KIND, bool STAGE>
__global__ void __launch_bounds__(NT) gram_fwd_entries(GRAM_ARGS) {
  entries_body<NT, KIND, false, STAGE>(GRAM_PASS);
}
template <int NT, int KIND, bool STAGE>
__global__ void __launch_bounds__(NT) gram_bwd_entries(GRAM_ARGS) {
  entries_body<NT, KIND, true, STAGE>(GRAM_PASS);
}
template <int KIND>
__global__ void __launch_bounds__(kSeriesThreads, 4) gram_fwd_series(GRAM_ARGS) {
  series_body<KIND, false>(GRAM_PASS);
}
template <int KIND>
__global__ void __launch_bounds__(kSeriesThreads, 4) gram_bwd_series(GRAM_ARGS) {
  series_body<KIND, true>(GRAM_PASS);
}

// How a call runs: a thread an entry (a series' rows read where they lie,
// or staged), a block a series (its rows fit in shared memory whole), else
// a block a tile.
enum Route { kDirect, kStaged, kSeries, kTiles };

struct Plan {
  Route route;
  int smem, parts;   // parts: the gradient's partial sums a series
};

constexpr int kDirectFloats = 2048;   // a series read where it lies: at most 8 KB

__host__ __forceinline__ Plan plan_of(const float* xa, const float* xb, int M, int N, int D,
                                      bool grad) {
  const bool sym = xa == xb && M == N;
  if (M * N <= kDirectThreads && (M + N) * D <= kDirectFloats)
    return {kDirect, 4 * entries_smem_floats(M, N, D, sym, false), 1};
  const int staged = 4 * entries_smem_floats(M, N, D, sym, true);
  if (M * N <= kEntryThreads && staged <= kSeriesSmemMax) return {kStaged, staged, 1};
  const int series = 4 * series_layout(M, N, D, sym, grad).total;
  if (series <= kSeriesSmemMax) return {kSeries, series, 1};
  return {kTiles, 0, tiles_of(M, N, sym)};
}

template <int KIND, bool GRAD>
cudaError_t by_series(const Plan& p, GRAM_ARGS, int B, cudaStream_t st) {
  switch (p.route) {
    case kDirect:
      if (GRAD) gram_bwd_entries<kDirectThreads, KIND, false><<<B, kDirectThreads, p.smem, st>>>(GRAM_PASS);
      else gram_fwd_entries<kDirectThreads, KIND, false><<<B, kDirectThreads, p.smem, st>>>(GRAM_PASS);
      break;
    case kStaged:
      if (GRAD) gram_bwd_entries<kEntryThreads, KIND, true><<<B, kEntryThreads, p.smem, st>>>(GRAM_PASS);
      else gram_fwd_entries<kEntryThreads, KIND, true><<<B, kEntryThreads, p.smem, st>>>(GRAM_PASS);
      break;
    default:
      if (GRAD) gram_bwd_series<KIND><<<B, kSeriesThreads, p.smem, st>>>(GRAM_PASS);
      else gram_fwd_series<KIND><<<B, kSeriesThreads, p.smem, st>>>(GRAM_PASS);
  }
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSeriesSmemMax);
}

template <int KIND>
cudaError_t allow_all() {
  cudaError_t e;
  if ((e = allow<kTile, KIND>()) != cudaSuccess ||
      (e = allow_smem(gram_fwd_entries<kEntryThreads, KIND, true>)) != cudaSuccess ||
      (e = allow_smem(gram_bwd_entries<kEntryThreads, KIND, true>)) != cudaSuccess ||
      (e = allow_smem(gram_fwd_series<KIND>)) != cudaSuccess)
    return e;
  return allow_smem(gram_bwd_series<KIND>);
}

}  // namespace

extern "C" int gp_gram_init() {
  cudaError_t e = allow_all<0>();
  if (e == cudaSuccess) e = allow_all<1>();
  return static_cast<int>(e);
}

// the gradient's partial sums a series (its scratch holds two floats each;
// 1: none needed)
extern "C" int gp_gram_parts(const float* xa, const float* xb, int M, int N, int D) {
  return plan_of(xa, xb, M, N, D, true).parts;
}

extern "C" int gp_gram_fwd(const float* xa, const float* xb, const float* ell,
                           const float* sf, float* out, int B, int M, int N,
                           int D, int kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(xa, xb, M, N, D, false);
  const int sym = symmetric(xa, xb, M, N);
  const float* grad = nullptr;
  float *d_ell = nullptr, *d_sf = nullptr;
  if (p.route != kTiles)
    return static_cast<int>(kind == 0 ? by_series<0, false>(p, GRAM_PASS, B, st)
                                      : by_series<1, false>(p, GRAM_PASS, B, st));
  const int tiles = tiles_of(M, N, sym);
  cudaError_t e = kind == 0 ? fwd<kTile, 0>(xa, xb, ell, sf, out, B, M, N, D, sym, tiles, st)
                            : fwd<kTile, 1>(xa, xb, ell, sf, out, B, M, N, D, sym, tiles, st);
  return static_cast<int>(e);
}

extern "C" int gp_gram_bwd(const float* grad, const float* xa, const float* xb,
                           const float* ell, const float* sf, float* d_ell,
                           float* d_sf, float* part, int B, int M, int N, int D, int kind,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(xa, xb, M, N, D, true);
  const int sym = symmetric(xa, xb, M, N);
  float* out = nullptr;
  if (p.route != kTiles)
    return static_cast<int>(kind == 0 ? by_series<0, true>(p, GRAM_PASS, B, st)
                                      : by_series<1, true>(p, GRAM_PASS, B, st));
  const int tiles = tiles_of(M, N, sym);
  cudaError_t e =
      kind == 0 ? bwd<kTile, 0>(grad, xa, xb, ell, sf, d_ell, d_sf, part, B, M, N, D, sym, tiles, st)
                : bwd<kTile, 1>(grad, xa, xb, ell, sf, d_ell, d_sf, part, B, M, N, D, sym, tiles, st);
  if (e != cudaSuccess || tiles == 1) return static_cast<int>(e);
  gram_tile_sums<<<(B + 127) / 128, 128, 0, st>>>(part, ell, sf, d_ell, d_sf, B, tiles, kind);
  return static_cast<int>(cudaGetLastError());
}
