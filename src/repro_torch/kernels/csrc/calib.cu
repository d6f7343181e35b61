// The device engine's conformal calibration, three kernels: the tick's
// resolution of outstanding predictions (calib_observe), the conformal
// quantile of score rings (conformal_scale), and the rest of the
// engine's shaping step (calib_begin: the fallback hierarchy and the
// registration of the deployed predictions).
//
// Replaces: XLA code of the reference, not a Pallas kernel:
// calib_observe (repro/core/uncertainty/online.py:317), whose pool
// update is a cumsum scatter; conformal_scale / conformal_scale_ring
// (repro/core/uncertainty/conformal.py:83,113), a sort of every ring;
// calib_scales' hierarchy and calib_begin (online.py:447,413).  The plain
// versions are repro_torch/kernels/ref.py:calib_observe, conformal_scale
// and calib_scales; each output equals them to the bit.
//
// calib_observe: grid (1 + ceil(R / 32), S) of 1,024 threads, S members
// of R = 2 * A * C series rows (3,072 at the default widths).  Blocks
// x >= 1 take 32 rows each, a warp a row: age `left`, take the running
// max `peak`, and copy the row's ring into the output with the resolved
// score at count % capacity.  Block x = 0 takes the member: one pass
// stages each row's outcome (resolved, its score) in shared memory and
// counts, then the resolved scores enter the pool in row order (a
// block-wide exclusive scan, ballot and popc per warp, of each 1,024-row
// tile) at pool_count + k, the last pool_capacity of them (so no two
// writes share a cell), and thread 0 adds the counters and takes the
// adaptive step of q.  What bounds it: bytes, the ring (1.5 MB a member
// at capacity 128) copied by the row blocks; the member block's one
// pass over ~30 B a row is its latency.
//
// conformal_scale: the element at sorted position k of each ring, by a
// sort.  A cell's key orders floats as jnp.sort does (-0 = +0, every NaN
// equal and last) and the sort is stable, so the element's key is the
// k-th least key, and where that key is not a zero's or a NaN's the key
// gives the element's bits.  A ring of up to 512 cells is a warp's: its
// keys in registers (cap / 32 a lane), a bitonic network within the lane
// and by shuffles across lanes, eight rows a block at once; a larger one
// (the 1,024-cell pool, generic capacities up to 8,192) is a block's of
// 256 threads, the network's stages across warps through shared memory.
// A zero or a NaN at rank k is a tie whose bits may differ: the element
// is then the (k - below)-th cell of that key in position order (below,
// the cells of lesser keys), found a tile of 32 positions a ballot.  The
// engine's launch (calib_quantiles) takes the series rings, the pools and
// the group rings in one grid and skips what its hierarchy does not read
// (young series, the pool when it is off).  What bounds it: instruction
// issue, ~400 instructions a 128-cell row (28 network stages, 15 of them
// shuffles), 3,072 rows over 528 schedulers; the rings' bytes (1.6 MB)
// take 0.48 us.  Measured on an H100 (PERF.md, profile_port.py --path
// calib): 6.22-6.43 us a launch at 3,072 warm rows and the pool, against
// 18.97-19.19 for the earlier design (ranks counted, cap^2 key
// comparisons a row) in the same call; torch.kthvalue 25.1 us.
//
// The per-tenant tier (the control plane on; every pointer of it null
// otherwise, and the kernels then do what they did without it):
// calib_observe's member block also scores each resolved row into its
// deploy group's ring, the group's scores ranked in row order by a
// ballot per group and warp over each 1,024-row tile, the last
// group_capacity of them written (online.py:375-413), and counts each
// group's resolved and missed scores, which it also returns as the
// tick's deltas for the tenant credit; conformal_scale ranks the group
// rings too, each at its tenant's credit-modulated quantile
// clip(fma(spread, 1 - 2 * credit, q), q_min, q_max) (XLA contracts it),
// and a series row of a tenant's slot at its tenant's quantile;
// calib_begin falls back from a young series to its tenant's warm ring
// before the pool, and registers the tenant as the row's group.  A row's
// tenant is read from the slot table (slot_gid, then the trace's tenant
// column) where it is needed.
//
// calib_begin: one block of 1,024 threads per member after the
// quantiles: each row's scale (its series' quantile once warm, else the
// pool's once warm, else K2) and the predictions it registers, the
// deployed scales staged in shared memory, then summed in XLA:CPU's tree
// of 32-wide windows (a thread a window).  It is a launch of its own
// because it needs the pool's quantile, which other blocks compute: a
// version that ran it in the quantiles' launch (the last block of each
// member, or of each window, found by atomic counters) measured 71.7 and
// 335.9 us a launch at 3,072 warm rows on an H100, against 15 for the
// quantiles.
// What bounds it: bytes, ~60 B a row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "xla_fma.cuh"

namespace {

constexpr int kThreads = 1024;             // calib_observe's blocks
constexpr int kWarps = kThreads / 32;      // ring rows per block
constexpr int kScaleThreads = 256;         // conformal_scale's blocks
constexpr int kScaleWarps = kScaleThreads / 32;   // rows a block on the warp path
constexpr int kWarpCap = 512;              // the largest ring a warp selects in
constexpr int kBlockCap = 32 * kScaleThreads;   // the largest ring a block selects in
constexpr int kWindow = 32;                // XLA:CPU's tree-reduction window

// max and min as XLA and numpy take them: NaN when either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a >= b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a <= b || a != a) ? a : b;
}

// a + b rounded once, a NaN operand returned as x86 returns it (the
// first NaN, quieted; CUDA's add returns its canonical NaN), so a NaN
// score reaches the sums with the bits the plain version's numpy gives
__device__ __forceinline__ float add_x86(float a, float b) {
  if (a != a) return __uint_as_float(__float_as_uint(a) | 0x400000u);
  if (b != b) return __uint_as_float(__float_as_uint(b) | 0x400000u);
  return __fadd_rn(a, b);
}

// the per-tenant tier's view of the slot table: a series row's tenant
struct Tier {
  const int* slot_gid;   // (S, A), null without the tier
  const int* tenant;     // (S, N)
  int A, C, N, T;
};

// the tenant of series row r (of R = 2M) of member s: its slot's app's,
// -1 for an empty slot (or a tenant id outside [0, T))
__device__ __forceinline__ int row_group(const Tier& t, int s, int r, int M) {
  const int mr = r < M ? r : r - M;
  const int gid = t.slot_gid[static_cast<size_t>(s) * t.A + mr / t.C];
  if (gid < 0) return -1;
  const int g = t.tenant[static_cast<size_t>(s) * t.N + gid];
  return (g >= 0 && g < t.T) ? g : -1;
}

// a tenant's target quantile from its credit (repro/control/credit.py:46,
// contracted as the reference's compiled tick does; 2 * credit is exact)
__device__ __forceinline__ float tenant_q(float q, float credit, float spread, float q_min,
                                          float q_max) {
  const float lin = __fsub_rn(1.f, __fmul_rn(2.f, credit));
  return min_nan(max_nan(xla::fma_f32(spread, lin, q), q_min), q_max);
}

// ---------------------------------------------------------------------
// calib_observe
// ---------------------------------------------------------------------

struct ObserveArgs {
  const float* ring; const int* ring_count; const float* pool; const int* pool_count;
  const float* mean; const float* sigma; const float* scale; const float* peak;
  const int* left; const int* due; const float* q; const int* resolved;
  const int* errors; const int* dropped; const float* usage; const int* mon_count;
  const uint8_t* active;
  float* o_ring; int* o_ring_count; float* o_pool; int* o_pool_count; float* o_peak;
  int* o_left; float* o_q; int* o_resolved; int* o_errors; int* o_dropped;
  int R, cap, pcap, pool_on, adaptive;
  float gamma, budget, q_min, q_max;
  // the per-tenant tier (G = 0 and null pointers without it)
  const float* group_ring; const int* group_count; const int* group;
  const int* group_resolved; const int* group_errors;
  float* o_group_ring; int* o_group_count; int* o_group_resolved; int* o_group_errors;
  int* o_d_res; int* o_d_err;
  int G, gcap;
};

struct Row {
  float peak, score;
  int left;
  bool fire, ok, err;
};

// series row r of member s this tick (rows r < M read the monitor row's
// cpu usage, M + r its mem)
__device__ __forceinline__ Row observe_row(const ObserveArgs& p, int s, int r,
                                           bool active) {
  const size_t i = static_cast<size_t>(s) * p.R + r;
  const int M = p.R / 2;
  const int mr = r < M ? r : r - M;
  const size_t mi = static_cast<size_t>(s) * M + mr;
  Row o;
  const int l = p.left[i];
  const bool act = active && l > 0;
  const float pk = p.peak[i];
  o.peak = act ? max_nan(pk, p.usage[mi * 2 + (r < M ? 0 : 1)]) : pk;
  o.left = l - (act ? 1 : 0);
  o.fire = act && o.left == 0;
  o.ok = o.fire && p.mon_count[mi] == p.due[i];
  const float mean = p.mean[i], sigma = p.sigma[i];
  o.score = __fdiv_rn(__fsub_rn(o.peak, mean), max_nan(sigma, 1e-6f));
  o.err = o.ok && o.peak > xla::fma_f32(p.scale[i], sigma, mean);
  return o;
}

__global__ void __launch_bounds__(kThreads) calib_observe_kernel(const ObserveArgs p) {
  const int s = blockIdx.y;
  const bool active = p.active[s] != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x > 0) {                    // ring rows, a warp each
    const int r = (blockIdx.x - 1) * kWarps + warp;
    if (r >= p.R) return;
    const Row o = observe_row(p, s, r, active);
    const size_t i = static_cast<size_t>(s) * p.R + r;
    const int count = p.ring_count[i];
    if (lane == 0) {
      p.o_peak[i] = o.peak;
      p.o_left[i] = o.left;
      p.o_ring_count[i] = count + (o.ok ? 1 : 0);
    }
    const int pos = count % p.cap;
    const float* src = p.ring + i * p.cap;
    float* dst = p.o_ring + i * p.cap;
    for (int c = lane; c < p.cap; c += 32) dst[c] = (o.ok && c == pos) ? o.score : src[c];
    return;
  }

  // the member: each row's outcome staged in shared memory by one pass
  // over the rows, then the pool, the group rings, the counters and q
  extern __shared__ float score[];                       // [R], then ok [R]
  uint8_t* ok = reinterpret_cast<uint8_t*>(score + p.R);
  // the tier: each resolved row's group or -1 [R], then per group its
  // scores and misses this tick, the scores of the tiles before, and the
  // scores of each warp in the current tile [G * kWarps]
  int8_t* gsel = reinterpret_cast<int8_t*>(ok + p.R);
  int* g_n = reinterpret_cast<int*>(score + (3 * p.R + 3) / 2 + 1);
  int* g_err = g_n + p.G;
  int* g_base = g_err + p.G;
  int* g_warp = g_base + p.G;
  __shared__ int warp_ok[kWarps], totals[3];
  if (tid < 3) totals[tid] = 0;
  for (int g = tid; g < 3 * p.G; g += kThreads) g_n[g] = 0;
  const float* psrc = p.pool + static_cast<size_t>(s) * p.pcap;
  float* pdst = p.o_pool + static_cast<size_t>(s) * p.pcap;
  for (int c = tid; c < p.pcap; c += kThreads) pdst[c] = psrc[c];
  const size_t gring = static_cast<size_t>(s) * p.G * p.gcap;
  for (int c = tid; c < p.G * p.gcap; c += kThreads)
    p.o_group_ring[gring + c] = p.group_ring[gring + c];
  if (p.G) __syncthreads();                // the group counters zeroed
  int n_ok = 0, n_err = 0, n_drop = 0;
  for (int r = tid; r < p.R; r += kThreads) {
    const Row o = observe_row(p, s, r, active);
    score[r] = o.score;
    ok[r] = o.ok;
    n_ok += o.ok;
    n_err += o.err;
    n_drop += o.fire && !o.ok;
    if (p.G) {
      const int g = p.group[static_cast<size_t>(s) * p.R + r];
      const bool mine = o.ok && g >= 0 && g < p.G;
      gsel[r] = mine ? static_cast<int8_t>(g) : -1;
      if (mine) {
        atomicAdd(&g_n[g], 1);
        if (o.err) atomicAdd(&g_err[g], 1);
      }
    }
  }
  n_ok = __reduce_add_sync(0xffffffffu, n_ok);
  n_err = __reduce_add_sync(0xffffffffu, n_err);
  n_drop = __reduce_add_sync(0xffffffffu, n_drop);
  __syncthreads();                         // totals zeroed, the pool copied, rows staged
  if (lane == 0) {
    atomicAdd(&totals[0], n_ok);
    atomicAdd(&totals[1], n_err);
    atomicAdd(&totals[2], n_drop);
  }
  __syncthreads();
  n_ok = totals[0];
  const int pool_count = p.pool_count[s];
  for (int t0 = 0, base = 0; p.pool_on && t0 < p.R; t0 += kThreads) {
    const int r = t0 + tid;
    const bool here = r < p.R && ok[r];
    const unsigned ballot = __ballot_sync(0xffffffffu, here);
    if (lane == 0) warp_ok[warp] = __popc(ballot);
    __syncthreads();
    int k = base + __popc(ballot & ((1u << lane) - 1u)), tile = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) k += warp_ok[w];
      tile += warp_ok[w];
    }
    if (here && k >= n_ok - p.pcap) pdst[(pool_count + k) % p.pcap] = score[r];
    base += tile;
    __syncthreads();                       // this tile's reads of warp_ok are done
  }
  // the group rings: a score's rank among its group's in row order is
  // the group's scores of the earlier tiles, of the earlier warps of this
  // tile and of the earlier lanes of its warp
  const int* gcount = p.group_count + static_cast<size_t>(s) * p.G;
  for (int t0 = 0; p.G && t0 < p.R; t0 += kThreads) {
    const int r = t0 + tid;
    const int mine = r < p.R ? gsel[r] : -1;
    unsigned own = 0;
    for (int g = 0; g < p.G; ++g) {
      const unsigned b = __ballot_sync(0xffffffffu, mine == g);
      if (lane == 0) g_warp[g * kWarps + warp] = __popc(b);
      if (mine == g) own = b;
    }
    __syncthreads();
    if (mine >= 0) {
      int k = g_base[mine] + __popc(own & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) k += g_warp[mine * kWarps + w];
      if (k >= g_n[mine] - p.gcap)
        p.o_group_ring[gring + static_cast<size_t>(mine) * p.gcap +
                       (gcount[mine] + k) % p.gcap] = score[r];
    }
    __syncthreads();                       // this tile's reads of g_base, g_warp are done
    for (int g = tid; g < p.G; g += kThreads)
      for (int w = 0; w < kWarps; ++w) g_base[g] += g_warp[g * kWarps + w];
    __syncthreads();
  }
  for (int g = tid; g < p.G; g += kThreads) {
    const size_t i = static_cast<size_t>(s) * p.G + g;
    p.o_group_count[i] = gcount[g] + g_n[g];
    p.o_group_resolved[i] = p.group_resolved[i] + g_n[g];
    p.o_group_errors[i] = p.group_errors[i] + g_err[g];
    p.o_d_res[i] = g_n[g];
    p.o_d_err[i] = g_err[g];
  }
  if (tid != 0) return;
  p.o_pool_count[s] = pool_count + (p.pool_on ? n_ok : 0);
  p.o_resolved[s] = p.resolved[s] + n_ok;
  p.o_errors[s] = p.errors[s] + totals[1];
  p.o_dropped[s] = p.dropped[s] + totals[2];
  float q = p.q[s];
  if (p.adaptive && n_ok > 0) {
    const float rate = __fdiv_rn(static_cast<float>(totals[1]), static_cast<float>(n_ok));
    q = min_nan(max_nan(xla::fma_f32(p.gamma, __fsub_rn(rate, p.budget), q), p.q_min),
                p.q_max);
  }
  p.o_q[s] = q;
}

// ---------------------------------------------------------------------
// conformal_scale
// ---------------------------------------------------------------------

struct ScaleArgs {
  // three sets of rings: 0 the series (or the only set), 1 the pools, 2
  // the group rings of the per-tenant tier
  const float* scores[3];
  const int* counts[3];
  // rpb: the rows of a block (kScaleWarps, a warp a row, up to kWarpCap
  // cells; 1 above); blocks: the set's blocks
  int rows[3], cap[3], rpb[3], blocks[3];
  const float* q;          // (groups,): row r of a set takes entry r / (rows / groups)
  const float* fallback;   // (groups,), or null for k2
  float k2;
  int groups, rolled;
  float* out[3];
  // the engine's step ranks only what its hierarchy reads: no series
  // below min_scores, no pool when pool_on is 0 (min_scores 0 and
  // pool_on 1 rank every row)
  int min_scores, pool_on;
  // the tier: a credit (S, T) moves the q of a tenant's series rows and
  // of its group ring (null: every row at its member's q)
  Tier tier;
  const float* credit;
  float spread, q_min, q_max;
};

// the q of row `row` of set `set`
__device__ __forceinline__ float row_q(const ScaleArgs& p, int set, int row) {
  const int per = p.rows[set] / p.groups, m = row / per;
  const float q = p.q[m];
  if (!p.credit || set == 1) return q;
  const int g = set == 2 ? row % per : row_group(p.tier, m, row % per, per / 2);
  return g < 0 ? q : tenant_q(q, p.credit[static_cast<size_t>(m) * p.tier.T + g], p.spread,
                              p.q_min, p.q_max);
}

// a float32's key in jnp.sort's order
__device__ __forceinline__ unsigned sort_key(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = v == 0.f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the rank k that row `row` of set `set` is read at, with its live count
// n; -1 where the step does not read it (too young, or the pool off) or
// where it is empty, which writes the fallback (thread `leader` of it)
__device__ __forceinline__ int row_rank(const ScaleArgs& p, int set, int row, int cap,
                                        bool leader, int& n) {
  n = min(p.counts[set][row], cap);
  if (n < p.min_scores || (set == 1 && !p.pool_on)) return -1;
  if (n <= 0) {
    if (leader) p.out[set][row] = p.fallback ? p.fallback[row / (p.rows[set] / p.groups)] : p.k2;
    return -1;
  }
  const int k = static_cast<int>(ceilf(__fmul_rn(__fadd_rn(static_cast<float>(n), 1.f),
                                                 row_q(p, set, row)))) - 1;
  return min(max(k, 0), n - 1);
}

// a cell's value: a rolled ring's first cap - n cells read as +inf
__device__ __forceinline__ float cell(const float* src, int i, int cap, int n, int rolled) {
  return (rolled && i < cap - n) ? INFINITY : src[i];
}

// the float32 whose sort key is `key`, for a key of neither class that
// ties (zeros, 0x80000000, and NaNs, 0xffffffff)
__device__ __forceinline__ float from_key(unsigned key) {
  return __uint_as_float(key & 0x80000000u ? key & 0x7fffffffu : ~key);
}

__device__ __forceinline__ bool ties(unsigned key) {
  return key == 0x80000000u || key == 0xffffffffu;
}

// A group of W warps (a warp, or the block) sorts N = 32 W J keys, thread
// t of the group holding elements t J .. t J + J - 1 in key[]: a bitonic
// network, its stages within a thread in registers, within a warp by
// shuffles, across warps through xchg (N words of shared memory).
template <int J, int W>
__device__ __forceinline__ void group_sort(unsigned (&key)[J], int t, unsigned* xchg) {
  constexpr int N = 32 * W * J;
  const int lane = t & 31;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      if (stride < J) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int j2 = j ^ stride;
          if (j2 > j) {
            const bool asc = ((t * J + j) & size) == 0;
            const unsigned lo = min(key[j], key[j2]), hi = max(key[j], key[j2]);
            key[j] = asc ? lo : hi;
            key[j2] = asc ? hi : lo;
          }
        }
      } else if (stride < 32 * J) {
        const int m = stride / J;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const unsigned other = __shfl_xor_sync(0xffffffffu, key[j], m);
          const bool asc = ((t * J + j) & size) == 0;
          key[j] = lower == asc ? min(key[j], other) : max(key[j], other);
        }
      } else {
        __syncthreads();                     // the last exchange is read
#pragma unroll
        for (int j = 0; j < J; ++j) xchg[t * J + j] = key[j];
        __syncthreads();
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int e = t * J + j;
          const unsigned other = xchg[e ^ stride];
          key[j] = ((e & stride) == 0) == ((e & size) == 0) ? min(key[j], other)
                                                            : max(key[j], other);
        }
      }
    }
  }
}

// The key of rank k among a row's cells and the number of cells of lesser
// keys (`below`, counted only where the key ties), by a group of W warps,
// thread t of it reading J cells (cell j 32 W + t; the cells past cap sort
// last as 0xffffffff, among the NaNs if any)
template <int J, int W>
__device__ unsigned group_select(const ScaleArgs& p, int set, const float* src, int cap, int n,
                                 int k, int t, unsigned* xchg, unsigned& below) {
  unsigned key[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = j * 32 * W + t;
    key[j] = i < cap ? sort_key(cell(src, i, cap, n, p.rolled)) : 0xffffffffu;
  }
  group_sort<J, W>(key, t, xchg);
  unsigned v = key[0];
#pragma unroll
  for (int j = 1; j < J; ++j)
    if (j == k % J) v = key[j];
  unsigned K;
  if (W == 1) {
    K = __shfl_sync(0xffffffffu, v, k / J);
  } else {
    __syncthreads();
    if (t == k / J) xchg[0] = v;
    __syncthreads();
    K = xchg[0];
  }
  if (!ties(K)) return K;
  unsigned c = 0;                             // sorted elements below K
#pragma unroll
  for (int j = 0; j < J; ++j) c += key[j] < K;
  c = __reduce_add_sync(0xffffffffu, c);
  if (W > 1) {
    __syncthreads();
    if ((t & 31) == 0) xchg[t >> 5] = c;
    __syncthreads();
    c = 0;
    for (int w = 0; w < W; ++w) c += xchg[w];
  }
  below = c;
  return K;
}

// The element at sorted position k of row `row` of set `set` (cap cells),
// by a group of W warps: from its key, or where that key ties (a zero or
// a NaN) the (k - below)-th cell of that key in position order, found by
// the group's first warp a tile of 32 positions a ballot.
template <int J, int W>
__device__ void select_row(const ScaleArgs& p, int set, int row, int cap, int n, int k, int t,
                           unsigned* xchg) {
  const float* src = p.scores[set] + static_cast<size_t>(row) * cap;
  unsigned below = 0;
  const unsigned K = group_select<J, W>(p, set, src, cap, n, k, t, xchg, below);
  if (!ties(K)) {
    if (t == 0) p.out[set][row] = from_key(K);
    return;
  }
  if (t >= 32) return;
  unsigned r = k - below;
  for (int i0 = 0; i0 < cap; i0 += 32) {
    const int i = i0 + t;
    const unsigned m = __ballot_sync(0xffffffffu,
                                     i < cap && sort_key(cell(src, i, cap, n, p.rolled)) == K);
    const unsigned c = __popc(m);
    if (r < c) {
      if (t == 0) p.out[set][row] = cell(src, i0 + __fns(m, 0, r + 1), cap, n, p.rolled);
      return;
    }
    r -= c;
  }
}

// A warp a row (up to kWarpCap cells) or a block a row: the element at
// sorted position k of the row (see the notes at the top), its own bits.
__global__ void __launch_bounds__(kScaleThreads, 3) conformal_scale_kernel(const ScaleArgs p) {
  extern __shared__ unsigned xchg[];
  int b = blockIdx.x, set = 0;
  while (b >= p.blocks[set]) b -= p.blocks[set++];
  const int cap = p.cap[set];
  int n;
  if (cap <= kWarpCap) {                       // a warp a row, its keys in registers
    const int lane = threadIdx.x & 31;
    const int row = b * kScaleWarps + (threadIdx.x >> 5);
    if (row >= p.rows[set]) return;
    const int k = row_rank(p, set, row, cap, lane == 0, n);
    if (k < 0) return;
    if (cap <= 32) select_row<1, 1>(p, set, row, cap, n, k, lane, nullptr);
    else if (cap <= 64) select_row<2, 1>(p, set, row, cap, n, k, lane, nullptr);
    else if (cap <= 128) select_row<4, 1>(p, set, row, cap, n, k, lane, nullptr);
    else if (cap <= 256) select_row<8, 1>(p, set, row, cap, n, k, lane, nullptr);
    else select_row<16, 1>(p, set, row, cap, n, k, lane, nullptr);
    return;
  }
  const int k = row_rank(p, set, b, cap, threadIdx.x == 0, n);   // a block a row
  if (k < 0) return;
  const int t = threadIdx.x;
  if (cap <= 1024) select_row<4, kScaleWarps>(p, set, b, cap, n, k, t, xchg);
  else if (cap <= 2048) select_row<8, kScaleWarps>(p, set, b, cap, n, k, t, xchg);
  else if (cap <= 4096) select_row<16, kScaleWarps>(p, set, b, cap, n, k, t, xchg);
  else select_row<32, kScaleWarps>(p, set, b, cap, n, k, t, xchg);
}

int scale_launch(ScaleArgs& p, void* stream) {
  size_t smem = 0;
  long long blocks = 0;
  for (int s = 0; s < 3; ++s) {
    p.blocks[s] = 0;
    if (p.rows[s] <= 0) continue;
    if (p.cap[s] <= 0 || p.cap[s] > kBlockCap || p.rows[s] % p.groups)
      return static_cast<int>(cudaErrorInvalidValue);
    p.rpb[s] = p.cap[s] <= kWarpCap ? kScaleWarps : 1;
    const long long nb = (p.rows[s] + p.rpb[s] - 1) / p.rpb[s];
    if (nb > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    p.blocks[s] = static_cast<int>(nb);
    blocks += nb;
    size_t words = 1024;                       // the block's network: a power of two
    while (words < static_cast<size_t>(p.cap[s])) words <<= 1;
    if (p.rpb[s] == 1) smem = std::max(smem, words * sizeof(unsigned));
  }
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  conformal_scale_kernel<<<static_cast<int>(blocks), kScaleThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// calib_begin: the engine's step after the quantiles
// ---------------------------------------------------------------------

// float32 sum of x(0), ..., x(n - 1) in XLA:CPU's order (ref.py:xla_sum):
// over more than 32 terms, the axis padded to a multiple of 32 (the
// padding split between its ends, the odd one at the end), each window
// summed in order from its first term, and the window sums the same way.
// The block's threads sum a window each, through buf (two halves of
// ``half`` >= ceil(n / 32) + 1 floats); the result is thread 0's.
template <class F>
__device__ float xla_tree_sum(int n, F x, float* buf, int half) {
  float* cur = nullptr;
  for (int level = 0; n > kWindow; ++level) {
    const int padded = (n + kWindow - 1) / kWindow * kWindow;
    const int lo = (padded - n) / 2, nw = padded / kWindow;
    float* nxt = buf + (level & 1) * half;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      const int j0 = max(w * kWindow - lo, 0), j1 = min(w * kWindow + kWindow - lo, n);
      float a = cur ? cur[j0] : x(j0);
      for (int j = j0 + 1; j < j1; ++j) a = add_x86(a, cur ? cur[j] : x(j));
      nxt[w] = a;
    }
    __syncthreads();
    cur = nxt;
    n = nw;
  }
  float a = 0.f;
  if (threadIdx.x == 0 && n > 0) {
    a = cur ? cur[0] : x(0);
    for (int j = 1; j < n; ++j) a = add_x86(a, cur ? cur[j] : x(j));
  }
  return a;
}

struct BeginArgs {
  const int* ring_count; const int* pool_count;
  const float* raw; const float* raw_pool;   // conformal_scale's quantiles
  const uint8_t* deploy;   // (S, M)
  const float* mean; const float* var;       // (S, R)
  const int* mon_count;    // (S, M)
  const float* c_mean; const float* c_sigma; const float* c_scale; const float* c_peak;
  const int* c_left; const int* c_due; const float* scale_sum; const int* scale_n;
  float* o_scale; float* o_mean; float* o_sigma; float* o_cscale; float* o_peak;
  int* o_left; int* o_due; float* o_scale_sum; int* o_scale_n;
  int R, cap, pcap, min_scores, pool_on, horizon;
  float k2;
  // the per-tenant tier (null tier.slot_gid without it): the group rings'
  // counts (S, T) and quantiles (S, T), the rows' groups (S, R) and their
  // output
  Tier tier;
  const int* group_count; const float* raw_group; const int* c_group; int* o_group;
  int gcap;
};

// one block per member: the fallback hierarchy and calib_begin of each
// row, the deployed scales staged in shared memory, then their sum in
// XLA's tree
__global__ void __launch_bounds__(kThreads) calib_begin_kernel(const BeginArgs p) {
  extern __shared__ float x[];           // [R], then the tree's two halves
  __shared__ int deployed;
  const int g = blockIdx.x, R = p.R, M = R / 2;
  if (threadIdx.x == 0) deployed = 0;
  float fb = p.k2;
  if (p.pool_on && min(p.pool_count[g], p.pcap) >= p.min_scores) fb = p.raw_pool[g];
  int n_dep = 0;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const size_t i = static_cast<size_t>(g) * R + r;
    float fb_row = fb;
    int grp = -1;
    if (p.tier.slot_gid) {
      grp = row_group(p.tier, g, r, M);
      const size_t gi = static_cast<size_t>(g) * p.tier.T + grp;
      if (grp >= 0 && min(p.group_count[gi], p.gcap) >= p.min_scores)
        fb_row = p.group_count[gi] == 0 ? fb : p.raw_group[gi];
    }
    const float scale = min(p.ring_count[i], p.cap) < p.min_scores ? fb_row : p.raw[i];
    p.o_scale[i] = scale;
    const size_t mi = static_cast<size_t>(g) * M + (r < M ? r : r - M);
    const bool dep = p.deploy[mi] != 0;
    x[r] = dep ? scale : 0.f;
    n_dep += dep;
    const int left = p.c_left[i];
    const bool m = dep && left == 0;
    p.o_mean[i] = m ? p.mean[i] : p.c_mean[i];
    p.o_sigma[i] = m ? __fsqrt_rn(max_nan(p.var[i], 0.f)) : p.c_sigma[i];
    p.o_cscale[i] = m ? scale : p.c_scale[i];
    p.o_peak[i] = m ? -INFINITY : p.c_peak[i];
    p.o_left[i] = m ? p.horizon : left;
    p.o_due[i] = m ? p.mon_count[mi] + p.horizon : p.c_due[i];
    if (p.tier.slot_gid) p.o_group[i] = m ? grp : p.c_group[i];
  }
  n_dep = __reduce_add_sync(0xffffffffu, n_dep);
  __syncthreads();                         // deployed zeroed, x staged
  if ((threadIdx.x & 31) == 0) atomicAdd(&deployed, n_dep);
  const int half = (R + kWindow - 1) / kWindow + 1;
  const float sum = xla_tree_sum(R, [&](int j) { return x[j]; }, x + R, half);
  __syncthreads();
  if (threadIdx.x == 0) {
    p.o_scale_sum[g] = add_x86(p.scale_sum[g], sum);
    p.o_scale_n[g] = p.scale_n[g] + deployed;
  }
}

}  // namespace

// The state as CalibState holds it, S members of R series rows: ring
// (S, R, cap) f32, ring_count (S, R) i32, pool (S, pcap) f32, pool_count
// (S,) i32, mean sigma scale peak (S, R) f32, left due (S, R) i32, q (S,)
// f32, resolved errors dropped (S,) i32; usage (S, R/2, 2) f32,
// mon_count (S, R/2) i32, active (S,) bool.  Outputs: new ring,
// ring_count, pool, pool_count, peak, left, q, resolved, errors,
// dropped of the same shapes.  R even.  The per-tenant tier, G groups of
// gcap (G = 0 and null pointers without it, G <= 127): group_ring (S, G,
// gcap) f32, group_count (S, G) i32, group (S, R) i32, group_resolved
// group_errors (S, G) i32, into the new ring, counts, resolved and
// errors, and the tick's resolved and missed scores d_res d_err (S, G).
extern "C" int calib_observe(
    const void* ring, const void* ring_count, const void* pool, const void* pool_count,
    const void* mean, const void* sigma, const void* scale, const void* peak,
    const void* left, const void* due, const void* q, const void* resolved,
    const void* errors, const void* dropped, const void* usage, const void* mon_count,
    const void* active, const void* group_ring, const void* group_count, const void* group,
    const void* group_resolved, const void* group_errors, void* o_ring, void* o_ring_count,
    void* o_pool, void* o_pool_count, void* o_peak, void* o_left, void* o_q, void* o_resolved,
    void* o_errors, void* o_dropped, void* o_group_ring, void* o_group_count,
    void* o_group_resolved, void* o_group_errors, void* o_d_res, void* o_d_err, int S, int R,
    int cap, int pcap, int pool_on, int adaptive, int G, int gcap, float gamma, float budget,
    float q_min, float q_max, void* stream) {
  if (S <= 0 || R <= 0 || R % 2 || cap <= 0 || pcap <= 0 || G < 0 || G > 127 ||
      (G > 0 && (gcap <= 0 || !group_ring || !group_count || !group || !group_resolved ||
                 !group_errors || !o_group_ring || !o_group_count || !o_group_resolved ||
                 !o_group_errors || !o_d_res || !o_d_err)))
    return static_cast<int>(cudaErrorInvalidValue);
  ObserveArgs p{
      static_cast<const float*>(ring), static_cast<const int*>(ring_count),
      static_cast<const float*>(pool), static_cast<const int*>(pool_count),
      static_cast<const float*>(mean), static_cast<const float*>(sigma),
      static_cast<const float*>(scale), static_cast<const float*>(peak),
      static_cast<const int*>(left), static_cast<const int*>(due),
      static_cast<const float*>(q), static_cast<const int*>(resolved),
      static_cast<const int*>(errors), static_cast<const int*>(dropped),
      static_cast<const float*>(usage), static_cast<const int*>(mon_count),
      static_cast<const uint8_t*>(active),
      static_cast<float*>(o_ring), static_cast<int*>(o_ring_count),
      static_cast<float*>(o_pool), static_cast<int*>(o_pool_count),
      static_cast<float*>(o_peak), static_cast<int*>(o_left), static_cast<float*>(o_q),
      static_cast<int*>(o_resolved), static_cast<int*>(o_errors),
      static_cast<int*>(o_dropped), R, cap, pcap, pool_on, adaptive, gamma, budget,
      q_min, q_max,
      static_cast<const float*>(group_ring), static_cast<const int*>(group_count),
      static_cast<const int*>(group), static_cast<const int*>(group_resolved),
      static_cast<const int*>(group_errors), static_cast<float*>(o_group_ring),
      static_cast<int*>(o_group_count), static_cast<int*>(o_group_resolved),
      static_cast<int*>(o_group_errors), static_cast<int*>(o_d_res),
      static_cast<int*>(o_d_err), G, gcap};
  // score and ok [R]; with the tier also gsel [R] and the group counters
  const size_t smem =
      G ? (static_cast<size_t>(3 * R + 3) / 2 + 1 + static_cast<size_t>(G) * (3 + kWarps)) *
              sizeof(float)
        : static_cast<size_t>(R) * (sizeof(float) + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(1 + (R + kWarps - 1) / kWarps, S);
  calib_observe_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// scores (B, cap) f32 rings, counts (B,) i32, q and fallback (G,) f32
// with G dividing B, rolled 0 (circular rings) or 1 (rolled: the first
// cap - n cells read as +inf); out (B,) f32.
extern "C" int conformal_scale(const void* scores, const void* counts, int B, int cap,
                               const void* q, const void* fallback, int G, int rolled,
                               void* out, void* stream) {
  if (B < 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ScaleArgs p{};
  p.scores[0] = static_cast<const float*>(scores);
  p.counts[0] = static_cast<const int*>(counts);
  p.rows[0] = B;
  p.cap[0] = cap;
  p.q = static_cast<const float*>(q);
  p.fallback = static_cast<const float*>(fallback);
  p.groups = G;
  p.rolled = rolled;
  p.out[0] = static_cast<float*>(out);
  p.pool_on = 1;
  return scale_launch(p, stream);
}

// The engine's quantiles for S members, in one launch: of ring (S, R,
// cap) into raw (S, R), where a row holds min_scores scores, and of pool
// (S, pcap) into raw_pool (S,) where pool_on, each at its member's q
// (S,), k2 where a ring is empty; the other entries are left unwritten.
// The per-tenant tier (null group_ring without it): the group rings
// group_ring (S, T, gcap) with group_count (S, T) into raw_group (S, T)
// likewise; with a credit (S, T) (or null), each at its tenant's
// quantile, and each series row of a tenant's slot (slot_gid (S, A) of A
// slots of C components, tenant (S, N)) at its tenant's.
extern "C" int calib_quantiles(const void* ring, const void* ring_count, const void* pool,
                               const void* pool_count, const void* q, float k2, void* raw,
                               void* raw_pool, int S, int R, int cap, int pcap,
                               int min_scores, int pool_on, const void* group_ring,
                               const void* group_count, void* raw_group, const void* credit,
                               const void* slot_gid, const void* tenant, int T, int gcap,
                               int A, int C, int N, float spread, float q_min, float q_max,
                               void* stream) {
  if (S <= 0 || R <= 0 || cap <= 0 || pcap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (group_ring && (T <= 0 || gcap <= 0 || !group_count || !raw_group || !slot_gid ||
                     !tenant || A <= 0 || C <= 0 || A * C * 2 != R))
    return static_cast<int>(cudaErrorInvalidValue);
  ScaleArgs p{};
  p.scores[0] = static_cast<const float*>(ring);
  p.counts[0] = static_cast<const int*>(ring_count);
  p.rows[0] = S * R;
  p.cap[0] = cap;
  p.scores[1] = static_cast<const float*>(pool);
  p.counts[1] = static_cast<const int*>(pool_count);
  p.rows[1] = S;
  p.cap[1] = pcap;
  p.q = static_cast<const float*>(q);
  p.k2 = k2;
  p.groups = S;
  p.out[0] = static_cast<float*>(raw);
  p.out[1] = static_cast<float*>(raw_pool);
  p.min_scores = min_scores;
  p.pool_on = pool_on;
  if (group_ring) {
    p.scores[2] = static_cast<const float*>(group_ring);
    p.counts[2] = static_cast<const int*>(group_count);
    p.rows[2] = S * T;
    p.cap[2] = gcap;
    p.out[2] = static_cast<float*>(raw_group);
    p.tier = Tier{static_cast<const int*>(slot_gid), static_cast<const int*>(tenant), A, C, N, T};
    p.credit = static_cast<const float*>(credit);
    p.spread = spread;
    p.q_min = q_min;
    p.q_max = q_max;
  }
  return scale_launch(p, stream);
}

// The engine's step after calib_quantiles, S members of R rows: the
// hierarchy into scale (S, R) (a series' quantile once it holds
// min_scores, else its member's pool quantile where pool_on and the pool
// holds min_scores, else k2) and calib_begin: deploy (S, R/2) bool, mean
// var (S, R) f32, mon_count (S, R/2) i32, and the state's mean sigma
// scale peak (S, R) f32, left due (S, R) i32, scale_sum (S,) f32,
// scale_n (S,) i32, into the o_ arrays of the same shapes.  The
// per-tenant tier (null slot_gid without it): slot_gid (S, A) of A slots
// of C components, tenant (S, N), group_count and raw_group (S, T), the
// rows' groups c_group (S, R) i32 into o_group; a young row of a
// tenant's slot takes its tenant's quantile where the ring holds
// min_scores (of gcap) before the pool's.
extern "C" int calib_begin(
    const void* ring_count, const void* pool_count, const void* raw, const void* raw_pool,
    const void* deploy, const void* mean, const void* var, const void* mon_count,
    const void* c_mean, const void* c_sigma, const void* c_scale, const void* c_peak,
    const void* c_left, const void* c_due, const void* scale_sum, const void* scale_n,
    void* scale, void* o_mean, void* o_sigma, void* o_cscale, void* o_peak, void* o_left,
    void* o_due, void* o_scale_sum, void* o_scale_n, int S, int R, int cap, int pcap,
    int min_scores, int pool_on, int horizon, float k2, const void* slot_gid,
    const void* tenant, const void* group_count, const void* raw_group, const void* c_group,
    void* o_group, int A, int C, int N, int T, int gcap, void* stream) {
  if (S <= 0 || R <= 0 || R % 2 || cap <= 0 || pcap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slot_gid && (!tenant || !group_count || !raw_group || !c_group || !o_group || T <= 0 ||
                   gcap <= 0 || A <= 0 || C <= 0 || A * C * 2 != R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(R) + 2 * ((R + kWindow - 1) / kWindow + 1)) *
                      sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  BeginArgs p{
      static_cast<const int*>(ring_count), static_cast<const int*>(pool_count),
      static_cast<const float*>(raw), static_cast<const float*>(raw_pool),
      static_cast<const uint8_t*>(deploy), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const int*>(mon_count),
      static_cast<const float*>(c_mean), static_cast<const float*>(c_sigma),
      static_cast<const float*>(c_scale), static_cast<const float*>(c_peak),
      static_cast<const int*>(c_left), static_cast<const int*>(c_due),
      static_cast<const float*>(scale_sum), static_cast<const int*>(scale_n),
      static_cast<float*>(scale), static_cast<float*>(o_mean), static_cast<float*>(o_sigma),
      static_cast<float*>(o_cscale), static_cast<float*>(o_peak), static_cast<int*>(o_left),
      static_cast<int*>(o_due), static_cast<float*>(o_scale_sum),
      static_cast<int*>(o_scale_n), R, cap, pcap, min_scores, pool_on, horizon, k2,
      Tier{static_cast<const int*>(slot_gid), static_cast<const int*>(tenant), A, C, N, T},
      static_cast<const int*>(group_count), static_cast<const float*>(raw_group),
      static_cast<const int*>(c_group), static_cast<int*>(o_group), gcap};
  calib_begin_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
