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
// calib_observe: grid (8 + ceil(R / 32), S) of 1,024 threads (rounded up
// to a multiple of 8, a cluster of kClusterBlocks), S members of R = 2 * A
// * C series rows (3,072 at the default widths).  Blocks x >= 8 take 32
// rows each, a warp a row:
// age `left`, take the running max `peak`, and copy the row's ring into
// the output (the engine's state is functional: leap chooses between the
// old and the new), 16 bytes a lane, with the resolved score at count %
// capacity.  Blocks 0-7 of a row, a thread-block cluster, take the member:
// each thread a run of contiguous rows, whose outcomes it stages; then one
// exclusive scan of the counts packed in 16-bit fields of two 64-bit words
// (the resolved scores, and each group's with the tier): a warp's shuffle
// scan, one barrier, each warp's sum of the warps before it (a reduction
// a 32-bit half), and the cluster's barrier, after which each block adds
// the totals of the blocks before it, read through distributed shared
// memory.  That ranks every resolved score in row order, in the pool at
// pool_count + k (the last pool_capacity of them, so no two writes share a
// cell) and in its group's ring; block 0's thread 0 adds the counters and
// takes the adaptive step of q.  What bounds it: bytes, the ring (1.5 MB
// a member at capacity 128) copied by the row blocks; the member's pass
// over ~40 B a row, its scan and the cluster's barrier are its latency.
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
// deploy group's ring, the group's scores ranked in row order by the same
// scan (a pack of eight counters at a time: the pool's and seven groups',
// then eight groups'), the last group_capacity of them written
// (online.py:375-413), and counts each
// group's resolved and missed scores, which it also returns as the
// tick's deltas for the tenant credit; conformal_scale ranks the group
// rings too, each at its tenant's credit-modulated quantile
// clip(fma(spread, 1 - 2 * credit, q), q_min, q_max) (XLA contracts it),
// and a series row of a tenant's slot at its tenant's quantile;
// calib_begin falls back from a young series to its tenant's warm ring
// before the pool, and registers the tenant as the row's group.  A row's
// tenant is read from the slot table (slot_gid, then the trace's tenant
// column): conformal_scale where it is needed, calib_begin from a slot's
// tenant staged in shared memory.
//
// calib_begin: a cluster of 8 blocks of 1,024 threads a member after the
// quantiles, each block a run of XLA:CPU's 32-row windows: each row's
// scale (its series' quantile once warm, else its tenant's group ring's
// once warm, else the pool's once warm, else K2) and the predictions it
// registers, the deployed scales staged in shared memory by window, a
// thread a window summing its 32 terms from registers into block 0's
// shared memory, and block 0's first warp the levels above.  With the
// tier each slot's tenant and the group rings' counts and quantiles are
// staged in shared memory first, so no row reads a chain of global loads.
// It is a launch of its own because it needs the pool's quantile, which
// other blocks compute: a version that ran it in the quantiles' launch
// (the last block of each member, or of each window, found by atomic
// counters) measured 71.7 and 335.9 us a launch at 3,072 warm rows on an
// H100, against 15 for the quantiles.  What bounds it: bytes, ~60 B a row;
// its latency is a row's loads, the window sums' chains of adds and the
// cluster's barrier.
//
// Both member kernels take R <= kMaxRows and spread a member over a
// cluster of kClusterBlocks blocks (PERF.md: 8 measured fastest of 1, 2,
// 3, 4 and 8 for both).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "xla_fma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;             // calib_observe's and calib_begin's blocks
constexpr int kWarps = kThreads / 32;      // ring rows per block
// the largest R the two member kernels take: every count then fits the
// 16-bit fields calib_observe scans (R < 2^16), a thread takes at most 16
// rows (its bits in a word), and calib_begin's 512 windows one block
constexpr int kMaxRows = 16384;
constexpr int kClusterBlocks = 8;          // a member's blocks: a portable cluster
constexpr int kMaxGroups = 127;            // calib_observe's groups (a row's, an int8)
constexpr int kPackWords = 2;              // 64-bit words calib_observe scans together
constexpr int kFields = 4 * kPackWords;    // their 16-bit fields
constexpr int kMaxSmem = 200 * 1024;       // dynamic shared memory a member block takes
constexpr int kScaleThreads = 256;         // conformal_scale's blocks
constexpr int kScaleWarps = kScaleThreads / 32;   // rows a block on the warp path
constexpr int kWarpCap = 512;              // the largest ring a warp selects in
constexpr int kBlockCap = 32 * kScaleThreads;   // the largest ring a block selects in
constexpr int kWindow = 32;                // XLA:CPU's tree-reduction window

// min as XLA takes it: NaN when either is NaN; the max is xla::fmax
// (the first of two NaNs where its sign bit is set, else the second; +0
// above -0: ref.py:fmax)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a <= b || a != a) ? a : b;
}

// a op b with x86's NaN where the plain result r is a NaN (the plain
// version's numpy; xla::nan_x86), subnormals kept
__device__ __forceinline__ float add_x86(float a, float b) {
  const float r = __fadd_rn(a, b);
  return r == r ? r : xla::nan_x86(a, b);
}
__device__ __forceinline__ float sub_x86(float a, float b) {
  const float r = __fsub_rn(a, b);
  return r == r ? r : xla::nan_x86(a, b);
}
__device__ __forceinline__ float div_x86(float a, float b) {
  const float r = __fdiv_rn(a, b);
  return r == r ? r : xla::nan_x86(a, b);
}
__device__ __forceinline__ float sqrt_x86(float a) {
  const float r = __fsqrt_rn(a);
  return r == r ? r : xla::nan_x86(a, a);
}

// a thread-block cluster's barrier in halves: arrive (what this thread
// wrote or read of the blocks' shared memory before it done), then wait
// (every thread of the cluster arrived)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the arrival without a release: a thread whose writes others read after
// the barrier fences them itself (fence_cluster), so that the others'
// arrivals do not wait on anything
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// the per-tenant tier's view of the slot table: a series row's tenant
struct Tier {
  const int* slot_gid;   // (S, A), null without the tier
  const int* tenant;     // (S, N)
  int A, C, N, T;
};

// the tenant id of series row r (of R = 2M) of member s: its slot's
// app's as the trace holds it, -1 for an empty slot (or an app id out of
// range).  Where a tenant's quantile or group ring is read, an id of T or
// more reads tenant T - 1's (the reference's gathers clamp it), a
// negative one none (ref.py:row_groups).
__device__ __forceinline__ int row_group(const Tier& t, int s, int r, int M) {
  const int mr = r < M ? r : r - M;
  const int gid = t.slot_gid[static_cast<size_t>(s) * t.A + mr / t.C];
  return gid < 0 || gid >= t.N ? -1 : t.tenant[static_cast<size_t>(s) * t.N + gid];
}

// a tenant's target quantile from its credit (repro/control/credit.py:46,
// contracted as the reference's compiled tick does; 2 * credit is exact)
__device__ __forceinline__ float tenant_q(float q, float credit, float spread, float q_min,
                                          float q_max) {
  const float lin = __fsub_rn(1.f, __fmul_rn(2.f, credit));
  return min_nan(xla::fmax(xla::fma_f32(spread, lin, q), q_min), q_max);
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
  const int l = p.left[i], due = p.due[i], mon = p.mon_count[mi];
  const float pk = p.peak[i], use = p.usage[mi * 2 + (r < M ? 0 : 1)];
  const float mean = p.mean[i], sigma = p.sigma[i], scale = p.scale[i];
  // every load issued before the first use (left to itself the compiler
  // issues them as they are used, a round trip each)
  asm volatile("" ::"r"(l), "r"(due), "r"(mon), "f"(pk), "f"(use), "f"(mean), "f"(sigma),
               "f"(scale));
  Row o;
  const bool act = active && l > 0;
  o.peak = act ? xla::fmax(pk, use) : pk;
  o.left = l - (act ? 1 : 0);
  o.fire = act && o.left == 0;
  o.ok = o.fire && mon == due;
  o.score = div_x86(sub_x86(o.peak, mean), xla::fmax(sigma, 1e-6f));
  o.err = o.ok && o.peak > xla::fma_f32(scale, sigma, mean);
  return o;
}

// the sums over the warp's lanes (those where `mine`) of the 16-bit fields
// of w, a 32-bit half at a time (no field's sum reaches 2^16)
__device__ __forceinline__ unsigned long long warp_fields(unsigned long long w, bool mine) {
  const unsigned lo = __reduce_add_sync(0xffffffffu, mine ? static_cast<unsigned>(w) : 0u);
  const unsigned hi = __reduce_add_sync(0xffffffffu, mine ? static_cast<unsigned>(w >> 32) : 0u);
  return lo | static_cast<unsigned long long>(hi) << 32;
}

// field f (16 bits) of a pack of kPackWords words, and one added to it
__device__ __forceinline__ int field(const unsigned long long (&w)[kPackWords], int f) {
  const unsigned long long v = f < 4 ? w[0] : w[1];
  return static_cast<int>(v >> (16 * (f & 3)) & 0xffffu);
}
__device__ __forceinline__ void bump(unsigned long long (&w)[kPackWords], int f) {
  const unsigned long long one = 1ull << (16 * (f & 3));
  if (f < 4) w[0] += one; else w[1] += one;
}

// The member's work, by blocks 0 .. kClusterBlocks - 1 of its row of the
// grid, a cluster: thread t of block b takes the k contiguous rows
// from r0 + t k, stages their scores (and their groups) in shared memory,
// only for itself, and keeps which resolve and miss as bits.  Then, a
// pack of kFields counters at a time (field 0 the resolved scores, 1 + g
// group g's), one exclusive scan of the counts packed in 16-bit fields
// gives each thread the rank of its first resolved score in row order, for
// the pool and for each group, and the totals; the misses (field 0 the
// member's, 1 + g group g's) and the drops reduce beside it.  A warp with
// no count skips its shuffles.  The blocks add the totals of the blocks
// before theirs through distributed shared memory.  Each thread
// then writes its scores at pool_count + rank and group_count + rank, the
// last pcap and gcap of them, and block 0 the counters and q.
__device__ __forceinline__ void observe_member(const ObserveArgs& p, int s, bool active) {
  extern __shared__ float score[];                       // [k][kThreads]
  __shared__ unsigned long long s_warp[kWarps][kPackWords], s_werr[kWarps][kPackWords];
  // the block's totals (resolved, then misses) and drops; a cluster's sums
  // and the totals of the blocks before this one
  __shared__ unsigned long long s_tot[2][kPackWords], s_sum[2][kPackWords], s_base[kPackWords];
  __shared__ unsigned s_wdrop[kWarps], s_drop[2];
  __shared__ int s_gcount[kMaxGroups], s_gres[kMaxGroups], s_gerr[kMaxGroups];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nb = kClusterBlocks;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int rows = (p.R + nb - 1) / nb, r0 = b * rows, r1 = min(r0 + rows, p.R);
  const int k = (rows + kThreads - 1) / kThreads, rt = r0 + tid * k;
  int8_t* sel = reinterpret_cast<int8_t*>(score + k * kThreads);   // [k][kThreads]
  // what the writes and the counters read, loaded before the rows
  const int pool_count = p.pool_count[s];
  if (tid < p.G) {
    const size_t i = static_cast<size_t>(s) * p.G + tid;
    s_gcount[tid] = p.group_count[i];
    s_gres[tid] = p.group_resolved[i];
    s_gerr[tid] = p.group_errors[i];
  }
  int resolved = 0, errors = 0, dropped = 0;
  float q = 0.f;
  if (b == 0 && tid == 0) {
    resolved = p.resolved[s];
    errors = p.errors[s];
    dropped = p.dropped[s];
    q = p.q[s];
  }
  // the pool's and the group rings' copies, a cell a thread of the member's
  // blocks: loaded before the rows, stored after them
  const float* psrc = p.pool + static_cast<size_t>(s) * p.pcap;
  float* pdst = p.o_pool + static_cast<size_t>(s) * p.pcap;
  const size_t gring = static_cast<size_t>(s) * p.G * p.gcap;
  const int cell = b * kThreads + tid, cells = nb * kThreads;
  const float pool_cell = cell < p.pcap ? psrc[cell] : 0.f;
  const float group_cell = cell < p.G * p.gcap ? p.group_ring[gring + cell] : 0.f;
  // phase: staging
  unsigned okm = 0, errm = 0, n_drop = 0;    // bit j: row rt + j resolves, misses
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const int r = rt + j;
    if (r < r1) {
      const int g = p.G ? p.group[static_cast<size_t>(s) * p.R + r] : -1;
      const Row o = observe_row(p, s, r, active);
      score[j * kThreads + tid] = o.score;
      okm |= static_cast<unsigned>(o.ok) << j;
      errm |= static_cast<unsigned>(o.err) << j;
      n_drop += o.fire && !o.ok;
      if (p.G) sel[j * kThreads + tid] = o.ok && g >= 0 && g < p.G ? static_cast<int8_t>(g) : -1;
    }
  }
  if (cell < p.pcap) pdst[cell] = pool_cell;
  for (int c = cell + cells; c < p.pcap; c += cells) pdst[c] = psrc[c];
  if (cell < p.G * p.gcap) p.o_group_ring[gring + cell] = group_cell;
  for (int c = cell + cells; c < p.G * p.gcap; c += cells)
    p.o_group_ring[gring + c] = p.group_ring[gring + c];
  // phase: scan
  int n_ok = 0, n_err = 0;
  for (int f0 = 0; f0 < 1 + p.G; f0 += kFields) {
    unsigned long long P[kPackWords] = {}, E[kPackWords] = {};
    for (int j = 0; j < k; ++j) {
      if (!(okm >> j & 1u)) continue;
      const bool err = errm >> j & 1u;
      if (f0 == 0) {
        bump(P, 0);
        if (err) bump(E, 0);
      }
      const int g = p.G ? sel[j * kThreads + tid] : -1, f = 1 + g - f0;
      if (g >= 0 && f >= 0 && f < kFields) {
        bump(P, f);
        if (err) bump(E, f);
      }
    }
    // the warp's inclusive scan of its threads' counts, its misses and
    // drops (a warp with none of them skips it)
    const bool busy = __any_sync(0xffffffffu, (P[0] | P[1] | E[0] | E[1]) != 0 ||
                                                  (f0 == 0 && n_drop != 0));
    unsigned long long inc[kPackWords] = {P[0], P[1]};
    if (busy) {
#pragma unroll
      for (int w = 0; w < kPackWords; ++w) {
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned long long v = __shfl_up_sync(0xffffffffu, inc[w], d);
          if (lane >= d) inc[w] += v;
        }
      }
    }
    const unsigned long long e0 = busy ? warp_fields(E[0], true) : 0ull;
    const unsigned long long e1 = busy ? warp_fields(E[1], true) : 0ull;
    const unsigned drops = busy ? __reduce_add_sync(0xffffffffu, f0 == 0 ? n_drop : 0u) : 0u;
    if (lane == 31) {
      s_warp[warp][0] = inc[0];
      s_warp[warp][1] = inc[1];
    }
    if (lane == 0) {
      s_werr[warp][0] = e0;
      s_werr[warp][1] = e1;
      s_wdrop[warp] = drops;
    }
    __syncthreads();                       // the warps' words written
    // the warps before this one, and the block's totals: sums over the 32
    // warps' words, by the warps that need them
    unsigned long long before[kPackWords] = {}, tot[kPackWords] = {}, et[kPackWords] = {};
    unsigned drop = 0;
    if (busy || warp == 0) {
#pragma unroll
      for (int w = 0; w < kPackWords; ++w) {
        const unsigned long long x = s_warp[lane][w];
        before[w] = warp_fields(x, lane < warp);
        if (warp == 0) {
          tot[w] = warp_fields(x, true);
          et[w] = warp_fields(s_werr[lane][w], true);
        }
      }
      if (warp == 0) drop = __reduce_add_sync(0xffffffffu, s_wdrop[lane]);
    }
    // the cluster's: the blocks before this one, and all
    if (tid == 0) {
#pragma unroll
      for (int w = 0; w < kPackWords; ++w) {
        s_tot[0][w] = tot[w];
        s_tot[1][w] = et[w];
      }
      s_drop[0] = drop;
    }
    // what other blocks read or overwrite after the barrier: these totals,
    // and the copied cells, which take new scores from any block
    if (tid == 0 || (f0 == 0 && (cell < p.pcap || cell < p.G * p.gcap))) fence_cluster();
    cluster_arrive_relaxed();
    cluster_wait();                        // every block's totals written
    if (tid <= 2 * kPackWords) {           // a word each: resolved, misses, then drops
      unsigned long long v[nb];
#pragma unroll
      for (int c = 0; c < nb; ++c)
        v[c] = tid < 2 * kPackWords ? *cluster.map_shared_rank(&s_tot[0][0] + tid, c)
                                    : *cluster.map_shared_rank(&s_drop[0], c);
      unsigned long long below = 0, all = 0;
#pragma unroll
      for (int c = 0; c < nb; ++c) {
        all += v[c];
        if (c < b) below += v[c];
      }
      if (tid < kPackWords) s_base[tid] = below;
      if (tid < 2 * kPackWords) (&s_sum[0][0])[tid] = all;
      else s_drop[1] = static_cast<unsigned>(all);
    }
    cluster_arrive_relaxed();              // this block's reads of the others' totals done
    __syncthreads();                       // the sums written
#pragma unroll
    for (int w = 0; w < kPackWords; ++w) {
      before[w] += s_base[w];
      tot[w] = s_sum[0][w];
      et[w] = s_sum[1][w];
    }
    drop = s_drop[1];
    unsigned long long rank[kPackWords];
#pragma unroll
    for (int w = 0; w < kPackWords; ++w) rank[w] = inc[w] - P[w] + before[w];
    if (f0 == 0) {
      n_ok = field(tot, 0);
      n_err = field(et, 0);
      n_drop = drop;
    }
    // phase: writes
    for (int j = 0; j < k; ++j) {
      if (!(okm >> j & 1u)) continue;
      const float sc = score[j * kThreads + tid];
      if (f0 == 0) {
        const int kk = field(rank, 0);
        bump(rank, 0);
        if (p.pool_on && kk >= n_ok - p.pcap) pdst[(pool_count + kk) % p.pcap] = sc;
      }
      const int g = p.G ? sel[j * kThreads + tid] : -1, f = 1 + g - f0;
      if (g >= 0 && f >= 0 && f < kFields) {
        const int kk = field(rank, f);
        bump(rank, f);
        if (kk >= field(tot, f) - p.gcap)
          p.o_group_ring[gring + static_cast<size_t>(g) * p.gcap +
                         (s_gcount[g] + kk) % p.gcap] = sc;
      }
    }
    const int g = f0 + tid - 1;            // this pack's groups' counters
    if (b == 0 && tid < kFields && g >= 0 && g < p.G) {
      const int n = field(tot, tid), e = field(et, tid);
      const size_t i = static_cast<size_t>(s) * p.G + g;
      p.o_group_count[i] = s_gcount[g] + n;
      p.o_group_resolved[i] = s_gres[g] + n;
      p.o_group_errors[i] = s_gerr[g] + e;
      p.o_d_res[i] = n;
      p.o_d_err[i] = e;
    }
    cluster_wait();                        // every block's totals read by the others
    if (f0 + kFields < 1 + p.G) __syncthreads();   // this pack's shared words read
  }
  // phase: end
  if (b != 0 || tid != 0) return;
  p.o_pool_count[s] = pool_count + (p.pool_on ? n_ok : 0);
  p.o_resolved[s] = resolved + n_ok;
  p.o_errors[s] = errors + n_err;
  p.o_dropped[s] = dropped + static_cast<int>(n_drop);
  if (p.adaptive && n_ok > 0) {
    const float rate = __fdiv_rn(static_cast<float>(n_err), static_cast<float>(n_ok));
    q = min_nan(xla::fmax(xla::fma_f32(p.gamma, __fsub_rn(rate, p.budget), q), p.q_min),
                p.q_max);
  }
  p.o_q[s] = q;
}

__global__ void __launch_bounds__(kThreads) calib_observe_kernel(const ObserveArgs p) {
  const int s = blockIdx.y;
  const bool active = p.active[s] != 0;
  if (blockIdx.x < kClusterBlocks) {
    observe_member(p, s, active);
    return;
  }
  const int lane = threadIdx.x & 31;       // ring rows, a warp each
  const int r = (blockIdx.x - kClusterBlocks) * kWarps + (threadIdx.x >> 5);
  if (r >= p.R) return;
  const Row o = observe_row(p, s, r, active);
  const size_t i = static_cast<size_t>(s) * p.R + r;
  const int count = p.ring_count[i];
  if (lane == 0) {
    p.o_peak[i] = o.peak;
    p.o_left[i] = o.left;
    p.o_ring_count[i] = count + (o.ok ? 1 : 0);
  }
  const int pos = o.ok ? count % p.cap : -1;
  const float* src = p.ring + i * p.cap;
  float* dst = p.o_ring + i * p.cap;
  if (p.cap % 4) {
    for (int c = lane; c < p.cap; c += 32) dst[c] = c == pos ? o.score : src[c];
    return;
  }
  for (int c = lane; c < p.cap / 4; c += 32) {    // 16 bytes a lane
    float4 v = reinterpret_cast<const float4*>(src)[c];
    if (pos >= 0 && c == pos / 4) {
      const int e = pos % 4;
      v.x = e == 0 ? o.score : v.x;
      v.y = e == 1 ? o.score : v.y;
      v.z = e == 2 ? o.score : v.z;
      v.w = e == 3 ? o.score : v.w;
    }
    reinterpret_cast<float4*>(dst)[c] = v;
  }
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
  return g < 0 ? q : tenant_q(q, p.credit[static_cast<size_t>(m) * p.tier.T + min(g, p.tier.T - 1)],
                              p.spread, p.q_min, p.q_max);
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

// the 32 floats at w (16-byte aligned) in registers
__device__ __forceinline__ void load32(const float* w, float (&v)[kWindow]) {
#pragma unroll
  for (int j = 0; j < kWindow; j += 4) {
    const float4 q = reinterpret_cast<const float4*>(w)[j / 4];
    v[j] = q.x;
    v[j + 1] = q.y;
    v[j + 2] = q.z;
    v[j + 3] = q.w;
  }
}

// The 32 floats at w (16-byte aligned) summed in order from the first,
// each sum rounded (the plain version's numpy cumsum of a window, whose
// padding, here -0, it leaves out: -0 + x is x, -0 included): a chain of
// plain adds over registers.  Where it ends in a NaN, x86's NaN where the
// chain turned NaN (the NaN term quieted, or the default NaN of inf - inf;
// a window holds two terms or more, or one window sum, already quiet):
// found again over the 8 terms after the last of the chain's checkpoints
// that is not a NaN.
__device__ __forceinline__ float sum32(const float* w) {
  float v[kWindow], at[kWindow / 8];
  load32(w, v);
  float a = -0.f;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    a = __fadd_rn(a, v[j]);
    if (j % 8 == 7) at[j / 8] = a;
  }
  if (a == a) return a;
  const int seg = at[0] != at[0] ? 0 : at[1] != at[1] ? 1 : at[2] != at[2] ? 2 : 3;
  a = seg == 0 ? -0.f : seg == 1 ? at[0] : seg == 2 ? at[1] : at[2];
  for (int j = 8 * seg; j < 8 * seg + 8; ++j) {
    const float x = w[j], next = __fadd_rn(a, x);
    if (next != next) return x != x ? xla::quiet(x) : __uint_as_float(xla::kDefaultNaN);
    a = next;
  }
  return a;                                // not reached: the segment turns NaN
}

// XLA's windows are kept kSlots floats apart in shared memory: 16-byte
// aligned, and the float4 reads of the lanes of a warp, each a window, on
// distinct banks
constexpr int kSlots = kWindow + 4;

using xla::Windows;   // XLA:CPU's windows over n terms (ref.py:xla_sum)
// calib_begin sums R rows in at most three levels: windows of rows, of
// their sums, and the last sum of 32 or fewer
static_assert(kMaxRows / kWindow <= kWindow * kWindow, "more than three levels");

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

// Blocks 0 .. kClusterBlocks - 1 of row m of the grid, a cluster, take
// member m, each a run of whole windows of XLA's tree over its R rows.
// With the tier each block first stages each slot's tenant id (-1 for an
// empty slot, or an app id out of range; row_group) and the group rings'
// counts and quantiles in shared memory, so a row's group is one
// shared-memory read.  A thread a row: the hierarchy's scale
// and calib_begin's registration, and the deployed scale written to the
// block's windows, 32 slots each, the padding -0.  A thread a window then
// sums its slots into block 0's window sums, which hold the next level's
// padding too (through distributed shared memory); after the cluster's
// barrier block 0's first warp sums the windows of those sums and
// the last sum, and writes scale_sum and scale_n.
__global__ void __launch_bounds__(kThreads) calib_begin_kernel(const BeginArgs p) {
  extern __shared__ float4 smem4[];        // the block's windows [nwb][kSlots], then the tables
  // block 0's: the window sums, padded into windows of their own, and theirs
  __shared__ __align__(16) float s_wsum[(kMaxRows / kWindow / kWindow + 1) * kSlots];
  __shared__ __align__(16) float s_up[kWindow];
  __shared__ int s_wdep[kWarps], s_bdep[kClusterBlocks];
  float* xs = reinterpret_cast<float*>(smem4);
  const int m = blockIdx.y, R = p.R, M = R / 2, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int nb = kClusterBlocks;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const Windows win(R), up(win.count);     // the rows' windows; their sums'
  const int per = (win.count + nb - 1) / nb;
  const int w0 = min(b * per, win.count), w1 = min(w0 + per, win.count), nwb = w1 - w0;
  const int rb0 = max(w0 * kWindow - win.lo, 0), rb1 = min(w1 * kWindow - win.lo, R);
  cluster_arrive();                        // this block started (waited for below)
  const bool tier = p.tier.slot_gid != nullptr;
  const int A = p.tier.A, N = p.tier.N, T = p.tier.T;
  int* t_slot = reinterpret_cast<int*>(xs + kSlots * nwb);       // a slot's tenant [A]
  int* t_gcount = t_slot + A;                                   // [T]
  float* t_graw = reinterpret_cast<float*>(t_gcount + T);       // [T]
  // phase: begin staging
  if (tier) {
    for (int i = tid; i < A; i += kThreads) {
      const int gid = p.tier.slot_gid[static_cast<size_t>(m) * A + i];
      t_slot[i] = gid < 0 || gid >= N ? -1 : p.tier.tenant[static_cast<size_t>(m) * N + gid];
    }
    for (int i = tid; i < T; i += kThreads) {
      t_gcount[i] = p.group_count[static_cast<size_t>(m) * T + i];
      t_graw[i] = p.raw_group[static_cast<size_t>(m) * T + i];
    }
  }
  if (tid < kWindow) {                     // the padding: the first and last windows'
    if (w0 * kWindow + tid < win.lo) xs[tid] = -0.f;
    const int last = w1 * kWindow - kWindow + tid;
    if (nwb > 0 && last - win.lo >= R) xs[(nwb - 1) * kSlots + tid] = -0.f;
    if (b == 0) {                          // and of the window sums' windows
      const int k = up.count * kWindow - win.count;   // the cells past the sums
      if (tid < up.lo) s_wsum[tid] = -0.f;
      if (tid < k - up.lo) {
        const int c = up.lo + win.count + tid;
        s_wsum[c / kWindow * kSlots + c % kWindow] = -0.f;
      }
      if (tid >= up.count) s_up[tid] = -0.f;
    }
  }
  const int pool_count = p.pool_count[m];  // both loaded, then chosen
  const float raw_pool = p.raw_pool[m];
  const float fb = p.pool_on && min(pool_count, p.pcap) >= p.min_scores ? raw_pool : p.k2;
  float scale_sum = 0.f;                   // what block 0's last lane adds to
  int scale_n = 0;
  if (b == 0 && tid == 0) {
    scale_sum = p.scale_sum[m];
    scale_n = p.scale_n[m];
  }
  if (tier) __syncthreads();               // the tables staged
  int n_dep = 0;
  for (int r = rb0 + tid; r < rb1; r += kThreads) {
    const size_t i = static_cast<size_t>(m) * R + r;
    const int mr = r < M ? r : r - M;
    const size_t mi = static_cast<size_t>(m) * M + mr;
    // every input of the row in one round of loads, before any is used
    const int count = p.ring_count[i], left = p.c_left[i], mon = p.mon_count[mi];
    const int due = p.c_due[i], c_group = tier ? p.c_group[i] : -1;
    const bool dep = p.deploy[mi] != 0;
    const float raw = p.raw[i], mean = p.mean[i], var = p.var[i], c_mean = p.c_mean[i];
    const float c_sigma = p.c_sigma[i], c_scale = p.c_scale[i], c_peak = p.c_peak[i];
    float fb_row = fb;
    int grp = -1;
    if (tier) {
      grp = t_slot[mr / p.tier.C];
      if (grp >= 0) {
        const int g = min(grp, T - 1), gc = t_gcount[g];
        if (min(gc, p.gcap) >= p.min_scores) fb_row = gc == 0 ? fb : t_graw[g];
      }
    }
    const float scale = min(count, p.cap) < p.min_scores ? fb_row : raw;
    p.o_scale[i] = scale;
    const int t = r + win.lo - w0 * kWindow;   // its slot among the block's windows
    xs[t / kWindow * kSlots + t % kWindow] = dep ? scale : 0.f;
    n_dep += dep;
    const bool reg = dep && left == 0;
    p.o_mean[i] = reg ? mean : c_mean;
    p.o_sigma[i] = reg ? sqrt_x86(xla::fmax(var, 0.f)) : c_sigma;
    p.o_cscale[i] = reg ? scale : c_scale;
    p.o_peak[i] = reg ? -INFINITY : c_peak;
    p.o_left[i] = reg ? p.horizon : left;
    p.o_due[i] = reg ? mon + p.horizon : due;
    if (tier) p.o_group[i] = reg ? grp : c_group;
  }
  n_dep = __reduce_add_sync(0xffffffffu, n_dep);
  if (lane == 0) s_wdep[warp] = n_dep;
  __syncthreads();                         // the terms staged
  // phase: tree
  cluster_wait();                          // block 0's, once every block started
  float* wsum = cluster.map_shared_rank(s_wsum, 0);
  int* bdep = cluster.map_shared_rank(s_bdep, 0);
  if (tid < nwb) {                         // a thread a window
    const int c = up.lo + w0 + tid;        // its sum's cell among the padded sums
    wsum[c / kWindow * kSlots + c % kWindow] = sum32(xs + tid * kSlots);
  }
  if (tid < kWarps) {
    const int d = __reduce_add_sync(0xffffffffu, s_wdep[tid]);
    if (tid == 0) bdep[b] = d;
  }
  cluster.sync();
  if (b != 0 || warp != 0) return;
  const float* last = s_wsum;              // block 0's first warp: the levels above
  if (win.count > kWindow) {
    if (lane < up.count) s_up[lane] = sum32(s_wsum + lane * kSlots);
    __syncwarp();
    last = s_up;
  }
  if (lane != 0) return;
  const float sum = sum32(last);
  for (int c = 0; c < nb; ++c) scale_n += s_bdep[c];
  p.o_scale_sum[m] = add_x86(sum, scale_sum);   // XLA's operand order (ref.py:_add_nan_x86)
  p.o_scale_n[m] = scale_n;
  // phase: begin end
}


// The member kernels' dynamic shared memory.  calib_observe: a thread's
// scores (and groups) [k][kThreads]; calib_begin: its windows' terms
// [kSlots] each and the tier's tables, A + 2T words (A <= kMaxRows / 2,
// T <= kMaxGroups).  At most 10 KB and 42 KB.
size_t observe_smem(int R, int G) {
  const int rows = (R + kClusterBlocks - 1) / kClusterBlocks;
  const int k = (rows + kThreads - 1) / kThreads;
  return static_cast<size_t>(k) * kThreads * (sizeof(float) + (G ? 1 : 0));
}
size_t begin_smem(int R, size_t table) {
  const int per = (Windows(R).count + kClusterBlocks - 1) / kClusterBlocks;
  return (static_cast<size_t>(kSlots) * per + table) * sizeof(float);
}

// a member kernel's launch: a cluster of kClusterBlocks blocks a member
template <class Args>
int launch_member(void (*kernel)(Args), dim3 grid, size_t smem, void* stream, const Args& p) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kClusterBlocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// One-time set-up on the current device: the member kernels' shared
// memory above 48 KB.
extern "C" int calib_init() {
  const cudaError_t e = cudaFuncSetAttribute(
      calib_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaFuncSetAttribute(
      calib_begin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

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
  if (S <= 0 || R <= 0 || R % 2 || R > kMaxRows || cap <= 0 || pcap <= 0 || G < 0 ||
      G > kMaxGroups ||
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
  constexpr int nb = kClusterBlocks;
  const int blocks = nb + (R + kWarps - 1) / kWarps;
  const dim3 grid((blocks + nb - 1) / nb * nb, S);
  return launch_member(calib_observe_kernel, grid, observe_smem(R, G), stream, p);
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
  if (S <= 0 || R <= 0 || R % 2 || R > kMaxRows || cap <= 0 || pcap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slot_gid && (!tenant || !group_count || !raw_group || !c_group || !o_group || T <= 0 ||
                   T > kMaxGroups || gcap <= 0 || A <= 0 || C <= 0 || A * C * 2 != R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t table = slot_gid ? static_cast<size_t>(A) + 2 * static_cast<size_t>(T) : 0;
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
  return launch_member(calib_begin_kernel, dim3(kClusterBlocks, S), begin_smem(R, table),
                       stream, p);
}
