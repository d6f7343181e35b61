// The scheduler's three event loops of the device engine's tick, one
// launch each for every member of a batch:
//
//   resolve_oom            the OS OOM handler   repro/sim/step.py:472
//   admit_queued           FIFO admission       repro/sim/step.py:554
//   place_missing_elastic  elastic re-placement repro/sim/step.py:670
//
// They replace lax.while_loops of the reference (XLA code, not Pallas
// kernels), whose trip counts are the number of events.  On the card a
// loop whose condition the host reads would wait for the device every
// tick; here each loop runs on the device and returns at once when it
// has no event.  Their plain versions are the functions of the same
// names in repro_torch/kernels/ref.py.
//
// What bounds them: nothing the card is rated for.  Each event depends
// on the state the previous one left (a kill changes the host's total,
// an admission the free table), and a tick has a handful of events; per
// member a call reads and writes the slot table once (~A*C*30 bytes).
// They are latency-bound by construction.  All three run one block of
// kBlock threads per member, built the same way:
//
//   0. stage: the member's slot table and queue flags go to shared
//      memory with the whole block by cp.async, every load in flight at
//      once (block_copy.cuh); the request tables (N, C) stay in global
//      memory, read a row at a time where an event needs one;
//   1. the parts that do not depend on an event in parallel: the FIFO
//      head and the first empty slot by block-wide reductions, the
//      missing elastic components, the per-host sums at entry;
//   2. the events themselves, in the reference's order, reading and
//      updating shared memory only: a placement by one warp over the
//      hosts, the per-host sums again in parallel where the reference
//      recomputes them;
//   3. every output written once from shared memory, 16 bytes a thread
//      where the addresses allow.  The caller's tensors are never written.
//
// Arithmetic: sums and differences only, no a*b+c to contract.  Every
// sum over the flat rows is taken in the order XLA:CPU gives the
// reference's reductions (repro_torch/kernels/ref.py:xla_sum): above 32
// units, windows of 32 (the padding to a multiple of 32 split between
// the ends), each window summed in order, the window sums reduced the
// same way; 32 or fewer summed in order (struct Tree; block_host_sums
// takes every window of a level in parallel, each in order from 0).  The
// OOM loop's per-host total over (A, C) windows of whole slots, where
// LLVM vectorised the reference's kernel, sums each window in its lanes,
// their tree, then the window's tail in order (ref.py:xla_slot_plan).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "block_copy.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kBlock = 256;        // threads per member
constexpr int kWarps = kBlock / 32;
constexpr int kMaxSmem = 232448;   // the opt-in shared memory of a block on sm_90

constexpr int WIN = 32;        // XLA:CPU's tree-reduction window
constexpr int MAX_LEVELS = 4;  // running sums per total: up to 32^3 units

// The windows of a sum over n units: level l has n[l] items and lo[l]
// leading pads; its windows of 32 give level l+1's items.  The top level
// (index `levels`, at most 32 items) is one sum in order.
struct Tree {
  int levels;
  int n[MAX_LEVELS], lo[MAX_LEVELS];
};

__device__ Tree tree_of(int n) {
  Tree t{};
  while (n > WIN && t.levels < MAX_LEVELS - 1) {
    const int padded = (n + WIN - 1) / WIN * WIN;
    t.n[t.levels] = n;
    t.lo[t.levels] = (padded - n) / 2;
    ++t.levels;
    n = padded / WIN;
  }
  return t;
}

// units [u0, u1) of level-0 window j (the whole range when there is no
// window, 32 or fewer units)
__device__ void window(const Tree& t, int j, int n, int* u0, int* u1) {
  const int lo = t.levels ? t.lo[0] : 0;
  *u0 = t.levels ? max(j * WIN - lo, 0) : 0;
  *u1 = t.levels ? min((j + 1) * WIN - lo, n) : n;
}

__device__ int n_windows(const Tree& t, int n) {
  return t.levels ? (n + WIN - 1) / WIN : 1;
}

// level-0 window j has closed: add its sum (acc[0..V)) to level 1 as item
// j, and carry every window that this closes upward; acc holds V values
// per level
template <int V>
__device__ void tree_push(float* acc, const Tree& t, int j) {
  for (int l = 0; l < t.levels; ++l) {
    for (int v = 0; v < V; ++v) {
      acc[(l + 1) * V + v] += acc[l * V + v];
      acc[l * V + v] = 0.f;
    }
    if (l + 1 == t.levels) break;              // the top level: one sum in order
    if ((j + t.lo[l + 1]) % WIN != WIN - 1 && j != t.n[l + 1] - 1) break;
    j = (j + t.lo[l + 1]) / WIN;
  }
}

__host__ __device__ inline size_t padded_rows(size_t n) { return n + n / 32 + 1; }

__device__ __forceinline__ int prow(int e) { return e + (e >> 5); }

// the level-0 windows of a sum over AC flat rows
__host__ __device__ inline int row_windows(int AC) {
  return AC > WIN ? (AC + WIN - 1) / WIN : 1;
}

// a level-0 window's row of per-host sums: H * V floats, odd for V > 1 so
// that the threads of different windows write different banks
template <int V>
__host__ __device__ inline size_t part_stride(int H) {
  return size_t(H) * V + (V > 1);
}

// block_host_sums<V>'s table of level-0 window sums, in bytes
template <int V>
__host__ __device__ inline size_t part_bytes(int AC, int H) {
  return size_t(row_windows(AC)) * part_stride<V>(H) * 4;
}

// the shared memory of block_host_sums<V>'s two tables, in bytes
template <int V>
__host__ __device__ inline size_t sums_smem(int AC, int H) {
  using blk::Carve;
  const size_t nw = row_windows(AC);
  return Carve::bytes(part_bytes<V>(AC, H)) +
         Carve::bytes((nw + WIN - 1) / WIN * size_t(H) * V * 4);
}

// The per-host totals of V values over the AC flat rows, in XLA:CPU's
// order, by the whole block.  Row e runs on host live_host[prow(e)]
// (-1: on none) with values val[v * padded_rows(AC) + prow(e)]; padding
// one word per 32 rows puts the rows that the threads of step 1 read
// together, one window of 32 apart, in different banks.
//   1. one thread per (level-0 window, value) sums its window's rows
//      into its own row of `part` (windows x part_stride), in flat order
//      from 0;
//   2. each upper level likewise, one thread per (window, host, value)
//      into `level`;
//   3. the top level one thread per host, which calls top(h, tot) with
//      the host's V totals.
// `part` is zero on entry: the caller zeroes it (part_bytes) and syncs
// before the call, which lets a kernel zero it while its staging loads
// are in flight.  Barriers inside; the caller syncs before it reads what
// top wrote.
template <int V, class Top>
__device__ void block_host_sums(const int* live_host, const float* val, int AC, int H,
                                float* part, float* level, Top top) {
  const int tid = threadIdx.x, nw = row_windows(AC);
  const int pr = int(padded_rows(AC)), ps = int(part_stride<V>(H)), HV = H * V;
  const Tree t = tree_of(AC);
  for (int i = tid; i < nw * V; i += kBlock) {
    const int j = i / V, v = i % V;
    int e0, e1;
    window(t, j, AC, &e0, &e1);
    float* row = part + j * ps + v;
    const float* x = val + v * pr;
    for (int e = e0; e < e1; ++e) {
      const int h = live_host[prow(e)];
      if (h >= 0) row[h * V] += x[prow(e)];
    }
  }
  __syncthreads();
  float* items = part;   // the current level's items, `stride` apart
  int stride = ps;
  float* out = level;
  int n = nw;
  for (int l = 1; l < t.levels; ++l) {
    const int lo = t.lo[l], n_next = (n + WIN - 1) / WIN;
    for (int i = tid; i < n_next * HV; i += kBlock) {
      const int w = i / HV, k = i % HV;
      float acc = 0.f;
      for (int u = max(w * WIN - lo, 0), u1 = min((w + 1) * WIN - lo, n); u < u1; ++u)
        acc += items[u * stride + k];
      out[i] = acc;
    }
    __syncthreads();
    // the next level goes where this one's items were
    float* done = items;
    items = out;
    out = done;
    stride = HV;
    n = n_next;
  }
  for (int h = tid; h < H; h += kBlock) {
    float tot[V];
    for (int v = 0; v < V; ++v) {
      float acc = 0.f;
      for (int u = 0; u < n; ++u) acc += items[u * stride + h * V + v];
      tot[v] = acc;
    }
    top(h, tot);
  }
}

// worst fit by one warp: the host with the most free memory among those
// where (cpu, mem) fits, the lowest index on ties; -1 when none fits.
// Every lane returns the same host.
__device__ int worst_fit(const float* fr, int H, float cpu, float mem) {
  const int lane = threadIdx.x & 31;
  float best = 0.f;
  int bi = -1;
  for (int h = lane; h < H; h += 32)
    if (fr[2 * h] >= cpu && fr[2 * h + 1] >= mem && (bi < 0 || fr[2 * h + 1] > best)) {
      best = fr[2 * h + 1];
      bi = h;
    }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (oi >= 0 && (bi < 0 || ob > best || (ob == best && oi < bi))) {
      best = ob;
      bi = oi;
    }
  }
  return bi;
}

// take `mem`/`cpu` off host h's free entry (one lane writes); the warp
// syncs before the next worst_fit reads the table
__device__ void take(float* fr, int h, float cpu, float mem) {
  if ((threadIdx.x & 31) == (h & 31)) {
    fr[2 * h] -= cpu;
    fr[2 * h + 1] -= mem;
  }
  __syncwarp();
}

// the running rows' hosts (-1 where a row does not run or its host is
// out of range) and allocations into block_host_sums' padded layout
__device__ void fill_alloc_rows(const uint8_t* run, const int* host, const float* alloc,
                                int AC, int H, int* live_host, float* val) {
  const size_t pr = padded_rows(AC);
  for (int e = threadIdx.x; e < AC; e += kBlock) {
    const int h = host[e];
    live_host[prow(e)] = run[e] && h >= 0 && h < H ? h : -1;
    val[prow(e)] = alloc[2 * e];
    val[pr + prow(e)] = alloc[2 * e + 1];
  }
}

// fr[h] = cap[h] - the allocations of the running rows on h
// (repro/sim/step.py:_free_resources), by the whole block; `part` zero
// on entry, as block_host_sums takes it
__device__ void free_table(const int* live_host, const float* val, const float* cap,
                           int AC, int H, float* part, float* level, float* fr) {
  block_host_sums<2>(live_host, val, AC, H, part, level, [&](int h, const float* tot) {
    fr[2 * h] = cap[2 * h] - tot[0];
    fr[2 * h + 1] = cap[2 * h + 1] - tot[1];
  });
  __syncthreads();
}

// The OS OOM handler, one block of kBlock threads per member:
//
//   0. stage: the member's slot table (slot, work, run, host, alloc,
//      usage) and queue flags (failed, queued); then per flat row its
//      host if running (else -1) and its memory usage, in
//      block_host_sums' padded layout;
//   1. per-host memory at entry, in XLA:CPU's order, in parallel
//      (block_host_sums);
//   2. only when a host is over its memory, the victim loop: one warp,
//      hosts in order, each total over windows of whole slots and the
//      victim (the largest overage, the largest flat index on ties) read
//      from shared memory, each kill written there;
//   3. write every output once.
__host__ __device__ inline size_t oom_smem(int A, int C, int N, int H) {
  using blk::Carve;
  const size_t AC = size_t(A) * C;
  return 2 * Carve::bytes(size_t(A) * 4) + 2 * Carve::bytes(AC) +      // slot, work, run, monreset
         Carve::bytes(AC * 4) + 2 * Carve::bytes(AC * 8) +             // host, alloc, usage
         2 * Carve::bytes(N) +                                          // failed, queued
         2 * Carve::bytes(padded_rows(AC) * 4) +                        // live host, memory
         sums_smem<1>(int(AC), H) + Carve::bytes(size_t(H) * 4);        // sums, over
}

// The lanes of a window that XLA:CPU's kernel sums vectorised
// (ref.py:xla_slot_plan), on warp 0: lane l of the first vf adds slots l,
// l + vf, ... below nv of the window from slot a0, each slot's components
// in order, from 0 (l = 0) or -0; then the lanes' tree.  Every lane gets
// the tree's sum.  Kept out of line, and the windows' loop instantiated
// apart for serial windows (resolve_oom_kernel's scan), so that a serial
// sum keeps its registers.
__device__ __noinline__ float lane_total(const int* live_host, const float* mem, int h,
                                         int a0, int nv, int C, int vf, int lane) {
  float ls = lane == 0 ? 0.f : -0.f;
  if (lane < vf) {
    for (int k = lane; k < nv; k += vf) {
      for (int c = 0; c < C; ++c) {
        const int e = (a0 + k) * C + c;
        ls += live_host[prow(e)] == h ? mem[prow(e)] : 0.f;
      }
    }
  }
  for (int o = vf / 2; o > 0; o >>= 1) {
    const float other = __shfl_down_sync(FULL, ls, o);
    if (lane < o) ls += other;
  }
  return __shfl_sync(FULL, ls, 0);
}

__global__ void __launch_bounds__(kBlock) resolve_oom_kernel(
    const int* __restrict__ slot_in, const float* __restrict__ work_in,
    const uint8_t* __restrict__ run_in, const int* __restrict__ host_all,
    const float* __restrict__ alloc_in, const float* __restrict__ usage_in,
    const uint8_t* __restrict__ failed_in, const uint8_t* __restrict__ queued_in,
    const int* __restrict__ oom_in, const int* __restrict__ fail_in,
    const int* __restrict__ part_in, const uint8_t* __restrict__ is_core_all,
    const float* __restrict__ cap, int* __restrict__ slot_all,
    float* __restrict__ work_all, uint8_t* __restrict__ run_all,
    float* __restrict__ alloc_all, float* __restrict__ usage_all,
    uint8_t* __restrict__ failed_all, uint8_t* __restrict__ queued_all,
    int* __restrict__ oom, int* __restrict__ fail, int* __restrict__ part,
    uint8_t* __restrict__ monreset_all, int A, int C, int N, int H, int vf, int tail,
    long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, AC = A * C;
  const size_t sa = size_t(s) * A, se = size_t(s) * AC, sn = size_t(s) * N;
  const int nw = row_windows(AC);
  const long long t0 = clock64();

  // ---- 0. stage ----
  blk::Carve sm{smem};
  int* slot = sm.take<int>(size_t(A) * 4, slot_in + sa);
  float* work = sm.take<float>(size_t(A) * 4, work_in + sa);
  uint8_t* run = sm.take<uint8_t>(AC, run_in + se);
  int* host = sm.take<int>(size_t(AC) * 4, host_all + se);
  float* alloc = sm.take<float>(size_t(AC) * 8, alloc_in + 2 * se);
  float* usage = sm.take<float>(size_t(AC) * 8, usage_in + 2 * se);
  uint8_t* failed = sm.take<uint8_t>(N, failed_in + sn);
  uint8_t* queued = sm.take<uint8_t>(N, queued_in + sn);
  uint8_t* monreset = sm.take<uint8_t>(AC, monreset_all + se);
  int* live_host = sm.take<int>(padded_rows(AC) * 4);
  float* mem = sm.take<float>(padded_rows(AC) * 4);
  float* part_sum = sm.take<float>(part_bytes<1>(AC, H));   // (window, host)
  float* level = sm.take<float>(size_t(nw + WIN - 1) / WIN * H * 4);
  int* over = sm.take<int>(size_t(H) * 4);
  blk::stage(slot, slot_in + sa, size_t(A) * 4);
  blk::stage(work, work_in + sa, size_t(A) * 4);
  blk::stage(run, run_in + se, AC);
  blk::stage(host, host_all + se, size_t(AC) * 4);
  blk::stage(alloc, alloc_in + 2 * se, size_t(AC) * 8);
  blk::stage(usage, usage_in + 2 * se, size_t(AC) * 8);
  blk::stage(failed, failed_in + sn, N);
  blk::stage(queued, queued_in + sn, N);
  blk::zero(monreset, AC);
  blk::zero(part_sum, part_bytes<1>(AC, H));
  blk::stage_wait();
  __syncthreads();
  for (int e = tid; e < AC; e += kBlock) {
    const int h = host[e];
    live_host[prow(e)] = run[e] && h >= 0 && h < H ? h : -1;
    mem[prow(e)] = usage[2 * e + 1];
  }
  __syncthreads();
  const long long t1 = clock64();

  // ---- 1. the running components' memory usage per host at entry ----
  bool any = false;
  block_host_sums<1>(live_host, mem, AC, H, part_sum, level, [&](int h, const float* tot) {
    over[h] = tot[0] > __fadd_rn(cap[2 * h + 1], 1e-6f);
    any |= over[h];
  });
  any = __syncthreads_or(any);
  const long long t2 = clock64();

  // ---- 2. the victim loop, on warp 0 ----
  int n_full = 0, n_part = 0;
  if (any && tid < 32) {
    const Tree ts = tree_of(A);
    for (int h = 0; h < H; ++h) {
      if (!over[h]) continue;
      const float lim = __fadd_rn(cap[2 * h + 1], 1e-6f);
      for (;;) {
        // the host's total (a sum over (A, C): windows of whole slots, each
        // in the lanes of XLA:CPU's kernel, then its tail in order; see
        // ref.py:xla_slot_plan) and the victim: the largest usage - alloc
        // overage, the largest flat index on ties
        float acc[MAX_LEVELS] = {};
        float bv = 0.f;
        int bi = -1;
        bool on_any = false;
        for (int j = 0, nws = n_windows(ts, A); j < nws; ++j) {
          int a0, a1;
          window(ts, j, A, &a0, &a1);
          const int nv = vf ? (a1 - a0 - tail) / vf * vf : 0;
          // the window's elements: the victim over every one, the total
          // over those past the lanes, in order (a serial window: all)
          auto scan = [&](auto lanes) {
            constexpr bool kLanes = decltype(lanes)::value;
            if constexpr (kLanes) acc[0] += lane_total(live_host, mem, h, a0, nv, C, vf, lane);
            const int tail0 = (a0 + nv) * C;
            for (int base = a0 * C; base < a1 * C; base += 32) {
              const int e = base + lane;
              const bool on = e < a1 * C && live_host[prow(e)] == h;
              const float u = on ? mem[prow(e)] : 0.f;
              const unsigned mask = __ballot_sync(FULL, on);
              on_any |= mask != 0;
              unsigned serial = mask;
              if constexpr (kLanes) serial = __ballot_sync(FULL, on && e >= tail0);
              for (unsigned m = serial; m; m &= m - 1) acc[0] += __shfl_sync(FULL, u, __ffs(m) - 1);
              if (on) {
                const float ov = u - alloc[2 * e + 1];
                if (bi < 0 || ov >= bv) {
                  bv = ov;
                  bi = e;
                }
              }
            }
          };
          if (nv > 0)
            scan(std::true_type{});
          else
            scan(std::false_type{});
          if (ts.levels) tree_push<1>(acc, ts, j);
        }
        const float tot = acc[ts.levels];
        if (!(on_any && tot > lim)) break;
        for (int o = 16; o > 0; o >>= 1) {
          const float ob = __shfl_xor_sync(FULL, bv, o);
          const int oi = __shfl_xor_sync(FULL, bi, o);
          if (oi >= 0 && (bi < 0 || ob > bv || (ob == bv && oi > bi))) {
            bv = ob;
            bi = oi;
          }
        }
        const int a = bi / C, c = bi % C;
        const int g = slot[a];
        if (is_core_all[(sn + g) * C + c]) {        // a core victim fails its app
          for (int cc = lane; cc < C; cc += 32) {
            const int e = a * C + cc;
            live_host[prow(e)] = -1;
            mem[prow(e)] = 0.f;
            usage[2 * e] = usage[2 * e + 1] = 0.f;
            alloc[2 * e] = alloc[2 * e + 1] = 0.f;
            run[e] = 0;
          }
          __syncwarp();                             // every lane has read slot[a]
          if (lane == 0) {
            slot[a] = -1;
            work[a] = 0.f;
            failed[g] = queued[g] = 1;
          }
          ++n_full;
        } else {                                    // an elastic victim alone
          if (lane == 0) {
            live_host[prow(bi)] = -1;
            mem[prow(bi)] = 0.f;
            usage[2 * bi] = usage[2 * bi + 1] = 0.f;
            alloc[2 * bi] = alloc[2 * bi + 1] = 0.f;
            run[bi] = 0;
            monreset[bi] = 1;
          }
          ++n_part;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  const long long t3 = clock64();

  // ---- 3. write ----
  blk::copy(slot_all + sa, slot, size_t(A) * 4);
  blk::copy(work_all + sa, work, size_t(A) * 4);
  blk::copy(run_all + se, run, AC);
  blk::copy(alloc_all + 2 * se, alloc, size_t(AC) * 8);
  blk::copy(usage_all + 2 * se, usage, size_t(AC) * 8);
  blk::copy(failed_all + sn, failed, N);
  blk::copy(queued_all + sn, queued, N);
  blk::copy(monreset_all + se, monreset, AC);
  if (tid == 0) {
    oom[s] = oom_in[s] + n_full;
    fail[s] = fail_in[s] + n_full;
    part[s] = part_in[s] + n_part;
  }
  if (clocks) {
    __syncthreads();
    if (tid == 0) {
      long long* out = clocks + 4 * size_t(s);
      out[0] = t1 - t0;           // stage
      out[1] = t2 - t1;           // per-host sums at entry
      out[2] = t3 - t2;           // victim loop
      out[3] = clock64() - t3;    // write
    }
  }
}

// FIFO admission (repro/sim/step.py:554), one block of kBlock threads per
// member:
//
//   0. stage the slot table (slot, work, run, host, alloc, alive), the
//      queue flags (queued, has_saved) and the FIFO keys (submit, gid);
//      zero resets;
//   1. the FIFO head (least submit, then least gid, then least row) and
//      the first empty slot, by one block-wide reduction; no head or no
//      empty slot ends the loop (the common tick: nothing else runs);
//   2. the free table in XLA:CPU's order in parallel (block_host_sums),
//      recomputed for every head as the reference's try_place does
//      (subtracting the last placement instead would round differently);
//   3. worst-fit placement by warp 0, core components then elastic ones,
//      the head's C requests read once from global memory into the lanes;
//      a core component that does not fit stops FIFO; otherwise the
//      admission is committed into shared memory, then back to 1;
//   4. write every output once.
// With the control plane's gate (tenant, elig and admitted not null) the
// heads are taken among the apps whose tenant elig marks (each app's
// tenant, clipped to [0, T), and its flag read from global memory in the
// head search), and
// each admission adds one to its tenant's admitted count (copied to the
// output at entry, then counted there by the committing lane:
// repro/sim/step.py:614, :872-876).  The gate is a template parameter:
// without it (null pointers) the launch is an instance that compiles none
// of it, the kernel as it was before the gate.
// clock64 stamps per phase are summed over the loop's rounds.
struct Head {
  float submit;
  int gid, row;
};

// a before b in FIFO order; row < 0 is no head
__device__ __forceinline__ bool before(const Head& a, const Head& b) {
  if (a.row < 0) return false;
  if (b.row < 0) return true;
  return a.submit < b.submit ||
         (a.submit == b.submit && (a.gid < b.gid || (a.gid == b.gid && a.row < b.row)));
}

__host__ __device__ inline size_t admit_smem(int A, int C, int N, int H) {
  using blk::Carve;
  const size_t AC = size_t(A) * C;
  return 2 * Carve::bytes(size_t(A) * 4) +                              // slot, work
         2 * Carve::bytes(AC) + 2 * Carve::bytes(AC * 4) +             // run, resets, host, alive
         Carve::bytes(AC * 8) +                                         // alloc
         2 * Carve::bytes(N) + 2 * Carve::bytes(size_t(N) * 4) +       // queued, has_saved, submit, gid
         Carve::bytes(padded_rows(AC) * 4) + Carve::bytes(padded_rows(AC) * 8) +
         sums_smem<2>(int(AC), H) + Carve::bytes(size_t(H) * 8) +       // sums, free table
         Carve::bytes((3 * kWarps + 2) * 4);                            // reduction, flags
}

template <bool kGated>
__global__ void __launch_bounds__(kBlock) admit_queued_kernel(
    const float* __restrict__ submit_all, const int* __restrict__ gid_all,
    const float* __restrict__ cpu_all, const float* __restrict__ mem_all,
    const uint8_t* __restrict__ exists_all, const uint8_t* __restrict__ core_all,
    const int* __restrict__ slot_in, const float* __restrict__ work_in,
    const uint8_t* __restrict__ run_in, const int* __restrict__ host_in,
    const float* __restrict__ alloc_in, const float* __restrict__ alive_in,
    const uint8_t* __restrict__ queued_in, const uint8_t* __restrict__ saved_in,
    const float* __restrict__ saved_work_all, const float* __restrict__ t,
    const float* __restrict__ cap, int* __restrict__ slot_all,
    float* __restrict__ work_all, uint8_t* __restrict__ run_all,
    int* __restrict__ host_all, float* __restrict__ alloc_all,
    float* __restrict__ alive_all, uint8_t* __restrict__ queued_all,
    uint8_t* __restrict__ saved_all, uint8_t* __restrict__ resets_all,
    const int* __restrict__ tenant_all, const uint8_t* __restrict__ elig_all,
    const int* __restrict__ admitted_in, int* __restrict__ admitted_all, int A, int C, int N,
    int H, int resume, int T, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int AC = A * C;
  const size_t sa = size_t(s) * A, se = size_t(s) * AC, sn = size_t(s) * N;
  long long cyc[5] = {}, tp = clock64();
  auto stamp = [&](int phase) {   // close `phase`: its cycles since the last stamp
    if (!clocks) return;
    const long long now = clock64();
    cyc[phase] += now - tp;
    tp = now;
  };

  // ---- 0. stage ----
  blk::Carve sm{smem};
  int* slot = sm.take<int>(size_t(A) * 4, slot_in + sa);
  float* work = sm.take<float>(size_t(A) * 4, work_in + sa);
  uint8_t* run = sm.take<uint8_t>(AC, run_in + se);
  uint8_t* resets = sm.take<uint8_t>(AC, resets_all + se);
  int* host = sm.take<int>(size_t(AC) * 4, host_in + se);
  float* alive = sm.take<float>(size_t(AC) * 4, alive_in + se);
  float* alloc = sm.take<float>(size_t(AC) * 8, alloc_in + 2 * se);
  uint8_t* queued = sm.take<uint8_t>(N, queued_in + sn);
  uint8_t* has_saved = sm.take<uint8_t>(N, saved_in + sn);
  float* submit = sm.take<float>(size_t(N) * 4, submit_all + sn);
  int* gid = sm.take<int>(size_t(N) * 4, gid_all + sn);
  int* live_host = sm.take<int>(padded_rows(AC) * 4);
  float* val = sm.take<float>(padded_rows(AC) * 8);
  const int nw = row_windows(AC);
  float* part = sm.take<float>(part_bytes<2>(AC, H));
  float* level = sm.take<float>(size_t(nw + WIN - 1) / WIN * H * 8);
  float* fr = sm.take<float>(size_t(H) * 8);
  float* red_submit = sm.take<float>((3 * kWarps + 2) * 4);
  int* red_gid = reinterpret_cast<int*>(red_submit + kWarps);
  int* red_row = red_gid + kWarps;
  int* red_slot = red_row + kWarps;   // [0]: the first empty slot; [1]: admitted
  blk::stage(slot, slot_in + sa, size_t(A) * 4);
  blk::stage(work, work_in + sa, size_t(A) * 4);
  blk::stage(run, run_in + se, AC);
  blk::stage(host, host_in + se, size_t(AC) * 4);
  blk::stage(alive, alive_in + se, size_t(AC) * 4);
  blk::stage(alloc, alloc_in + 2 * se, size_t(AC) * 8);
  blk::stage(queued, queued_in + sn, N);
  blk::stage(has_saved, saved_in + sn, N);
  blk::stage(submit, submit_all + sn, size_t(N) * 4);
  blk::stage(gid, gid_all + sn, size_t(N) * 4);
  blk::zero(resets, AC);
  blk::zero(part, part_bytes<2>(AC, H));
  if (tid == 0) red_slot[0] = INT_MAX;
  const int* tenant = kGated ? tenant_all + sn : nullptr;
  const uint8_t* elig = kGated ? elig_all + size_t(s) * T : nullptr;
  int* admitted = kGated ? admitted_all + size_t(s) * T : nullptr;
  if (kGated)
    for (int t = tid; t < T; t += kBlock) admitted[t] = admitted_in[size_t(s) * T + t];
  blk::stage_wait();
  __syncthreads();
  stamp(0);

  bool filled = false;
  for (;;) {
    // ---- 1. the FIFO head and the first empty slot ----
    if (filled) blk::zero(part, part_bytes<2>(AC, H));   // for the next free table
    Head hd{INFINITY, 0, -1};
    for (int n = tid; n < N; n += kBlock) {
      const Head c{submit[n], gid[n], n};
      if (queued[n] && (!kGated || elig[min(max(tenant[n], 0), T - 1)]) && before(c, hd))
        hd = c;
    }
    int target = INT_MAX;
    for (int a = tid; a < A; a += kBlock)
      if (slot[a] < 0) {
        target = a;
        break;
      }
    for (int o = 16; o > 0; o >>= 1) {
      const Head c{__shfl_xor_sync(FULL, hd.submit, o), __shfl_xor_sync(FULL, hd.gid, o),
                   __shfl_xor_sync(FULL, hd.row, o)};
      if (before(c, hd)) hd = c;
    }
    target = __reduce_min_sync(FULL, target);
    if (lane == 0) {
      red_submit[warp] = hd.submit;
      red_gid[warp] = hd.gid;
      red_row[warp] = hd.row;
      if (target != INT_MAX) atomicMin(red_slot, target);
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      const Head c{red_submit[w], red_gid[w], red_row[w]};
      if (before(c, hd)) hd = c;
    }
    target = red_slot[0];
    const int head = hd.row;
    stamp(1);
    if (head < 0 || target == INT_MAX) break;

    // ---- 2. the free table of the current state ----
    if (!filled) {
      fill_alloc_rows(run, host, alloc, AC, H, live_host, val);
      filled = true;
      __syncthreads();
    }
    free_table(live_host, val, cap, AC, H, part, level, fr);
    stamp(2);

    // ---- 3. worst-fit placement of the head, then commit ----
    if (warp == 0) {
      const size_t hc = (sn + head) * C;
      float cpu = 0.f, mem = 0.f;
      bool ex = false, core = false;
      if (lane < C) {
        cpu = cpu_all[hc + lane];
        mem = mem_all[hc + lane];
        ex = exists_all[hc + lane];
        core = core_all[hc + lane];
      }
      int place = -1;   // lane c: component c's host
      bool ok = true;
      for (int pass = 0; pass < 2 && ok; ++pass) {
        const unsigned want = __ballot_sync(FULL, ex && core == (pass == 0));
        for (int c = 0; c < C; ++c) {
          if (!(want >> c & 1)) continue;
          const float cc = __shfl_sync(FULL, cpu, c), mc = __shfl_sync(FULL, mem, c);
          const int h = worst_fit(fr, H, cc, mc);
          if (h < 0) {
            if (pass == 0) {
              ok = false;
              break;
            }
            continue;
          }
          take(fr, h, cc, mc);
          if (lane == c) place = h;
        }
      }
      if (ok) {
        if (lane < C) {
          const int e = target * C + lane;
          const bool p = place >= 0;
          run[e] = p;
          host[e] = p ? place : 0;
          alloc[2 * e] = p ? cpu : 0.f;
          alloc[2 * e + 1] = p ? mem : 0.f;
          alive[e] = t[s];
          resets[e] = 1;
          live_host[prow(e)] = p ? place : -1;
          val[prow(e)] = alloc[2 * e];
          val[padded_rows(AC) + prow(e)] = alloc[2 * e + 1];
        }
        if (lane == 0) {
          slot[target] = head;
          work[target] = resume && has_saved[head] ? saved_work_all[sn + head] : 0.f;
          queued[head] = has_saved[head] = 0;
          red_slot[0] = INT_MAX;
          if (kGated && tenant[head] >= 0 && tenant[head] < T) ++admitted[tenant[head]];
        }
      }
      if (lane == 0) red_slot[1] = ok;
    }
    __syncthreads();
    stamp(3);
    if (!red_slot[1]) break;                    // the head does not fit: FIFO stops
  }

  // ---- 4. write ----
  blk::copy(slot_all + sa, slot, size_t(A) * 4);
  blk::copy(work_all + sa, work, size_t(A) * 4);
  blk::copy(run_all + se, run, AC);
  blk::copy(host_all + se, host, size_t(AC) * 4);
  blk::copy(alloc_all + 2 * se, alloc, size_t(AC) * 8);
  blk::copy(alive_all + se, alive, size_t(AC) * 4);
  blk::copy(queued_all + sn, queued, N);
  blk::copy(saved_all + sn, has_saved, N);
  blk::copy(resets_all + se, resets, AC);
  if (clocks) {
    __syncthreads();
    stamp(4);
    if (tid == 0)
      for (int i = 0; i < 5; ++i) clocks[5 * size_t(s) + i] = cyc[i];
  }
}

// Elastic re-placement (repro/sim/step.py:670), one block of kBlock
// threads per member:
//
//   0. stage the slot table (slot, run, host, alloc, alive);
//   1. the entry snapshot's missing components in parallel: a running
//      app's existing elastic component that is not running (exists and
//      is_core read only for the rows of occupied slots that do not run),
//      with the requests of each missing one; nothing missing (the common
//      tick) goes straight to the write;
//   2. the free table of the entry state, once, in parallel;
//   3. warp 0 walks the missing rows in flat (slot, component) order, the
//      reference's argsort(~missing) walk: worst fit, placed rows
//      committed into shared memory;
//   4. write every output once.
__host__ __device__ inline size_t elastic_smem(int A, int C, int N, int H) {
  using blk::Carve;
  const size_t AC = size_t(A) * C;
  return Carve::bytes(size_t(A) * 4) + 2 * Carve::bytes(AC) +         // slot, run, missing
         2 * Carve::bytes(AC * 4) + 2 * Carve::bytes(AC * 8) +         // host, alive, alloc, requests
         Carve::bytes(padded_rows(AC) * 4) + Carve::bytes(padded_rows(AC) * 8) +
         sums_smem<2>(int(AC), H) + Carve::bytes(size_t(H) * 8);        // sums, free table
}

__global__ void __launch_bounds__(kBlock) place_missing_elastic_kernel(
    const float* __restrict__ cpu_all, const float* __restrict__ mem_all,
    const uint8_t* __restrict__ exists_all, const uint8_t* __restrict__ core_all,
    const int* __restrict__ slot_all, const uint8_t* __restrict__ run_in,
    const int* __restrict__ host_in, const float* __restrict__ alloc_in,
    const float* __restrict__ alive_in, const float* __restrict__ t,
    const float* __restrict__ cap, uint8_t* __restrict__ run_all,
    int* __restrict__ host_all, float* __restrict__ alloc_all,
    float* __restrict__ alive_all, int A, int C, int N, int H,
    long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, AC = A * C;
  const size_t sa = size_t(s) * A, se = size_t(s) * AC, sn = size_t(s) * N;
  long long cyc[5] = {}, tp = clock64();
  auto stamp = [&](int phase) {
    if (!clocks) return;
    const long long now = clock64();
    cyc[phase] += now - tp;
    tp = now;
  };

  // ---- 0. stage ----
  blk::Carve sm{smem};
  int* slot = sm.take<int>(size_t(A) * 4, slot_all + sa);
  uint8_t* run = sm.take<uint8_t>(AC, run_in + se);
  uint8_t* missing = sm.take<uint8_t>(AC);
  int* host = sm.take<int>(size_t(AC) * 4, host_in + se);
  float* alive = sm.take<float>(size_t(AC) * 4, alive_in + se);
  float* alloc = sm.take<float>(size_t(AC) * 8, alloc_in + 2 * se);
  float* req = sm.take<float>(size_t(AC) * 8);   // (cpu, mem) of each missing row
  int* live_host = sm.take<int>(padded_rows(AC) * 4);
  float* val = sm.take<float>(padded_rows(AC) * 8);
  const int nw = row_windows(AC);
  float* part = sm.take<float>(part_bytes<2>(AC, H));
  float* level = sm.take<float>(size_t(nw + WIN - 1) / WIN * H * 8);
  float* fr = sm.take<float>(size_t(H) * 8);
  blk::zero(part, part_bytes<2>(AC, H));
  blk::stage(slot, slot_all + sa, size_t(A) * 4);
  blk::stage(run, run_in + se, AC);
  blk::stage(host, host_in + se, size_t(AC) * 4);
  blk::stage(alive, alive_in + se, size_t(AC) * 4);
  blk::stage(alloc, alloc_in + 2 * se, size_t(AC) * 8);
  blk::stage_wait();
  __syncthreads();
  stamp(0);

  // ---- 1. the missing elastic components at entry ----
  bool any = false;
  for (int e = tid; e < AC; e += kBlock) {
    const int g = slot[e / C];
    bool m = false;
    if (g >= 0 && !run[e]) {   // four independent loads, one round trip
      const size_t gc = (sn + g) * C + e % C;
      const bool ex = exists_all[gc], core = core_all[gc];
      const float cpu = cpu_all[gc], mem = mem_all[gc];
      m = ex && !core;
      req[2 * e] = cpu;
      req[2 * e + 1] = mem;
    }
    missing[e] = m;
    any |= m;
  }
  any = __syncthreads_or(any);
  stamp(1);

  if (any) {
    // ---- 2. the free table at entry ----
    fill_alloc_rows(run, host, alloc, AC, H, live_host, val);
    __syncthreads();
    free_table(live_host, val, cap, AC, H, part, level, fr);
    stamp(2);

    // ---- 3. the walk, on warp 0 ----
    if (tid < 32) {
      const float now = t[s];
      for (int base = 0; base < AC; base += 32) {
        const int e = base + lane;
        for (unsigned m = __ballot_sync(FULL, e < AC && missing[e]); m; m &= m - 1) {
          const int r = base + __ffs(m) - 1;
          const float cpu = req[2 * r], mem = req[2 * r + 1];
          const int h = worst_fit(fr, H, cpu, mem);
          if (h < 0) continue;
          take(fr, h, cpu, mem);
          if (lane == 0) {
            run[r] = 1;
            host[r] = h;
            alloc[2 * r] = cpu;
            alloc[2 * r + 1] = mem;
            alive[r] = now;
          }
        }
      }
    }
    __syncthreads();
    stamp(3);
  }

  // ---- 4. write ----
  blk::copy(run_all + se, run, AC);
  blk::copy(host_all + se, host, size_t(AC) * 4);
  blk::copy(alloc_all + 2 * se, alloc, size_t(AC) * 8);
  blk::copy(alive_all + se, alive, size_t(AC) * 4);
  if (clocks) {
    __syncthreads();
    stamp(4);
    if (tid == 0)
      for (int i = 0; i < 5; ++i) clocks[5 * size_t(s) + i] = cyc[i];
  }
}

}  // namespace

// The shared memory one block of each kernel needs at (A, C, N, H), in
// bytes; the wrappers refuse a call above kMaxSmem (their MAX_SMEM).
extern "C" long long resolve_oom_smem(int A, int C, int N, int H) {
  return static_cast<long long>(oom_smem(A, C, N, H));
}

extern "C" long long admit_queued_smem(int A, int C, int N, int H) {
  return static_cast<long long>(admit_smem(A, C, N, H));
}

extern "C" long long place_missing_elastic_smem(int A, int C, int N, int H) {
  return static_cast<long long>(elastic_smem(A, C, N, H));
}

// Allow each kernel its opt-in shared memory on the current device: once,
// before the first launch (never inside one, so a captured CUDA graph
// holds launches only).
extern "C" int resolve_oom_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      resolve_oom_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

extern "C" int admit_queued_init() {
  cudaError_t rc = cudaFuncSetAttribute(
      admit_queued_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(admit_queued_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return static_cast<int>(rc);
}

extern "C" int place_missing_elastic_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      place_missing_elastic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

// vf, tail: the plan of XLA:CPU's kernel for the loop's per-host total
// over (A, C) (ref.py:xla_slot_plan; vf 0 for a serial sum, else 4 or 8).
// clocks: null, or (S, 4) int64 for the cycles of each phase per member
// (stage, per-host sums, victim loop, write).
extern "C" int resolve_oom(const void* slot_in, const void* work_in,
                           const void* run_in, const void* host,
                           const void* alloc_in, const void* usage_in,
                           const void* failed_in, const void* queued_in,
                           const void* oom_in, const void* fail_in,
                           const void* part_in, const void* is_core,
                           const void* cap, void* slot, void* work, void* run,
                           void* alloc, void* usage, void* failed, void* queued,
                           void* oom, void* fail, void* part, void* monreset,
                           int S, int A, int C, int N, int H, int vf, int tail,
                           void* clocks, void* stream) {
  const size_t smem = oom_smem(A, C, N, H);
  if (smem > size_t(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  resolve_oom_kernel<<<S, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slot_in), static_cast<const float*>(work_in),
      static_cast<const uint8_t*>(run_in), static_cast<const int*>(host),
      static_cast<const float*>(alloc_in), static_cast<const float*>(usage_in),
      static_cast<const uint8_t*>(failed_in), static_cast<const uint8_t*>(queued_in),
      static_cast<const int*>(oom_in), static_cast<const int*>(fail_in),
      static_cast<const int*>(part_in), static_cast<const uint8_t*>(is_core),
      static_cast<const float*>(cap), static_cast<int*>(slot),
      static_cast<float*>(work), static_cast<uint8_t*>(run),
      static_cast<float*>(alloc), static_cast<float*>(usage),
      static_cast<uint8_t*>(failed), static_cast<uint8_t*>(queued),
      static_cast<int*>(oom), static_cast<int*>(fail), static_cast<int*>(part),
      static_cast<uint8_t*>(monreset), A, C, N, H, vf, tail,
      static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

// clocks: null, or (S, 5) int64 for the cycles of each phase per member
// (stage, head search, free table, placement, write; summed over rounds).
// The gate: tenant (S, N) i32, elig (S, T) bool, admitted_in and
// admitted (S, T) i32, all null without it.
extern "C" int admit_queued(const void* submit, const void* gid,
                            const void* cpu_req, const void* mem_req,
                            const void* exists, const void* is_core,
                            const void* slot_in, const void* work_in,
                            const void* run_in, const void* host_in,
                            const void* alloc_in, const void* alive_in,
                            const void* queued_in, const void* saved_in,
                            const void* saved_work, const void* t,
                            const void* cap, void* slot, void* work, void* run,
                            void* host, void* alloc, void* alive, void* queued,
                            void* has_saved, void* resets, const void* tenant,
                            const void* elig, const void* admitted_in, void* admitted,
                            int S, int A, int C, int N, int H, int resume, int T,
                            void* clocks, void* stream) {
  if (tenant && (!elig || !admitted_in || !admitted || T <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = admit_smem(A, C, N, H);
  if (smem > size_t(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tenant ? admit_queued_kernel<true> : admit_queued_kernel<false>;
  kernel<<<S, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(submit), static_cast<const int*>(gid),
      static_cast<const float*>(cpu_req), static_cast<const float*>(mem_req),
      static_cast<const uint8_t*>(exists), static_cast<const uint8_t*>(is_core),
      static_cast<const int*>(slot_in), static_cast<const float*>(work_in),
      static_cast<const uint8_t*>(run_in), static_cast<const int*>(host_in),
      static_cast<const float*>(alloc_in), static_cast<const float*>(alive_in),
      static_cast<const uint8_t*>(queued_in), static_cast<const uint8_t*>(saved_in),
      static_cast<const float*>(saved_work), static_cast<const float*>(t),
      static_cast<const float*>(cap), static_cast<int*>(slot),
      static_cast<float*>(work), static_cast<uint8_t*>(run),
      static_cast<int*>(host), static_cast<float*>(alloc),
      static_cast<float*>(alive), static_cast<uint8_t*>(queued),
      static_cast<uint8_t*>(has_saved), static_cast<uint8_t*>(resets),
      static_cast<const int*>(tenant), static_cast<const uint8_t*>(elig),
      static_cast<const int*>(admitted_in), static_cast<int*>(admitted), A, C, N, H, resume,
      T, static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

// clocks: null, or (S, 5) int64 for the cycles of each phase per member
// (stage, missing search, free table, walk, write).
extern "C" int place_missing_elastic(const void* cpu_req, const void* mem_req,
                                     const void* exists, const void* is_core,
                                     const void* slot, const void* run_in,
                                     const void* host_in, const void* alloc_in,
                                     const void* alive_in, const void* t,
                                     const void* cap, void* run, void* host,
                                     void* alloc, void* alive, int S, int A,
                                     int C, int N, int H, void* clocks, void* stream) {
  const size_t smem = elastic_smem(A, C, N, H);
  if (smem > size_t(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  place_missing_elastic_kernel<<<S, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cpu_req), static_cast<const float*>(mem_req),
      static_cast<const uint8_t*>(exists), static_cast<const uint8_t*>(is_core),
      static_cast<const int*>(slot), static_cast<const uint8_t*>(run_in),
      static_cast<const int*>(host_in), static_cast<const float*>(alloc_in),
      static_cast<const float*>(alive_in), static_cast<const float*>(t),
      static_cast<const float*>(cap), static_cast<uint8_t*>(run),
      static_cast<int*>(host), static_cast<float*>(alloc),
      static_cast<float*>(alive), A, C, N, H, static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}
