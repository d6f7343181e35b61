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
// They are latency-bound by construction.  admit_queued and
// place_missing_elastic run one warp per member, with no block-wide
// barrier; each host is owned by lane h % 32, which keeps that host's
// entries of the (H, 2) free table in shared memory; a scan over the
// flat (slot, component) rows takes them 32 at a time with one
// coalesced load per lane, and a __ballot_sync orders the rows that
// matter so that the owner lanes add them in flat order.  resolve_oom
// runs one block per member (its design is described at its kernel):
// the whole block stages the member's state in shared memory and sums
// memory per host in parallel, its victim loop reads and updates shared
// memory only, and each output is written once at the end.
//
// Arithmetic: sums and differences only, no a*b+c to contract.  Every
// sum over the flat rows is taken in the order XLA:CPU gives the
// reference's reductions (repro_torch/kernels/ref.py:xla_sum): above 32
// units, windows of 32 (the padding to a multiple of 32 split between
// the ends), each window summed in order, the window sums reduced the
// same way; 32 or fewer summed in order.  The lanes walk the windows in
// order and carry one running sum per level (struct Tree).
//
// admit_queued and place_missing_elastic first copy their inputs to
// their outputs and then update the outputs; resolve_oom updates its
// staged copy and writes the outputs from it.  The caller's tensors are
// never written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_copy.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ void copy_rows(T* __restrict__ dst, const T* __restrict__ src, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += 32) dst[i] = src[i];
}

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

// out[h] = the (v0, v1) of the running flat rows on host h summed in
// XLA:CPU's order, each host's by its owner lane; row(e, &live, &host,
// &v0, &v1) reads row e.  acc: 2 * MAX_LEVELS floats per host.
template <class Row>
__device__ void host_sums(Row row, int AC, int H, float* acc, float* out) {
  const Tree t = tree_of(AC);
  const int lane = threadIdx.x, stride = 2 * MAX_LEVELS;
  for (int h = lane; h < H; h += 32)
    for (int i = 0; i < stride; ++i) acc[h * stride + i] = 0.f;
  for (int j = 0, nw = n_windows(t, AC); j < nw; ++j) {
    int e0, e1;
    window(t, j, AC, &e0, &e1);                 // at most 32 rows
    const int e = e0 + lane;
    bool live = false;
    int h = 0;
    float v0 = 0.f, v1 = 0.f;
    if (e < e1) row(e, &live, &h, &v0, &v1);
    for (unsigned m = __ballot_sync(FULL, live); m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const int hk = __shfl_sync(FULL, h, k);
      const float x0 = __shfl_sync(FULL, v0, k);
      const float x1 = __shfl_sync(FULL, v1, k);
      if (lane == (hk & 31)) {
        acc[hk * stride] += x0;
        acc[hk * stride + 1] += x1;
      }
    }
    if (t.levels)
      for (int hh = lane; hh < H; hh += 32) tree_push<2>(acc + hh * stride, t, j);
  }
  for (int h = lane; h < H; h += 32) {
    out[2 * h] = acc[h * stride + 2 * t.levels];
    out[2 * h + 1] = acc[h * stride + 2 * t.levels + 1];
  }
  __syncwarp();
}

// fr[h] = cap[h] - the allocations of the running rows on h
// (repro/sim/step.py:_free_resources)
__device__ void free_table(const uint8_t* __restrict__ run,
                           const int* __restrict__ host,
                           const float* __restrict__ alloc,
                           const float* __restrict__ cap, int AC, int H,
                           float* acc, float* fr) {
  host_sums([&](int e, bool* live, int* h, float* v0, float* v1) {
    *live = run[e];
    *h = host[e];
    *v0 = alloc[2 * e];
    *v1 = alloc[2 * e + 1];
  }, AC, H, acc, fr);
  for (int h = threadIdx.x; h < H; h += 32) {
    fr[2 * h] = cap[2 * h] - fr[2 * h];
    fr[2 * h + 1] = cap[2 * h + 1] - fr[2 * h + 1];
  }
  __syncwarp();
}

// worst fit: the host with the most free memory among those where (cpu,
// mem) fits, the lowest index on ties; -1 when none fits.  Every lane
// returns the same host.
__device__ int worst_fit(const float* fr, int H, float cpu, float mem) {
  float best = 0.f;
  int bi = -1;
  for (int h = threadIdx.x; h < H; h += 32)
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

// take `mem`/`cpu` off host h's free entry: only its owner lane writes
__device__ void take(float* fr, int h, float cpu, float mem) {
  if (int(threadIdx.x) == (h & 31)) {
    fr[2 * h] -= cpu;
    fr[2 * h + 1] -= mem;
  }
}

// The OS OOM handler, one block of kOomThreads per member:
//
//   0. stage: the member's slot table (slot, work, run, host, alloc,
//      usage) and queue flags (failed, queued) go to shared memory with
//      the whole block by cp.async, every load in flight at once
//      (block_copy.cuh); then per flat row its host if running (else -1)
//      and its memory usage, in a padded layout (row e at e + e / 32) so
//      that the threads of step 1, one per window of 32 rows, read 32
//      different banks;
//   1. per-host memory at entry, in XLA:CPU's order, in parallel: one
//      thread per level-0 window sums its window's running rows into its
//      own row of a (window, host) table, in flat order from 0; each
//      upper level likewise, one thread per (window, host); the top level
//      one thread per host (what tree_of / tree_push carry lane by lane);
//   2. only when a host is over its memory, the victim loop: one warp,
//      hosts in order, each total over windows of whole slots and the
//      victim (the largest overage, the largest flat index on ties) read
//      from shared memory, each kill written there;
//   3. write every output once from shared memory, 16 bytes a thread
//      where the addresses allow.
constexpr int kOomThreads = 256;
constexpr int kMaxSmem = 232448;   // the opt-in shared memory of a block on sm_90

__host__ __device__ inline size_t padded_rows(size_t n) { return n + n / 32 + 1; }

__host__ __device__ inline int oom_windows(int AC) {
  return AC > WIN ? (AC + WIN - 1) / WIN : 1;
}

__host__ __device__ inline size_t oom_smem(int A, int C, int N, int H) {
  using blk::Carve;
  const size_t AC = size_t(A) * C, nw = oom_windows(int(AC));
  return 2 * Carve::bytes(size_t(A) * 4) + 2 * Carve::bytes(AC) +      // slot, work, run, monreset
         Carve::bytes(AC * 4) + 2 * Carve::bytes(AC * 8) +             // host, alloc, usage
         2 * Carve::bytes(N) +                                          // failed, queued
         2 * Carve::bytes(padded_rows(AC) * 4) +                        // live host, memory
         Carve::bytes(nw * H * 4) + Carve::bytes((nw + WIN - 1) / WIN * H * 4) +
         Carve::bytes(size_t(H) * 4);                                   // over
}

__device__ __forceinline__ int prow(int e) { return e + (e >> 5); }

__global__ void __launch_bounds__(kOomThreads) resolve_oom_kernel(
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
    uint8_t* __restrict__ monreset_all, int A, int C, int N, int H,
    long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, AC = A * C;
  const size_t sa = size_t(s) * A, se = size_t(s) * AC, sn = size_t(s) * N;
  const int nw = oom_windows(AC);
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
  float* part_sum = sm.take<float>(size_t(nw) * H * 4);             // (window, host)
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
  for (size_t i = tid; i < size_t(nw) * H; i += kOomThreads) part_sum[i] = 0.f;
  blk::stage_wait();
  __syncthreads();
  for (int e = tid; e < AC; e += kOomThreads) {
    live_host[prow(e)] = run[e] ? host[e] : -1;
    mem[prow(e)] = usage[2 * e + 1];
  }
  __syncthreads();
  const long long t1 = clock64();

  // ---- 1. the running components' memory usage per host at entry ----
  const Tree t = tree_of(AC);
  for (int j = tid; j < nw; j += kOomThreads) {
    int e0, e1;
    window(t, j, AC, &e0, &e1);
    float* row = part_sum + size_t(j) * H;
    for (int e = e0; e < e1; ++e) {
      const int h = live_host[prow(e)];
      if (h >= 0 && h < H) row[h] += mem[prow(e)];
    }
  }
  __syncthreads();
  float* items = part_sum;   // (n, H): the current level's items
  int n = nw;
  for (int l = 1; l < t.levels; ++l) {
    const int lo = t.lo[l], n_next = (n + WIN - 1) / WIN;
    for (int i = tid; i < n_next * H; i += kOomThreads) {
      const int w = i / H, h = i % H;
      float acc = 0.f;
      for (int u = max(w * WIN - lo, 0), u1 = min((w + 1) * WIN - lo, n); u < u1; ++u)
        acc += items[size_t(u) * H + h];
      level[i] = acc;
    }
    __syncthreads();
    float* done = items;
    items = level;
    level = done;
    n = n_next;
  }
  bool any = false;
  for (int h = tid; h < H; h += kOomThreads) {
    float tot = 0.f;
    for (int u = 0; u < n; ++u) tot += items[size_t(u) * H + h];
    over[h] = tot > __fadd_rn(cap[2 * h + 1], 1e-6f);
    any |= over[h];
  }
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
        // the host's total (a sum over (A, C): windows of whole slots)
        // and the victim: the largest usage - alloc overage, the largest
        // flat index on ties
        float acc[MAX_LEVELS] = {};
        float bv = 0.f;
        int bi = -1;
        bool on_any = false;
        for (int j = 0, nws = n_windows(ts, A); j < nws; ++j) {
          int a0, a1;
          window(ts, j, A, &a0, &a1);
          for (int base = a0 * C; base < a1 * C; base += 32) {
            const int e = base + lane;
            const bool on = e < a1 * C && live_host[prow(e)] == h;
            const float u = on ? mem[prow(e)] : 0.f;
            const unsigned mask = __ballot_sync(FULL, on);
            on_any |= mask != 0;
            for (unsigned m = mask; m; m &= m - 1) acc[0] += __shfl_sync(FULL, u, __ffs(m) - 1);
            if (on) {
              const float ov = u - alloc[2 * e + 1];
              if (bi < 0 || ov >= bv) {
                bv = ov;
                bi = e;
              }
            }
          }
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

__global__ void __launch_bounds__(32) admit_queued_kernel(
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
    uint8_t* __restrict__ saved_all, uint8_t* __restrict__ resets_all, int A,
    int C, int N, int H, int resume) {
  extern __shared__ float fr[];   // (H, 2), 2 * MAX_LEVELS per host, C placements
  float* acc = fr + 2 * H;
  int* place = reinterpret_cast<int*>(acc + 2 * MAX_LEVELS * H);
  const int s = blockIdx.x, lane = threadIdx.x, AC = A * C;
  const size_t sa = size_t(s) * A, se = size_t(s) * AC, sn = size_t(s) * N;
  const float* submit = submit_all + sn;
  const int* gid = gid_all + sn;
  const float* cpu_req = cpu_all + sn * C;
  const float* mem_req = mem_all + sn * C;
  const uint8_t* exists = exists_all + sn * C;
  const uint8_t* is_core = core_all + sn * C;
  const float* saved_work = saved_work_all + sn;
  int* slot = slot_all + sa;
  float* work = work_all + sa;
  uint8_t* run = run_all + se;
  int* host = host_all + se;
  float* alloc = alloc_all + 2 * se;
  float* alive = alive_all + se;
  uint8_t* queued = queued_all + sn;
  uint8_t* has_saved = saved_all + sn;
  uint8_t* resets = resets_all + se;
  copy_rows(slot, slot_in + sa, A);
  copy_rows(work, work_in + sa, A);
  copy_rows(run, run_in + se, AC);
  copy_rows(host, host_in + se, AC);
  copy_rows(alloc, alloc_in + 2 * se, 2 * size_t(AC));
  copy_rows(alive, alive_in + se, AC);
  copy_rows(queued, queued_in + sn, N);
  copy_rows(has_saved, saved_in + sn, N);
  for (int e = lane; e < AC; e += 32) resets[e] = 0;
  __syncwarp();
  for (;;) {
    // the first empty slot
    int target = -1;
    for (int base = 0; base < A && target < 0; base += 32) {
      const unsigned m = __ballot_sync(FULL, base + lane < A && slot[base + lane] < 0);
      if (m) target = base + __ffs(m) - 1;
    }
    // the FIFO head: the least submit, then the least gid, then the row
    float bs = INFINITY;
    int bg = 0, head = -1;
    for (int n = lane; n < N; n += 32)
      if (queued[n] && (head < 0 || submit[n] < bs || (submit[n] == bs && gid[n] < bg))) {
        bs = submit[n];
        bg = gid[n];
        head = n;
      }
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(FULL, bs, o);
      const int og = __shfl_xor_sync(FULL, bg, o), on = __shfl_xor_sync(FULL, head, o);
      if (on >= 0 && (head < 0 || os < bs || (os == bs && (og < bg || (og == bg && on < head))))) {
        bs = os;
        bg = og;
        head = on;
      }
    }
    if (head < 0 || target < 0) break;
    // worst-fit placement: every core component, then elastic ones
    free_table(run, host, alloc, cap, AC, H, acc, fr);
    const size_t hc = size_t(head) * C;
    for (int c = lane; c < C; c += 32) place[c] = -1;
    __syncwarp();
    bool ok = true;
    for (int pass = 0; pass < 2 && ok; ++pass)
      for (int c = 0; c < C; ++c) {
        if (!exists[hc + c] || bool(is_core[hc + c]) != (pass == 0)) continue;
        const int h = worst_fit(fr, H, cpu_req[hc + c], mem_req[hc + c]);
        if (h < 0) {
          if (pass == 0) {
            ok = false;
            break;
          }
          continue;
        }
        take(fr, h, cpu_req[hc + c], mem_req[hc + c]);
        if (lane == 0) place[c] = h;
        __syncwarp();
      }
    if (!ok) break;                          // the head does not fit: FIFO stops
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      const int e = target * C + c, p = place[c];
      run[e] = p >= 0;
      host[e] = p >= 0 ? p : 0;
      alloc[2 * e] = p >= 0 ? cpu_req[hc + c] : 0.f;
      alloc[2 * e + 1] = p >= 0 ? mem_req[hc + c] : 0.f;
      alive[e] = t[s];
      resets[e] = 1;
    }
    if (lane == 0) {
      slot[target] = head;
      work[target] = resume && has_saved[head] ? saved_work[head] : 0.f;
      queued[head] = has_saved[head] = 0;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32) place_missing_elastic_kernel(
    const float* __restrict__ cpu_all, const float* __restrict__ mem_all,
    const uint8_t* __restrict__ exists_all, const uint8_t* __restrict__ core_all,
    const int* __restrict__ slot_all, const uint8_t* __restrict__ run_in,
    const int* __restrict__ host_in, const float* __restrict__ alloc_in,
    const float* __restrict__ alive_in, const float* __restrict__ t,
    const float* __restrict__ cap, uint8_t* __restrict__ run_all,
    int* __restrict__ host_all, float* __restrict__ alloc_all,
    float* __restrict__ alive_all, int A, int C, int N, int H) {
  extern __shared__ float fr[];   // (H, 2), then 2 * MAX_LEVELS per host
  const int s = blockIdx.x, lane = threadIdx.x, AC = A * C;
  const size_t se = size_t(s) * AC, sn = size_t(s) * N;
  const float* cpu_req = cpu_all + sn * C;
  const float* mem_req = mem_all + sn * C;
  const uint8_t* exists = exists_all + sn * C;
  const uint8_t* is_core = core_all + sn * C;
  const int* slot = slot_all + size_t(s) * A;
  uint8_t* run = run_all + se;
  int* host = host_all + se;
  float* alloc = alloc_all + 2 * se;
  float* alive = alive_all + se;
  copy_rows(run, run_in + se, AC);
  copy_rows(host, host_in + se, AC);
  copy_rows(alloc, alloc_in + 2 * se, 2 * size_t(AC));
  copy_rows(alive, alive_in + se, AC);
  // a running app's existing elastic component that is not running, at entry
  auto missing = [&](int e) {
    const int g = e < AC ? slot[e / C] : -1;
    if (g < 0) return false;
    const size_t gc = size_t(g) * C + e % C;
    return exists[gc] && !is_core[gc] && !run_in[se + e];
  };
  bool any = false;
  for (int e = lane; e < AC; e += 32) any |= missing(e);
  if (!__any_sync(FULL, any)) return;
  __syncwarp();
  free_table(run_in + se, host_in + se, alloc_in + 2 * se, cap, AC, H, fr + 2 * H, fr);
  for (int base = 0; base < AC; base += 32) {
    for (unsigned m = __ballot_sync(FULL, missing(base + lane)); m; m &= m - 1) {
      const int e = base + __ffs(m) - 1;
      const size_t gc = size_t(slot[e / C]) * C + e % C;
      const float cpu = cpu_req[gc], mem = mem_req[gc];
      const int h = worst_fit(fr, H, cpu, mem);
      if (h < 0) continue;
      take(fr, h, cpu, mem);
      if (lane == 0) {
        run[e] = 1;
        host[e] = h;
        alloc[2 * e] = cpu;
        alloc[2 * e + 1] = mem;
        alive[e] = t[s];
      }
      __syncwarp();
    }
  }
}

}  // namespace

// The shared memory one block of resolve_oom needs at (A, C, N, H), in
// bytes; the wrapper refuses a call above kMaxSmem (its MAX_SMEM).
extern "C" long long resolve_oom_smem(int A, int C, int N, int H) {
  return static_cast<long long>(oom_smem(A, C, N, H));
}

// Allow resolve_oom its opt-in shared memory on the current device: once,
// before the first launch (never inside one, so a captured CUDA graph
// holds launches only).
extern "C" int resolve_oom_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      resolve_oom_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

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
                           int S, int A, int C, int N, int H, void* clocks,
                           void* stream) {
  const size_t smem = oom_smem(A, C, N, H);
  if (smem > size_t(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  resolve_oom_kernel<<<S, kOomThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<uint8_t*>(monreset), A, C, N, H, static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

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
                            void* has_saved, void* resets, int S, int A, int C,
                            int N, int H, int resume, void* stream) {
  const size_t smem = (2 + 2 * MAX_LEVELS) * H * sizeof(float) + C * sizeof(int);
  admit_queued_kernel<<<S, 32, smem, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<uint8_t*>(has_saved), static_cast<uint8_t*>(resets), A, C, N,
      H, resume);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int place_missing_elastic(const void* cpu_req, const void* mem_req,
                                     const void* exists, const void* is_core,
                                     const void* slot, const void* run_in,
                                     const void* host_in, const void* alloc_in,
                                     const void* alive_in, const void* t,
                                     const void* cap, void* run, void* host,
                                     void* alloc, void* alive, int S, int A,
                                     int C, int N, int H, void* stream) {
  const size_t smem = (2 + 2 * MAX_LEVELS) * H * sizeof(float);
  place_missing_elastic_kernel<<<S, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cpu_req), static_cast<const float*>(mem_req),
      static_cast<const uint8_t*>(exists), static_cast<const uint8_t*>(is_core),
      static_cast<const int*>(slot), static_cast<const uint8_t*>(run_in),
      static_cast<const int*>(host_in), static_cast<const float*>(alloc_in),
      static_cast<const float*>(alive_in), static_cast<const float*>(t),
      static_cast<const float*>(cap), static_cast<uint8_t*>(run),
      static_cast<int*>(host), static_cast<float*>(alloc),
      static_cast<float*>(alive), A, C, N, H);
  return static_cast<int>(cudaGetLastError());
}
