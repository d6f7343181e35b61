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
// They are latency-bound by construction.  The design: one warp per
// member, no block-wide barrier; each host is owned by lane h % 32,
// which keeps that host's entries of the (H, 2) free table in shared
// memory; a scan over the flat (slot, component) rows takes them 32 at
// a time with one coalesced load per lane, and a __ballot_sync orders
// the rows that matter so that the owner lanes add them in flat order.
//
// Arithmetic: sums and differences only, no a*b+c to contract.  Every
// sum over the flat rows is taken in the order XLA:CPU gives the
// reference's reductions (repro_torch/kernels/ref.py:xla_sum): above 32
// units, windows of 32 (the padding to a multiple of 32 split between
// the ends), each window summed in order, the window sums reduced the
// same way; 32 or fewer summed in order.  The lanes walk the windows in
// order and carry one running sum per level (struct Tree).
//
// Each kernel first copies its inputs to its outputs and then updates
// the outputs, so the caller's tensors are never written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(32) resolve_oom_kernel(
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
    uint8_t* __restrict__ monreset_all, int A, int C, int N, int H) {
  extern __shared__ float over0[];   // (H,) 1 where the host is over at entry
  const int s = blockIdx.x, lane = threadIdx.x, AC = A * C;
  const size_t sa = size_t(s) * A, se = size_t(s) * AC, sn = size_t(s) * N;
  int* slot = slot_all + sa;
  float* work = work_all + sa;
  uint8_t* run = run_all + se;
  const int* host = host_all + se;
  float* alloc = alloc_all + 2 * se;
  float* usage = usage_all + 2 * se;
  uint8_t* failed = failed_all + sn;
  uint8_t* queued = queued_all + sn;
  uint8_t* monreset = monreset_all + se;
  const uint8_t* is_core = is_core_all + sn * C;
  copy_rows(slot, slot_in + sa, A);
  copy_rows(work, work_in + sa, A);
  copy_rows(run, run_in + se, AC);
  copy_rows(alloc, alloc_in + 2 * se, 2 * size_t(AC));
  copy_rows(usage, usage_in + 2 * se, 2 * size_t(AC));
  copy_rows(failed, failed_in + sn, N);
  copy_rows(queued, queued_in + sn, N);
  for (int e = lane; e < AC; e += 32) monreset[e] = 0;

  // the running components' memory usage per host at entry
  float* tot0 = over0 + H;              // (H, 2); then 2 * MAX_LEVELS per host
  host_sums([&](int e, bool* live, int* h, float* v0, float* v1) {
    *live = run_in[se + e];
    *h = host[e];
    *v0 = usage_in[2 * (se + e) + 1];
    *v1 = 0.f;
  }, AC, H, tot0 + 2 * H, tot0);
  for (int h = lane; h < H; h += 32) over0[h] = tot0[2 * h];
  bool any = false;
  for (int h = lane; h < H; h += 32) {
    const bool over = over0[h] > __fadd_rn(cap[2 * h + 1], 1e-6f);
    over0[h] = over ? 1.f : 0.f;
    any |= over;
  }
  int n_full = 0, n_part = 0;
  if (__any_sync(FULL, any)) {
    __syncwarp();
    for (int h = 0; h < H; ++h) {
      if (over0[h] == 0.f) continue;
      const float lim = __fadd_rn(cap[2 * h + 1], 1e-6f);
      for (;;) {
        // the host's total (a sum over (A, C): windows of whole slots)
        // and the victim: the largest usage - alloc overage, the largest
        // flat index on ties
        const Tree t = tree_of(A);
        float acc[MAX_LEVELS] = {};
        float bv = 0.f;
        int bi = -1;
        bool on_any = false;
        for (int j = 0, nw = n_windows(t, A); j < nw; ++j) {
          int a0, a1;
          window(t, j, A, &a0, &a1);
          for (int base = a0 * C; base < a1 * C; base += 32) {
            const int e = base + lane;
            const bool on = e < a1 * C && run[e] && host[e] == h;
            const float u = on ? usage[2 * e + 1] : 0.f;
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
          if (t.levels) tree_push<1>(acc, t, j);
        }
        const float tot = acc[t.levels];
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
        const bool core = is_core[size_t(g) * C + c];
        __syncwarp();                               // every lane has read slot[a]
        if (core) {                                 // a core victim fails its app
          for (int cc = lane; cc < C; cc += 32) {
            const int e = a * C + cc;
            usage[2 * e] = usage[2 * e + 1] = 0.f;
            alloc[2 * e] = alloc[2 * e + 1] = 0.f;
            run[e] = 0;
          }
          if (lane == 0) {
            slot[a] = -1;
            work[a] = 0.f;
            failed[g] = queued[g] = 1;
          }
          ++n_full;
        } else {                                    // an elastic victim alone
          if (lane == 0) {
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
  if (lane == 0) {
    oom[s] = oom_in[s] + n_full;
    fail[s] = fail_in[s] + n_full;
    part[s] = part_in[s] + n_part;
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

extern "C" int resolve_oom(const void* slot_in, const void* work_in,
                           const void* run_in, const void* host,
                           const void* alloc_in, const void* usage_in,
                           const void* failed_in, const void* queued_in,
                           const void* oom_in, const void* fail_in,
                           const void* part_in, const void* is_core,
                           const void* cap, void* slot, void* work, void* run,
                           void* alloc, void* usage, void* failed, void* queued,
                           void* oom, void* fail, void* part, void* monreset,
                           int S, int A, int C, int N, int H, void* stream) {
  const size_t smem = (3 + 2 * MAX_LEVELS) * H * sizeof(float);
  resolve_oom_kernel<<<S, 32, smem, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<uint8_t*>(monreset), A, C, N, H);
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
