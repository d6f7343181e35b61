// The telemetry rings' tick of the device engine, one launch for every
// member of a batch: the tick's thirteen channels, written at column
// cursor % R of the member's rings where the member is active.
//
// Replaces: XLA code of the reference, not a Pallas kernel: the rings'
// part of its fused tick (repro/sim/step.py:757-770 the entry snapshots,
// :822 and :880-881 the demand and gate values, :901-920 obs_record; some
// thirty operations that PyTorch would run as about twenty-five small
// kernels a tick).  Its plain version is
// repro_torch/kernels/ref.py:obs_tick; every output equals it to the bit.
//
// Arithmetic, as the reference's compiled tick rounds it on x86:
//   * the usage and the shaped demand are each summed over the slot
//     table's (A, C) in the order of XLA:CPU's compiled sum
//     (ref.py:xla_table_sum, read from the dumped LLVM IR and object
//     code): windows of 32 slots (the slot axis padded to a multiple of
//     32, the padding split between its ends, the odd one at the end;
//     32 slots or fewer one window), each summed by its kernel one of two
//     ways, then the window sums in order from the first, + 0, + the
//     next ...  Serial: 0 + the window's slots and their components in
//     order.  In VF lanes (C of 2 to 4 at the A that LLVM vectorised,
//     ref.py:xla_table_plan, passed in as `order`): lane l starts at 0
//     (l = 0) or -0 and adds slots l, l + VF, ... below nv, each slot's
//     components in order, the data or the lane the first operand by
//     component; a tree adds lane i + VF/2 to lane i, then i + VF/4, ...,
//     the higher or the lower lane first; slots nv..n-1 follow serially
//     (nv = VF floor((n - 1) / VF), or n where the loop is unrolled).
//     The gap is the demand's sum minus the usage's;
//   * the credit channel is the sum of credit * active over the tenants
//     in XLA's tree of 32-tenant windows (ref.py:xla_sum: each window in
//     order from its first term, then the windows' sums), divided by the
//     count of active tenants;
//   * subnormals as x86's denormals-are-zero and flush-to-zero give them,
//     and a NaN as x86 gives it: the first NaN operand of an add, a
//     product or a quotient, quieted, or x86's default NaN for inf - inf
//     (ref.py:add_xla, sub_xla, mul_xla, div_xla).
// The int channels are counts and counter deltas, exact in any order.
//
// Design: one block of kThreads a member, its warps each on one task
// from the start, one block barrier.  Warps 4-7 each take a window of
// XLA's tree: its first lane sets an mbarrier and has the Tensor Memory
// Accelerator copy the window's slots of the two (A, C, 2) tables into
// shared memory (cp.async.bulk, completing on the barrier; plain loads
// behind a block barrier where a window's rows are not 16-byte aligned,
// C odd), and as soon as they land two lanes, a table each, run its two
// resources' serial chains side by side over float4 reads (a window's
// 32 C adds, the floor of the kernel), or, where XLA's loop has lanes,
// lane t*16 + r*8 + l runs table t's resource r's lane l, the warp's
// shuffles make the tree and lane l = 0 adds the tail.  Meanwhile warp 0
// loads the cursor, the counters and the tenant state, a lane each, counts the
// queue and the admissions a word of four apps a lane, and forms the
// deltas and the credit mean (its tree over T by the lanes, a shuffle a
// term); warps 1-3 copy the member's rings to the outputs, 16 bytes a
// lane, every load of a thread before its stores.  After the barrier
// warp 0 adds the windows and writes the column.  The tables are copied
// and summed before the member's active flag is known (an inactive
// member's sums go unused), so that no load stands before the copies.
// What bounds it: the bytes of one read of the two tables and the rings
// and one write of the rings (~39 KB a member at the main path's widths,
// A = 128 slots of C = 12 components, N = 500 apps, R = 128); at these
// sizes a launch is latency, the longest chain being a window's 384
// dependent adds.  On an NVIDIA H100 at those widths a launch takes
// 3.8 us, about 6,300 cycles, ~2,600 of them a window's chain.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_fma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChainWarp0 = 4;                  // warps 4-7: the windows' chains
constexpr int kChainWarps = kThreads / 32 - kChainWarp0;
constexpr int kWindow = xla::kWindow;
constexpr int kMaxWindows = 32;                 // A <= 1024
constexpr int kF32 = 5, kI32 = 8;
constexpr int kBatch = 8;                       // float4s a chain reads ahead
// floats after each staged window: a chain's batch read ahead, and 4 more
// so that windows 32 C + kPad floats apart sit 4 banks apart
constexpr int kPad = 4 * kBatch + 4;
constexpr int kMaxSmem = 47 * 1024;             // dynamic: 48 KB less the static tables
constexpr unsigned kFull = 0xffffffffu;

using xla::Windows;

// ---- the mbarrier and the bulk copy (PTX) ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
// Returns once the barrier's first phase completed.  The copies are this
// block's own, so a wait past 2^26 polls is a fault: trap, and the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

struct Args {
  const int* cursor; const float* f32; const int* i32; const int* lead_ring;   // lead_ring or null
  const uint8_t* active; const float* usage; const float* demand;             // demand or null
  const uint8_t* queued; const uint8_t* q_admit;
  const int* cnt[4]; const int* cnt0[4];
  const float* credit; const int* throttled; const int* active_ticks;         // or null
  const int* throttled0; const int* active_ticks0;
  const int* resolved; const int* errors; const int* resolved0; const int* errors0;  // or null
  const int* lead;                                                            // or null
  int* o_cursor; float* o_f32; int* o_i32; int* o_lead_ring;
  int A, C, N, T, R;
  int order;   // XLA's loop over a window (xla_table_plan): see window_lanes
};

// floats a staged window takes: 32 slots of C components of 2, and kPad
__device__ __host__ __forceinline__ int window_floats(int C) { return kWindow * C * 2 + kPad; }

// n words from src to dst by threads [0, nt) of the block (tid among them),
// 16 bytes a load where both are aligned, each thread's loads issued
// before its stores
__device__ __forceinline__ void copy_words(int* dst, const int* src, int n, int tid, int nt) {
  constexpr int kLoads = 8;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n / 4;
    for (int i0 = tid; i0 < n4; i0 += kLoads * nt) {
      int4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        if (i0 + k * nt < n4) v[k] = reinterpret_cast<const int4*>(src)[i0 + k * nt];
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        if (i0 + k * nt < n4) reinterpret_cast<int4*>(dst)[i0 + k * nt] = v[k];
    }
    for (int i = 4 * n4 + tid; i < n; i += nt) dst[i] = src[i];
  } else {
    for (int i = tid; i < n; i += nt) dst[i] = src[i];
  }
}

// Warp 0's channels: the cursor, the counters' deltas, the tenants' and
// the queue's
struct Tail {
  int cursor, lead, oom, fail, preempt, throttled, res, err, queue, admitted;
  float credit;
};

__device__ __forceinline__ Tail tail(const Args& p, int s, int lane) {
  // a lane a value: 0 the cursor, 1-4 the counters, 5-8 at entry, 9-12
  // the calibration's now and at entry, 13 the lead
  int v = 0;
  if (lane == 0) v = p.cursor[s];
  else if (lane <= 4) v = p.cnt[lane - 1][s];
  else if (lane <= 8) v = p.cnt0[lane - 5][s];
  else if (lane <= 12 && p.resolved)
    v = (lane == 9 ? p.resolved : lane == 10 ? p.errors : lane == 11 ? p.resolved0 : p.errors0)[s];
  else if (lane == 13 && p.lead) v = p.lead[s];
  // the queue and the admissions (apps that left the queue), a word of four
  // apps a lane where the rows allow
  const size_t sn = static_cast<size_t>(s) * p.N;
  const uint8_t* q = p.queued + sn;
  const uint8_t* qa = p.q_admit + sn;
  int nq = 0, na = 0;
  if (p.N % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(qa)) & 3) == 0) {
    for (int i = lane; i < p.N / 4; i += 32) {
      const unsigned wq = reinterpret_cast<const unsigned*>(q)[i];
      const unsigned wa = reinterpret_cast<const unsigned*>(qa)[i];
      nq += __popc(wq);
      na += __popc(wa & ~wq & 0x01010101u);
    }
  } else {
    for (int n = lane; n < p.N; n += 32) {
      nq += q[n];
      na += qa[n] && !q[n];
    }
  }
  Tail o;
  const auto at = [&](int k) { return __shfl_sync(kFull, v, k); };
  o.cursor = at(0);
  o.lead = at(13);
  o.oom = at(1) - at(5);
  o.fail = at(2) - at(6);
  o.preempt = at(3) + at(4) - at(7) - at(8);
  o.res = at(9) - at(11);
  o.err = at(10) - at(12);
  o.queue = __reduce_add_sync(kFull, nq);
  o.admitted = __reduce_add_sync(kFull, na);
  o.throttled = 0;
  o.credit = 0.f;
  if (!p.credit) return o;
  const int T = p.T;
  const size_t st = static_cast<size_t>(s) * T;
  const Windows tw(T);
  // lane t's tenants t, t + 32, ...: the counts, and where T <= 32 its term
  // credit * active in a register
  int n = 0, thr = 0;
  float x = 0.f;
  for (int t = lane; t < max(T, 32); t += 32) {
    const bool in = t < T;
    const int at1 = in ? p.active_ticks[st + t] : 0, at0 = in ? p.active_ticks0[st + t] : 0;
    const float c = in ? p.credit[st + t] : 0.f;
    thr += in ? p.throttled[st + t] - p.throttled0[st + t] : 0;
    n += at1 > at0;
    if (T <= kWindow) x = xla::mul(c, at1 > at0 ? 1.f : 0.f);
  }
  o.throttled = __reduce_add_sync(kFull, thr);
  n = __reduce_add_sync(kFull, n);
  float sum;
  if (T <= kWindow) {
    sum = xla::fold([&](auto add) {
      float a = __shfl_sync(kFull, x, 0);
      for (int u = 1; u < T; ++u) a = add(a, __shfl_sync(kFull, x, u));
      return make_float2(a, 0.f);
    }).x;
  } else {              // lane w: window w of the tenants, then the windows
    const auto term = [&](int t) {
      return xla::mul(p.credit[st + t],
                      p.active_ticks[st + t] > p.active_ticks0[st + t] ? 1.f : 0.f);
    };
    float ws = 0.f;
    if (lane < tw.count)
      ws = xla::fold([&](auto add) {
        const int j0 = tw.first(lane), j1 = tw.end(lane, T);
        float a = term(j0);
        for (int j = j0 + 1; j < j1; ++j) a = add(a, term(j));
        return make_float2(a, 0.f);
      }).x;
    sum = xla::fold([&](auto add) {
      float a = __shfl_sync(kFull, ws, 0);
      for (int w = 1; w < tw.count; ++w) a = add(a, __shfl_sync(kFull, ws, w));
      return make_float2(a, 0.f);
    }).x;
  }
  o.credit = n > 0 ? xla::div(sum, static_cast<float>(n)) : 0.f;
  return o;
}

// A window's serial chain over staged floats x: 0 + n units of (cpu, mem)
// pairs in order (one unit, at A = C = 1, as it is).  With n even the fast
// path reads float4s, a batch of kBatch ahead of the adds, whole batches
// without a branch (the reads ahead unconditional: a staged window has
// kBatch float4s of padding after it); a NaN at its end, or n odd, takes
// the plain chain, with x86's adds where the fast one ended in a NaN.
__device__ __forceinline__ float2 chain(const float* x, int n) {
  if (n == 1) return make_float2(x[0], x[1]);   // A = C = 1: XLA drops the reduce
  const auto plain = [&](auto add) {
    float2 a = make_float2(0.f, 0.f);
    for (int j = 0; j < n; ++j) a = make_float2(add(a.x, x[2 * j]), add(a.y, x[2 * j + 1]));
    return a;
  };
  if (n % 2 == 1) return xla::fold(plain);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int n4 = n / 2;
  const auto add2 = [](float2 a, float4 v) {
    return make_float2(xla::add_ftz(xla::add_ftz(a.x, v.x), v.z),
                       xla::add_ftz(xla::add_ftz(a.y, v.y), v.w));
  };
  float2 a = add2(make_float2(0.f, 0.f), x4[0]);
  int i = 1;                // whole batches without a condition, then the rest
  float4 cur[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) cur[k] = x4[i + k];
  for (; i + kBatch <= n4; i += kBatch) {
    float4 nxt[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) nxt[k] = x4[i + kBatch + k];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) a = add2(a, cur[k]);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) cur[k] = nxt[k];
  }
  for (; i < n4; ++i) a = add2(a, x4[i]);
  if (a.x != a.x || a.y != a.y) a = plain(xla::AddX86{});
  return a;
}

// A window of n slots summed in XLA's VF lanes (order = VF | unrolled << 4
// | the tree's higher lane first << 5 | data first by component << 8,
// ref.py:xla_table_plan and XLA_LANE_ORDER): lane t*16 + r*8 + l of the
// warp runs lane l of table t's resource r over the staged windows x0
// and x1 (slot j's component c of resource r at (j C + c) 2 + r), the
// shuffles reduce each group of lanes in the tree, and lane l = 0 adds
// the slots past nv; it returns the window's sum there.
__device__ __forceinline__ float window_lanes(const float* x0, const float* x1, int ntab,
                                             int n, int C, int order, int lane) {
  const int vf = order & 15, t = lane >> 4, r = (lane >> 3) & 1, l = lane & 7;
  const bool on = t < ntab && l < vf;
  const float* x = t ? x1 : x0;
  const int nv = order & 16 ? n : (n - 1) / vf * vf;
  float a = l == 0 ? 0.f : -0.f;
  if (on)
    for (int j = l; j < nv; j += vf)
      for (int c = 0; c < C; ++c) {
        const float v = x[(j * C + c) * 2 + r];
        a = order >> (8 + c) & 1 ? xla::add(v, a) : xla::add(a, v);
      }
  for (int h = vf >> 1; h > 0; h >>= 1) {          // lane l takes lane l + h
    const float hi = __shfl_down_sync(kFull, a, h);
    if (l < h) a = order & 32 ? xla::add(hi, a) : xla::add(a, hi);
  }
  if (on && l == 0)
    for (int k = nv * C; k < n * C; ++k) a = xla::add(a, x[2 * k + r]);
  return a;
}

__global__ void __launch_bounds__(kThreads) obs_tick_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t s_bar[kMaxWindows];
  __shared__ float s_part[2][2][kMaxWindows];    // [table][resource][window]
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.R, A = p.A, C = p.C;
  const int ntab = p.demand ? 2 : 1;
  const Windows win(A);
  const int wf = window_floats(C);
  // phase: staging
  const bool on = p.active[s];
  const bool bulk = C % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(p.usage) | reinterpret_cast<uintptr_t>(p.demand)) & 15) == 0;
  const size_t tab0 = static_cast<size_t>(s) * A * C * 2;
  if (!bulk) {                        // rows not 16-byte aligned: plain loads
    for (int w = 0; w < win.count; ++w) {
      const int a0 = win.first(w), n = (win.end(w, A) - a0) * C * 2;
      for (int t = 0; t < ntab; ++t)
        for (int j = tid; j < n; j += kThreads)
          smem[(w * ntab + t) * wf + j] = (t ? p.demand : p.usage)[tab0 + a0 * C * 2 + j];
    }
    __syncthreads();
  }
  Tail o{};
  if (warp >= kChainWarp0) {
    // a warp's windows: its first lane sets their barriers and has the
    // Tensor Memory Accelerator copy both tables' slots of each
    const int w0 = warp - kChainWarp0;
    if (bulk && lane == 0) {
      for (int w = w0; w < win.count; w += kChainWarps) mbar_init(&s_bar[w]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int w = w0; w < win.count; w += kChainWarps) {
        const int a0 = win.first(w), a1 = win.end(w, A);
        const uint32_t bytes = (a1 - a0) * C * 2 * 4;
        mbar_expect_tx(&s_bar[w], ntab * bytes);
        for (int t = 0; t < ntab; ++t)
          bulk_copy(smem + (w * ntab + t) * wf, (t ? p.demand : p.usage) + tab0 + a0 * C * 2,
                    bytes, &s_bar[w]);
      }
    }
    __syncwarp();
    // phase: chains
    if (p.order & 15) {               // XLA's lanes: the whole warp a window
      for (int w = w0; w < win.count; w += kChainWarps) {
        if (bulk) mbar_wait(&s_bar[w]);
        const float* x0 = smem + w * ntab * wf;
        const float sum = window_lanes(x0, x0 + wf, ntab, win.end(w, A) - win.first(w), C,
                                       p.order, lane);
        if ((lane & 7) == 0 && lane >> 4 < ntab) s_part[lane >> 4][(lane >> 3) & 1][w] = sum;
      }
    } else if (lane < ntab) {         // lane t: table t, both resources
      for (int w = w0; w < win.count; w += kChainWarps) {
        if (bulk) mbar_wait(&s_bar[w]);
        // phase: landed
        const float2 sum = chain(smem + (w * ntab + lane) * wf,
                                 (win.end(w, A) - win.first(w)) * C);
        s_part[lane][0][w] = sum.x;
        s_part[lane][1][w] = sum.y;
      }
    }
    // phase: chains done
  } else if (warp == 0) {
    // phase: tail
    o = tail(p, s, lane);
    // phase: tail done
  } else {
    // phase: ring copy
    const int nt = 32 * (kChainWarp0 - 1), t = tid - 32;
    copy_words(reinterpret_cast<int*>(p.o_f32) + static_cast<size_t>(s) * kF32 * R,
               reinterpret_cast<const int*>(p.f32) + static_cast<size_t>(s) * kF32 * R,
               kF32 * R, t, nt);
    copy_words(p.o_i32 + static_cast<size_t>(s) * kI32 * R,
               p.i32 + static_cast<size_t>(s) * kI32 * R, kI32 * R, t, nt);
    if (p.lead_ring)
      copy_words(p.o_lead_ring + static_cast<size_t>(s) * R,
                 p.lead_ring + static_cast<size_t>(s) * R, R, t, nt);
    // phase: ring copy done
  }
  __syncthreads();
  if (warp != 0) return;
  // phase: writes
  if (!on) {
    if (lane == 0) p.o_cursor[s] = o.cursor;
    return;
  }
  // lanes 0-3: (table, resource)'s windows in order, w0 + 0 + w1 + ...
  // (one window: its sum)
  float total = 0.f;
  const int t = lane >> 1, r = lane & 1;
  if (lane < 2 * ntab)
    total = win.count == 1 ? s_part[t][r][0] : xla::fold([&](auto add) {
      float a = add(s_part[t][r][0], 0.f);
      for (int w = 1; w < win.count; ++w) a = add(a, s_part[t][r][w]);
      return make_float2(a, 0.f);
    }).x;
  const float u0 = __shfl_sync(kFull, total, 0), u1 = __shfl_sync(kFull, total, 1);
  const float d0 = __shfl_sync(kFull, total, 2), d1 = __shfl_sync(kFull, total, 3);
  // phase: summed
  // a lane a channel, each lane one store: lanes 0-4 the float ones, 8-15
  // the int ones, 16 the lead, 17 the cursor
  const int col = o.cursor % R;
  const bool gap = p.demand != nullptr;
  const float g0 = gap ? xla::sub(d0, u0) : 0.f, g1 = gap ? xla::sub(d1, u1) : 0.f;
  const float fv = lane == 0 ? u0 : lane == 1 ? u1 : lane == 2 ? g0 : lane == 3 ? g1 : o.credit;
  const int k = lane - 8;
  const int iv = k == 0 ? o.queue : k == 1 ? o.oom : k == 2 ? o.fail : k == 3 ? o.preempt
               : k == 4 ? o.admitted : k == 5 ? o.throttled : k == 6 ? o.res : o.err;
  float* fd = p.o_f32 + (static_cast<size_t>(s) * kF32 + min(lane, kF32 - 1)) * R + col;
  int* id = p.o_i32 + (static_cast<size_t>(s) * kI32 + min(max(k, 0), kI32 - 1)) * R + col;
  if (lane < kF32) *fd = fv;
  if (k >= 0 && k < kI32) *id = iv;
  if (lane == 16 && p.lead_ring) p.o_lead_ring[static_cast<size_t>(s) * R + col] = o.lead;
  if (lane == 17) p.o_cursor[s] = o.cursor + 1;
  // phase: end
}

}  // namespace

// The dynamic shared memory obs_tick_kernel takes: each window of XLA's
// tree of each table staged, window_floats(C) floats apart.
extern "C" size_t obs_tick_smem(int A, int C, int ntab) {
  return static_cast<size_t>(Windows(A).count) * ntab * window_floats(C) * sizeof(float);
}

// The rings: cursor (S,) i32, f32 (S, 5, R), i32 (S, 8, R), lead_ring (S,
// R) i32 or null; active (S,) bool; usage and demand (S, A, C, 2) f32
// (demand null under the baseline policy); queued and q_admit (S, N)
// bool; the counters oom_kills, failure_events, full_preemptions,
// partial_preemptions (S,) i32 now (cnt*) and at the tick's entry
// (cnt0*); the tenancy's credit (S, T) f32, throttled and active_ticks
// (S, T) i32 after the control step and before it (all null without the
// control plane); the calibration's resolved and errors (S,) i32 now and
// at entry (null without calibration); lead (S,) i32 or null; order,
// XLA's loop over a window of the tables' sums (0 serial, else VF | the
// loop unrolled << 4 | the tree's higher lane first << 5 | data first by
// component << 8; ref.py:xla_table_plan).  Outputs: the rings.  A <= 1024
// and C <= 32 (the tree has one level of windows that span whole slots),
// lanes only at C <= 4, T <= 1024, and obs_tick_smem within 47 KB.
extern "C" int obs_tick(
    const void* cursor, const void* f32, const void* i32, const void* lead_ring,
    const void* active, const void* usage, const void* demand, const void* queued,
    const void* q_admit, const void* oom, const void* fail, const void* full,
    const void* part, const void* oom0, const void* fail0, const void* full0,
    const void* part0, const void* credit, const void* throttled, const void* active_ticks,
    const void* throttled0, const void* active_ticks0, const void* resolved,
    const void* errors, const void* resolved0, const void* errors0, const void* lead,
    void* o_cursor, void* o_f32, void* o_i32, void* o_lead_ring, int S, int A, int C, int N,
    int T, int R, int order, void* stream) {
  if (S <= 0 || A <= 0 || A > 1024 || C <= 0 || C > 32 || N < 0 || R <= 0 || T < 0 ||
      T > 1024 || (credit == nullptr) != (T == 0) || (resolved == nullptr) != (errors == nullptr) ||
      (lead_ring == nullptr) != (o_lead_ring == nullptr) ||
      ((order & 15) && ((order & 15) > 8 || C > 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto I = [](const void* x) { return static_cast<const int*>(x); };
  Args p{I(cursor), static_cast<const float*>(f32), I(i32), I(lead_ring),
         static_cast<const uint8_t*>(active), static_cast<const float*>(usage),
         static_cast<const float*>(demand), static_cast<const uint8_t*>(queued),
         static_cast<const uint8_t*>(q_admit), {I(oom), I(fail), I(full), I(part)},
         {I(oom0), I(fail0), I(full0), I(part0)}, static_cast<const float*>(credit),
         I(throttled), I(active_ticks), I(throttled0), I(active_ticks0), I(resolved), I(errors),
         I(resolved0), I(errors0), I(lead), static_cast<int*>(o_cursor),
         static_cast<float*>(o_f32), static_cast<int*>(o_i32), static_cast<int*>(o_lead_ring),
         A, C, N, T, R, order};
  const size_t smem = obs_tick_smem(A, C, demand ? 2 : 1);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  obs_tick_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
