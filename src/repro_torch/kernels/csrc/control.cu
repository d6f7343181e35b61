// The control plane's step of a device-engine tick, one launch for every
// member of a batch: the tenant credit, the weighted dominant-resource
// (wDRF) shares, the admission gate and the tenant counters.
//
// Replaces: XLA code of the reference, not a Pallas kernel: the control
// step of its fused tick (repro/sim/step.py:778-887: _tenant_counts,
// credit_step, dominant_shares, gate_mask and the counter updates, some
// thirty operations that PyTorch would run as several dozen small
// kernels a tick).  Its plain version is
// repro_torch/kernels/ref.py:control_tick; every output equals it to the
// bit.
//
// Arithmetic, as the reference's compiled tick rounds it on x86:
//   * the credit step credit + gamma * (target - credit) and the gate's
//     mean + slack * credit are contracted by XLA:CPU into fused
//     multiply-adds (xla_fma.cuh), rounded once;
//   * a division by a constant becomes a product by its reciprocal: the
//     shares are max_r(alloc_r * (1 / max(cap_r, 1e-9))) * (1 / weight),
//     the reciprocals rounded to float32 first;
//   * each tenant's allocation is summed over a slot's components in
//     order, then over the slots in XLA:CPU's tree of 32-wide windows
//     (ref.py:xla_sum), a slot of another tenant adding +0; the hosts'
//     capacities in order (the reference folds that sum of constants);
//     the gate's mean over the tenants of share * active in the same
//     tree, then divided by their count;
//   * subnormals as x86's denormals-are-zero and flush-to-zero give them,
//     and a NaN as x86 gives it: the first NaN operand of an add, a
//     product or a quotient, quieted, or x86's default NaN for inf - inf
//     (ref.py:add_xla, mul_xla, div_xla); the max of the two resources'
//     shares a select (ref.py:fmax).
//
// Design: one block of kThreads a member, no shared-memory atomics where
// T <= 32, one block barrier.  Every independent load of the member is
// issued at the start.  Warps 0-3 take the slot table, a warp a window of
// XLA's 32 slots and a lane a slot, which loads its slot_gid and its 2 C
// allocation floats (16 bytes a load where C is even) into registers,
// then its tenant (the one dependent load); a slot lane sums its
// components, the lanes of a window match their tenants
// (__match_any_sync) and the lowest lane of each tenant sums that
// tenant's slots of the window in slot order, a gap (a slot of another
// tenant, an empty one) adding +0, which only turns -0 into +0: a chain as
// long as the tenant's slots, not the window.  Warp 4 takes every app,
// four a chunk and four chunks a lane a round (their tenant ids 16 bytes
// a load, each byte mask a word, where N % 4 == 0), all loaded before it
// counts each tenant's completions, failures and queued apps, packed in
// one word, by one warp reduction a tenant (T <= 32; above, a
// __match_any_sync group a tenant and one shared add); its lane t then
// steps tenant t's credit and writes its event counters.  Warp 5 stages
// the hosts' capacities and its first lane sums them.  After the barrier
// warp 0 alone finishes (T <= 32): a lane a tenant sums its windows,
// forms its share, the active shares' mean is a chain of shuffles, and
// the gate and its counters follow; above 32 tenants the block finishes
// in three steps.  What bounds it: the bytes of one read of the member's
// app columns and slot table (~15 KB a member at the main path's widths,
// N = 500 apps, A = 128 slots of C = 12 components); at these sizes a
// launch is latency: two rounds of loads, then a warp's short chains.  On
// an NVIDIA H100 at those widths it takes 3.3-3.4 us, about 6,000 cycles,
// ~3,900 of them until the barrier.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_fma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlotWarps = 4;                   // warps 0-3: the slot table
constexpr int kWindow = xla::kWindow;
constexpr int kMaxC = 32;                       // components a slot
constexpr int kVoteT = 32;                      // tenants counted by warp votes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAppWarp = 4;                     // the apps' warp
constexpr int kCapWarp = 5;                     // the capacities' warp
constexpr int kAppChunks = 4;                   // chunks of 4 apps a lane a round
constexpr int kCapRegs = 2;                     // hosts' capacities a lane holds

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a >= b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a <= b || a != a) ? a : b;
}
using xla::Windows;

struct Args {
  const float* credit; const int* throttled; const int* completed; const int* failed;
  const float* share_sum; const int* active_ticks;
  const uint8_t* done0; const uint8_t* done; const uint8_t* queued0; const uint8_t* queued;
  const uint8_t* conflict;                  // or null
  const int* d_res; const int* d_err;       // or null
  const int* tenant; const int* slot_gid; const float* alloc; const float* cap;
  const float* weights;
  float* o_credit; int* o_throttled; int* o_completed; int* o_failed; float* o_share_sum;
  int* o_active_ticks; uint8_t* o_elig;
  int T, N, A, C, H, credit_on, gate_on;
  float gamma, floor, slack;
};

// A tenant's share from its allocation summed over the slots (a0, a1), the
// capacities' reciprocals and its weight's, rw.
__device__ __forceinline__ float share_of(float a0, float a1, float r0, float r1, float rw) {
  return xla::mul(xla::fmax(xla::mul(a0, r0), xla::mul(a1, r1)), rw);
}

// A tenant's credit after the tick's events.
__device__ __forceinline__ float stepped(const Args& p, float credit, int comp, int fail,
                                         int d_res, int d_err) {
  if (!p.credit_on) return credit;
  const int good = comp + d_res - d_err, bad = fail + d_err;
  const float g = static_cast<float>(good), tot = __fadd_rn(g, static_cast<float>(bad));
  const float target = tot > 0.f ? __fdiv_rn(g, max_nan(tot, 1.f)) : credit;
  return min_nan(max_nan(xla::fma_f32(p.gamma, __fsub_rn(target, credit), credit), p.floor),
                 1.f);
}

// Tenant i's gate and the counters it moves, from its stepped credit c.
__device__ __forceinline__ void gate(const Args& p, size_t i, float c, float share, bool active,
                                     float counted, float mean, int queued, int throttled,
                                     float share_sum, int active_ticks) {
  const float bound = p.credit_on ? xla::fma_f32(p.slack, c, mean) : xla::add(mean, p.slack);
  const bool elig = !(p.gate_on && active) || share <= bound;
  p.o_throttled[i] = throttled + (elig ? 0 : queued);
  p.o_share_sum[i] = xla::add(share_sum, counted);
  p.o_active_ticks[i] = active_ticks + active;
  p.o_elig[i] = elig;
}

// Warps 0 .. kSlotWarps - 1: window w of the member's slots, a lane a
// slot; each tenant's sum over the window's slots into part[w][r][t] (+0
// for a tenant without a slot there).
__device__ __forceinline__ void slot_windows(const Args& p, int s, int warp, int lane,
                                             float2* rows, float* part) {
  const int A = p.A, C = p.C, T = p.T;
  const Windows win(A);
  const bool vec4 = C % 2 == 0 && (reinterpret_cast<uintptr_t>(p.alloc) & 15) == 0;
  for (int w = warp; w < win.count; w += kSlotWarps) {
    const int a = w * kWindow + lane - win.lo, k0 = win.first(w) - (w * kWindow - win.lo);
    const int k1 = win.end(w, A) - (w * kWindow - win.lo);   // the window's lanes [k0, k1)
    const bool valid = lane >= k0 && lane < k1;
    // the slot: its app and its components, in one round of loads
    int gid = -1;
    float2 v[kMaxC];
    if (valid) {
      gid = p.slot_gid[static_cast<size_t>(s) * A + a];
      const float* row = p.alloc + (static_cast<size_t>(s) * A + a) * C * 2;
      if (vec4) {
#pragma unroll
        for (int k = 0; k < kMaxC / 2; ++k)
          if (2 * k < C) {
            const float4 q = reinterpret_cast<const float4*>(row)[k];
            v[2 * k] = make_float2(q.x, q.y);
            v[2 * k + 1] = make_float2(q.z, q.w);
          }
      } else {
#pragma unroll
        for (int k = 0; k < kMaxC; ++k)
          if (k < C) v[k] = reinterpret_cast<const float2*>(row)[k];
      }
    }
    const int t = gid >= 0 && gid < p.N ? p.tenant[static_cast<size_t>(s) * p.N + gid] : -1;
    // phase: windows
    if (valid) {
      rows[a] = xla::fold([&](auto add) {
        float2 r = v[0];
#pragma unroll
        for (int k = 1; k < kMaxC; ++k)
          if (k < C) r = make_float2(add(r.x, v[k].x), add(r.y, v[k].y));
        return r;
      });
    }
    // +0 for every tenant, then each tenant's lowest lane writes its sums
    for (int u = lane; u < T; u += 32) {
      part[(2 * w) * T + u] = 0.f;
      part[(2 * w + 1) * T + u] = 0.f;
    }
    const int own = valid ? (t >= 0 && t < T ? t : -1) : -2;
    const unsigned group = __match_any_sync(kFull, own);
    __syncwarp();
    if (own < 0 || lane != __ffs(group) - 1) continue;
    const float2* wr = rows + (w * kWindow - win.lo);        // lane k's slot
    const float2 sum = xla::fold([&](auto add) {
      unsigned m = group & (group - 1);
      float2 r = wr[lane];
      if (lane > k0) r = make_float2(add(0.f, r.x), add(0.f, r.y));   // after a gap
      int prev = lane;
      while (m) {
        const int k = __ffs(m) - 1;
        m &= m - 1;
        if (k > prev + 1) r = make_float2(add(r.x, 0.f), add(r.y, 0.f));
        r = make_float2(add(r.x, wr[k].x), add(r.y, wr[k].y));
        prev = k;
      }
      if (prev < k1 - 1) r = make_float2(add(r.x, 0.f), add(r.y, 0.f));
      return r;
    });
    part[(2 * w) * T + own] = sum.x;
    part[(2 * w + 1) * T + own] = sum.y;
  }
}

// An app's tenant and its events: completed, failed (0, 1 or 2) and queued
// packed in fields of 10, 11 and 10 bits (a round of the warp's 512 apps
// fits them: up to 512, 1,024 and 512).
struct App {
  int t;
  unsigned packed;
};

// the apps' columns 16 and 4 bytes a load: N % 4 == 0 and aligned rows
__device__ __forceinline__ bool apps_aligned(const Args& p) {
  const uintptr_t bytes = reinterpret_cast<uintptr_t>(p.done0) |
      reinterpret_cast<uintptr_t>(p.done) | reinterpret_cast<uintptr_t>(p.queued0) |
      reinterpret_cast<uintptr_t>(p.queued) | reinterpret_cast<uintptr_t>(p.conflict);
  return p.N % 4 == 0 && (reinterpret_cast<uintptr_t>(p.tenant) & 15) == 0 && (bytes & 3) == 0;
}

// Chunk i's four apps as loaded: tenant ids, and the masks' bytes in words
// (done0, done, queued0, queued, conflict).  Every load of a round is
// issued before any is read (unpack).
struct Chunk {
  int4 t;
  unsigned m[5];
};

__device__ __forceinline__ Chunk load_chunk(const Args& p, int s, int i, bool aligned) {
  const size_t sn = static_cast<size_t>(s) * p.N;
  const int n0 = 4 * i;
  const uint8_t* masks[5] = {p.done0, p.done, p.queued0, p.queued, p.conflict};
  Chunk c;
  if (aligned) {
    c.t = *reinterpret_cast<const int4*>(p.tenant + sn + n0);
#pragma unroll
    for (int k = 0; k < 5; ++k)
      c.m[k] = masks[k] ? *reinterpret_cast<const unsigned*>(masks[k] + sn + n0) : 0u;
  } else {
    int t[4];
    unsigned b[5][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = n0 + j < p.N;
      t[j] = in ? p.tenant[sn + n0 + j] : -1;
#pragma unroll
      for (int k = 0; k < 5; ++k) b[k][j] = in && masks[k] ? masks[k][sn + n0 + j] : 0u;
    }
    c.t = make_int4(t[0], t[1], t[2], t[3]);
#pragma unroll
    for (int k = 0; k < 5; ++k) c.m[k] = b[k][0] | b[k][1] << 8 | b[k][2] << 16 | b[k][3] << 24;
  }
  return c;
}

__device__ __forceinline__ void unpack(const Chunk& c, int T, App (&app)[4]) {
  const int t[4] = {c.t.x, c.t.y, c.t.z, c.t.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned d0 = c.m[0] >> 8 * j & 1u, d = c.m[1] >> 8 * j & 1u;
    const unsigned q0 = c.m[2] >> 8 * j & 1u, q = c.m[3] >> 8 * j & 1u;
    const unsigned x = c.m[4] >> 8 * j & 1u;
    app[j].t = t[j] >= 0 && t[j] < T ? t[j] : -1;   // one-hot: other ids count for none
    app[j].packed = (d & ~d0) | ((q & ~q0) + x) << 10 | q << 21;
  }
}

__device__ __forceinline__ int3 fields(unsigned x) {
  return make_int3(x & 1023u, x >> 10 & 2047u, x >> 21 & 1023u);
}

__global__ void __launch_bounds__(kThreads) control_tick_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.T, nw = Windows(p.A).count;
  const bool votes = T <= kVoteT;
  float2* rows = reinterpret_cast<float2*>(smem);                // [A] a slot's (cpu, mem)
  float* part = reinterpret_cast<float*>(rows + p.A);            // [nw][2][T] window sums
  float2* caps = reinterpret_cast<float2*>(part + 2 * nw * T);   // [32 kCapRegs] hosts'
  float* credit_t = reinterpret_cast<float*>(caps + 32 * kCapRegs);   // [T] stepped credit
  int* queued_t = reinterpret_cast<int*>(credit_t + T);          // [T] queued apps
  int* cnt = queued_t + T;                                       // T > 32: [3][T] counts
  float* shares = reinterpret_cast<float*>(cnt + (votes ? 0 : 3 * T));   // T > 32: [T]
  float* counted = shares + (votes ? 0 : T);                     // T > 32: [T]
  uint8_t* active_t = reinterpret_cast<uint8_t*>(counted + (votes ? 0 : T));   // T > 32: [T]
  __shared__ float s_rcap[2], s_mean;
  const size_t st = static_cast<size_t>(s) * T;

  // phase: staging
  if (!votes) {
    for (int i = tid; i < 3 * T; i += kThreads) cnt[i] = 0;
    __syncthreads();
  }
  // warp 0's lane t (T <= 32): tenant t's state that the last step reads
  float share_sum = 0.f, rw = 0.f;
  int throttled = 0, active_ticks = 0;
  // phase: slots and apps
  if (warp < kSlotWarps) {
    float weight = 1.f;
    if (votes && warp == 0 && lane < T) {
      share_sum = p.share_sum[st + lane];
      throttled = p.throttled[st + lane];
      active_ticks = p.active_ticks[st + lane];
      weight = p.weights[lane];
    }
    slot_windows(p, s, warp, lane, rows, part);
    rw = __fdiv_rn(1.f, weight);
    // phase: slots done
  } else if (warp == kAppWarp) {
    // lane t (T <= 32): tenant t's credit step and event counters
    float credit = 0.f;
    int completed = 0, failed = 0, d_res = 0, d_err = 0;
    if (votes && lane < T) {
      credit = p.credit[st + lane];
      completed = p.completed[st + lane];
      failed = p.failed[st + lane];
      if (p.d_res) {
        d_res = p.d_res[st + lane];
        d_err = p.d_err[st + lane];
      }
    }
    const bool aligned = apps_aligned(p);
    const int chunks = (p.N + 3) / 4;
    int3 mine = make_int3(0, 0, 0);      // votes: lane u's tenant u's counts
    for (int c0 = 0; c0 < chunks; c0 += 32 * kAppChunks) {
      Chunk raw[kAppChunks];             // every load of a round before its counts
#pragma unroll
      for (int k = 0; k < kAppChunks; ++k) {
        const int i = c0 + 32 * k + lane;
        raw[k] = i < chunks ? load_chunk(p, s, i, aligned)
                            : Chunk{make_int4(-1, -1, -1, -1), {0u, 0u, 0u, 0u, 0u}};
      }
      App app[kAppChunks][4];
#pragma unroll
      for (int k = 0; k < kAppChunks; ++k) unpack(raw[k], T, app[k]);
      if (votes) {
        for (int u = 0; u < T; ++u) {
          unsigned x = 0;
#pragma unroll
          for (int k = 0; k < kAppChunks; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) x += app[k][j].t == u ? app[k][j].packed : 0u;
          x = __reduce_add_sync(kFull, x);
          if (lane == u) {
            const int3 f = fields(x);
            mine = make_int3(mine.x + f.x, mine.y + f.y, mine.z + f.z);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kAppChunks; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const App a = app[k][j];
            const unsigned group = __match_any_sync(kFull, a.t);
            const int3 f = fields(a.packed);
            const int comp = __popc(group & __ballot_sync(kFull, f.x));
            const int fail = __popc(group & __ballot_sync(kFull, f.y & 1)) +
                             2 * __popc(group & __ballot_sync(kFull, f.y >> 1));
            const int queued = __popc(group & __ballot_sync(kFull, f.z));
            if (a.t >= 0 && lane == __ffs(group) - 1) {
              if (comp) atomicAdd(&cnt[a.t], comp);
              if (fail) atomicAdd(&cnt[T + a.t], fail);
              if (queued) atomicAdd(&cnt[2 * T + a.t], queued);
            }
          }
      }
    }
    if (votes && lane < T) {
      const float c = stepped(p, credit, mine.x, mine.y, d_res, d_err);
      credit_t[lane] = c;
      queued_t[lane] = mine.z;
      p.o_credit[st + lane] = c;
      p.o_completed[st + lane] = completed + mine.x;
      p.o_failed[st + lane] = failed + mine.y;
    }
    // phase: apps done
  } else if (warp == kCapWarp) {
    // phase: capacities
    // the first 32 kCapRegs hosts staged, then summed in order, as the
    // reference folds the constants
#pragma unroll
    for (int k = 0; k < kCapRegs; ++k) {
      const int h = 32 * k + lane;
      if (h < p.H) caps[h] = reinterpret_cast<const float2*>(p.cap)[h];
    }
    __syncwarp();
    if (lane == 0) {
      float2 c = caps[0];
      const int staged = min(p.H, 32 * kCapRegs);
#pragma unroll 8
      for (int h = 1; h < staged; ++h)
        c = make_float2(__fadd_rn(c.x, caps[h].x), __fadd_rn(c.y, caps[h].y));
      for (int h = staged; h < p.H; ++h) {
        const float2 x = reinterpret_cast<const float2*>(p.cap)[h];
        c = make_float2(__fadd_rn(c.x, x.x), __fadd_rn(c.y, x.y));
      }
      s_rcap[0] = __fdiv_rn(1.f, max_nan(c.x, 1e-9f));
      s_rcap[1] = __fdiv_rn(1.f, max_nan(c.y, 1e-9f));
    }
    // phase: capacities done
  }
  __syncthreads();
  // phase: final
  const float r0 = s_rcap[0], r1 = s_rcap[1];
  const auto windows = [&](int t) {      // tenant t's sums over the windows, in order
    return xla::fold([&](auto add) {
      float2 a = make_float2(part[t], part[T + t]);
      for (int w = 1; w < nw; ++w) a = make_float2(add(a.x, part[2 * w * T + t]),
                                                   add(a.y, part[(2 * w + 1) * T + t]));
      return a;
    });
  };
  if (votes) {            // warp 0: a lane a tenant, the mean by shuffles
    if (warp != 0) return;
    const int t = lane, tt = min(t, T - 1);    // every lane runs tenant tt's arithmetic
    const float2 a = windows(tt);
    const bool in = t < T;
    const float share = in ? share_of(a.x, a.y, r0, r1, rw) : 0.f;
    const int queued = in ? queued_t[tt] : 0;
    const float credit = credit_t[tt];
    const bool active = in && (share > 0.f || queued > 0);
    const float mine = xla::mul(share, active ? 1.f : 0.f);
    float mean = 0.f;
    // phase: mean
    if (p.gate_on) {
      const int n = __popc(__ballot_sync(kFull, active));
      const float sum = xla::fold([&](auto add) {
        float a = __shfl_sync(kFull, mine, 0);
        for (int u = 1; u < T; ++u) a = add(a, __shfl_sync(kFull, mine, u));
        return make_float2(a, 0.f);
      }).x;
      mean = n > 0 ? xla::div(sum, static_cast<float>(n)) : 0.f;
    }
    // phase: writes
    if (t < T)
      gate(p, st + t, credit, share, active, mine, mean, queued, throttled, share_sum,
           active_ticks);
    // phase: end
    return;
  }
  // more than 32 tenants: shares, then the mean in XLA's tree, then the rest
  for (int t = tid; t < T; t += kThreads) {
    const float2 a = windows(t);
    const float share = share_of(a.x, a.y, r0, r1, __fdiv_rn(1.f, p.weights[t]));
    const bool active = share > 0.f || cnt[2 * T + t] > 0;
    shares[t] = share;
    counted[t] = xla::mul(share, active ? 1.f : 0.f);
    active_t[t] = active;
  }
  __syncthreads();
  if (warp == 0 && p.gate_on) {
    const Windows tw(T);
    float wsum = 0.f;
    if (lane < tw.count)
      wsum = xla::fold([&](auto add) {
        const int j0 = tw.first(lane), j1 = tw.end(lane, T);
        float a = counted[j0];
        for (int j = j0 + 1; j < j1; ++j) a = add(a, counted[j]);
        return make_float2(a, 0.f);
      }).x;
    int n = 0;
    for (int t = lane; t < T; t += 32) n += active_t[t];
    n = __reduce_add_sync(kFull, n);
    const float sum = xla::fold([&](auto add) {
      float a = __shfl_sync(kFull, wsum, 0);
      for (int w = 1; w < tw.count; ++w) a = add(a, __shfl_sync(kFull, wsum, w));
      return make_float2(a, 0.f);
    }).x;
    if (lane == 0) s_mean = n > 0 ? xla::div(sum, static_cast<float>(n)) : 0.f;
  }
  __syncthreads();
  for (int t = tid; t < T; t += kThreads) {
    const size_t i = st + t;
    const int comp = cnt[t], fail = cnt[T + t];
    const float c = stepped(p, p.credit[i], comp, fail, p.d_res ? p.d_res[i] : 0,
                            p.d_err ? p.d_err[i] : 0);
    p.o_credit[i] = c;
    p.o_completed[i] = p.completed[i] + comp;
    p.o_failed[i] = p.failed[i] + fail;
    gate(p, i, c, shares[t], active_t[t], counted[t], p.gate_on ? s_mean : 0.f, cnt[2 * T + t],
         p.throttled[i], p.share_sum[i], p.active_ticks[i]);
  }
}

}  // namespace

// The shared memory control_tick_kernel carves: the slots' sums, the
// windows' sums per tenant, the staged capacities, the stepped credit and
// queued apps per tenant, and above 32 tenants the counts, the shares and
// the flags.
extern "C" size_t control_tick_smem(int T, int A) {
  const size_t nw = A > kWindow ? (A + kWindow - 1) / kWindow : 1;
  return 8 * size_t(A) + 4 * (2 * nw * T) + 8 * 32 * kCapRegs + 8 * size_t(T) +
         (T <= kVoteT ? 0 : 21 * size_t(T));
}

// The tenant state (S, T): credit, share_sum f32, throttled, completed,
// failed, active_ticks i32; the tick's events over the apps (S, N) bool:
// done0 and done (completions), queued0 and queued (OOM kills; queued is
// the queue at admission), conflict (or null); d_res and d_err (S, T)
// i32 the tick's conformal resolutions per tenant (or null); tenant (S,
// N) i32, slot_gid (S, A) i32, alloc (S, A, C, 2) f32, cap (H, 2) f32,
// weights (T,) f32.  Outputs: the state's six arrays and elig (S, T)
// bool.  T <= 1024, A <= 1024 (the sums' windows fit one level), C <= 32,
// and control_tick_smem(T, A) within 48 KB.
extern "C" int control_tick(
    const void* credit, const void* throttled, const void* completed, const void* failed,
    const void* share_sum, const void* active_ticks, const void* done0, const void* done,
    const void* queued0, const void* queued, const void* conflict, const void* d_res,
    const void* d_err, const void* tenant, const void* slot_gid, const void* alloc,
    const void* cap, const void* weights, void* o_credit, void* o_throttled,
    void* o_completed, void* o_failed, void* o_share_sum, void* o_active_ticks, void* o_elig,
    int S, int T, int N, int A, int C, int H, int credit_on, int gate_on, float gamma,
    float floor, float slack, void* stream) {
  if (S <= 0 || T <= 0 || T > 1024 || A <= 0 || A > 1024 || C <= 0 || C > kMaxC || H <= 0 ||
      N < 0 || (d_res == nullptr) != (d_err == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const float*>(credit), static_cast<const int*>(throttled),
         static_cast<const int*>(completed), static_cast<const int*>(failed),
         static_cast<const float*>(share_sum), static_cast<const int*>(active_ticks),
         static_cast<const uint8_t*>(done0), static_cast<const uint8_t*>(done),
         static_cast<const uint8_t*>(queued0), static_cast<const uint8_t*>(queued),
         static_cast<const uint8_t*>(conflict), static_cast<const int*>(d_res),
         static_cast<const int*>(d_err), static_cast<const int*>(tenant),
         static_cast<const int*>(slot_gid), static_cast<const float*>(alloc),
         static_cast<const float*>(cap), static_cast<const float*>(weights),
         static_cast<float*>(o_credit), static_cast<int*>(o_throttled),
         static_cast<int*>(o_completed), static_cast<int*>(o_failed),
         static_cast<float*>(o_share_sum), static_cast<int*>(o_active_ticks),
         static_cast<uint8_t*>(o_elig), T, N, A, C, H, credit_on, gate_on, gamma, floor,
         slack};
  const size_t smem = control_tick_smem(T, A);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  control_tick_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
