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
// Arithmetic, as the reference's compiled tick rounds it:
//   * the credit step credit + gamma * (target - credit) and the gate's
//     mean + slack * credit are contracted by XLA:CPU into fused
//     multiply-adds (xla_fma.cuh), rounded once;
//   * a division by a constant becomes a product by its reciprocal: the
//     shares are max_r(alloc_r * (1 / max(cap_r, 1e-9))) * (1 / weight),
//     the reciprocals rounded to float32 first;
//   * each tenant's allocation is summed over a slot's components in
//     order, then over the slots in XLA:CPU's tree of 32-wide windows
//     (ref.py:xla_sum), the hosts' capacities in order (the reference
//     folds that sum of constants); the gate's mean over the tenants in
//     the same tree, then divided by their count.
//
// Design: one block of kThreads per member.  One pass over the member's
// apps counts completions, failures and queued apps per tenant (shared
// memory atomics: integers, so the order does not matter).  The slot
// table's allocations are staged in shared memory by the whole block
// (several loads in flight a thread); a thread a slot reads its tenant
// and sums its components in order there; the tenants' sums over the
// slots in XLA's tree take a thread per tenant, resource and window of 32
// slots, then a thread per tenant adds its windows in order and forms
// its share; thread 0 takes the active tenants' mean share, and a thread
// per tenant decides its gate and writes its counters.  What bounds it:
// the bytes of one read of the member's app columns and slot table (~15
// KB a member at the main path's widths, N = 500 apps, A = 128 slots of
// C = 12 components); at these sizes a launch is latency, a few passes
// of dependent loads.  The first version (each slot's components read by
// one thread from device memory, one load after another; each tenant's
// slots summed by one thread) took 11.7 us a launch at those widths on an
// NVIDIA H100; a warp a slot, its slots one after another, took 16.5.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_fma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;     // XLA:CPU's tree-reduction window

// max as XLA takes it: NaN when either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a >= b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a <= b || a != a) ? a : b;
}

// float32 sum of x(0), ..., x(n - 1) in XLA:CPU's order, by one thread:
// 32 or fewer in order; more (up to 32 * 32) in windows of 32 of the axis
// padded to a multiple of 32 (the padding split between its ends, the odd
// one at the end), each window in order, then the window sums in order
template <class F>
__device__ float tree_sum(int n, const F& x) {
  if (n <= kWindow) {
    float a = 0.f;
    for (int j = 0; j < n; ++j) a = j ? __fadd_rn(a, x(j)) : x(j);
    return a;
  }
  const int padded = (n + kWindow - 1) / kWindow * kWindow, lo = (padded - n) / 2;
  float top = 0.f;
  for (int w = 0; w < padded / kWindow; ++w) {
    const int j0 = max(w * kWindow - lo, 0), j1 = min(w * kWindow + kWindow - lo, n);
    float a = x(j0);
    for (int j = j0 + 1; j < j1; ++j) a = __fadd_rn(a, x(j));
    top = w ? __fadd_rn(top, a) : a;
  }
  return top;
}

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

__global__ void __launch_bounds__(kThreads) control_tick_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, tid = threadIdx.x, T = p.T, A = p.A, AC2 = A * p.C * 2;
  // the level-0 windows of the slots' tree sums (one window of A when A <= 32)
  const int padded = (A + kWindow - 1) / kWindow * kWindow;
  const int nw = A > kWindow ? padded / kWindow : 1, lo = A > kWindow ? (padded - A) / 2 : 0;
  float* alloc = reinterpret_cast<float*>(smem);     // [A * C * 2] the slot table's
  float* rows = alloc + AC2;                         // [2A] each slot's (cpu, mem)
  float* part = rows + 2 * A;                        // [T][2][nw] window sums
  float* share = part + 2 * T * nw;                  // [T]
  int* comp = reinterpret_cast<int*>(share + T);     // [T] completions
  int* fail = comp + T;                              // [T] failures
  int* queued_t = fail + T;                          // [T] queued apps
  int* ten = queued_t + T;                           // [A] each slot's tenant, -1 none
  uint8_t* active = reinterpret_cast<uint8_t*>(ten + A);   // [T]
  __shared__ float mean;
  for (int t = tid; t < 3 * T; t += kThreads) comp[t] = 0;
  const float* src = p.alloc + size_t(s) * AC2;
#pragma unroll 4
  for (int i = tid; i < AC2; i += kThreads) alloc[i] = src[i];
  __syncthreads();

  // the apps: the tick's events and the queue, per tenant
  const size_t sn = size_t(s) * p.N;
  for (int n = tid; n < p.N; n += kThreads) {
    const int t = p.tenant[sn + n];
    if (t < 0 || t >= T) continue;
    if (p.done[sn + n] && !p.done0[sn + n]) atomicAdd(&comp[t], 1);
    const bool q = p.queued[sn + n];
    int f = q && !p.queued0[sn + n];                 // OOM kills, requeued
    if (p.conflict && p.conflict[sn + n]) ++f;       // optimistic conflicts
    if (f) atomicAdd(&fail[t], f);
    if (q) atomicAdd(&queued_t[t], 1);
  }
  // the slots: tenant and allocation summed over the components in order
  for (int a = tid; a < A; a += kThreads) {
    const int g = p.slot_gid[size_t(s) * A + a];
    const int t = g >= 0 ? p.tenant[sn + g] : -1;
    ten[a] = (t >= 0 && t < T) ? t : -1;
    const float* al = alloc + a * p.C * 2;
    float c0 = al[0], c1 = al[1];
    for (int c = 1; c < p.C; ++c) {
      c0 = __fadd_rn(c0, al[2 * c]);
      c1 = __fadd_rn(c1, al[2 * c + 1]);
    }
    rows[2 * a] = c0;
    rows[2 * a + 1] = c1;
  }
  __syncthreads();

  // each tenant's slots in XLA's tree: a thread per (tenant, resource,
  // window) sums its window in order from its first slot
  for (int i = tid; i < 2 * T * nw; i += kThreads) {
    const int t = i / (2 * nw), r = i / nw % 2, w = i % nw;
    const int j0 = max(w * kWindow - lo, 0), j1 = nw > 1 ? min(w * kWindow + kWindow - lo, A) : A;
    float x = ten[j0] == t ? rows[2 * j0 + r] : 0.f;
    for (int j = j0 + 1; j < j1; ++j) x = __fadd_rn(x, ten[j] == t ? rows[2 * j + r] : 0.f);
    part[i] = x;
  }
  __syncthreads();
  // a thread per tenant: its windows in order, its share, whether it is
  // active
  float cap0 = 0.f, cap1 = 0.f;
  for (int h = 0; h < p.H; ++h) {
    cap0 = h ? __fadd_rn(cap0, p.cap[2 * h]) : p.cap[0];
    cap1 = h ? __fadd_rn(cap1, p.cap[2 * h + 1]) : p.cap[1];
  }
  const float r0 = __fdiv_rn(1.f, max_nan(cap0, 1e-9f)), r1 = __fdiv_rn(1.f, max_nan(cap1, 1e-9f));
  for (int t = tid; t < T; t += kThreads) {
    const float* w0 = part + 2 * t * nw;
    const float* w1 = w0 + nw;
    float a0 = w0[0], a1 = w1[0];
    for (int w = 1; w < nw; ++w) {
      a0 = __fadd_rn(a0, w0[w]);
      a1 = __fadd_rn(a1, w1[w]);
    }
    const float sh = __fmul_rn(max_nan(__fmul_rn(a0, r0), __fmul_rn(a1, r1)),
                               __fdiv_rn(1.f, p.weights[t]));
    share[t] = sh;
    active[t] = sh > 0.f || queued_t[t] > 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < T; ++t) n += active[t];
    const float sum = tree_sum(T, [&](int t) { return active[t] ? share[t] : 0.f; });
    mean = n > 0 ? __fdiv_rn(sum, static_cast<float>(n)) : 0.f;
  }
  __syncthreads();

  // a thread per tenant: the credit, the gate and the counters
  const size_t st = size_t(s) * T;
  for (int t = tid; t < T; t += kThreads) {
    const size_t i = st + t;
    int good = comp[t], bad = fail[t];
    if (p.d_res) {
      good += p.d_res[i] - p.d_err[i];
      bad += p.d_err[i];
    }
    float credit = p.credit[i];
    if (p.credit_on) {
      const float g = static_cast<float>(good), tot = __fadd_rn(g, static_cast<float>(bad));
      const float target = tot > 0.f ? __fdiv_rn(g, max_nan(tot, 1.f)) : credit;
      credit = min_nan(max_nan(xla::fma_f32(p.gamma, __fsub_rn(target, credit), credit), p.floor),
                       1.f);
    }
    bool elig = true;
    if (p.gate_on && active[t]) {
      const float bound = p.credit_on ? xla::fma_f32(p.slack, credit, mean)
                                      : __fadd_rn(mean, p.slack);
      elig = share[t] <= bound;
    }
    p.o_credit[i] = credit;
    p.o_throttled[i] = p.throttled[i] + (elig ? 0 : queued_t[t]);
    p.o_completed[i] = p.completed[i] + comp[t];
    p.o_failed[i] = p.failed[i] + fail[t];
    p.o_share_sum[i] = active[t] ? __fadd_rn(p.share_sum[i], share[t]) : p.share_sum[i];
    p.o_active_ticks[i] = p.active_ticks[i] + active[t];
    p.o_elig[i] = elig;
  }
}

}  // namespace

// The tenant state (S, T): credit, share_sum f32, throttled, completed,
// failed, active_ticks i32; the tick's events over the apps (S, N) bool:
// done0 and done (completions), queued0 and queued (OOM kills; queued is
// the queue at admission), conflict (or null); d_res and d_err (S, T)
// i32 the tick's conformal resolutions per tenant (or null); tenant (S,
// N) i32, slot_gid (S, A) i32, alloc (S, A, C, 2) f32, cap (H, 2) f32,
// weights (T,) f32.  Outputs: the state's six arrays and elig (S, T)
// bool.  T <= 1024, A <= 1024 (the sums' windows fit one level), and the
// block's tables, the slot table's allocations among them, within 48 KB.
extern "C" int control_tick(
    const void* credit, const void* throttled, const void* completed, const void* failed,
    const void* share_sum, const void* active_ticks, const void* done0, const void* done,
    const void* queued0, const void* queued, const void* conflict, const void* d_res,
    const void* d_err, const void* tenant, const void* slot_gid, const void* alloc,
    const void* cap, const void* weights, void* o_credit, void* o_throttled,
    void* o_completed, void* o_failed, void* o_share_sum, void* o_active_ticks, void* o_elig,
    int S, int T, int N, int A, int C, int H, int credit_on, int gate_on, float gamma,
    float floor, float slack, void* stream) {
  if (S <= 0 || T <= 0 || T > 1024 || A <= 0 || A > 1024 || C <= 0 || H <= 0 || N < 0 ||
      (d_res == nullptr) != (d_err == nullptr))
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
  const size_t nw = A > kWindow ? (A + kWindow - 1) / kWindow : 1;
  const size_t smem = (2 * size_t(A) * C + 2 * size_t(A) + 2 * T * nw + T) * sizeof(float) +
                      (3 * size_t(T) + A) * sizeof(int) + T;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  control_tick_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
