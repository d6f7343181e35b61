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
// Arithmetic, as the reference's compiled tick rounds it:
//   * the usage and the shaped demand are each summed over the slot
//     table's (A, C) in XLA:CPU's tree (ref.py:xla_sum with group = C):
//     windows of 32 slots (the slot axis padded to a multiple of 32, the
//     padding split between its ends, the odd one at the end), each
//     window's slots and their components in order, then the window sums
//     in order; 32 slots or fewer in order.  The gap is the demand's sum
//     minus the usage's;
//   * the credit channel is the sum of credit * active over the tenants
//     in the same tree, divided by the count of active tenants.
// The int channels are counts and counter deltas, exact in any order.
//
// Design: one block of kThreads per member.  The block copies the
// member's rings to the outputs and stages the two (A, C, 2) tables in
// shared memory (coalesced, several loads in flight a thread), and counts
// the queue and the admissions over the apps (a shared atomic per warp);
// a warp per window, four of its lanes per (table, resource), sums the
// window from shared memory (the tables kPad floats apart, so the four
// lanes read four banks; with a table start or a window a multiple of 32
// floats from another, one lane per window in one warp would read one
// bank); meanwhile the last thread reads the counters and the tenant
// state and forms the deltas and the credit mean, then adds the windows
// and writes the member's column.  On an NVIDIA H100 at the widths below
// it takes 6.8 us a launch; the first version (a thread per (table,
// resource, window), all in one warp, and thread 0's tail after the sums)
// took 9.3-9.5 us.  What bounds it: the
// bytes of one read of the two tables and the rings and one write of the
// rings (~39 KB a member at the main path's widths, A = 128 slots of C =
// 12 components, N = 500 apps, R = 128); at these sizes a launch is
// latency, the longest chain being a window's 384 dependent adds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;     // XLA:CPU's tree-reduction window
constexpr int kF32 = 5, kI32 = 8;
constexpr int kPad = 2;         // floats between the staged tables

// float32 sum of x(0), ..., x(n - 1) in XLA:CPU's order, by one thread:
// 32 or fewer in order; more (up to 32 * 32) in windows of 32, each in
// order, then the window sums in order
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
};

__global__ void __launch_bounds__(kThreads) obs_tick_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x, tid = threadIdx.x, R = p.R, AC2 = p.A * p.C * 2;
  const int ntab = p.demand ? 2 : 1;
  const int padded = (p.A + kWindow - 1) / kWindow * kWindow;
  const int nw = p.A > kWindow ? padded / kWindow : 1;
  const int lo = p.A > kWindow ? (padded - p.A) / 2 : 0;
  // usage at 0, demand kPad floats after it: a warp's four lanes of a
  // window (table, resource) then read four banks
  float* tab = smem;                               // [ntab][A * C * 2 (+ kPad)]
  float* part = tab + ntab * (AC2 + kPad);         // [ntab][2][nw] window sums
  __shared__ int queue, admitted;
  if (tid == 0) queue = admitted = 0;

  // the rings, copied to the outputs
  {
    const float* f = p.f32 + size_t(s) * kF32 * R;
    float* of = p.o_f32 + size_t(s) * kF32 * R;
    for (int j = tid; j < kF32 * R; j += kThreads) of[j] = f[j];
    const int* i = p.i32 + size_t(s) * kI32 * R;
    int* oi = p.o_i32 + size_t(s) * kI32 * R;
    for (int j = tid; j < kI32 * R; j += kThreads) oi[j] = i[j];
    if (p.lead_ring)
      for (int j = tid; j < R; j += kThreads)
        p.o_lead_ring[size_t(s) * R + j] = p.lead_ring[size_t(s) * R + j];
  }
  const bool on = p.active[s];
  if (!on) {
    if (tid == 0) p.o_cursor[s] = p.cursor[s];
    return;
  }
  // the tables, staged
  const float* u = p.usage + size_t(s) * AC2;
#pragma unroll 4
  for (int j = tid; j < AC2; j += kThreads) tab[j] = u[j];
  if (p.demand) {
    const float* d = p.demand + size_t(s) * AC2;
#pragma unroll 4
    for (int j = tid; j < AC2; j += kThreads) tab[AC2 + kPad + j] = d[j];
  }
  __syncthreads();
  // the queue and the admissions
  int nq = 0, na = 0;
  const size_t sn = size_t(s) * p.N;
  for (int n = tid; n < p.N; n += kThreads) {
    const bool q = p.queued[sn + n];
    nq += q;
    na += p.q_admit[sn + n] && !q;
  }
  for (int off = 16; off; off >>= 1) {
    nq += __shfl_down_sync(0xffffffffu, nq, off);
    na += __shfl_down_sync(0xffffffffu, na, off);
  }
  if ((tid & 31) == 0) {
    atomicAdd(&queue, nq);
    atomicAdd(&admitted, na);
  }
  // a warp a window, a lane per (table, resource): its slots and their
  // components in order
  const int warp = tid / 32, lane = tid % 32;
  if (lane < 2 * ntab) {
    const int t = lane / 2, r = lane % 2;
    const float* x = tab + t * (AC2 + kPad) + r;
    for (int w = warp; w < nw; w += kThreads / 32) {
      const int a0 = max(w * kWindow - lo, 0);
      const int a1 = nw > 1 ? min(w * kWindow + kWindow - lo, p.A) : p.A;
      const int j0 = a0 * p.C, j1 = a1 * p.C;
      float acc = x[2 * j0];
#pragma unroll 16
      for (int j = j0 + 1; j < j1; ++j) acc = __fadd_rn(acc, x[2 * j]);
      part[(t * 2 + r) * nw + w] = acc;
    }
  }
  // meanwhile the last thread (in a warp without a window while nw < 8)
  // reads the counters and the tenant state and forms the deltas and the
  // credit mean
  const bool last = tid == kThreads - 1;
  int col = 0, d_oom = 0, d_fail = 0, d_pre = 0, throttled = 0, d_res = 0, d_err = 0;
  float credit = 0.f;
  if (last) {
    col = p.cursor[s] % R;
    d_oom = p.cnt[0][s] - p.cnt0[0][s];
    d_fail = p.cnt[1][s] - p.cnt0[1][s];
    d_pre = p.cnt[2][s] + p.cnt[3][s] - p.cnt0[2][s] - p.cnt0[3][s];
    if (p.resolved) {
      d_res = p.resolved[s] - p.resolved0[s];
      d_err = p.errors[s] - p.errors0[s];
    }
    if (p.credit) {
      const size_t st = size_t(s) * p.T;
      int n = 0;
      for (int t = 0; t < p.T; ++t) {
        n += p.active_ticks[st + t] > p.active_ticks0[st + t];
        throttled += p.throttled[st + t] - p.throttled0[st + t];
      }
      const float sum = tree_sum(p.T, [&](int t) {
        return __fmul_rn(p.credit[st + t],
                         p.active_ticks[st + t] > p.active_ticks0[st + t] ? 1.f : 0.f);
      });
      if (n > 0) credit = __fdiv_rn(sum, static_cast<float>(n));
    }
  }
  __syncthreads();
  if (!last) return;

  float sums[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int t = 0; t < ntab; ++t)
    for (int r = 0; r < 2; ++r) {
      const float* w = part + (t * 2 + r) * nw;
      float a = w[0];
      for (int k = 1; k < nw; ++k) a = __fadd_rn(a, w[k]);
      sums[t][r] = a;
    }
  float* of = p.o_f32 + size_t(s) * kF32 * R + col;
  of[0] = sums[0][0];
  of[R] = sums[0][1];
  of[2 * R] = p.demand ? __fsub_rn(sums[1][0], sums[0][0]) : 0.f;
  of[3 * R] = p.demand ? __fsub_rn(sums[1][1], sums[0][1]) : 0.f;
  of[4 * R] = credit;
  int* oi = p.o_i32 + size_t(s) * kI32 * R + col;
  oi[0] = queue;
  oi[R] = d_oom;
  oi[2 * R] = d_fail;
  oi[3 * R] = d_pre;
  oi[4 * R] = admitted;
  oi[5 * R] = throttled;
  oi[6 * R] = d_res;
  oi[7 * R] = d_err;
  if (p.lead_ring) p.o_lead_ring[size_t(s) * R + col] = p.lead ? p.lead[s] : 0;
  p.o_cursor[s] = p.cursor[s] + 1;
}

}  // namespace

// The rings: cursor (S,) i32, f32 (S, 5, R), i32 (S, 8, R), lead_ring (S,
// R) i32 or null; active (S,) bool; usage and demand (S, A, C, 2) f32
// (demand null under the baseline policy); queued and q_admit (S, N)
// bool; the counters oom_kills, failure_events, full_preemptions,
// partial_preemptions (S,) i32 now (cnt*) and at the tick's entry
// (cnt0*); the tenancy's credit (S, T) f32, throttled and active_ticks
// (S, T) i32 after the control step and before it (all null without the
// control plane); the calibration's resolved and errors (S,) i32 now and
// at entry (null without calibration); lead (S,) i32 or null.  Outputs:
// the rings.  A <= 1024 and C <= 32 (the tree has one level of windows
// that span whole slots), T <= 1024, and the staged tables within 48 KB.
extern "C" int obs_tick(
    const void* cursor, const void* f32, const void* i32, const void* lead_ring,
    const void* active, const void* usage, const void* demand, const void* queued,
    const void* q_admit, const void* oom, const void* fail, const void* full,
    const void* part, const void* oom0, const void* fail0, const void* full0,
    const void* part0, const void* credit, const void* throttled, const void* active_ticks,
    const void* throttled0, const void* active_ticks0, const void* resolved,
    const void* errors, const void* resolved0, const void* errors0, const void* lead,
    void* o_cursor, void* o_f32, void* o_i32, void* o_lead_ring, int S, int A, int C, int N,
    int T, int R, void* stream) {
  if (S <= 0 || A <= 0 || A > 1024 || C <= 0 || C > 32 || N < 0 || R <= 0 || T < 0 ||
      T > 1024 || (credit == nullptr) != (T == 0) || (resolved == nullptr) != (errors == nullptr) ||
      (lead_ring == nullptr) != (o_lead_ring == nullptr))
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
         A, C, N, T, R};
  const size_t ntab = demand ? 2 : 1, nw = A > kWindow ? (A + kWindow - 1) / kWindow : 1;
  const size_t smem = (ntab * (2 * size_t(A) * C + kPad) + ntab * 2 * nw) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  obs_tick_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
