// The device engine's idle-tick skip: for each member of a batch, the
// run of provably idle ticks before its next real tick, with the clock
// advanced over them exactly as the uniform engine's ticks advance it.
//
// Replaces: the scalar lax.while_loop of the reference's fused_leap
// (repro/sim/step.py:955-970), XLA code, not a Pallas kernel.  Its plain
// version is repro_torch/kernels/ref.py:leap_skip, the serial loop, which
// stays the definition: every output equals it to the bit.
//
// A member is idle when some app is not done, its tick budget `left` is
// positive, no slot holds an app, the FIFO queue is empty and, with
// calibration on, no calibration score is pending (every row's `left`
// of the calibration state is 0: a pending score ages per executed
// tick, so those ticks must run); then every phase of a tick is a no-op
// until the next arrival.  The reference's loop
//     while idle && n < left && next_sub > t + tick: t = t + tick; n++
// rounds t + tick once to float32 and compares in float32.
//
// The count in closed form, one float32 binade at a time.  Let t > 0 be
// normal, in [2^e, 2^(e+1)), with ulp u = 2^(e-23), so t = K u for an
// integer K in [2^23, 2^24), and let 0 < tick be finite.  While the exact
// sum t + tick stays below 2^(e+1) it is rounded on the grid of u:
// fl(t + tick) = u * RNE(K + tick/u) = t + d u, where d = RNE(tick/u) is
// the same for every t of the binade, unless tick/u is a half-integer
// m + 1/2 (a tie), where the rounding goes to the even one of K + m and
// K + m + 1 and so depends on K.  After one tied step K is even, and from
// an even K the even one is K + rint(m + 1/2) (rint to even), so from
// there d = rint(tick/u) is again constant.  Hence from a t with K even,
// or at any K where tick/u is not a tie, the j-th skipped tick lands
// exactly on t + j d u as long as K + j d <= 2^24 - 1 (then the exact sum
// t + tick < (K + j d + 1/2) u <= 2^(e+1) - u/2 is still rounded on the
// grid of u).  The count of steps from t is then the least of
//   * the budget left, left - n;
//   * the steps that stay in the binade, (2^24 - 1 - K) / d;
//   * the steps before the next arrival: each needs next_sub > t + j d u,
//     so none if next_sub <= t, all of them if next_sub lies at or past
//     2^(e+1) (or is +inf), else, next_sub = K' u in the same binade,
//     (K' - K - 1) / d;
// all in exact arithmetic (tick/u is a power-of-two scaling of tick, exact
// in float64; K, K', d < 2^24 are integers).  The clock then jumps to
// (K + j d) u.  What the jump does not cover takes the reference's own
// step, one __fadd_rn and one float32 compare: the step out of a binade,
// a tied step from an odd K, and every step where t is 0, subnormal,
// negative, infinite or NaN or tick is not a positive finite number (the
// engine's clock starts at 0 and its tick is positive, so there the
// serial steps are the step onto the first binade and one across each
// binade's edge).  d = 0 (tick below u/2, or u/2 from an even K) is a
// fixed point: the clock never moves, and the loop runs out the budget
// when next_sub > t, else skips nothing more; so is a serial step with
// fl(t + tick) == t.  A stretch of n ticks from t takes about two passes
// of the loop per binade between t and t + n tick, where the serial loop
// took n dependent adds (~35 ns each on an H100).
//
// Design: one block per member.  The block's threads reduce the idle
// test (__syncthreads_and / _or over the slot table, the app columns and
// the calibration rows) and the next arrival time (the least submit time
// of the apps that have not arrived; +inf when all have) in one pass over
// the member's columns, 16 bytes a load where a row allows it (four slots
// or calibration rows an int4; four apps a load of each bool column as a
// 32-bit word and of submit as a float4), then thread 0 counts the skip
// in closed form and writes the new clock and the number of skipped
// ticks.  What bounds it: the bytes of one read of the slot table and
// four app columns (~4.5 KB a member at the main path's widths; 12 KB
// more with calibration's rows), then the count's few dependent passes
// on one thread; at the engine's sizes a launch is latency.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kTop = 0xFFFFFFu;   // the largest significand of a binade, 2^24 - 1

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The reference's loop from (t, n = 0): the skipped ticks and the clock,
// counted in closed form per binade (see the header).
__device__ int skip(float& t, float tick, float next_sub, int left) {
  int n = 0;
  const bool jumps = tick > 0.f && tick <= 3.4028235e38f;
  while (n < left) {
    const unsigned bits = __float_as_uint(t);
    const unsigned e = bits >> 23;       // t > 0 normal: 1 <= e <= 254
    if (jumps && e >= 1u && e <= 254u) {
      unsigned K = (bits & 0x7FFFFFu) | 0x800000u;
      // tick / u = tick * 2^(150 - e), exact in float64
      const double dr = static_cast<double>(tick) *
                        __longlong_as_double(static_cast<long long>(1023 + 150 - e) << 52);
      if (dr < 16777216.0) {
        const double m = floor(dr);
        if (!(dr - m == 0.5 && (K & 1u))) {
          const unsigned d = static_cast<unsigned>(__double2int_rn(dr));
          if (d == 0u) {                   // the clock never moves
            if (next_sub > t) n = left;
            break;
          }
          const unsigned kbin = (kTop - K) / d;
          const unsigned ns = __float_as_uint(next_sub);
          unsigned karr = 0u;
          if (next_sub > t)
            karr = (ns >> 23) > e ? kbin : (((ns & 0x7FFFFFu) | 0x800000u) - K - 1u) / d;
          const unsigned j = min(static_cast<unsigned>(left - n), min(kbin, karr));
          K += j * d;
          n += static_cast<int>(j);
          t = __uint_as_float((e << 23) | (K & 0x7FFFFFu));
          if (n >= left) break;
        }
      }
    }
    // the reference's own step
    const float nt = __fadd_rn(t, tick);
    if (!(next_sub > nt)) break;
    if (nt == t) {                         // a fixed point: the budget runs out
      n = left;
      break;
    }
    t = nt;
    ++n;
  }
  return n;
}

__global__ void __launch_bounds__(kThreads) leap_skip_kernel(
    const int* __restrict__ slot_gid, const uint8_t* __restrict__ queued,
    const uint8_t* __restrict__ arrived, const float* __restrict__ submit,
    const uint8_t* __restrict__ done, const float* __restrict__ t_in,
    const int* __restrict__ left_in, const int* __restrict__ calib_left, float tick,
    float* __restrict__ t_out, int* __restrict__ lead_out, int A, int N, int R) {
  __shared__ float warp_min[kThreads / 32];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  slot_gid += static_cast<size_t>(s) * A;
  const size_t off = static_cast<size_t>(s) * N;
  queued += off;
  arrived += off;
  submit += off;
  done += off;

  // a busy slot, or a pending calibration score, keeps the member busy
  int running = 0;
  if (A % 4 == 0 && aligned16(slot_gid)) {
    for (int i = tid; i < A / 4; i += kThreads) {
      const int4 v = reinterpret_cast<const int4*>(slot_gid)[i];
      running |= (v.x >= 0) | (v.y >= 0) | (v.z >= 0) | (v.w >= 0);
    }
  } else {
    for (int a = tid; a < A; a += kThreads) running |= slot_gid[a] >= 0;
  }
  if (calib_left) {
    const int* cl = calib_left + static_cast<size_t>(s) * R;
    if (R % 4 == 0 && aligned16(cl)) {
      for (int i = tid; i < R / 4; i += kThreads) {
        const int4 v = reinterpret_cast<const int4*>(cl)[i];
        running |= (v.x | v.y | v.z | v.w) != 0;
      }
    } else {
      for (int r = tid; r < R; r += kThreads) running |= cl[r] != 0;
    }
  }
  int all_done = 1, any_queued = 0;
  float next_sub = INFINITY;
  const bool words = N % 4 == 0 && aligned16(submit) &&
      ((reinterpret_cast<uintptr_t>(queued) | reinterpret_cast<uintptr_t>(arrived) |
        reinterpret_cast<uintptr_t>(done)) & 3) == 0;
  if (words) {                             // four apps a thread: a word of each bool column
    for (int i = tid; i < N / 4; i += kThreads) {
      const unsigned d = reinterpret_cast<const unsigned*>(done)[i];
      const unsigned q = reinterpret_cast<const unsigned*>(queued)[i];
      const unsigned a = reinterpret_cast<const unsigned*>(arrived)[i];
      const float4 sub = reinterpret_cast<const float4*>(submit)[i];
      all_done &= __vcmpne4(d, 0u) == 0xFFFFFFFFu;
      any_queued |= q != 0u;
      if (!(a & 0xFFu) && sub.x < next_sub) next_sub = sub.x;
      if (!(a & 0xFF00u) && sub.y < next_sub) next_sub = sub.y;
      if (!(a & 0xFF0000u) && sub.z < next_sub) next_sub = sub.z;
      if (!(a & 0xFF000000u) && sub.w < next_sub) next_sub = sub.w;
    }
  } else {
    for (int n = tid; n < N; n += kThreads) {
      all_done &= done[n] != 0;
      any_queued |= queued[n] != 0;
      if (!arrived[n] && submit[n] < next_sub) next_sub = submit[n];
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, next_sub, o);
    if (other < next_sub) next_sub = other;
  }
  if ((tid & 31) == 0) warp_min[tid >> 5] = next_sub;
  running = __syncthreads_or(running);
  all_done = __syncthreads_and(all_done);
  any_queued = __syncthreads_or(any_queued);
  if (tid != 0) return;
  for (int w = 1; w < kThreads / 32; ++w)
    if (warp_min[w] < next_sub) next_sub = warp_min[w];

  const int left = left_in[s];
  float t = t_in[s];
  int n = 0;
  if (!all_done && left > 0 && !running && !any_queued) n = skip(t, tick, next_sub, left);
  t_out[s] = t;
  lead_out[s] = n;
}

}  // namespace

// slot_gid (S, A) int32; queued, arrived, done (S, N) bool; submit (S, N)
// float32; t (S,) float32; left (S,) int32; calib_left (S, R) int32, the
// calibration state's ticks to each pending score, or null without
// calibration; out: t_out (S,) float32 and lead (S,) int32.  S, A, N >= 1.
extern "C" int leap_skip(const void* slot_gid, const void* queued, const void* arrived,
                         const void* submit, const void* done, const void* t,
                         const void* left, const void* calib_left, float tick,
                         void* t_out, void* lead, int S, int A, int N, int R,
                         void* stream) {
  if (S <= 0 || A <= 0 || N <= 0 || (calib_left && R <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  leap_skip_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slot_gid), static_cast<const uint8_t*>(queued),
      static_cast<const uint8_t*>(arrived), static_cast<const float*>(submit),
      static_cast<const uint8_t*>(done), static_cast<const float*>(t),
      static_cast<const int*>(left), static_cast<const int*>(calib_left), tick,
      static_cast<float*>(t_out), static_cast<int*>(lead), A, N, R);
  return static_cast<int>(cudaGetLastError());
}
