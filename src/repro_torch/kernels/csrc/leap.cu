// The device engine's idle-tick skip: for each member of a batch, the
// run of provably idle ticks before its next real tick, with the clock
// advanced over them exactly as the uniform engine's ticks advance it.
//
// Replaces: the scalar lax.while_loop of the reference's fused_leap
// (repro/sim/step.py:955-970), XLA code, not a Pallas kernel.  Its plain
// version is repro_torch/kernels/ref.py:leap_skip.
//
// A member is idle when some app is not done, its tick budget `left` is
// positive, no slot holds an app, the FIFO queue is empty and, with
// calibration on, no calibration score is pending (every row's `left`
// of the calibration state is 0: a pending score ages per executed
// tick, so those ticks must run); then every phase of a tick is a no-op
// until the next arrival.  The reference's
// loop
//     while idle && n < left && next_sub > t + tick: t = t + tick; n++
// is serial by nature (each t rounds from the one before, so the count
// has no closed form that keeps the bits), ~3 operations a skipped tick:
// one thread runs it.  t + tick is rounded once to float32 (__fadd_rn,
// never contracted) and compared in float32, as the reference does, so
// the arrival tick indices and everything after them are the uniform
// engine's for any tick value.
//
// Design: one block per member.  The block's threads reduce the idle
// test (__syncthreads_and / _or over the slot table, the app columns and
// the calibration rows)
// and the next arrival time (the least submit time of the apps that have
// not arrived; +inf when all have) with one pass over the member's
// columns, then thread 0 runs the loop and writes the new clock and the
// number of skipped ticks.  What bounds it: the bytes of one read of the
// slot table and four app columns (~4.5 KB a member at the main path's
// widths; 12 KB more with calibration's rows), then a loop of at most `left` iterations that runs only on
// idle members; at the engine's sizes a launch is latency.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

  int running = 0;
  for (int a = tid; a < A; a += kThreads) running |= slot_gid[a] >= 0;
  if (calib_left)   // a pending calibration score keeps the member busy
    for (int r = tid; r < R; r += kThreads)
      running |= calib_left[static_cast<size_t>(s) * R + r] != 0;
  int all_done = 1, any_queued = 0;
  float next_sub = INFINITY;
  for (int n = tid; n < N; n += kThreads) {
    all_done &= done[n] != 0;
    any_queued |= queued[n] != 0;
    if (!arrived[n] && submit[n] < next_sub) next_sub = submit[n];
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
  if (!all_done && left > 0 && !running && !any_queued) {
    while (n < left && next_sub > __fadd_rn(t, tick)) {
      t = __fadd_rn(t, tick);
      ++n;
    }
  }
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
