// Algorithm 1's sequential pass (the pessimistic policy, paper lines
// 11-38) for every member of a batch, in one launch.
//
// Replaces: the lax.scan over the processing order in
// repro/core/shaper/pessimistic.py:117-143 (pessimistic_shape_raw), XLA
// code of the reference, not a Pallas kernel.  Its plain version is
// repro_torch/kernels/ref.py:pessimistic_pass.
//
// What bounds it: nothing the card is rated for.  The pass is a chain
// of dependent decisions, A rows x C components, each reading the free
// table the previous one wrote; per member it moves (A*C*14 + H*16)
// bytes, a few microseconds of HBM at most.  It is latency-bound by
// construction.  What the design does about it: one warp per member,
// the (H, 2) free table in shared memory, each host owned by lane
// h % 32, so a row's core check is one pass of the lanes over their
// hosts and one __any_sync, and an elastic check is one lane's
// subtraction and one shuffle.  No block-wide barrier anywhere.
//
// Arithmetic: sums and differences only, in the plain version's order
// (a row's core demand per host summed over components c = 0..C-1 from
// 0, then subtracted from the free table), so there is no a*b+c for
// the compiler to contract.
//
// Layout (row-major, one byte per bool):
//   valid (S,A) u8       row r of the processing order holds a running app
//   dem   (S,A,C,2) f32  the row's shaped (cpu, mem) demand by component
//   core, el (S,A,C) u8  the row's existing core / elastic components
//   host  (S,A,C) i32    the host of each component
//   order (S,A,C) i32    the row's components oldest-first
//   free0 (S,H,2) f32    capacity before the pass
// Outputs: remove_pos (S,A) u8, kill_pos (S,A,C) u8 (by position in
// `order`), free (S,H,2) f32 after the pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32) pessimistic_pass_kernel(
    const uint8_t* __restrict__ valid, const float* __restrict__ dem,
    const uint8_t* __restrict__ core, const uint8_t* __restrict__ el,
    const int* __restrict__ host, const int* __restrict__ order,
    const float* __restrict__ free0, uint8_t* __restrict__ remove_pos,
    uint8_t* __restrict__ kill_pos, float* __restrict__ free_out, int A,
    int C, int H) {
  extern __shared__ float fr[];   // (H, 2); host h belongs to lane h % 32
  const int s = blockIdx.x, lane = threadIdx.x;
  for (int h = lane; h < H; h += 32) {
    fr[2 * h] = free0[(size_t(s) * H + h) * 2];
    fr[2 * h + 1] = free0[(size_t(s) * H + h) * 2 + 1];
  }
  __syncwarp();
  for (int r = 0; r < A; ++r) {
    const size_t row = size_t(s) * A + r;
    const size_t rc = row * C;
    if (!valid[row]) {                          // the same for every lane
      if (lane == 0) remove_pos[row] = 0;
      for (int j = lane; j < C; j += 32) kill_pos[rc + j] = 0;
      continue;
    }
    // core components (lines 11-19): the app's demand on each host must
    // leave that host's free cpu and memory >= 0
    bool neg = false;
    for (int h = lane; h < H; h += 32) {
      float d0 = 0.f, d1 = 0.f;
      for (int c = 0; c < C; ++c)
        if (core[rc + c] && host[rc + c] == h) {
          d0 += dem[2 * (rc + c)];
          d1 += dem[2 * (rc + c) + 1];
        }
      neg |= (fr[2 * h] - d0 < 0.f) || (fr[2 * h + 1] - d1 < 0.f);
    }
    const bool remove = __any_sync(FULL, neg);
    if (!remove)
      for (int h = lane; h < H; h += 32) {
        float d0 = 0.f, d1 = 0.f;
        for (int c = 0; c < C; ++c)
          if (core[rc + c] && host[rc + c] == h) {
            d0 += dem[2 * (rc + c)];
            d1 += dem[2 * (rc + c) + 1];
          }
        fr[2 * h] -= d0;
        fr[2 * h + 1] -= d1;
      }
    // elastic components (lines 25-33), oldest first: the owner lane of
    // the component's host tests and commits, the others learn by shuffle
    for (int j = 0; j < C; ++j) {
      const int c = order[rc + j];
      bool kill = false;
      if (!remove && el[rc + c]) {              // the same for every lane
        const int h = host[rc + c];
        const int owner = h & 31;
        int k = 0;
        if (lane == owner) {
          const float a0 = fr[2 * h] - dem[2 * (rc + c)];
          const float a1 = fr[2 * h + 1] - dem[2 * (rc + c) + 1];
          k = (a0 <= 0.f) || (a1 <= 0.f);
          if (!k) {
            fr[2 * h] = a0;
            fr[2 * h + 1] = a1;
          }
        }
        kill = __shfl_sync(FULL, k, owner);
      }
      if (lane == 0) kill_pos[rc + j] = kill;
    }
    if (lane == 0) remove_pos[row] = remove;
  }
  for (int h = lane; h < H; h += 32) {
    free_out[(size_t(s) * H + h) * 2] = fr[2 * h];
    free_out[(size_t(s) * H + h) * 2 + 1] = fr[2 * h + 1];
  }
}

}  // namespace

extern "C" int pessimistic_pass(const void* valid, const void* dem,
                                const void* core, const void* el,
                                const void* host, const void* order,
                                const void* free0, void* remove_pos,
                                void* kill_pos, void* free_out, int S, int A,
                                int C, int H, void* stream) {
  pessimistic_pass_kernel<<<S, 32, 2 * H * sizeof(float),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const float*>(dem),
      static_cast<const uint8_t*>(core), static_cast<const uint8_t*>(el),
      static_cast<const int*>(host), static_cast<const int*>(order),
      static_cast<const float*>(free0), static_cast<uint8_t*>(remove_pos),
      static_cast<uint8_t*>(kill_pos), static_cast<float*>(free_out), A, C, H);
  return static_cast<int>(cudaGetLastError());
}
