// Algorithm 1's sequential pass (the pessimistic policy, paper lines
// 11-38) for every member of a batch, in one launch.
//
// Replaces: the lax.scan over the processing order in
// repro/core/shaper/pessimistic.py:117-143 (pessimistic_shape_raw), XLA
// code of the reference, not a Pallas kernel.  Its plain version is
// repro_torch/kernels/ref.py:pessimistic_pass.
//
// What bounds it: nothing the card is rated for.  The pass is a chain
// of dependent decisions, one per valid row and elastic component,
// each reading the free table the previous one wrote; per member it
// moves (A*C*18 + H*16) bytes, a few nanoseconds of HBM.  It is
// latency-bound by construction, so the design keeps the chain short
// and its every step in shared memory:
//
//   1. stage: one block of 256 threads per member copies the member's
//      inputs into shared memory by cp.async, 16 bytes a thread, every
//      load in flight at once (block_copy.cuh);
//   2. precompute, in parallel, everything that does not depend on the
//      free table: the valid rows compacted by a block-wide prefix sum;
//      per valid row (one thread each) its core demand per host as a
//      list of <= C (host, cpu, mem) entries, summed over c = 0..C-1
//      from 0 as the plain version sums it; its elastic steps in
//      `order` as (kill_pos index, host, cpu, mem) entries, only where
//      `el` is set; and the count of hosts whose free cpu or memory is
//      already below 0;
//   3. chain: one thread walks the compacted rows over shared memory
//      only, loading each next record and entry ahead of its own store.
//      A row's core test is the plain version's `(free - core_dem <
//      0).any()` over all H hosts: its listed hosts are tested one by
//      one, and an unlisted host fails it exactly when its entry is
//      already negative, which the count of negative hosts (kept up to
//      date at each commit) answers without a pass over H.  An elastic
//      step tests `<= 0` on its one host;
//   4. write remove_pos, kill_pos and the free table once, coalesced.
//
// Arithmetic: sums and differences only, in the plain version's order,
// so there is no a*b+c for the compiler to contract.
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

#include "block_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kMaxSmem = 232448;   // the opt-in shared memory of a block on sm_90

struct CoreEntry {   // a row's core demand on one host
  int h;
  float d0, d1;
  int pad;
};

struct ElasticEntry {   // one elastic step: its kill_pos index, host, demand
  int kill, h;
  float d0, d1;
};

__host__ __device__ size_t smem_bytes(int A, int C, int H) {
  using blk::Carve;
  const size_t AC = size_t(A) * C;
  return Carve::bytes(A) + Carve::bytes(AC * 8) + 2 * Carve::bytes(AC) +
         2 * Carve::bytes(AC * 4) + Carve::bytes(size_t(H) * 8) +   // staged inputs
         Carve::bytes((size_t(A) + 1) * 8) +                        // row records
         Carve::bytes(AC * 16) + Carve::bytes((AC + 1) * 16) +      // entries
         Carve::bytes(A) + Carve::bytes(AC) +                       // outputs
         Carve::bytes(kThreads / 32 * 4);                           // warp counts
}

__device__ __forceinline__ int negative(float2 f) { return f.x < 0.f || f.y < 0.f; }

__global__ void __launch_bounds__(kThreads) pessimistic_pass_kernel(
    const uint8_t* __restrict__ valid_all, const float* __restrict__ dem_all,
    const uint8_t* __restrict__ core_all, const uint8_t* __restrict__ el_all,
    const int* __restrict__ host_all, const int* __restrict__ order_all,
    const float* __restrict__ free0, uint8_t* __restrict__ remove_pos,
    uint8_t* __restrict__ kill_pos, float* __restrict__ free_out, int A, int C,
    int H, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t AC = size_t(A) * C, sa = size_t(s) * A, se = sa * C;
  const long long t0 = clock64();

  // ---- 1. stage ----
  blk::Carve sm{smem};
  uint8_t* valid = sm.take<uint8_t>(A, valid_all + sa);
  float* dem = sm.take<float>(AC * 8, dem_all + 2 * se);
  uint8_t* core = sm.take<uint8_t>(AC, core_all + se);
  uint8_t* el = sm.take<uint8_t>(AC, el_all + se);
  int* host = sm.take<int>(AC * 4, host_all + se);
  int* order = sm.take<int>(AC * 4, order_all + se);
  float2* fr = sm.take<float2>(size_t(H) * 8, free0 + 2 * size_t(s) * H, 8);
  // per valid row k: (row, core entries | elastic entries << 8), and its
  // C core and C elastic entries (one spare record and entry at the end)
  int2* info = sm.take<int2>((size_t(A) + 1) * 8);
  CoreEntry* cent = sm.take<CoreEntry>(AC * 16);
  ElasticEntry* eent = sm.take<ElasticEntry>((AC + 1) * 16);
  uint8_t* o_remove = sm.take<uint8_t>(A, remove_pos + sa);
  uint8_t* o_kill = sm.take<uint8_t>(AC, kill_pos + se);
  int* warp_n = sm.take<int>(kThreads / 32 * 4);
  blk::stage(valid, valid_all + sa, A);
  blk::stage(dem, dem_all + 2 * se, AC * 8);
  blk::stage(core, core_all + se, AC);
  blk::stage(el, el_all + se, AC);
  blk::stage(host, host_all + se, AC * 4);
  blk::stage(order, order_all + se, AC * 4);
  blk::stage(fr, free0 + 2 * size_t(s) * H, size_t(H) * 8);
  blk::zero(o_remove, A);
  blk::zero(o_kill, AC);
  blk::stage_wait();
  __syncthreads();
  const long long t1 = clock64();

  // ---- 2. precompute ----
  // the valid rows compacted in order by a block-wide prefix sum (chunks
  // of kThreads rows); the thread of valid row r, the k-th, writes entry k:
  // the row's core demand per host and its elastic steps
  int nv = 0;
  for (int base = 0; base < A; base += kThreads) {
    const int r = base + tid;
    const bool v = r < A && valid[r];
    const unsigned m = __ballot_sync(FULL, v);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int k = nv, total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) k += warp_n[w];
      total += warp_n[w];
    }
    k += __popc(m & ((1u << lane) - 1));
    if (v) {
      const size_t rc = size_t(r) * C;
      CoreEntry* ce = cent + size_t(k) * C;
      int nc = 0;
      for (int c = 0; c < C; ++c) {
        if (!core[rc + c]) continue;
        const int h = host[rc + c];
        if (h < 0 || h >= H) continue;            // on no host: no demand
        int i = 0;
        while (i < nc && ce[i].h != h) ++i;
        if (i == nc) ce[nc++] = CoreEntry{h, 0.f, 0.f, 0};
        ce[i].d0 += dem[2 * (rc + c)];
        ce[i].d1 += dem[2 * (rc + c) + 1];
      }
      ElasticEntry* ee = eent + size_t(k) * C;
      int ne = 0;
      for (int j = 0; j < C; ++j) {
        const int c = order[rc + j];
        if (el[rc + c])
          ee[ne++] = ElasticEntry{int(rc) + j, host[rc + c], dem[2 * (rc + c)],
                                  dem[2 * (rc + c) + 1]};
      }
      info[k] = make_int2(r, nc | ne << 8);
    }
    nv += total;
    __syncthreads();
  }
  // hosts already short of cpu or memory
  int nneg = 0;
  for (int base = 0; base < H; base += kThreads)
    nneg += __syncthreads_count(base + tid < H && negative(fr[base + tid]));
  const long long t2 = clock64();

  // ---- 3. the chain, on one thread, over shared memory only ----
  // Each step loads what it reads next (the next row's record, the next
  // elastic entry) before its own store to the free table, so that the
  // loads that do not depend on the table are in flight beside it.
  if (tid == 0) {
    int2 cur = info[0];
    for (int k = 0; k < nv; ++k) {
      const int2 next = info[k + 1];
      const int r = cur.x, nc = cur.y & 255, ne = cur.y >> 8;
      cur = next;
      const CoreEntry* ce = cent + size_t(k) * C;
      // core components (lines 11-19): the app's demand on each host must
      // leave that host's free cpu and memory >= 0, on every host
      bool remove = false;
      int listed_negative = 0;
      for (int i = 0; i < nc; ++i) {
        const CoreEntry e = ce[i];
        const float2 f = fr[e.h];
        remove |= (f.x - e.d0 < 0.f) || (f.y - e.d1 < 0.f);
        listed_negative += negative(f);
      }
      if (remove || nneg > listed_negative) {
        o_remove[r] = 1;
        continue;
      }
      for (int i = 0; i < nc; ++i) {
        const CoreEntry e = ce[i];
        const float2 f = fr[e.h];
        const float2 t = make_float2(f.x - e.d0, f.y - e.d1);
        fr[e.h] = t;
        nneg += negative(t) - negative(f);
      }
      // elastic components (lines 25-33), oldest first
      const ElasticEntry* ee = eent + size_t(k) * C;
      ElasticEntry e = ee[0];
      for (int i = 0; i < ne; ++i) {
        const ElasticEntry following = ee[i + 1];
        const float2 f = fr[e.h];
        const float a0 = f.x - e.d0, a1 = f.y - e.d1;
        if (a0 <= 0.f || a1 <= 0.f) {
          o_kill[e.kill] = 1;
        } else {
          fr[e.h] = make_float2(a0, a1);
          nneg -= negative(f);
        }
        e = following;
      }
    }
  }
  __syncthreads();
  const long long t3 = clock64();

  // ---- 4. write ----
  blk::copy(remove_pos + sa, o_remove, A);
  blk::copy(kill_pos + se, o_kill, AC);
  blk::copy(free_out + 2 * size_t(s) * H, fr, size_t(H) * 8);
  if (clocks) {
    __syncthreads();
    if (tid == 0) {
      const long long t4 = clock64();
      long long* out = clocks + 4 * size_t(s);
      out[0] = t1 - t0;   // stage
      out[1] = t2 - t1;   // precompute
      out[2] = t3 - t2;   // chain
      out[3] = t4 - t3;   // write
    }
  }
}

}  // namespace

// The shared memory one block needs at (A, C, H), in bytes; the wrapper
// refuses a call above kMaxSmem (its MAX_SMEM).
extern "C" long long pessimistic_pass_smem(int A, int C, int H) {
  return static_cast<long long>(smem_bytes(A, C, H));
}

// Allow the kernel its opt-in shared memory on the current device: once,
// before the first launch (never inside one, so a captured CUDA graph
// holds launches only).
extern "C" int pessimistic_pass_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      pessimistic_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

// clocks: null, or (S, 4) int64 for the cycles of each phase per member
// (stage, precompute, chain, write).
extern "C" int pessimistic_pass(const void* valid, const void* dem,
                                const void* core, const void* el,
                                const void* host, const void* order,
                                const void* free0, void* remove_pos,
                                void* kill_pos, void* free_out, int S, int A,
                                int C, int H, void* clocks, void* stream) {
  const size_t smem = smem_bytes(A, C, H);
  if (C > 255 || smem > size_t(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  pessimistic_pass_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const float*>(dem),
      static_cast<const uint8_t*>(core), static_cast<const uint8_t*>(el),
      static_cast<const int*>(host), static_cast<const int*>(order),
      static_cast<const float*>(free0), static_cast<uint8_t*>(remove_pos),
      static_cast<uint8_t*>(kill_pos), static_cast<float*>(free_out), A, C, H,
      static_cast<long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}
