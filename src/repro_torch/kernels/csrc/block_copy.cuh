// Copies made by a whole thread block, 16 bytes a thread where the
// addresses allow it.  Shared by the kernels that stage a member's
// state in shared memory and write their outputs from it (shaper.cu,
// sched.cu's resolve_oom).
//
// A member's rows start at s * (row bytes), which is 16-byte aligned
// only by chance (the byte arrays of N = 24 apps start every 24 bytes).
// So each copy takes an unaligned head and tail a byte at a time and
// the aligned middle as uint4, when source and destination are equally
// misaligned; 4-byte words when they agree mod 4; bytes otherwise.
// Shared-memory regions are carved (Carve below) at the source's
// misalignment, so a staging copy always takes the 16-byte path.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace blk {

template <typename W>
__device__ __forceinline__ void copy_words(char* d, const char* s, size_t n) {
  const size_t nt = blockDim.x, W_ = sizeof(W);
  size_t head = (W_ - (reinterpret_cast<uintptr_t>(s) & (W_ - 1))) & (W_ - 1);
  if (head > n) head = n;
  const size_t nw = (n - head) / W_;
  for (size_t i = threadIdx.x; i < head; i += nt) d[i] = s[i];
  const W* sw = reinterpret_cast<const W*>(s + head);
  W* dw = reinterpret_cast<W*>(d + head);
  for (size_t i = threadIdx.x; i < nw; i += 4 * nt) {   // four loads in flight
    W v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * nt < nw) v[u] = sw[i + u * nt];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * nt < nw) dw[i + u * nt] = v[u];
  }
  for (size_t i = head + nw * W_ + threadIdx.x; i < n; i += nt) d[i] = s[i];
}

// dst[0, n) = src[0, n), by every thread of the block; no barrier
__device__ __forceinline__ void copy(void* dst, const void* src, size_t n) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const uintptr_t mis = reinterpret_cast<uintptr_t>(d) ^ reinterpret_cast<uintptr_t>(s);
  if ((mis & 15) == 0)
    copy_words<uint4>(d, s, n);
  else if ((mis & 3) == 0)
    copy_words<uint32_t>(d, s, n);
  else
    copy_words<char>(d, s, n);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
}

template <int W>
__device__ __forceinline__ void stage_words(char* d, const char* s, size_t n) {
  const size_t nt = blockDim.x;
  size_t head = (W - (reinterpret_cast<uintptr_t>(s) & (W - 1))) & (W - 1);
  if (head > n) head = n;
  const size_t nw = (n - head) / W;
  for (size_t i = threadIdx.x; i < nw; i += nt) cp_async<W>(d + head + i * W, s + head + i * W);
  for (size_t i = threadIdx.x; i < head; i += nt) d[i] = s[i];
  for (size_t i = head + nw * W + threadIdx.x; i < n; i += nt) d[i] = s[i];
}

// Shared dst[0, n) = global src[0, n), by every thread of the block,
// asynchronously: the words go by cp.async (16 bytes where source and
// destination agree mod 16, 4 where they agree mod 4), so a thread's
// loads of several arrays are all in flight at once; an unaligned head
// and tail go a byte at a time.  Complete with stage_wait() and a
// barrier before reading dst.
__device__ __forceinline__ void stage(void* dst, const void* src, size_t n) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const uintptr_t mis = reinterpret_cast<uintptr_t>(d) ^ reinterpret_cast<uintptr_t>(s);
  if ((mis & 15) == 0)
    stage_words<16>(d, s, n);
  else if ((mis & 3) == 0)
    stage_words<4>(d, s, n);
  else
    copy_words<char>(d, s, n);
}

// this thread's stage() copies have landed (each thread waits for its own)
__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// dst[0, n) = 0, by every thread of the block; no barrier
__device__ __forceinline__ void zero(void* dst, size_t n) {
  char* d = static_cast<char*>(dst);
  const size_t nt = blockDim.x;
  size_t head = (16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  if (head > n) head = n;
  const size_t nw = (n - head) / 16;
  for (size_t i = threadIdx.x; i < head; i += nt) d[i] = 0;
  uint4* dw = reinterpret_cast<uint4*>(d + head);
  for (size_t i = threadIdx.x; i < nw; i += nt) dw[i] = make_uint4(0, 0, 0, 0);
  for (size_t i = head + nw * 16 + threadIdx.x; i < n; i += nt) d[i] = 0;
}

// Regions of dynamic shared memory, each 16 bytes longer than asked so
// that it can start at a source's misalignment.  The host sizes the
// launch with the same arithmetic (bytes()).
struct Carve {
  unsigned char* base;
  size_t off = 0;
  __host__ __device__ static size_t bytes(size_t n) { return (n + 16 + 15) / 16 * 16; }
  // a region of n bytes, aligned to `align` (a power of two <= 16: the
  // widest element the kernel reads from it), whose address otherwise
  // agrees with `like` mod 16
  template <typename T>
  __device__ T* take(size_t n, const void* like = nullptr, size_t align = 1) {
    const uintptr_t mis = like ? reinterpret_cast<uintptr_t>(like) & 15 & ~(align - 1) : 0;
    T* p = reinterpret_cast<T*>(base + off + mis);
    off += bytes(n);
    return p;
  }
};

}  // namespace blk
