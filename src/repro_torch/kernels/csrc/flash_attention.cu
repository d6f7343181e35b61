// Block-wise online-softmax attention (FlashAttention forward), causal or
// full, with grouped KV heads, in fp32 on the CUDA cores, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel), which the JAX package reaches from
// repro/kernels/ops.py:attention, for the calls the tensor-core kernel
// (flash_attention_sm90.cu) does not take: fp32, which must hold 2e-5 and
// so cannot use TF32, and bf16 whose head dim is not a multiple of 8 or
// whose rows TMA cannot address.  It computes, for q (B,Hq,S,D) and
// k, v (B,Hkv,T,D) with Hq % Hkv == 0,
//
//   o[b,h,i] = softmax_j(sm_scale * q[b,h,i] . k[b,h/g,j] | mask) . v[b,h/g,j]
//
// with g = Hq / Hkv, queries aligned to the end of the keys (query i sits
// at position q_offset + i, q_offset = T - S from the caller, >= 0 when
// causal), the causal mask j <= q_offset + i, fp32 arithmetic throughout
// and the output in the input type (fp32 or bf16).
//
// What bounds it: at q = k = v = (8, 20, 448, 64) fp32, causal (the
// Whisper decoder's self-attention in an fp32 prefill), the call must move
// 73,400,320 B (21.9 us at 3.35 TB/s) and do 4,119,592,960 flop over the
// causal half, 61.5 us at the CUDA cores' 67 TFLOP/s: it is bound by
// operations, and only FMAs fed fast enough from registers reach that.
//
// The first version of this kernel (one block per 32-row tile, four lanes
// per row) issued one scalar shared-memory load per FMA, loaded K/V
// synchronously, and took 7.5x its bound.  This design:
//  * one block of 256 threads per (query tile of 64 rows, query head,
//    batch); a 16 x 16 grid of threads, thread (ty, tx) owning rows
//    ty + 16 r and keys tx + 16 c (r, c < 4) of each 64 x 64 logit tile
//    and rows ty + 16 r, columns 4 tx .. 4 tx + 3 (and 64 + 4 tx .. for
//    D > 64) of the output, all in registers;
//  * Q, K and V stay row-major in shared memory (rows padded by 4 floats
//    so the row stride is an odd number of 16-byte units); S = Q.K^T walks
//    D four at a time, each thread loading 4 float4 of Q (a broadcast: the
//    8 threads of a load phase share ty) and 4 float4 of K for 64 FMAs;
//  * the weights P go to shared memory in fp32 (only the 16 threads of one
//    ty, in one warp, write and read a row, so a __syncwarp orders them),
//    and O += P.V reads 4 float4 of P and 4 (or 8) float4 of V per 64 (or
//    128) FMAs;
//  * K/V tiles of 64 keys are double-buffered: fp32 tiles arrive by
//    cp.async (16-byte copies when rows are 16-byte aligned, 4-byte copies
//    otherwise) while the previous tile is computed; bf16 tiles convert
//    while staging through registers;
//  * log2(e) is folded into the scale and the softmax uses exp2f; the row
//    max takes four shuffles per tile, the row sum is kept per thread and
//    reduced once at the end;
//  * causal: the loop stops at the last key tile the query tile's last
//    row can see, and the query tiles are launched longest first;
//  * ragged edges (S, T not multiples of 64, any D <= 128) are masked
//    here: rows past S and keys past T are zero in shared memory, masked
//    keys get -inf logits, columns past D are zero, nothing is padded in
//    device memory;
//  * GQA: head h reads kv head h / g, so no repeated K/V exists anywhere;
//  * fp32 with D = 64 or 128 (and 16-byte rows) is compiled for that D, so
//    the loops over D unroll and the tile loads' index arithmetic is
//    shifts; other D take a loop over D.
//
// Tried on the card at the Whisper shape and not kept, being slower: 8
// query rows per thread (128 threads, 64 x 64 tiles), alone and with
// single-buffered K/V (K loading during the softmax and P.V, V during the
// next S); and 4 rows per thread with single-buffered K/V.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the caller allocates the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kRT = 4;         // query rows per thread
constexpr int kTY = 16;        // thread rows: thread (ty, tx) owns rows ty + 16 r
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kLdP = kBK + 4;  // row stride of P
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as .astype does
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copies of 16 or 4 bytes; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of a contiguous (rows_total, D) matrix into a
// float tile with row stride ld; rows past rows_total arrive as zeros,
// columns >= D are left alone (zeroed once at the start).  fp32 goes by
// cp.async (16 bytes a copy when VEC: D % 4 == 0 and 16-byte aligned
// rows), bf16 through registers.
template <bool VEC, int KD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src,
                                          int row0, int rows_total, int D_) {
  const int D = KD ? KD : D_;  // a compile-time D turns the divisions into shifts
  const float* base = src + static_cast<size_t>(row0) * D;
  const int rows = min(kBK, rows_total - row0);
  if (VEC) {
    const int d4 = D >> 2;
    for (int e = threadIdx.x; e < kBK * d4; e += kThreads) {
      const int r = e / d4, c = (e - r * d4) << 2;
      const bool ok = r < rows;
      cp_async16(dst + r * ld + c, ok ? base + r * D + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const bool ok = r < rows;
      cp_async4(dst + r * ld + c, ok ? base + e : src, ok ? 4 : 0);
    }
  }
}

template <bool VEC, int KD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int rows_total, int D) {
  const __nv_bfloat16* base = src + static_cast<size_t>(row0) * D;
  const int valid = min(kBK, rows_total - row0) * D;
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    dst[r * ld + c] = e < valid ? to_float(base[e]) : 0.f;
  }
}

// s[r][c] += Q[ty + 16 r][d .. d + 3] . K[tx + 16 c][d .. d + 3]
__device__ __forceinline__ void qk_step(float (&s)[kRT][4], const float* Qs,
                                        const float* Kt, int ld, int ty,
                                        int tx, int d) {
  float4 kb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    kb[c] = *reinterpret_cast<const float4*>(Kt + (tx + 16 * c) * ld + d);
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const float4 qa = *reinterpret_cast<const float4*>(Qs + (ty + kTY * r) * ld + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[r][c] = fmaf(qa.x, kb[c].x, s[r][c]);
      s[r][c] = fmaf(qa.y, kb[c].y, s[r][c]);
      s[r][c] = fmaf(qa.z, kb[c].z, s[r][c]);
      s[r][c] = fmaf(qa.w, kb[c].w, s[r][c]);
    }
  }
}

template <int DP>
constexpr int smem_bytes() {  // Q, K and V twice, P
  return static_cast<int>(sizeof(float)) * ((kBQ + 4 * kBK) * (DP + 4) + kBQ * kLdP);
}

// KD: D known at compile time (64 or 128, = DP) or 0 for any D <= DP.
// Two blocks per SM at DP = 64 (104,448 B of shared memory, 128
// registers), one at DP = 128.
template <typename T, int DP, bool VEC, int KD>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int S, int T_len, int D, float sm_scale, int causal,
                 int q_offset) {
  constexpr int kLd = DP + 4;       // row stride of Q, K and V
  constexpr int kCol4 = DP / 64;    // float4 output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // (kBQ, kLd)
  float* Ks = Qs + kBQ * kLd;       // 2 x (kBK, kLd)
  float* Vs = Ks + 2 * kBK * kLd;   // 2 x (kBK, kLd)
  float* Ps = Vs + 2 * kBK * kLd;   // (kBQ, kLdP)

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;  // longest first
  const int q0 = qt * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * T_len * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // zero everything once: the columns >= D of Q, K and V stay zero
  for (int e = threadIdx.x; e < (kBQ + 4 * kBK) * kLd; e += kThreads)
    smem[e] = 0.f;
  __syncthreads();

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    const int last = q_offset + min(q0 + kBQ, S) - 1;  // the tile's last query
    n_tiles = min(n_tiles, last / kBK + 1);
  }

  load_tile<VEC, KD>(Qs, kLd, q + q_base, q0, S, D);
  load_tile<VEC, KD>(Ks, kLd, k + kv_base, 0, T_len, D);
  load_tile<VEC, KD>(Vs, kLd, v + kv_base, 0, T_len, D);
  cp_async_commit();

  const float scale = sm_scale * kLog2e;  // logits in log2 units
  const int d_end = KD ? KD : (D + 3) & ~3;
  float m_run[kRT], l_run[kRT], acc[kRT][4 * kCol4];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCol4; ++c) acc[r][c] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed; every thread is done with kt - 1
    if (kt + 1 < n_tiles) {
      load_tile<VEC, KD>(Ks + ((kt + 1) & 1) * kBK * kLd, kLd, k + kv_base,
                         k0 + kBK, T_len, D);
      load_tile<VEC, KD>(Vs + ((kt + 1) & 1) * kBK * kLd, kLd, v + kv_base,
                         k0 + kBK, T_len, D);
      cp_async_commit();
    }
    const float* Kt = Ks + (kt & 1) * kBK * kLd;
    const float* Vt = Vs + (kt & 1) * kBK * kLd;

    // s[r][c]: row ty + 16 r against key k0 + tx + 16 c
    float s[kRT][4];
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    if constexpr (KD > 0) {
#pragma unroll
      for (int d = 0; d < KD; d += 4) qk_step(s, Qs, Kt, kLd, ty, tx, d);
    } else {
#pragma unroll 2
      for (int d = 0; d < d_end; d += 4) qk_step(s, Qs, Kt, kLd, ty, tx, d);
    }

    // online softmax, per row; a row's 64 keys live in the 16 lanes of
    // one half-warp (tx = lane & 15)
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int qpos = q_offset + q0 + ty + kTY * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const bool ok = kpos < T_len && (!causal || kpos <= qpos);
        s[r][c] = ok ? s[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      const float corr = exp2f(m_run[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = exp2f(s[r][c] - m_use);
        sum += s[r][c];
      }
      l_run[r] = l_run[r] * corr + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCol4; ++c) acc[r][c] *= corr;
    }
    __syncwarp();  // this warp's rows of P are no longer read for kt - 1
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty + kTY * r) * kLdP + tx + 16 * c] = s[r][c];
    __syncwarp();

    // acc += P . V, four keys at a time
#pragma unroll
    for (int j = 0; j < kBK; j += 4) {
      float4 vb[4][kCol4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h4 = 0; h4 < kCol4; ++h4)
          vb[jj][h4] = *reinterpret_cast<const float4*>(Vt + (j + jj) * kLd + 64 * h4 + 4 * tx);
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const float4 pa = *reinterpret_cast<const float4*>(Ps + (ty + kTY * r) * kLdP + j);
        const float p[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h4 = 0; h4 < kCol4; ++h4) {
            acc[r][4 * h4 + 0] = fmaf(p[jj], vb[jj][h4].x, acc[r][4 * h4 + 0]);
            acc[r][4 * h4 + 1] = fmaf(p[jj], vb[jj][h4].y, acc[r][4 * h4 + 1]);
            acc[r][4 * h4 + 2] = fmaf(p[jj], vb[jj][h4].z, acc[r][4 * h4 + 2]);
            acc[r][4 * h4 + 3] = fmaf(p[jj], vb[jj][h4].w, acc[r][4 * h4 + 3]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    float l = l_run[r];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int qi = q0 + ty + kTY * r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int h4 = 0; h4 < kCol4; ++h4) {
      const int c0 = 64 * h4 + 4 * tx;
      if (VEC && c0 + 3 < D) {
        *reinterpret_cast<float4*>(orow + c0) =
            make_float4(acc[r][4 * h4] * inv, acc[r][4 * h4 + 1] * inv,
                        acc[r][4 * h4 + 2] * inv, acc[r][4 * h4 + 3] * inv);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < D) orow[c0 + c] = from_float<T>(acc[r][4 * h4 + c] * inv);
      }
    }
  }
}

template <typename T, int DP, bool VEC, int KD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int T_len, int D, float sm_scale,
           int causal, int q_offset, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  auto* kernel = flash_fwd_kernel<T, DP, VEC, KD>;
  // the shared-memory limit belongs to one device: it is set once per
  // device and instantiation (bit d of `set`; every time past device 63)
  static std::atomic<uint64_t> set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(set.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set.fetch_or(bit);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, S, T_len, D,
      sm_scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int S, int T_len, int D, float sm_scale,
               int causal, int q_offset, cudaStream_t stream) {
  // fp32 with 16-byte rows and D = 64 or 128, the common head dims,
  // unrolls over D
  if constexpr (VEC) {
    if (D == 64)
      return launch<T, 64, VEC, 64>(q, k, v, o, B, Hq, Hkv, S, T_len, D,
                                    sm_scale, causal, q_offset, stream);
    if (D == 128)
      return launch<T, 128, VEC, 128>(q, k, v, o, B, Hq, Hkv, S, T_len, D,
                                      sm_scale, causal, q_offset, stream);
  }
  if (D <= 64)
    return launch<T, 64, VEC, 0>(q, k, v, o, B, Hq, Hkv, S, T_len, D, sm_scale,
                                 causal, q_offset, stream);
  return launch<T, 128, VEC, 0>(q, k, v, o, B, Hq, Hkv, S, T_len, D, sm_scale,
                                causal, q_offset, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Sizes are checked by the Python
// wrapper; the checks here only keep a bad call from launching.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int S, int T_len, int D,
                                   float sm_scale, int causal, int q_offset,
                                   int dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || T_len < 1 ||
      D < 1 || D > 128 || (causal && q_offset < 0) || B > 65535 ||
      Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    // 16-byte copies and stores need 16-byte rows: D % 4 == 0, aligned bases
    if (D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o))
      return dispatch_d<float, true>(q, k, v, o, B, Hq, Hkv, S, T_len, D,
                                     sm_scale, causal, q_offset, st);
    return dispatch_d<float, false>(q, k, v, o, B, Hq, Hkv, S, T_len, D,
                                    sm_scale, causal, q_offset, st);
  }
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, false>(q, k, v, o, B, Hq, Hkv, S, T_len,
                                            D, sm_scale, causal, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
