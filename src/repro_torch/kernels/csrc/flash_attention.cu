// Block-wise online-softmax attention (FlashAttention forward), causal or
// full, with grouped KV heads, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel), which the JAX package reaches from
// repro/kernels/ops.py:attention.  It computes, for q (B,Hq,S,D) and
// k, v (B,Hkv,T,D) with Hq % Hkv == 0,
//
//   o[b,h,i] = softmax_j(sm_scale * q[b,h,i] . k[b,h/g,j] | mask) . v[b,h/g,j]
//
// with g = Hq / Hkv, queries aligned to the end of the keys (query i sits
// at position q_offset + i, q_offset = T - S from the caller, >= 0 when
// causal), the causal mask j <= q_offset + i, fp32 arithmetic throughout
// and the output in the input type (fp32 or bf16).
//
// What bounds it: on the Whisper decoder's teacher-forced self-attention,
// q = k = v = (8, 20, 448, 64) bf16, causal.  The call must move 36.7 MB
// (q, k, v read once, o written once), 11.0 us at 3.35 TB/s, and needs
// 4.1 GFLOP for the two products over the causal half, 4.2 us on the
// tensor cores' 989 TFLOP/s: the bound is bytes.  This first kernel does
// its arithmetic in fp32 on the CUDA cores, one FMA per shared-memory
// load, so it is bound by shared-memory load issue instead, well above
// both.  It is the simple kernel that is right; the tensor-core version
// (mma / wgmma on bf16 tiles) is later work.
//
// Design:
//  * one thread block per (query tile of 32 rows, query head, batch), four
//    lanes of a warp per query row; the TPU kernel's sequential kv grid
//    axis becomes a loop over key tiles inside the block;
//  * each key tile (64 keys) of K and V is staged in shared memory as fp32,
//    converted with the intrinsics; q's tile is staged once;
//  * the online-softmax state (m, l and the row's output accumulator) stays
//    in registers in fp32: each lane holds 16 of the row's 64 logits and
//    D/4 of its output columns, and the row's max, sum and weights move
//    between its four lanes by warp shuffles;
//  * causal: the loop stops at the last key tile that the query tile's
//    last row can see, as the TPU kernel skips blocks with pl.when;
//  * ragged edges (S, T not multiples of the tiles, any D <= 128) are
//    masked here: rows past S and keys past T are zero in shared memory,
//    masked keys get -inf logits, and nothing is padded in device memory;
//  * GQA: head h reads kv head h / g, so no repeated K/V exists anywhere.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the caller allocates the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 32;                      // query rows per block
constexpr int kBK = 64;                      // keys per shared-memory tile
constexpr int kLanes = 4;                    // lanes per query row
constexpr int kThreads = kBQ * kLanes;       // 128
constexpr int kKeysPerLane = kBK / kLanes;   // 16
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
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

// Rows [row0, row0 + kRows) of a contiguous (rows_total, D) matrix into a
// float tile with row stride ld; rows past rows_total become zeros.  The
// tile is contiguous in device memory, so neighbouring threads read
// neighbouring elements.
template <int kRows, typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src, int row0,
                                          int rows_total, int D) {
  const T* base = src + static_cast<size_t>(row0) * D;
  const int valid = min(kRows, rows_total - row0) * D;
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    dst[r * ld + c] = e < valid ? to_float(base[e]) : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int S, int T_len, int D, float sm_scale, int causal,
                 int q_offset) {
  constexpr int kCols = DMAX / kLanes;  // output columns per lane
  extern __shared__ float smem[];
  const int ldqk = D | 1;  // odd row stride: the column walks hit distinct banks
  float* Qs = smem;                 // (kBQ, ldqk)
  float* Ks = Qs + kBQ * ldqk;      // (kBK, ldqk)
  float* Vs = Ks + kBK * ldqk;      // (kBK, DMAX), columns >= D stay zero

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * T_len * D;
  const int row = threadIdx.x / kLanes;
  const int sub = threadIdx.x % kLanes;
  const unsigned quad = (threadIdx.x & 31) & ~(kLanes - 1u);
  const int qpos = q_offset + q0 + row;

  for (int e = threadIdx.x; e < kBK * DMAX; e += kThreads)
    if (e % DMAX >= D) Vs[e] = 0.f;
  load_tile<kBQ>(Qs, ldqk, q + q_base, q0, S, D);

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    const int last = q_offset + min(q0 + kBQ, S) - 1;  // the tile's last query
    n_tiles = min(n_tiles, last / kBK + 1);
  }

  float m_run = -INFINITY, l_run = 0.f;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  const float* qrow = Qs + row * ldqk;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every lane is done with the previous tile
    load_tile<kBK>(Ks, ldqk, k + kv_base, k0, T_len, D);
    load_tile<kBK>(Vs, DMAX, v + kv_base, k0, T_len, D);
    __syncthreads();

    // s[i]: this row's logit against key k0 + sub + kLanes * i
    float s[kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i)
        s[i] = fmaf(qd, Ks[(sub + kLanes * i) * ldqk + d], s[i]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int kpos = k0 + sub + kLanes * i;
      const bool ok = kpos < T_len && (!causal || kpos <= qpos);
      s[i] = ok ? s[i] * sm_scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
    const float corr = expf(m_run - m_use);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      s[i] = expf(s[i] - m_use);
      sum += s[i];
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    l_run = l_run * corr + sum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= corr;

    // acc += p . V: key j's weight lives in lane j % kLanes of the quad
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = __shfl_sync(kFull, s[j / kLanes], quad + j % kLanes);
      const float* vrow = Vs + j * DMAX + sub;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(p, vrow[kLanes * i], acc[i]);
    }
  }

  const int qi = q0 + row;
  if (qi < S) {
    T* orow = o + q_base + static_cast<size_t>(qi) * D;
    const float l = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = sub + kLanes * i;
      if (d < D) orow[d] = from_float<T>(acc[i] / l);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int T_len, int D, float sm_scale,
           int causal, int q_offset, cudaStream_t stream) {
  const int ldqk = D | 1;
  const int smem = static_cast<int>(
      sizeof(float) * ((kBQ + kBK) * ldqk + kBK * DMAX));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, S, T_len, D,
      sm_scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int S, int T_len, int D, float sm_scale,
             int causal, int q_offset, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, T_len, D, sm_scale,
                         causal, q_offset, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, T_len, D, sm_scale,
                         causal, q_offset, stream);
  return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, T_len, D, sm_scale,
                        causal, q_offset, stream);
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
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Hq, Hkv, S, T_len, D, sm_scale,
                           causal, q_offset, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T_len, D,
                                   sm_scale, causal, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
