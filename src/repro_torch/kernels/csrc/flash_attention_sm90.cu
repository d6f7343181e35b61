// Block-wise online-softmax attention (FlashAttention forward) on Hopper's
// tensor cores: bf16 inputs, wgmma for both products, TMA loads into an
// mbarrier-guarded ring, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:110
// (flash_attention, body _flash_kernel) for bf16 inputs whose head dim D
// is a multiple of 8.  It computes, for q (B,Hq,S,D) and k, v (B,Hkv,T,D)
// with Hq % Hkv == 0,
//
//   o[b,h,i] = softmax_j(sm_scale * q[b,h,i] . k[b,h/g,j] | mask) . v[b,h/g,j]
//
// with g = Hq / Hkv, query i at key position q_offset + i, the causal mask
// j <= q_offset + i, D <= 128, and o in bf16.  fp32 inputs, and bf16 with
// D % 8 != 0 (TMA needs 16-byte row strides), take the CUDA-core kernel
// in flash_attention.cu; the wrapper chooses and counts the route.
//
// What bounds it: on the Whisper decoder's teacher-forced self-attention,
// q = k = v = (8, 20, 448, 64) bf16, causal, the call must move
// 36,700,160 B (q, k, v read once, o written once), 10.955 us at
// 3.35 TB/s; its 4,119,592,960 flop over the causal half take 4.165 us at
// the tensor cores' 989 TFLOP/s.  The bound is bytes: 10.955 us.  Each
// block re-reads its head's K and V up to the diagonal, so about 73 MB
// cross from L2 to the SMs per call, twice the bytes of the bound.
//
// What held the CUDA-core kernel (flash_attention.cu) back, and what this
// design does about it:
//  1. fp32 FMAs on the CUDA cores, one shared-memory load per FMA.  Here
//     S = Q.K^T is a wgmma m64n64k16 with both operands in shared memory
//     (K-major), and O += P.V a wgmma m64nDk16 with P in registers and V
//     in shared memory (MN-major, trans-b), all accumulating in fp32.
//  2. K and V converted to fp32 as they were staged, with synchronous
//     copies between two __syncthreads().  Here TMA loads bf16 tiles
//     (128-byte swizzle, the layout wgmma reads) into a ring of kStages
//     stages; "full" barriers carry the bytes in flight and "empty"
//     barriers the warpgroup's release, so the next tiles load while this
//     one is computed.  Nothing is staged as fp32.
//  3. Four lanes per query row, each weight shuffled into the P.V loop.
//     Here the softmax runs on wgmma's accumulator layout: a thread holds
//     16 logits of each of two rows, the row max takes two quad shuffles
//     per key tile, the row sum is kept per thread and reduced once at the
//     end, and the fp32 accumulator of S becomes the bf16 A fragment of
//     P.V in place (the two layouts coincide), with no shuffle at all.
//
// Design.  The alternatives named here were built and timed on the card
// in trials at the main shape and at T = 1024 and 1500, and were slower
// or no faster:
//  * one block of one warpgroup (128 threads) per (query tile of 64 rows,
//    query head, batch).  Two warpgroups on a 128-row tile sharing one
//    K/V ring were slower, with or without letting the first warpgroup
//    stop at its own diagonal: at S = 448 the plain version walks 38
//    warpgroup tile steps per head instead of 28, and the shared ring
//    ties the two warpgroups' pace together;
//  * the block's first thread issues the loads (Q, then each key tile once
//    its stage is released) instead of a producer warp: the extra warp's
//    registers cost a block per SM (3 instead of 4 at 106 registers);
//  * two stages: a third costs a block per SM in shared memory, and
//    releasing K apart from V (so K refills as soon as S has read it) did
//    not help either, so the loads are not what the kernel waits on;
//  * the query tiles are launched in reverse order, so the causal tiles
//    with the most key tiles start first;
//  * software pipeline inside the warpgroup: S of tile j is issued
//    together with P.V of tile j - 1, and the softmax of tile j runs while
//    the tensor cores finish P.V (fewer softmax instructions, by folding
//    the scale into the exponent's FMA and skipping unchanged rescales,
//    did not show);
//  * q, k and v are described to TMA as 3-d tensors (D, rows, B*H), so a
//    box past a head's last row or past D reads zeros, never the next
//    head; D is zero-filled up to D_PAD (64 or 128, in 64-column panels);
//  * logits are scaled by sm_scale * log2(e) and exponentiated with
//    ex2.approx.ftz; the mask (keys >= T, and keys after the row's
//    position when causal) is applied only on tiles that cross the
//    diagonal or the ragged end; a row that has seen no key yet keeps
//    m = -inf and uses 0 in its exponent (the CUDA-core kernel's m_use
//    rule);
//  * causal: the key loop stops at the last tile the query tile's last
//    row can see, as the TPU kernel skips blocks with pl.when;
//  * epilogue: o = acc / max(l, 1e-30), rounded to bf16 (nearest even),
//    stored for rows < S and columns < D only.
//
// Precision: P is rounded to bf16 before P.V, as tensor-core flash
// attention does; the TPU kernel keeps p in fp32.  The sum l is taken over
// the fp32 p.  Both are held against the fp32 plain version at the bf16
// tolerance by the tests and chip_smoke.py.
//
// Host side: cuTensorMapEncodeTiled lives in libcuda, not in the CUDA
// runtime; its address is looked up once through the runtime's entry-point
// query, so the library links no libcuda and NVCC_FLAGS stay as they were.  The three
// tensor maps are encoded per call on the host and passed as
// __grid_constant__ kernel parameters.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(), or 1000 + a CUresult if a tensor map could not be
// encoded; the caller allocates the output.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;   // one warpgroup
constexpr int kBQ = 64;         // query rows per block: wgmma's M
constexpr int kBK = 64;         // keys per tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kPanel = 64;      // bf16 columns per 128-byte row
constexpr int kRowBytes = 128;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory, in bytes from a 1024-aligned base (the 128-byte
// swizzle repeats every 8 rows = 1024 B).  Each tile is D_PAD / 64 panels
// of rows x 128 B.
template <int DP>
struct Smem {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBytes = kV + kStages * kTileBytes + 1024;  // + alignment
};

// blocks per SM asked of ptxas: 4 at D_PAD 64 (at most 128 registers),
// 2 at D_PAD 128, whose output accumulator is twice as large
template <int DP>
constexpr int kMinBlocks = DP == 64 ? 4 : 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.  A
// block waits only on its own loads and its own consumers, so a wait that
// outlasts 2^26 polls is a fault: trap, and the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One box of a 3-d tensor map into shared memory; the bytes complete on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
// K-major (Q, K): the stride offset steps 8 rows (1024 B), the leading one
// is unused.  MN-major (V): the stride offset steps 8 keys (1024 B), the
// leading one steps to the next 64-column panel.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instruction's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(r[i][x])::"memory");
}

// D(64 x 64) (+)= A(64 x 16, shared, K-major) . B(16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16, registers) . B(16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) . B(16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (DP == 64)
    wgmma_rs_n64(o, a, desc_v);
  else
    wgmma_rs_n128(o, a, desc_v);
}

// 2^x on the special-function unit; subnormal results flush to 0, which
// for a softmax weight is below 2^-126 of the row's largest
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int S,
                      int T_len, int D, float scale_log2, int causal,
                      int q_offset) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  // bars: [0] q full, [1 + s] k full, [1 + kStages + s] v full,
  // [1 + 2 kStages + s] stage s empty
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = smem_u32(bars);
  const auto k_full = [&](int s) { return bar0 + 8u * (1 + s); };
  const auto v_full = [&](int s) { return bar0 + 8u * (1 + kStages + s); };
  const auto empty = [&](int s) { return bar0 + 8u * (1 + 2 * kStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest tiles first
  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q_offset + min(q0 + kBQ, S) - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kv_head = b * Hkv + h / (Hq / Hkv);
  // K and V of key tile j into stage j % kStages, once every thread has
  // released the tile that was there
  const auto load_tile = [&](int j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
    const uint32_t koff = base + L::kK + s * L::kTileBytes;
    const uint32_t voff = base + L::kV + s * L::kTileBytes;
    mbar_expect_tx(k_full(s), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load_3d(koff + p * kBK * kRowBytes, &tm_k, k_full(s), p * kPanel, j * kBK,
                  kv_head);
    mbar_expect_tx(v_full(s), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load_3d(voff + p * kBK * kRowBytes, &tm_v, v_full(s), p * kPanel, j * kBK,
                  kv_head);
  };
  // thread 0 issues every load of the block: Q and the first kStages key
  // tiles now, each later tile as its stage is released (in the loop)
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar0, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load_3d(base + L::kQ + p * kBQ * kRowBytes, &tm_q, bar0, p * kPanel, q0,
                  b * Hq + h);
    for (int j = 0; j < min(n_tiles, kStages); ++j) load_tile(j);
  }

  // in wgmma's accumulator layout this thread holds rows r and r + 8 of
  // the tile, r = 16 warp + lane / 4, columns 8 n + 2 (lane % 4) + {0, 1}
  // of every 8-column block n: elements 4 n + {0, 1} (row r) and
  // 4 n + {2, 3} (row r + 8)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = q0 + 16 * warp + lane / 4;  // and row + 8
  const int qpos = q_offset + row;
  const int first_pos = q_offset + q0;  // the tile's first query position
  const uint32_t q_smem = base + L::kQ;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s_acc[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s_acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  uint32_t pa[kBK / 16][4];  // P of the previous tile as bf16 A fragments

  // S = Q . K_j^T over D_PAD / 16 steps of 16 columns, issued and committed
  const auto issue_s = [&](int j) {
    const int s = j % kStages;
    const uint32_t k_smem = base + L::kK + s * L::kTileBytes;
    mbar_wait(k_full(s), (j / kStages) & 1);
    wgmma_fence();
    fence_regs(s_acc);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // 16 columns = 32 B into the panel
      wgmma_ss_n64(s_acc,
                   desc_b128(q_smem + (kk / 4) * kBQ * kRowBytes + col, 16, 1024),
                   desc_b128(k_smem + (kk / 4) * kBK * kRowBytes + col, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
  };
  // O += P . V_j over kBK / 16 steps of 16 keys (2048 B of V each)
  const auto issue_pv = [&](int j) {
    const int s = j % kStages;
    const uint32_t v_smem = base + L::kV + s * L::kTileBytes;
    mbar_wait(v_full(s), (j / kStages) & 1);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<DP>(acc, pa[kk],
                   desc_b128(v_smem + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
    wgmma_commit();
  };
  // the online softmax of tile j on the finished s_acc: logits to weights
  // p (in place), m and l updated, corr = exp2(m_old - m_new) per row
  float corr[2];
  const auto softmax = [&](int j) {
    const int k0 = j * kBK;
    // scale to log2 units; mask only where the tile crosses the diagonal
    // or the end of the keys
    const bool masked = k0 + kBK > T_len || (causal && k0 + kBK - 1 > first_pos);
    if (masked) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int qp = qpos + (i % 4 < 2 ? 0 : 8);
        const bool ok = kpos < T_len && (!causal || kpos <= qp);
        s_acc[i] = ok ? s_acc[i] * scale_log2 : -INFINITY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s_acc[i] *= scale_log2;
    }
    float mx[2] = {-INFINITY, -INFINITY}, m_use[2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s_acc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      corr[r] = ex2(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      s_acc[i] = ex2(s_acc[i] - m_use[i % 4 / 2]);
      sum[i % 4 / 2] += s_acc[i];
    }
    l_run[0] = l_run[0] * corr[0] + sum[0];
    l_run[1] = l_run[1] * corr[1] + sum[1];
  };
  // P as bf16 A fragments: keys 16 kk .. 16 kk + 15 are accumulator
  // elements 8 kk .. 8 kk + 7, already in the A operand's order
  const auto pack_p = [&] {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(s_acc[8 * kk + 2 * x], s_acc[8 * kk + 2 * x + 1]);
  };

  // Software pipeline: the softmax of tile j runs while the tensor cores
  // do P.V of tile j - 1.  A stage is released once P.V has read its V.
  mbar_wait(bar0, 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s_acc);
  softmax(0);  // acc is still 0: nothing to rescale
  pack_p();
  for (int j = 1; j < n_tiles; ++j) {
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S_j done; P.V of tile j - 1 may still run
    fence_regs(s_acc);
    softmax(j);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);  // the previous P stays put until its product is done
    mbar_arrive(empty((j - 1) % kStages));
    if (threadIdx.x == 0 && j - 1 + kStages < n_tiles)
      load_tile(j - 1 + kStages);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[i % 4 / 2];
    pack_p();
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
  __nv_bfloat16* out = o + (static_cast<size_t>(b) * Hq + h) * S * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int c = 8 * n + 2 * (lane % 4);
    if (c >= D) continue;  // D % 8 == 0: c < D implies c + 1 < D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      if (qi < S)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(qi) * D + c) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] / l_run[r],
                                  acc[4 * n + 2 * r + 1] / l_run[r]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                : nullptr;
  }();
  return fn;
}

// (D, rows, heads) bf16, boxes of 64 columns x box_rows rows x 1 head,
// 128-byte swizzle, zeros outside the tensor.
CUresult encode(CUtensorMap* map, const void* ptr, int D, int rows, int heads,
                int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {kPanel, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                   dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* o, int B, int Hq, int Hkv, int S, int T_len, int D,
           float scale_log2, int causal, int q_offset, cudaStream_t stream) {
  constexpr int smem = Smem<DP>::kBytes;
  // the shared-memory limit is set once per device (bit d of `set`)
  static std::atomic<uint64_t> set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(set.load() & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set.fetch_or(bit);
  }
  const dim3 grid(Hq, B, (S + kBQ - 1) / kBQ);
  flash_fwd_sm90_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, S, T_len, D, scale_log2,
      causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only.  Sizes are checked by the Python wrapper; the checks here only
// keep a bad call from launching.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k,
                                        const void* v, void* o, int B, int Hq,
                                        int Hkv, int S, int T_len, int D,
                                        float sm_scale, int causal, int q_offset,
                                        void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || T_len < 1 ||
      D < 8 || D > 128 || D % 8 != 0 || (causal && q_offset < 0) || B > 65535 ||
      Hq > 65535 || misaligned(q) || misaligned(k) || misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  CUresult r = encode(&tq, q, D, S, B * Hq, kBQ);
  if (r == CUDA_SUCCESS) r = encode(&tk, k, D, T_len, B * Hkv, kBK);
  if (r == CUDA_SUCCESS) r = encode(&tv, v, D, T_len, B * Hkv, kBK);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  const auto st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64>(tq, tk, tv, o, B, Hq, Hkv, S, T_len, D, scale_log2, causal,
                      q_offset, st);
  return launch<128>(tq, tk, tv, o, B, Hq, Hkv, S, T_len, D, scale_log2, causal,
                     q_offset, st);
}
