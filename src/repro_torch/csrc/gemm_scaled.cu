// Per-K-block scaled GEMM with an fp32 accumulator for Hopper (sm_90a), CUDA
// C++ with a plain C interface (loaded with ctypes by
// repro_torch/hopper/gemm_scaled.py).
//
// Replaces: src/repro/kernels/gemm.py `_gemm_scaled_kernel` (as built by
// `gemm_scaled_program` and `gemm_scaled_pallas`).
//
// What it computes. A (M, K) and B (K, N) arrive quantized per K-block of
// `bk` elements: values in one compute type (fp32, bf16, fp8 e4m3 or fp8
// e5m2) and fp32 scales a_s (M, nk), b_s (nk, N), nk = ceil(K / bk). For each
// K-block kb the kernel forms the product of the narrow values in a fresh
// fp32 partial tile, then adds part[m, n] * (a_s[m, kb] * b_s[kb, n]) to the
// fp32 accumulator: the TPU kernel's `acc += dot * (a_s (x) b_s)`. C (M, N)
// is fp32 or bf16, one rounding at the end. The quantization itself runs
// before the kernel (core/precision.py), as it runs outside the Pallas body
// in the reference. Ragged M, N and K (and a ragged last K-block) are
// masked: tiles are zero-filled past the edges and past each K-block's end,
// so a tile never mixes two blocks' values under one scale.
//
// Bound on this card. At the ladder's card shape (the occamy-gptj MLP
// up-projection of a 2048-token prefill, (2048, 4096) . (4096, 16384), bk
// 256) the product does 2MNK = 275 GFLOP; over the compute type's peak
// (fp32 67, bf16 989, fp8 1979 TFLOP/s) that takes longer than moving the
// values, scales and output over 3.35 TB/s, so the function is bound by
// operations. Three kernels, one route each; the wrapper's planner
// (hopper/gemm_scaled.py `plan`) picks the route from shapes and types:
//
//  - wgmma (bf16, e4m3, e5m2 where bk is a multiple of a stage's k and the
//    rows are 16-byte aligned): a persistent grid of one CTA an SM walking
//    128 x 128 output tiles, M fastest, so the CTAs at work share B's
//    column panels in L2. One producer thread keeps a ring of 6 stages full
//    by TMA (128 bytes of k a stage: 64 bf16 or 128 fp8 values, in boxes of
//    64 rows, 128B-swizzled as wgmma reads them and zero-filled by TMA past
//    M, N and K), completed on mbarriers; two consumer warpgroups each take
//    64 rows and issue wgmma m64n128 from shared memory (bf16 k16 with B
//    read MN-major, no copy; fp8 k32 at the native fp8 rate, both operands
//    K-major, so B is first transposed into a scratch (N, K) by a small
//    kernel in the same call). A consumer walks its k-steps in promotion
//    units of `promote` values (a divisor of bk, so a unit never mixes two
//    K-blocks), alternating two partial register tiles: unit u + 1's wgmmas
//    are issued, fresh (scale_d = 0), before unit u's partial is scaled by
//    its block's a_s (x) b_s and added to the fp32 accumulator, so the
//    tensor cores work while the CUDA cores scale. The fp8 tensor-core sum
//    keeps fewer bits than fp32, so fp8 partials are never carried further
//    than `promote` values (CUTLASS's MMA promotion interval, chosen on the
//    card: e4m3 64, e5m2 128); bf16's is fp32, and its units span two
//    stages (128 values) to halve the scaling. A thread keeps its rows' a_s
//    in registers and each warp its tile's 128 b_s in shared memory, loaded
//    a K-block ahead. ptxas serialises every wgmma of a function when a
//    branch it cannot prove warp-uniform sits among them, so the mbarrier
//    wait loop and the release are PTX's own (a labelled loop, a predicated
//    arrive).
//  - ffma (fp32 values, the fp32 policy): exact fp32 on the CUDA cores with
//    gemm.cu's fp32 design: a cp.async ring, 4 x 12 or 2 x 12 register
//    tiles, up to 12 warps, tiles of 8 tm wr rows x 48 wc columns walked by
//    a persistent grid; B streams through the ring (the card shape's
//    4096-row panel does not fit). Chunks of 32 k, not gemm.cu's 16: the
//    ring's barrier and copies per k halve, which the card shape showed
//    faster (PERF.md). The K loop splits at block edges (a chunk is
//    zero-filled past its block's end) and each block's partial is scaled
//    into the accumulator.
//  - mma (every other shape: a bk that is not a multiple of a stage's k,
//    rows not 16-byte aligned, M or N below 64, fp8 N not a multiple of
//    16): mma.sync m16n8k16 with fp32 accumulation on 128 x 64 tiles (4
//    warps of 32 x 64), bf16
//    MMAs for bf16 values and fp16 MMAs for fp8 values, which
//    cvt.rn.f16x2.e4m3x2 / .e5m2x2 widen exactly as they are staged; tiles
//    move in chunks of 8 values, and the next tile loads into registers
//    while the current one's MMAs run. Any bk >= 1.
//
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): for the
// wgmma route, halving the grid doubles the time and three stages do as
// well as six, so each CTA's own work bounds it, not L2 or latency: the
// TMA intake of its stages, and the scaling between units (2 x 2 clusters
// sharing A and B halves by TMA multicast were slower, and are gone).
//
// Offsets are 64-bit (long long) throughout.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using tma::mbar_arrive_lane0;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::tensor_map;

enum ValueType { VT_F32 = 0, VT_BF16 = 1, VT_E4M3 = 2, VT_E5M2 = 3 };

struct Params {
  const void* a;
  const void* b;
  const float* as;  // (M, nk)
  const float* bs;  // (nk, N)
  void* c;
  int M, N, K, bk, nk;
  long long lda, ldb, ldc;  // row strides of the values and of C (elements)
  long long as0, as1, bs0, bs1;  // element strides of the two scale tensors
  int vec_a, vec_b;  // 16-byte aligned base and a row stride that is a multiple of 8 (mma route)
  int vec_out;       // C's rows take 2-element stores (wgmma route) / 4-element stores (ffma route)
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store4(float* p, float x, float y, float z, float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float x, float y, float z, float w) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x, y), hi = __floats2bfloat162_rn(z, w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// ffma route: fp32 values on the CUDA cores, gemm.cu's ring and tiles
// ---------------------------------------------------------------------------

constexpr int F_BK = 32;             // k values per ring stage: twice gemm.cu's, half its barriers a k
constexpr int F_AS = F_BK + 4;       // A stage row stride (floats)
constexpr int F_TN = 12;             // columns per thread: three float4
constexpr int F_MAX_STAGES = 8;
constexpr int F_MAX_THREADS = 384;   // 12 warps: up to 168 registers a thread (acc + part + scales)
constexpr int SMEM_MAX = 232448;     // 227 KB of dynamic shared memory a CTA may use

// The planner's choice (hopper/gemm_scaled.py `plan`), checked by the entry.
struct FPlan {
  int wr, wc;        // warps down and across: BM = 8 TM wr rows, BN = 48 wc columns
  int stages;        // ring depth
  int row_tiles;     // ceil(M / BM); tile t is (t % row_tiles, t / row_tiles)
  int tiles;         // row_tiles x col_tiles
  int vec;           // 16-byte copies of A and B rows (aligned rows, bk % 4 == 0)
  int cb, cl;        // F_BK-chunks of a whole K-block and of the last one
};

// hopper/gemm_scaled.py `ffma_smem_bytes` is the same formula
long long f_smem_bytes(int tm, int wr, int wc, int stages) {
  return 4LL * stages * (8LL * tm * wr * F_AS + F_BK * 48LL * wc);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// The oldest pending chunk has landed once at most stages - 2 younger
// groups are pending (wait_group takes an immediate).
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  switch (stages) {
    case 2: cp_async_wait<0>(); break;
    case 3: cp_async_wait<1>(); break;
    case 4: cp_async_wait<2>(); break;
    case 5: cp_async_wait<3>(); break;
    case 6: cp_async_wait<4>(); break;
    case 7: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Where a CTA's next copies go: ring stage `stage` gets chunk `kc` of
// K-block `kb` of the CTA's tile `it` (global tile blockIdx.x + it *
// gridDim.x). Advanced one chunk at a time, so no division runs in the loop.
struct Cursor {
  int it, kb, kc, stage;
  __device__ __forceinline__ void next(const Params& p, const FPlan& q) {
    if (++kc == (kb == p.nk - 1 ? q.cl : q.cb)) {
      kc = 0;
      if (++kb == p.nk) {
        kb = 0;
        ++it;
      }
    }
    if (++stage == q.stages) stage = 0;
  }
};

// Issue the copies of the cursor's chunk into its ring stage and commit
// them as one group (an empty group past the CTA's last tile, so every
// thread counts groups alike). Elements past M, N, or the chunk's K-block
// are zero-filled.
template <int TM>
__device__ __forceinline__ void f_issue(const Params& p, const FPlan& q, float* ring, const Cursor& u,
                                        int my_tiles, int stage_floats) {
  if (u.it < my_tiles) {
    const int BM = 8 * TM * q.wr, BN = 48 * q.wc, T = 32 * q.wr * q.wc;
    const int tid = threadIdx.x;
    const int tile = blockIdx.x + u.it * gridDim.x;
    const long long m0 = static_cast<long long>(tile % q.row_tiles) * BM;
    const int n0 = (tile / q.row_tiles) * BN;
    const int kb1 = min((u.kb + 1) * p.bk, p.K);
    const int k0 = u.kb * p.bk + u.kc * F_BK;
    float* sA = ring + u.stage * stage_floats;
    float* sB = sA + BM * F_AS;
    const float* A = static_cast<const float*>(p.a);
    const float* B = static_cast<const float*>(p.b);
    if (q.vec) {
      for (int x = tid; x < BM * (F_BK / 4); x += T) {
        const int r = x / (F_BK / 4), kk = (x % (F_BK / 4)) * 4, k = k0 + kk;
        const long long m = m0 + r;
        const int bytes = (m < p.M && k < kb1) ? (kb1 - k >= 4 ? 16 : (kb1 - k) * 4) : 0;
        cp_async16(smem_u32(sA + r * F_AS + kk), bytes ? A + m * p.lda + k : A, bytes);
      }
      for (int x = tid; x < F_BK * (BN / 4); x += T) {
        const int r = x / (BN / 4), cc = (x - r * (BN / 4)) * 4;
        const int k = k0 + r, n = n0 + cc;
        const int bytes = (k < kb1 && n < p.N) ? (p.N - n >= 4 ? 16 : (p.N - n) * 4) : 0;
        cp_async16(smem_u32(sB + r * BN + cc), bytes ? B + static_cast<long long>(k) * p.ldb + n : B, bytes);
      }
    } else {
      for (int x = tid; x < BM * F_BK; x += T) {
        const int r = x / F_BK, kk = x % F_BK, k = k0 + kk;
        const long long m = m0 + r;
        const bool in = m < p.M && k < kb1;
        cp_async4(smem_u32(sA + r * F_AS + kk), in ? A + m * p.lda + k : A, in ? 4 : 0);
      }
      for (int x = tid; x < F_BK * BN; x += T) {
        const int r = x / BN, cc = x - r * BN;
        const int k = k0 + r, n = n0 + cc;
        const bool in = k < kb1 && n < p.N;
        cp_async4(smem_u32(sB + r * BN + cc), in ? B + static_cast<long long>(k) * p.ldb + n : B, in ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

template <int TM, typename OutT>
__global__ void __launch_bounds__(F_MAX_THREADS, 1) gemm_scaled_ffma_kernel(const Params p, const FPlan q) {
  extern __shared__ __align__(16) float smem[];
  const int BM = 8 * TM * q.wr, BN = 48 * q.wc, S = q.stages;
  const int stage_floats = BM * F_AS + F_BK * BN;
  float* ring = smem;
  const int my_tiles = q.tiles > static_cast<int>(blockIdx.x)
                           ? (q.tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                           : 0;
  const long long total = static_cast<long long>(my_tiles) * ((p.nk - 1) * q.cb + q.cl);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = (warp / q.wc) * 8 * TM;                // this warp's first row in a tile
  const int row0 = wrow + (lane >> 2);                     // this thread's rows: row0 + 8 i
  const int col0 = ((warp % q.wc) * 4 + (lane & 3)) * 4;  // its columns: col0 + third j + (0..3)
  const int third = 16 * q.wc;

  Cursor issue{0, 0, 0, 0};
  for (int s = 0; s < S - 1; ++s) {
    f_issue<TM>(p, q, ring, issue, my_tiles, stage_floats);
    issue.next(p, q);
  }

  float acc[TM][F_TN], part[TM][F_TN], sa[TM], sb[F_TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = part[i][j] = 0.f;

  Cursor cur{0, 0, 0, 0};
  for (long long c = 0; c < total; ++c) {
    cp_async_wait_ring(S);
    __syncthreads();  // chunk c is in for every thread; stage (c - 1) % S is free
    f_issue<TM>(p, q, ring, issue, my_tiles, stage_floats);
    issue.next(p, q);

    const int tile = blockIdx.x + cur.it * gridDim.x;
    const long long m0 = static_cast<long long>(tile % q.row_tiles) * BM;
    const int n0 = (tile / q.row_tiles) * BN;
    const bool rows = m0 + wrow < p.M;  // a warp row wholly past M skips its work
    if (rows && cur.kc == 0) {  // a K-block starts: its scales, used at its end
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long m = m0 + row0 + 8 * i;
        sa[i] = m < p.M ? p.as[m * p.as0 + cur.kb * p.as1] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < F_TN; ++j) {
        const int n = n0 + col0 + (j >> 2) * third + (j & 3);
        sb[j] = n < p.N ? p.bs[cur.kb * p.bs0 + n * p.bs1] : 0.f;
      }
    }
    if (rows) {
      const float* stage = ring + cur.stage * stage_floats;
      const float* sA = stage + row0 * F_AS;
      const float* sB = stage + BM * F_AS + col0;
#pragma unroll
      for (int kq = 0; kq < F_BK; kq += 4) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(sA + i * 8 * F_AS + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* bp = sB + (kq + kk) * BN;
          const float4 b0 = *reinterpret_cast<const float4*>(bp);
          const float4 b1 = *reinterpret_cast<const float4*>(bp + third);
          const float4 b2 = *reinterpret_cast<const float4*>(bp + 2 * third);
          const float b[F_TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b2.x, b2.y, b2.z, b2.w};
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = lane_of(a[i], kk);
#pragma unroll
            for (int j = 0; j < F_TN; ++j) part[i][j] = fmaf(av, b[j], part[i][j]);
          }
        }
      }
      if (cur.kc == (cur.kb == p.nk - 1 ? q.cl : q.cb) - 1) {  // the K-block is done: scale it in
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < F_TN; ++j) {
            acc[i][j] = fmaf(part[i][j], sa[i] * sb[j], acc[i][j]);
            part[i][j] = 0.f;
          }
        if (cur.kb == p.nk - 1) {  // the tile is done: store it, start the next from zero
          OutT* C = static_cast<OutT*>(p.c);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const long long m = m0 + row0 + 8 * i;
            if (m < p.M) {
              OutT* crow = C + m * p.ldc;
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                const int n = n0 + col0 + j * third;
                if (p.vec_out && n + 3 < p.N) {
                  store4(crow + n, acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    if (n + e < p.N) crow[n + e] = from_f32<OutT>(acc[i][4 * j + e]);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.f;
          }
        }
      }
    }
    cur.next(p, q);
  }
  cp_async_wait<0>();  // the trailing groups are empty; leave none pending
}

// ---------------------------------------------------------------------------
// wgmma route: bf16 / fp8 values, TMA ring, producer warp + two consumer
// warpgroups, persistent 128 x 128 tiles
// ---------------------------------------------------------------------------

constexpr int W_BM = 128, W_BN = 128;
constexpr int W_ROW = 128;             // bytes of k in a stage row: one 128B swizzle row
constexpr int W_TILE = 128 * W_ROW;    // 16 KB: A's or B's half of a stage
constexpr int W_STAGE = 2 * W_TILE;    // 32 KB
constexpr int W_THREADS = 384;         // warpgroup 0 produces, 1 and 2 consume
constexpr int W_MAX_STAGES = 7;

// hopper/gemm_scaled.py `wgmma_smem_bytes` is the same formula: the stages,
// 1 KB to align them for the swizzle, a full and an empty mbarrier each,
// and two K-blocks' b_s for the tile's 128 columns for each consumer warp
long long w_smem_bytes(int stages) {
  return static_cast<long long>(stages) * W_STAGE + 1024 + 16LL * stages + 8 * 256 * 4;
}

struct WPlan {
  int stages;
  int tiles_m, tiles;  // tile t is (t % tiles_m, t / tiles_m): down M, then across N
  int per_block;  // stages a K-block spans
  int nkt;        // stages a tile takes: ceil(K / stage k)
};

template <int VT>
__device__ __forceinline__ void w_mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (VT == VT_BF16) {
    wgmma::mma_ss_n128_bf16_tb(d, a, b, scale_d);
  } else if constexpr (VT == VT_E4M3) {
    wgmma::mma_ss_n128_e4m3(d, a, b, scale_d);
  } else {
    wgmma::mma_ss_n128_e5m2(d, a, b, scale_d);
  }
}

// Stage layout: A (128 rows of 128 bytes of k, 128B-swizzled: TMA's box
// {stage k, 128}), then B. bf16 B arrives (K, N) and stays MN-major: two
// boxes {64 n, 64 k}, each 64 k-rows of 128 bytes, the wgmma reading them
// as column blocks 8 KB apart (LBO) with 8-row groups 1 KB apart (SBO);
// fp8 B arrives transposed, (N, K), a box {128 k, 128 n} read K-major like
// A. A wgmma k-step is 32 bytes of k for both types.
//
// A consumer warpgroup walks its tile's k-steps in promotion units of CK
// steps (a unit never spans two K-blocks: CK steps divide bk), alternating
// two partial register tiles: unit u + 1's wgmmas are issued before unit
// u's partial is scaled into the accumulator, so the tensor cores work
// while the CUDA cores scale. A stage is released once its last unit's
// products are complete. The block's scales (this warpgroup's 64 rows of
// a_s, the tile's 128 columns of b_s) sit in shared memory, two blocks'
// worth, loaded into registers when the block's first unit is issued and
// stored after the warpgroup's barrier.
template <int VT, int CK>
struct WUnit {
  static constexpr int UPS = CK < 4 ? 4 / CK : 1;  // units a stage
  static constexpr int SPU = CK > 4 ? CK / 4 : 1;  // stages a unit
  // k-steps first .. first + n - 1 of a stage into `part`; `fresh`: the
  // first overwrites it
  template <int N>
  static __device__ __forceinline__ void issue(float (&part)[64], uint32_t sA, uint32_t sB, int first, bool fresh) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int ks = first + s;
      const uint64_t da = wgmma::smem_desc(sA + 32 * ks, 16, 1024, wgmma::SWIZZLE_128B);
      const uint64_t db = VT == VT_BF16
                              ? wgmma::smem_desc(sB + ks * 16 * W_ROW, W_TILE / 2, 1024, wgmma::SWIZZLE_128B)
                              : wgmma::smem_desc(sB + 32 * ks, 16, 1024, wgmma::SWIZZLE_128B);
      w_mma<VT>(part, da, db, (fresh && s == 0) ? 0 : 1);
    }
  }
};

template <int VT, int CK, typename OutT>
__global__ void __launch_bounds__(W_THREADS, 1)
    gemm_scaled_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                             const Params p, const WPlan q) {
  constexpr int KEL = VT == VT_BF16 ? 64 : 128;  // k values a stage holds
  using U = WUnit<VT, CK>;
  constexpr int UPS = U::UPS, SPU = U::SPU;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + q.stages * W_STAGE;  // full[0 .. S), then empty[0 .. S)
  // b_s of two K-blocks for each consumer warp: 8 x 256 floats
  float* const sscale = reinterpret_cast<float*>(smem_raw + (bars + 16 * q.stages - smem_u32(smem_raw)));

  if (threadIdx.x == 0) {
    for (int s = 0; s < q.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                // the producer's arrive + TMA's bytes
      mbar_init(bars + 8 * (q.stages + s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
        const int m0 = (tile % q.tiles_m) * W_BM, n0 = (tile / q.tiles_m) * W_BN;
        for (int kt = 0; kt < q.nkt; ++kt) {
          mbar_wait(bars + 8 * (q.stages + stage), phase ^ 1);  // the consumers freed it
          const uint32_t st = base + stage * W_STAGE, full = bars + 8 * stage;
          mbar_expect_tx(full, W_STAGE);
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // boxes of 64 rows (A) and 64 columns (B)
            tma::load_2d(st + h * (W_TILE / 2), &tma_a, full, kt * KEL, m0 + h * 64);
            if constexpr (VT == VT_BF16) {
              tma::load_2d(st + W_TILE + h * (W_TILE / 2), &tma_b, full, n0 + h * 64, kt * KEL);
            } else {
              tma::load_2d(st + W_TILE + h * (W_TILE / 2), &tma_b, full, kt * KEL, n0 + h * 64);
            }
          }
          if (++stage == q.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = warp * 16 + g;  // this thread's rows of the warpgroup's 64: r0 and r0 + 8
    float* const sbw = sscale + (cw * 4 + warp) * 256;  // this warp's b_s of two K-blocks (parity)
    float acc[64], p0[64], p1[64];
    int stage = 0, phase = 0;  // the next stage to wait for
    int rstage = 0;            // the next stage to release
    // a unit never spans two K-blocks: CK k-steps divide bk (the last unit of
    // a ragged last block may hold fewer stages)
    const int units = q.nkt * UPS / SPU + (q.nkt % SPU ? 1 : 0), block_units = UPS * q.per_block / SPU;
    for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
      const long long m0 = static_cast<long long>(tile % q.tiles_m) * W_BM + cw * 64;
      const int n0 = (tile / q.tiles_m) * W_BN;
      // K-block kb's scales: a_s of this thread's rows (registers), b_s of the
      // tile's columns lane * 4 .. lane * 4 + 3 (the warp's buffer)
      auto load_sa = [&](int kb, float (&d)[2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + r0 + 8 * h;
          d[h] = m < p.M ? p.as[m * p.as0 + kb * p.as1] : 0.f;
        }
      };
      auto sb_col = [&](int kb, int c) {
        const int n = n0 + lane * 4 + c;
        return n < p.N ? p.bs[kb * p.bs0 + n * p.bs1] : 0.f;
      };
      auto load_sb = [&](int kb) { return make_float4(sb_col(kb, 0), sb_col(kb, 1), sb_col(kb, 2), sb_col(kb, 3)); };
      float sa[2], sa_next[2] = {0.f, 0.f};
      float4 sb_next = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();  // the warp is done with the last tile's buffer
      load_sa(0, sa);
      *reinterpret_cast<float4*>(sbw + lane * 4) = load_sb(0);
      if (p.nk > 1) {  // a block ahead: its loads land while block 0 runs
        load_sa(1, sa_next);
        sb_next = load_sb(1);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;

      // unit u: k-steps u CK .. u CK + CK - 1 (a part of a stage, or SPU
      // stages); a stage is waited for when its first unit is issued
      auto wait_stage = [&]() {
        mbar_wait(bars + 8 * stage, phase);
        const int s = stage;
        if (++stage == q.stages) {
          stage = 0;
          phase ^= 1;
        }
        return base + s * W_STAGE;
      };
      auto issue = [&](float (&part)[64], int u) {
        if constexpr (SPU == 1) {
          const uint32_t st = u % UPS == 0 ? wait_stage() : base + (stage == 0 ? q.stages - 1 : stage - 1) * W_STAGE;
          wgmma::fence();
          U::template issue<CK>(part, st + cw * 64 * W_ROW, st + W_TILE, (u % UPS) * CK, true);
        } else {
          const uint32_t st = wait_stage();
          wgmma::fence();
          U::template issue<4>(part, st + cw * 64 * W_ROW, st + W_TILE, 0, true);
#pragma unroll
          for (int h = 1; h < SPU; ++h) {
            if (u * SPU + h < q.nkt) {
              const uint32_t sh = wait_stage();
              U::template issue<4>(part, sh + cw * 64 * W_ROW, sh + W_TILE, 0, false);
            }
          }
        }
        wgmma::commit();
      };
      // unit u is in `part` and unit u + 1 (if any) goes to `other`: issue
      // it, wait for u, release u's stage if it was the stage's last, scale u in
      auto finish = [&](float (&part)[64], float (&other)[64], int u) {
        const bool next = u + 1 < units;
        if (next) {
          issue(other, u + 1);
          wgmma::wait<1>();
        } else {
          wgmma::wait<0>();
        }
        wgmma::fence_operands(part);
        if (u % UPS == UPS - 1) {  // the unit's stages are complete: free them
#pragma unroll
          for (int h = 0; h < SPU; ++h) {
            if (h == 0 || u * SPU + h < q.nkt) {
              mbar_arrive_lane0(bars + 8 * (q.stages + rstage), lane);
              if (++rstage == q.stages) rstage = 0;
            }
          }
        }
        const int kb = u / block_units;
        const float* sb = sbw + (kb & 1) * 128;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(sb + 8 * j + 2 * t);
          acc[4 * j] = fmaf(part[4 * j], sa[0] * b.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(part[4 * j + 1], sa[0] * b.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(part[4 * j + 2], sa[1] * b.x, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(part[4 * j + 3], sa[1] * b.y, acc[4 * j + 3]);
        }
        if (next && (u + 1) % block_units == 0) {  // block kb + 1 starts: its scales are in hand
          sa[0] = sa_next[0];
          sa[1] = sa_next[1];
          *reinterpret_cast<float4*>(sbw + ((kb + 1) & 1) * 128 + lane * 4) = sb_next;
          if (kb + 2 < p.nk) {  // and the next block's are loaded now, a block ahead
            load_sa(kb + 2, sa_next);
            sb_next = load_sb(kb + 2);
          }
          __syncwarp();
        }
      };

      issue(p0, 0);
      for (int u = 0; u < units; u += 2) {
        finish(p0, p1, u);
        if (u + 1 < units) finish(p1, p0, u + 1);
      }

      // the accumulator: d[4 j + e] is row r0 + 8 (e >> 1), column 8 j + 2 t + (e & 1)
      OutT* C = static_cast<OutT*>(p.c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + r0 + 8 * h;
        if (m >= p.M) continue;
        OutT* crow = C + m * p.ldc;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
          if (p.vec_out && n + 1 < p.N) {
            store2(crow + n, x, y);
          } else {
            if (n < p.N) crow[n] = from_f32<OutT>(x);
            if (n + 1 < p.N) crow[n + 1] = from_f32<OutT>(y);
          }
        }
      }
    }
  }
}

// fp8 B (K, N) -> its transpose (N, K) with row stride ldd, for the wgmma
// route (fp8 wgmma reads both operands K-major): a 64 x 64 byte tile a CTA.
// A thread reads four k-rows of four bytes (a warp: 128 bytes of each of two
// rows), transposes the 4 x 4 bytes in registers (__byte_perm) and writes
// four words of k-bytes into the transposed tile in shared memory; then four
// threads write each 64-byte output row. The route takes N % 16 == 0 and
// 16-byte aligned rows; a chunk of the transpose past K lands in its rows'
// padding (ldd >= K rounded up to 16), which no tile reads.
__global__ void __launch_bounds__(256) transpose_u8_kernel(const uint8_t* src, uint8_t* dst, int K, int N,
                                                           long long lds, long long ldd) {
  __shared__ uint32_t tile[64][17];  // [n][k / 4]: 17 words a row spread a column over the banks
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  {
    const int nw = threadIdx.x & 15, kq = threadIdx.x >> 4;  // bytes n0 + 4 nw .., rows k0 + 4 kq ..
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 4 * kq + i;
      x[i] = (k < K && n0 + 4 * nw < N)
                 ? *reinterpret_cast<const uint32_t*>(src + static_cast<long long>(k) * lds + n0 + 4 * nw)
                 : 0u;
    }
    const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140), t1 = __byte_perm(x[2], x[3], 0x5140);
    const uint32_t t2 = __byte_perm(x[0], x[1], 0x7362), t3 = __byte_perm(x[2], x[3], 0x7362);
    tile[4 * nw][kq] = __byte_perm(t0, t1, 0x5410);  // byte i: row k0 + 4 kq + i of column 4 nw
    tile[4 * nw + 1][kq] = __byte_perm(t0, t1, 0x7632);
    tile[4 * nw + 2][kq] = __byte_perm(t2, t3, 0x5410);
    tile[4 * nw + 3][kq] = __byte_perm(t2, t3, 0x7632);
  }
  __syncthreads();
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;  // output row n0 + r, bytes k0 + 16 c ..
  if (n0 + r < N && k0 + 16 * c < K) {
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(n0 + r) * ldd + k0 + 16 * c) =
        make_uint4(tile[r][4 * c], tile[r][4 * c + 1], tile[r][4 * c + 2], tile[r][4 * c + 3]);
  }
}

// ---------------------------------------------------------------------------
// mma route: bf16 / fp8 values at every other shape
// ---------------------------------------------------------------------------

// two fp8 values (the low byte first) to two fp16 values in one word, by the
// card's own conversion (sm_89+): exact, since every e4m3 and e5m2 value is an
// fp16 value; NaN stays NaN
template <int VT>
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint16_t x) {
  uint32_t d;
  if constexpr (VT == VT_E4M3) {
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(d) : "h"(x));
  } else {
    asm("cvt.rn.f16x2.e5m2x2 %0, %1;" : "=r"(d) : "h"(x));
  }
  return d;
}

// Eight consecutive values of a narrow operand as they sit in memory: bf16
// in 16 bytes, fp8 in 8. A tile is fetched into these registers before the
// previous tile's MMAs and converted only when it is stored to shared
// memory, so the loads are in flight while the tensor cores work.
template <int VT>
struct Raw8 {
  uint4 v;  // 8 bf16
};
template <>
struct Raw8<VT_E4M3> {
  uint2 v;  // 8 fp8 bytes
};
template <>
struct Raw8<VT_E5M2> {
  uint2 v;
};

// values e .. e + count - 1 of `base` (count <= 8), zeros past them; one
// vector load when the chunk is whole and aligned, single loads otherwise
template <int VT>
__device__ __forceinline__ Raw8<VT> fetch8(const void* base, long long e, int count, bool vec) {
  Raw8<VT> r;
  if constexpr (VT == VT_BF16) {
    const uint16_t* src = static_cast<const uint16_t*>(base) + e;
    if (vec && count == 8) {
      r.v = *reinterpret_cast<const uint4*>(src);
    } else {
      uint16_t h[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = j < count ? src[j] : 0;
      r.v = make_uint4(h[0] | (uint32_t(h[1]) << 16), h[2] | (uint32_t(h[3]) << 16),
                       h[4] | (uint32_t(h[5]) << 16), h[6] | (uint32_t(h[7]) << 16));
    }
  } else {
    const uint8_t* src = static_cast<const uint8_t*>(base) + e;
    if (vec && count == 8) {
      r.v = *reinterpret_cast<const uint2*>(src);
    } else {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j / 4] |= (j < count ? uint32_t(src[j]) : 0u) << (8 * (j % 4));
      r.v = make_uint2(w[0], w[1]);
    }
  }
  return r;
}

// the eight values as the MMA's 16-bit type (bf16 for bf16, fp16 for fp8)
template <int VT>
__device__ __forceinline__ uint4 widen8(const Raw8<VT>& r) {
  if constexpr (VT == VT_BF16) {
    return r.v;
  } else {
    return make_uint4(fp8x2_to_f16x2<VT>(r.v.x & 0xFFFFu), fp8x2_to_f16x2<VT>(r.v.x >> 16),
                      fp8x2_to_f16x2<VT>(r.v.y & 0xFFFFu), fp8x2_to_f16x2<VT>(r.v.y >> 16));
  }
}

constexpr int H_BM = 128, H_BN = 64, H_BK = 32, H_THREADS = 128;
constexpr int H_S = H_BK + 8;  // padded row stride (elements) of both tiles
constexpr int A_CHUNKS = H_BM * H_BK / 8 / H_THREADS;  // 8-value chunks of A per thread
constexpr int B_CHUNKS = H_BK * H_BN / 8 / H_THREADS;  // and of B

// c += a . b, 16 x 8 x 16, fp32 accumulation; the inputs are bf16 (VT_BF16)
// or fp16 (the fp8 types, widened exactly)
template <int VT>
__device__ __forceinline__ void mma16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                      uint32_t b0, uint32_t b1) {
  if constexpr (VT == VT_BF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* ptr) { return *reinterpret_cast<const uint32_t*>(ptr); }

// Fragment layouts (PTX ISA, mma.m16n8k16 with 16-bit inputs): lane = 4 * g + t.
// A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..). B (16 x 8, k-major pairs): b0 (k 2t..2t+1, n g), b1
// (k 2t+8.., n g). C (16 x 8): c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..).
//
// The K tiles of all K-blocks run as one sequence: tile k0 of block kb is
// [k0, min(k0 + BK, kb1)), kb1 = min((kb + 1) * bk, K). While the MMAs of
// one tile run, the next tile's chunks are already loading into registers
// (one 16- or 8-byte load per whole, aligned chunk of 8 values).
template <int VT, typename OutT>
__global__ void __launch_bounds__(H_THREADS) gemm_scaled_mma_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sA[H_BM * H_S];   // (BM, BK + 8)
  __shared__ __align__(16) uint16_t sBt[H_BN * H_S];  // (BN, BK + 8): B transposed

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long m0 = static_cast<long long>(blockIdx.x) * H_BM;
  const int n0 = blockIdx.y * H_BN;
  const int row0 = warp * 32;  // this warp's first row in the tile

  float acc[2][8][4], part[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = part[mt][nt][r] = 0.f;

  Raw8<VT> ra[A_CHUNKS], rb[B_CHUNKS];
  // A chunks run along k (4 per row), B chunks along n (8 per k row)
  auto fetch = [&](int kb, int k0) {
    const int kb1 = min((kb + 1) * p.bk, p.K);
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int idx = tid + i * H_THREADS;
      const int r = idx / (H_BK / 8), c = (idx % (H_BK / 8)) * 8;
      const long long m = m0 + r;
      const int k = k0 + c;
      const int count = m < p.M ? max(0, min(8, kb1 - k)) : 0;
      ra[i] = fetch8<VT>(p.a, m * p.lda + k, count, p.vec_a && (k % 8 == 0));
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int idx = tid + i * H_THREADS;
      const int r = idx / (H_BN / 8), c = (idx % (H_BN / 8)) * 8;
      const int k = k0 + r, n = n0 + c;
      const int count = k < kb1 ? max(0, min(8, p.N - n)) : 0;
      rb[i] = fetch8<VT>(p.b, static_cast<long long>(k) * p.ldb + n, count, p.vec_b);
    }
  };

  if (p.nk > 0) fetch(0, 0);
  int kb = 0, k0 = 0;
  while (kb < p.nk) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int idx = tid + i * H_THREADS;
      const int r = idx / (H_BK / 8), c = (idx % (H_BK / 8)) * 8;
      *reinterpret_cast<uint4*>(sA + r * H_S + c) = widen8<VT>(ra[i]);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int idx = tid + i * H_THREADS;
      const int r = idx / (H_BN / 8), c = (idx % (H_BN / 8)) * 8;
      const uint4 w = widen8<VT>(rb[i]);
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j) sBt[(c + j) * H_S + r] = e[j];
    }
    __syncthreads();

    // the next tile, in this K-block or the first of the next
    const int kb1 = min((kb + 1) * p.bk, p.K);
    int nkb = kb, nk0 = k0 + H_BK;
    const bool block_done = nk0 >= kb1;
    if (block_done) {
      nkb = kb + 1;
      nk0 = nkb * p.bk;
    }
    if (nkb < p.nk) fetch(nkb, nk0);

#pragma unroll
    for (int ks = 0; ks < H_BK / 16; ++ks) {
      uint32_t b[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* bp = sBt + (nt * 8 + g) * H_S + ks * 16 + 2 * t;
        b[nt][0] = ld32(bp);
        b[nt][1] = ld32(bp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint16_t* ap = sA + (row0 + mt * 16 + g) * H_S + ks * 16 + 2 * t;
        const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * H_S), a2 = ld32(ap + 8), a3 = ld32(ap + 8 * H_S + 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma16<VT>(part[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
    __syncthreads();

    if (block_done) {
      // acc += part * (a_s (x) b_s): rows (mt, half) and columns (nt, e) of this thread
      float sa[2][2], sb[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long m = m0 + row0 + mt * 16 + g + half * 8;
          sa[mt][half] = m < p.M ? p.as[m * p.as0 + kb * p.as1] : 0.f;
        }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + nt * 8 + 2 * t + e;
          sb[nt][e] = n < p.N ? p.bs[kb * p.bs0 + n * p.bs1] : 0.f;
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[mt][nt][r] += part[mt][nt][r] * (sa[mt][r >> 1] * sb[nt][r & 1]);
            part[mt][nt][r] = 0.f;
          }
    }
    kb = nkb;
    k0 = nk0;
  }

  OutT* C = static_cast<OutT*>(p.c);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + row0 + mt * 16 + g + half * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + nt * 8 + 2 * t + e;
          if (n < p.N) C[m * p.ldc + n] = from_f32<OutT>(acc[mt][nt][half * 2 + e]);
        }
      }
    }
  }
}


// The dynamic shared memory above 48 KB is allowed once per device and
// kernel, not on every launch (the call costs host time).
template <typename Kernel>
cudaError_t smem_attribute_once(Kernel kernel, std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <int VT, int CK, typename OutT>
cudaError_t launch_wgmma_ck(const CUtensorMap& ma, const CUtensorMap& mb, const Params& p, const WPlan& q, int grid,
                            cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = smem_attribute_once(gemm_scaled_wgmma_kernel<VT, CK, OutT>, ready);
  if (err != cudaSuccess) return err;
  gemm_scaled_wgmma_kernel<VT, CK, OutT>
      <<<grid, W_THREADS, static_cast<size_t>(w_smem_bytes(q.stages)), st>>>(ma, mb, p, q);
  return cudaGetLastError();
}

template <int VT, typename OutT>
cudaError_t launch_wgmma(const Params& p, const void* bt, long long ldbt, int stages, int promote, int grid,
                         cudaStream_t st) {
  constexpr int KEL = VT == VT_BF16 ? 64 : 128;
  const int kstep = KEL / 4;  // values a wgmma k-step takes
  // promote: half a stage or a stage (fp8: 2 or 4 k-steps), a stage or two (bf16: 4 or 8)
  const int ck = promote / kstep;
  if (stages < 2 || stages > W_MAX_STAGES || p.bk % KEL != 0 || p.bk % promote != 0 || promote % kstep != 0)
    return cudaErrorInvalidValue;
  if (VT == VT_BF16 ? (ck != 4 && ck != 8) : (ck != 2 && ck != 4)) return cudaErrorInvalidValue;
  if (ck == 8 && stages < 5) return cudaErrorInvalidValue;  // two units of two stages in flight
  const int esize = VT == VT_BF16 ? 2 : 1;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p.a), pb = reinterpret_cast<uintptr_t>(VT == VT_BF16 ? p.b : bt);
  const long long ldb = VT == VT_BF16 ? p.ldb : ldbt;
  if (pa % 16 || pb % 16 || (p.lda * esize) % 16 || (ldb * esize) % 16) return cudaErrorInvalidValue;
  const CUtensorMapDataType type = VT == VT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap ma, mb;  // boxes of 64 rows of A and 64 columns of B
  if (!tensor_map(&ma, p.a, type, esize, p.K, p.M, p.lda, KEL, W_BM / 2)) return cudaErrorInvalidValue;
  const bool ok = VT == VT_BF16 ? tensor_map(&mb, p.b, type, esize, p.N, p.K, p.ldb, 64, KEL)
                                : tensor_map(&mb, bt, type, esize, p.K, p.N, ldbt, KEL, W_BN / 2);
  if (!ok) return cudaErrorInvalidValue;
  WPlan q;
  q.stages = stages;
  q.tiles_m = (p.M + W_BM - 1) / W_BM;
  q.tiles = q.tiles_m * ((p.N + W_BN - 1) / W_BN);
  q.per_block = p.bk / KEL;
  q.nkt = (p.K + KEL - 1) / KEL;
  if (grid < 1 || grid > q.tiles) return cudaErrorInvalidValue;
  if constexpr (VT == VT_BF16) {
    if (ck == 8) return launch_wgmma_ck<VT, 8, OutT>(ma, mb, p, q, grid, st);
  } else {
    if (ck == 2) return launch_wgmma_ck<VT, 2, OutT>(ma, mb, p, q, grid, st);
  }
  return launch_wgmma_ck<VT, 4, OutT>(ma, mb, p, q, grid, st);
}

template <int TM, typename OutT>
cudaError_t launch_ffma(const Params& p, const FPlan& q, int grid, long long smem, cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = smem_attribute_once(gemm_scaled_ffma_kernel<TM, OutT>, ready);
  if (err != cudaSuccess) return err;
  gemm_scaled_ffma_kernel<TM, OutT><<<grid, 32 * q.wr * q.wc, static_cast<size_t>(smem), st>>>(p, q);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_route(const Params& p, int vtype, int route, const int* plan, const void* bt, long long ldbt,
                         cudaStream_t st) {
  if (route == 0) {  // mma
    if (vtype == VT_F32) return cudaErrorInvalidValue;
    if ((static_cast<long long>(p.N) + H_BN - 1) / H_BN > 65535) return cudaErrorInvalidValue;  // grid.y
    const dim3 grid(static_cast<unsigned>((static_cast<long long>(p.M) + H_BM - 1) / H_BM),
                    static_cast<unsigned>((static_cast<long long>(p.N) + H_BN - 1) / H_BN));
    if (vtype == VT_BF16) gemm_scaled_mma_kernel<VT_BF16, OutT><<<grid, H_THREADS, 0, st>>>(p);
    else if (vtype == VT_E4M3) gemm_scaled_mma_kernel<VT_E4M3, OutT><<<grid, H_THREADS, 0, st>>>(p);
    else if (vtype == VT_E5M2) gemm_scaled_mma_kernel<VT_E5M2, OutT><<<grid, H_THREADS, 0, st>>>(p);
    else return cudaErrorInvalidValue;
    return cudaGetLastError();
  }
  if (route == 1) {  // wgmma: plan = (stages, promote, grid)
    if (p.nk < 1) return cudaErrorInvalidValue;
    if (vtype == VT_E4M3 || vtype == VT_E5M2) {  // B transposed into the scratch first
      const uintptr_t b16 = reinterpret_cast<uintptr_t>(p.b) | reinterpret_cast<uintptr_t>(bt);
      if (bt == nullptr || ldbt < p.K || b16 % 16 || p.ldb % 16 || ldbt % 16 || p.N % 16) return cudaErrorInvalidValue;
      const dim3 tgrid(static_cast<unsigned>((p.N + 63) / 64), static_cast<unsigned>((p.K + 63) / 64));
      if (tgrid.y > 65535) return cudaErrorInvalidValue;
      transpose_u8_kernel<<<tgrid, 256, 0, st>>>(static_cast<const uint8_t*>(p.b), static_cast<uint8_t*>(const_cast<void*>(bt)),
                                                 p.K, p.N, p.ldb, ldbt);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    switch (vtype) {
      case VT_BF16: return launch_wgmma<VT_BF16, OutT>(p, bt, ldbt, plan[0], plan[1], plan[2], st);
      case VT_E4M3: return launch_wgmma<VT_E4M3, OutT>(p, bt, ldbt, plan[0], plan[1], plan[2], st);
      case VT_E5M2: return launch_wgmma<VT_E5M2, OutT>(p, bt, ldbt, plan[0], plan[1], plan[2], st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route == 2) {  // ffma: plan = (tm, wr, wc, stages, vec, grid)
    const int tm = plan[0], wr = plan[1], wc = plan[2], stages = plan[3], grid = plan[5];
    if (vtype != VT_F32 || p.nk < 1) return cudaErrorInvalidValue;
    if ((tm != 2 && tm != 4) || wr < 1 || wc < 1 || 32 * wr * wc > F_MAX_THREADS) return cudaErrorInvalidValue;
    if (stages < 2 || stages > F_MAX_STAGES) return cudaErrorInvalidValue;
    FPlan q;
    q.wr = wr;
    q.wc = wc;
    q.stages = stages;
    q.row_tiles = (p.M + 8 * tm * wr - 1) / (8 * tm * wr);
    const long long tiles = static_cast<long long>(q.row_tiles) * ((p.N + 48 * wc - 1) / (48 * wc));
    if (tiles > (1LL << 30) || grid < 1 || grid > tiles) return cudaErrorInvalidValue;
    q.tiles = static_cast<int>(tiles);
    q.vec = plan[4] ? 1 : 0;
    const uintptr_t pa = reinterpret_cast<uintptr_t>(p.a), pb = reinterpret_cast<uintptr_t>(p.b);
    if (q.vec && (pa % 16 || pb % 16 || p.lda % 4 || p.ldb % 4 || p.bk % 4)) return cudaErrorInvalidValue;
    q.cb = (p.bk + F_BK - 1) / F_BK;
    q.cl = (p.K - (p.nk - 1) * p.bk + F_BK - 1) / F_BK;
    const long long smem = f_smem_bytes(tm, wr, wc, stages);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    if (tm == 2) return launch_ffma<2, OutT>(p, q, grid, smem, st);
    return launch_ffma<4, OutT>(p, q, grid, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// vtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = float8_e5m2 (A and
// B values); otype: 0 = float32, 1 = bfloat16. A (M, K), B (K, N) and C (M, N)
// with unit column stride and the given row strides (elements); a_s (M, nk)
// and b_s (nk, N) fp32 with the given element strides, nk = ceil(K / bk).
// route and plan come from hopper/gemm_scaled.py `plan`: 0 = mma (plan
// unused), 1 = wgmma (stages, promote in k values, grid; fp8 needs `bt`, a
// scratch of N rows of ldbt >= K bytes for B's transpose), 2 = ffma (tm,
// wr, wc, stages, vec, grid). A plan that does not fit the shapes, types
// or the card is refused (cudaErrorInvalidValue). Returns the launch's
// cudaError_t.
int repro_gemm_scaled(const void* a, const void* b, const float* as, const float* bs, void* c, void* bt, int vtype,
                      int otype, int M, int N, int K, int bk, long long lda, long long ldb, long long ldc,
                      long long as0, long long as1, long long bs0, long long bs1, long long ldbt, int route,
                      int p0, int p1, int p2, int p3, int p4, int p5, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || bk <= 0) return cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.b = b;
  p.as = as;
  p.bs = bs;
  p.c = c;
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = bk;
  p.nk = (K + bk - 1) / bk;
  p.lda = lda;
  p.ldb = ldb;
  p.ldc = ldc;
  p.as0 = as0;
  p.as1 = as1;
  p.bs0 = bs0;
  p.bs1 = bs1;
  const auto aligned = [](const void* ptr, long long ld) {
    return (reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ld % 8 == 0) ? 1 : 0;
  };
  p.vec_a = aligned(a, lda);
  p.vec_b = aligned(b, ldb);
  const uintptr_t pc = reinterpret_cast<uintptr_t>(c);
  const int osize = otype == 0 ? 4 : 2;
  const int width = route == 2 ? 4 : 2;  // elements a vector store writes
  p.vec_out = (ldc % width == 0 && pc % (width * osize) == 0) ? 1 : 0;
  const int plan[6] = {p0, p1, p2, p3, p4, p5};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (otype == 0) return launch_route<float>(p, vtype, route, plan, bt, ldbt, st);
  if (otype == 1) return launch_route<__nv_bfloat16>(p, vtype, route, plan, bt, ldbt, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
