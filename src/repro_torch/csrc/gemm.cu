// Tiled GEMM with an fp32 accumulator for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by repro_torch/hopper/gemm.py).
//
// Replaces: src/repro/kernels/gemm.py `_gemm_kernel` (as built by
// `gemm_program` and `gemm_pallas`).
//
// What it computes. C (M, N) = A (M, K) . B (K, N), summed in fp32, one
// rounding to the output type at the end. A and B share one type, fp32 or
// bf16; C is fp32 or bf16. Rows are unit-stride; the row strides are
// arguments. M, N and K need not be multiples of anything: the kernels
// zero-fill the tile edges on load and mask the stores, so nothing is
// padded in memory (the TPU kernel pads the operands to its blocks).
//
// A narrow accumulator (acc = 1: bf16, 2: fp16) is the TPU kernel's
// `acc_ref` in that type: K is cut in blocks of `bk` (the reference's K
// block), each block's fp32 partial is rounded to the accumulator type and
// added into a running sum that is rounded after each add; the output is
// the last sum. Every kernel folds the partial at every bk boundary, so bk
// must be a multiple of the kernels' K step (16 for fp32 inputs, 32 for
// bf16) or cover K; the partial's fp32 order inside a block is the
// kernel's own.
//
// fp32 (the GCN path): CUDA-core FFMA, exact fp32, not TF32 (the reference
// computes exact fp32). Bound on this card: at the GCN shape (M = nodes,
// K = N = 144) 2MNK operations over 67 TFLOP/s take about twice as long as
// A and C through HBM, so the kernel is bound by operations and its design
// aims at keeping the FFMA pipes fed:
//  - Whole-width output tiles. A CTA's tile is BM = 8 TM wr rows by
//    BN = 48 wc columns; the wrapper's planner (hopper/gemm.py `plan_f32`)
//    picks wc so that BN covers N with the least waste (144 = 3 x 48: no
//    padded column, so A leaves HBM once) and TM, wr and the grid from a
//    model of the issue slots, calibrated on the card.
//  - A persistent grid of col_tiles x groups CTAs. Each CTA keeps one
//    column tile and takes an even, contiguous share of the row units (8 TM
//    rows, a warp row's part of a tile), so the busiest CTA has at most one
//    unit more than the least (M = 169,343 on 132 CTAs: 41 units of 32
//    rows against 40.09). A warp row wholly
//    past the share skips its FFMAs in the last tile. The K chunks of all
//    of a CTA's tiles form one sequence, so the next tile's A is in flight
//    while this tile computes and stores.
//  - B resident: when B's (K, BN) panel fits in shared memory beside the
//    ring (83 KB at 144 x 144) it is copied in once, during the CTA's first
//    tile, and read from there for every later tile (each CTA keeps one
//    column tile). Otherwise B's K chunks stream through the ring with A's.
//  - A multistage cp.async ring of 16-k chunks, one barrier a chunk; rows
//    stay row-major as they arrive (16-byte copies for 16-byte-aligned
//    rows, 4-byte copies otherwise, with the zero-fill of cp.async masking
//    the edges). A thread reads a float4 along k for each of its rows: its
//    rows are 8 apart, so a warp's 8 row lanes read 8 consecutive rows, and
//    the ring's row stride of 20 floats puts those 8 float4 on distinct
//    banks; the 4 column lanes of a row read the same words (broadcast).
//  - A 4 x 12 (TM = 4) or 2 x 12 register tile: per k a warp issues 48
//    FFMA against 4 shared-memory loads (1 of A, 3 of B; each a single
//    wavefront, the lanes of a row or a column reading the same words). A
//    thread's 12 columns are three float4, one in each third of the tile,
//    so a warp's 4 column lanes store 64 contiguous bytes per row and
//    third. (8 x 12 was no faster at 168 registers, and spilled once the
//    row ranges below took registers.)
//  - The epilogue stores from registers (float4, or 4 bf16 as 8 bytes,
//    when C's rows are aligned) while the next tile's loads are in flight.
//
// bf16: the tensor cores, by one of two kernels that the wrapper's planner
// (hopper/gemm.py `plan_bf16`) picks from shapes, strides and alignment
// alone. Bound on this card: at 4096^3, 2MNK operations over 989 TFLOP/s
// take 0.139 ms against 0.06 ms for A, B and C through HBM, so the product
// is bound by operations, and only wgmma reaches that rate.
//  - wgmma (16-byte aligned bases, row strides a multiple of 8 elements, M
//    and N at least 64): a persistent grid of one CTA an SM walking 128 x BN
//    output tiles in groups of 16 row tiles, so the CTAs at work share A's
//    row panels and B's column panels in L2. One producer thread keeps a
//    ring of stages full by TMA (64 k a stage: A in two boxes of 64 rows, B
//    in BN / 64 boxes of 64 columns, 128B-swizzled as wgmma reads them and
//    zero-filled by TMA past M, N and K), completed on mbarriers. Two
//    consumer warpgroups each take 64 rows and issue wgmma m64nBNk16 from
//    shared memory, B read MN-major through the descriptor's transpose bit,
//    so B is never transposed in memory. A stage is released once the
//    next one's products are issued and its own are complete. An fp32
//    accumulator takes BN = 256 (one 128-float register tile a thread) or
//    128 where the planner finds the narrower tile less padded. A narrow
//    accumulator takes BN = 128 and two partial register tiles that
//    alternate block by block: a K block's first products are issued
//    (fresh, scale_d = 0) before the previous block's partial is folded,
//    so the tensor cores work while the CUDA cores round. A block may end
//    inside a stage (bk = 32 mod 64): the partial units are then half a
//    stage (two k16 steps). Zero-filled k past K join the last block, so
//    they add no fold. ptxas serialises every wgmma of a function when a
//    branch it cannot prove warp-uniform sits among them, so the waits and
//    releases are tma.cuh's PTX.
//  - mma (every other shape: unaligned rows, a row stride TMA refuses, M
//    or N below 64): mma.sync m16n8k16 with fp32 accumulation, 128 x 64
//    tiles, K tiles of 32, 4 warps of 32 rows x 64 columns each. A is
//    stored row-major and B transposed (n-major), both with rows padded by
//    8 elements, so every fragment load of a warp hits 32 distinct banks.
//
// Offsets are 64-bit (long long) throughout.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <climits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

struct Params {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  long long lda, ldb, ldc;  // row strides in elements
  int block_steps;          // a narrow accumulator's K block, in the kernel's K steps
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to the accumulator type ACC (0 fp32, 1 bf16, 2 fp16), as a float
template <int ACC>
__device__ __forceinline__ float to_acc(float x) {
  if (ACC == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (ACC == 2) return __half2float(__float2half_rn(x));
  return x;
}

// A narrow accumulator's fold at the end of a K block: sum = acc(sum +
// acc(partial)), and the partial starts again from zero.
template <int ACC, int R, int C>
__device__ __forceinline__ void fold_block(float (&sum)[R][C], float (&part)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      sum[i][j] = to_acc<ACC>(sum[i][j] + to_acc<ACC>(part[i][j]));
      part[i][j] = 0.f;
    }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, a persistent grid of whole-width tiles
// ---------------------------------------------------------------------------

constexpr int F_BK = 16;             // k values per ring stage
constexpr int F_AS = F_BK + 4;       // A stage row stride (floats)
constexpr int F_TN = 12;             // columns per thread: three float4
constexpr int F_SMEM_MAX = 232448;   // 227 KB of dynamic shared memory a CTA may use
constexpr int F_MAX_STAGES = 8;

// The planner's choice (hopper/gemm.py `plan_f32`), checked by repro_gemm.
struct Plan {
  int wr, wc;        // warps down and across: BM = 8 TM wr rows, BN = 48 wc columns
  int stages;        // ring depth
  int col_tiles;     // ceil(N / BN); the grid is col_tiles x (CTAs a column tile)
  int resident;      // B's (K, BN) panel stays in shared memory
  int vec;           // 16-byte copies of A and B rows
  int vec_out;       // C's rows take 16-byte (fp32) / 8-byte (bf16) stores
};

constexpr int F_MAX_THREADS = 512;  // a CTA's bound: at most 128 registers a thread

// Shared memory of a plan, in bytes: the resident B panel (nk * 16 rows of
// BN) and `stages` ring stages of A (BM rows of F_AS) and, streamed, B
// (16 rows of BN). hopper/gemm.py `smem_bytes` is the same formula.
long long f_smem_bytes(int tm, int wr, int wc, int K, int stages, int resident) {
  const long long bm = 8LL * tm * wr, bn = 48LL * wc;
  const long long nk = K > 0 ? (K + F_BK - 1) / F_BK : 1;
  const long long stage = bm * F_AS + (resident ? 0 : F_BK * bn);
  return 4 * (stage * stages + (resident ? nk * F_BK * bn : 0));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `bytes` of the 16 (4) are read, the rest of the destination zero-filled
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

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Where a CTA's next copies go: ring stage `stage` gets K chunk `kc` of
// the CTA's tile `it` (rows m0 = r_begin + it * BM). Advanced one chunk at
// a time, so no division runs in the loop.
struct Cursor {
  int it, kc, stage;
  __device__ __forceinline__ void next(int nk, int stages) {
    if (++kc == nk) {
      kc = 0;
      ++it;
    }
    if (++stage == stages) stage = 0;
  }
};

// Issue the copies of the cursor's chunk into its ring stage and commit
// them as one group (an empty group past the CTA's last tile, so every
// thread counts groups alike). A's rows past the CTA's row range, and
// every element past M, N or K, are zero-filled.
template <int TM>
__device__ __forceinline__ void f_issue(const Params& p, const Plan& q, float* panel, float* ring, const Cursor& u,
                                        int my_tiles, long long r_begin, long long r_end, int n0, int stage_floats) {
  if (u.it < my_tiles) {
    const int BM = 8 * TM * q.wr, BN = 48 * q.wc, T = 32 * q.wr * q.wc;
    const int tid = threadIdx.x;
    const long long m0 = r_begin + static_cast<long long>(u.it) * BM;
    const int k0 = u.kc * F_BK;
    const int a_floats = BM * F_AS;
    float* sA = ring + u.stage * stage_floats;
    const float* A = static_cast<const float*>(p.a);
    const float* B = static_cast<const float*>(p.b);
    if (q.vec) {
      for (int x = tid; x < BM * (F_BK / 4); x += T) {
        const int r = x >> 2, kk = (x & 3) * 4, k = k0 + kk;
        const long long m = m0 + r;
        const int bytes = (m < r_end && k < p.K) ? (p.K - k >= 4 ? 16 : (p.K - k) * 4) : 0;
        cp_async16(smem_u32(sA + r * F_AS + kk), bytes ? A + m * p.lda + k : A, bytes);
      }
    } else {
      for (int x = tid; x < BM * F_BK; x += T) {
        const int r = x >> 4, kk = x & 15, k = k0 + kk;
        const long long m = m0 + r;
        const bool in = m < r_end && k < p.K;
        cp_async4(smem_u32(sA + r * F_AS + kk), in ? A + m * p.lda + k : A, in ? 4 : 0);
      }
    }
    if (!q.resident || u.it == 0) {  // the resident panel is filled during the first tile
      float* sB = q.resident ? panel + k0 * BN : sA + a_floats;
      // (row, column group) of copy x = tid + j T, stepped without division
      const int v = q.vec ? BN / 4 : BN, w = q.vec ? 4 : 1;
      const int dr = T / v, dc = T - dr * v;
      int r = tid / v, cc = tid - r * v;
      for (; r < F_BK; r += dr, cc += dc) {
        if (cc >= v) {
          cc -= v;
          ++r;
          if (r >= F_BK) break;
        }
        const int k = k0 + r, n = n0 + cc * w;
        const float* src = B + static_cast<long long>(k) * p.ldb + n;
        const uint32_t dst = smem_u32(sB + r * BN + cc * w);
        if (q.vec) {
          const int bytes = (k < p.K && n < p.N) ? (p.N - n >= 4 ? 16 : (p.N - n) * 4) : 0;
          cp_async16(dst, bytes ? src : B, bytes);
        } else {
          const bool in = k < p.K && n < p.N;
          cp_async4(dst, in ? src : B, in ? 4 : 0);
        }
      }
    }
  }
  cp_async_commit();
}

template <int TM, typename OutT, int ACC>
__global__ void __launch_bounds__(F_MAX_THREADS, 1) gemm_f32_kernel(const Params p, const Plan q) {
  extern __shared__ __align__(16) float smem[];
  const int BM = 8 * TM * q.wr, BN = 48 * q.wc, S = q.stages;
  const int nk = p.K > 0 ? (p.K + F_BK - 1) / F_BK : 1;
  const int a_floats = BM * F_AS;
  const int stage_floats = a_floats + (q.resident ? 0 : F_BK * BN);
  float* panel = smem;  // resident B: (nk * 16, BN), k-major
  float* ring = smem + (q.resident ? nk * F_BK * BN : 0);

  // This CTA's column tile, and its share of the row units (8 TM rows, one
  // warp row's worth): unit ranges split evenly over the CTAs of a column
  // tile, so the busiest CTA has at most one unit more than the least.
  const int ct = blockIdx.x % q.col_tiles, rg = blockIdx.x / q.col_tiles;
  const int groups = gridDim.x / q.col_tiles;
  const long long unit = 8 * TM, units = (p.M + unit - 1) / unit;
  const long long r_begin = rg * units / groups * unit;
  const long long r_end = min(static_cast<long long>(p.M), (rg + 1) * units / groups * unit);
  const int my_tiles = r_end > r_begin ? static_cast<int>((r_end - r_begin + BM - 1) / BM) : 0;
  const int total = my_tiles * nk;
  const int n0 = ct * BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = (warp / q.wc) * 8 * TM;                   // this warp's first row in a tile
  const int row0 = wrow + (lane >> 2);                        // this thread's rows: row0 + 8 i
  const int col0 = ((warp % q.wc) * 4 + (lane & 3)) * 4;     // its columns: col0 + third j + (0..3)
  const int third = 16 * q.wc;

  Cursor issue{0, 0, 0};
  for (int s = 0; s < S - 1; ++s) {
    f_issue<TM>(p, q, panel, ring, issue, my_tiles, r_begin, r_end, n0, stage_floats);
    issue.next(nk, S);
  }

  float acc[TM][F_TN], sum[TM][F_TN];  // sum: a narrow accumulator's running sum
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = sum[i][j] = 0.f;
  float (&res)[TM][F_TN] = ACC ? sum : acc;  // what a finished tile stores

  Cursor cur{0, 0, 0};
  for (int c = 0; c < total; ++c) {
    cp_async_wait_ring(S);
    __syncthreads();  // chunk c is in for every thread; stage (c - 1) % S is free
    f_issue<TM>(p, q, panel, ring, issue, my_tiles, r_begin, r_end, n0, stage_floats);
    issue.next(nk, S);

    const long long m0 = r_begin + static_cast<long long>(cur.it) * BM;
    if (m0 + wrow < r_end) {  // a warp row wholly past the range (the last tile) skips its FFMAs
      const float* stage = ring + cur.stage * stage_floats;
      const float* sA = stage + row0 * F_AS;
      const float* sB = (q.resident ? panel + cur.kc * F_BK * BN : stage + a_floats) + col0;
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
            for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
          }
        }
      }
      if (ACC && ((cur.kc + 1) % p.block_steps == 0 || cur.kc == nk - 1)) fold_block<ACC>(sum, acc);
      if (cur.kc == nk - 1) {  // the tile is done: store it, start the next from zero
        OutT* C = static_cast<OutT*>(p.c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const long long m = m0 + row0 + 8 * i;
          if (m < r_end) {
            OutT* crow = C + m * p.ldc;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const int n = n0 + col0 + j * third;
              if (q.vec_out && n + 3 < p.N) {
                store4(crow + n, res[i][4 * j], res[i][4 * j + 1], res[i][4 * j + 2], res[i][4 * j + 3]);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (n + e < p.N) crow[n + e] = from_f32<OutT>(res[i][4 * j + e]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < F_TN; ++j) acc[i][j] = sum[i][j] = 0.f;
        }
      }
    }
    cur.next(nk, S);
  }
  cp_async_wait<0>();  // the trailing groups are empty; leave none pending
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int H_BM = 128, H_BN = 64, H_BK = 32, H_THREADS = 128;
constexpr int H_S = H_BK + 8;  // padded row stride (elements) of both tiles

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * g + t.
// A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..). B (16 x 8, k-major pairs): b0 (k 2t..2t+1, n g), b1
// (k 2t+8.., n g). C (16 x 8): c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..).
template <typename OutT, int ACC>
__global__ void __launch_bounds__(H_THREADS) gemm_bf16_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 sA[H_BM * H_S];   // (BM, BK + 8)
  __shared__ __align__(16) __nv_bfloat16 sBt[H_BN * H_S];  // (BN, BK + 8): B transposed

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long m0 = static_cast<long long>(blockIdx.x) * H_BM;
  const int n0 = blockIdx.y * H_BN;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const int row0 = warp * 32;  // this warp's first row in the tile

  // acc (2 x 8 m16n8 tiles of 4) as 16 rows of 4 for fold_block; sum: a
  // narrow accumulator's running sum
  float acc[16][4], sum[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = sum[i][0] = sum[i][1] = sum[i][2] = sum[i][3] = 0.f;
  float (&res)[16][4] = ACC ? sum : acc;

  for (int k0 = 0, step = 0; k0 < p.K; k0 += H_BK, ++step) {
    // A tile: a warp reads one row's 32 k values
#pragma unroll 4
    for (int i = 0; i < H_BM * H_BK / H_THREADS; ++i) {
      const int idx = tid + i * H_THREADS;
      const int r = idx / H_BK, c = idx % H_BK;
      const long long m = m0 + r;
      const int k = k0 + c;
      sA[r * H_S + c] = (m < p.M && k < p.K) ? A[m * p.lda + k] : zero;
    }
    // B tile: a warp reads 32 consecutive columns of one k row, stored transposed
#pragma unroll 4
    for (int i = 0; i < H_BK * H_BN / H_THREADS; ++i) {
      const int idx = tid + i * H_THREADS;
      const int r = idx / H_BN, c = idx % H_BN;
      const int k = k0 + r, n = n0 + c;
      sBt[c * H_S + r] = (k < p.K && n < p.N) ? B[static_cast<long long>(k) * p.ldb + n] : zero;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < H_BK / 16; ++ks) {
      uint32_t b[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* bp = sBt + (nt * 8 + g) * H_S + ks * 16 + 2 * t;
        b[nt][0] = ld32(bp);
        b[nt][1] = ld32(bp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* ap = sA + (row0 + mt * 16 + g) * H_S + ks * 16 + 2 * t;
        const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * H_S), a2 = ld32(ap + 8), a3 = ld32(ap + 8 * H_S + 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt * 8 + nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
    if (ACC && ((step + 1) % p.block_steps == 0 || k0 + H_BK >= p.K)) fold_block<ACC>(sum, acc);
    __syncthreads();
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
          if (n < p.N) C[m * p.ldc + n] = from_f32<OutT>(res[mt * 8 + nt][half * 2 + e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, wgmma route: a TMA ring, a producer thread and two consumer
// warpgroups, persistent 128 x BN output tiles
// ---------------------------------------------------------------------------

constexpr int W_BM = 128;
constexpr int W_KEL = 64;         // k values a stage holds: 128 bytes of bf16, one swizzle row
constexpr int W_BOX = 64 * 128;   // 8 KB: 64 rows of A, or 64 k-rows of 64 columns of B
constexpr int W_THREADS = 384;    // warpgroup 0 produces, 1 and 2 consume
constexpr int W_MAX_STAGES = 8;
constexpr int W_GROUP = 16;       // row tiles a group of the tile order walks down before moving across

// A stage: A's 128 rows (two boxes), then B's BN columns (BN / 64 boxes).
__host__ __device__ constexpr int w_stage_bytes(int bn) { return (2 + bn / 64) * W_BOX; }
// hopper/gemm.py `wgmma_smem_bytes` is the same formula: the stages, 1 KB
// to align them for the swizzle, a full and an empty mbarrier a stage
long long w_smem_bytes(int bn, int stages) {
  return static_cast<long long>(stages) * w_stage_bytes(bn) + 1024 + 16LL * stages;
}

struct WPlan {
  int stages;
  int tiles_m, tiles_n, tiles;
  int nkt;      // stages a tile takes: ceil(K / 64), 0 for K = 0
  int units;    // partial units a tile takes: nkt x (4 / CK)
  int upb;      // units a K block: bk / (16 CK), or `units` for one block
  int nblocks;  // K blocks a tile folds: ceil(K / bk); 1 without a narrow accumulator or for bk >= K
  int vec_out;  // C's rows take 2-element stores
};

// Output tile t in groups of W_GROUP row tiles: down M within a group, then
// across N, so the 132 tiles at work share 16 of A's row panels and about
// 8 of B's column panels in L2.
__device__ __forceinline__ void w_tile(const WPlan& q, int t, int& tm, int& tn) {
  const int per_group = W_GROUP * q.tiles_n;
  const int g = t / per_group, r = t - g * per_group;
  const int rows = min(W_GROUP, q.tiles_m - g * W_GROUP);
  tm = g * W_GROUP + r % rows;
  tn = r / rows;
}

template <int BN>
__device__ __forceinline__ void w_mma(float (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 256) {
    wgmma::mma_ss_n256_bf16_tb(d, a, b, scale_d);
  } else {
    wgmma::mma_ss_n128_bf16_tb(d, a, b, scale_d);
  }
}

// k16 steps first .. first + N - 1 of a stage into d: A (this warpgroup's
// 64 rows of 128 bytes of k, 8-row groups 1 KB apart) at sa, B (64-column
// boxes 8 KB apart, read MN-major: 8 k-rows 1 KB apart) at sb; `fresh`:
// the first product overwrites d.
template <int BN, int N>
__device__ __forceinline__ void w_issue(float (&d)[BN / 2], uint32_t sa, uint32_t sb, int first, bool fresh) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int ks = first + s;
    const uint64_t da = wgmma::smem_desc(sa + 32 * ks, 16, 1024, wgmma::SWIZZLE_128B);
    const uint64_t db = wgmma::smem_desc(sb + ks * 16 * 128, W_BOX, 1024, wgmma::SWIZZLE_128B);
    w_mma<BN>(d, da, db, (fresh && s == 0) ? 0 : 1);
  }
}

// A narrow accumulator's fold at the end of a K block, sum = acc(sum +
// acc(part)); the next block's first product overwrites part.
template <int ACC, int N>
__device__ __forceinline__ void fold(float (&sum)[N], const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] = to_acc<ACC>(sum[i] + to_acc<ACC>(part[i]));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// A warpgroup's 64 x 2NV tile from its wgmma fragment: d[4 j + e] is row
// r0 + 8 (e >> 1), column 8 j + 2 t + (e & 1); rows past M and columns past
// N are not stored.
template <typename OutT, int NV>
__device__ __forceinline__ void w_store(const Params& p, const WPlan& q, const float (&d)[NV], long long m0, int n0,
                                        int r0, int t) {
  OutT* C = static_cast<OutT*>(p.c);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = m0 + r0 + 8 * h;
    if (m >= p.M) continue;
    OutT* crow = C + m * p.ldc;
#pragma unroll
    for (int j = 0; j < NV / 4; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const float x = d[4 * j + 2 * h], y = d[4 * j + 2 * h + 1];
      if (q.vec_out && n + 1 < p.N) {
        store2(crow + n, x, y);
      } else {
        if (n < p.N) crow[n] = from_f32<OutT>(x);
        if (n + 1 < p.N) crow[n + 1] = from_f32<OutT>(y);
      }
    }
  }
}

// ACC: the accumulator (0 fp32, 1 bf16, 2 fp16); BN: the tile's columns
// (256 or 128; 128 for a narrow accumulator); CK: k16 steps a partial unit
// (4: a stage, 2: half a stage, where a K block ends inside a stage).
template <typename OutT, int ACC, int BN, int CK>
__global__ void __launch_bounds__(W_THREADS, 1)
    gemm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                           const Params p, const WPlan q) {
  constexpr int UPS = 4 / CK;  // units a stage
  constexpr int STAGE = w_stage_bytes(BN);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + q.stages * STAGE;  // full[0 .. S), then empty[0 .. S)

  if (threadIdx.x == 0) {
    for (int s = 0; s < q.stages; ++s) {
      tma::mbar_init(bars + 8 * s, 1);                // the producer's arrive + TMA's bytes
      tma::mbar_init(bars + 8 * (q.stages + s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
        int tm, tn;
        w_tile(q, tile, tm, tn);
        const int m0 = tm * W_BM, n0 = tn * BN;
        for (int kt = 0; kt < q.nkt; ++kt) {
          tma::mbar_wait(bars + 8 * (q.stages + stage), phase ^ 1);  // the consumers freed it
          const uint32_t st = base + stage * STAGE, full = bars + 8 * stage;
          tma::mbar_expect_tx(full, STAGE);
#pragma unroll
          for (int h = 0; h < 2; ++h) tma::load_2d(st + h * W_BOX, &map_a, full, kt * W_KEL, m0 + h * 64);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma::load_2d(st + (2 + h) * W_BOX, &map_b, full, n0 + h * 64, kt * W_KEL);
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
    const int r0 = warp * 16 + lane / 4, t = lane % 4;  // this thread's rows r0, r0 + 8 of the 64
    int stage = 0, phase = 0;  // the next stage to wait for
    int rstage = 0;            // the next stage to release
    auto wait_stage = [&]() {
      tma::mbar_wait(bars + 8 * stage, phase);
      const int s = stage;
      if (++stage == q.stages) {
        stage = 0;
        phase ^= 1;
      }
      return base + s * STAGE;
    };
    auto release = [&]() {
      tma::mbar_arrive_lane0(bars + 8 * (q.stages + rstage), lane);
      if (++rstage == q.stages) rstage = 0;
    };
    for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
      int tm, tn;
      w_tile(q, tile, tm, tn);
      const long long m0 = static_cast<long long>(tm) * W_BM + cw * 64;
      const int n0 = tn * BN;
      if constexpr (ACC == 0) {
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        for (int kt = 0; kt < q.nkt; ++kt) {
          const uint32_t st = wait_stage();
          wgmma::fence();
          w_issue<BN, 4>(acc, st + cw * W_BOX, st + 2 * W_BOX, 0, false);
          wgmma::commit();
          wgmma::wait<1>();  // the previous stage's products are complete: free it
          if (kt > 0) release();
        }
        wgmma::wait<0>();
        if (q.nkt > 0) release();
        wgmma::fence_operands(acc);
        w_store<OutT>(p, q, acc, m0, n0, r0, t);
      } else {
        float sum[64], p0[64], p1[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = 0.f;
        int u = 0;  // the tile's next unit
        // K block b's units into `part` (its first product overwrites it);
        // once that first unit is issued, the previous block's partial
        // `prev` is complete and folded into the sum
        auto run_block = [&](float (&part)[64], float (&prev)[64], int b) {
          const int n = b == q.nblocks - 1 ? q.units - b * q.upb : q.upb;
          for (int i = 0; i < n; ++i, ++u) {
            const int first = (u % UPS) * CK;  // the unit's first k16 step in its stage
            const uint32_t st =
                first == 0 ? wait_stage() : base + (stage == 0 ? q.stages - 1 : stage - 1) * STAGE;
            wgmma::fence();
            w_issue<BN, CK>(part, st + cw * W_BOX, st + 2 * W_BOX, first, i == 0);
            wgmma::commit();
            wgmma::wait<1>();                     // every unit but this one is complete
            if (u > 0 && first == 0) release();  // the previous unit ended its stage
            if (i == 0 && b > 0) {
              wgmma::fence_operands(prev);
              fold<ACC>(sum, prev);
            }
          }
        };
        for (int b = 0; b < q.nblocks; b += 2) {
          run_block(p0, p1, b);
          if (b + 1 < q.nblocks) run_block(p1, p0, b + 1);
        }
        wgmma::wait<0>();
        if (q.units > 0) {  // the last stage is free and the last block's partial complete
          release();
          if ((q.nblocks - 1) & 1) {
            wgmma::fence_operands(p1);
            fold<ACC>(sum, p1);
          } else {
            wgmma::fence_operands(p0);
            fold<ACC>(sum, p0);
          }
        }
        w_store<OutT>(p, q, sum, m0, n0, r0, t);
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
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM_MAX);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <int TM, typename OutT, int ACC>
cudaError_t launch_f32(const Params& p, const Plan& q, int grid, long long smem, cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = smem_attribute_once(gemm_f32_kernel<TM, OutT, ACC>, ready);
  if (err != cudaSuccess) return err;
  gemm_f32_kernel<TM, OutT, ACC><<<grid, 32 * q.wr * q.wc, static_cast<size_t>(smem), st>>>(p, q);
  return cudaGetLastError();
}

template <int TM, typename OutT>
cudaError_t launch_f32_acc(int acc, const Params& p, const Plan& q, int grid, long long smem, cudaStream_t st) {
  if (acc == 1) return launch_f32<TM, OutT, 1>(p, q, grid, smem, st);
  if (acc == 2) return launch_f32<TM, OutT, 2>(p, q, grid, smem, st);
  return launch_f32<TM, OutT, 0>(p, q, grid, smem, st);
}

template <typename OutT>
cudaError_t launch_mma(int acc, const Params& p, cudaStream_t st) {
  if ((static_cast<long long>(p.N) + H_BN - 1) / H_BN > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(p.M) + H_BM - 1) / H_BM),
                  static_cast<unsigned>((static_cast<long long>(p.N) + H_BN - 1) / H_BN));
  if (acc == 1)
    gemm_bf16_kernel<OutT, 1><<<grid, H_THREADS, 0, st>>>(p);
  else if (acc == 2)
    gemm_bf16_kernel<OutT, 2><<<grid, H_THREADS, 0, st>>>(p);
  else
    gemm_bf16_kernel<OutT, 0><<<grid, H_THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename OutT, int ACC, int BN, int CK>
cudaError_t launch_wgmma_t(const CUtensorMap& ma, const CUtensorMap& mb, const Params& p, const WPlan& q, int grid,
                           cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = smem_attribute_once(gemm_bf16_wgmma_kernel<OutT, ACC, BN, CK>, ready);
  if (err != cudaSuccess) return err;
  gemm_bf16_wgmma_kernel<OutT, ACC, BN, CK>
      <<<grid, W_THREADS, static_cast<size_t>(w_smem_bytes(BN, q.stages)), st>>>(ma, mb, p, q);
  return cudaGetLastError();
}

// The wgmma route at the planner's (bn, stages, grid); a plan or an operand
// the route does not take is refused.
template <typename OutT>
cudaError_t launch_wgmma(int acc, int bk, const Params& p, int bn, int stages, int grid, cudaStream_t st) {
  if (p.M < 64 || p.N < 64) return cudaErrorInvalidValue;
  if ((bn != 128 && bn != 256) || (acc && bn != 128)) return cudaErrorInvalidValue;
  if (stages < 2 || stages > W_MAX_STAGES || w_smem_bytes(bn, stages) > F_SMEM_MAX) return cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p.a), pb = reinterpret_cast<uintptr_t>(p.b);
  if (pa % 16 || pb % 16 || p.lda % 8 || p.ldb % 8) return cudaErrorInvalidValue;  // TMA's 16-byte rows
  WPlan q;
  q.stages = stages;
  q.tiles_m = (p.M + W_BM - 1) / W_BM;
  q.tiles_n = (p.N + bn - 1) / bn;
  const long long tiles = static_cast<long long>(q.tiles_m) * q.tiles_n;
  if (tiles > (1LL << 30) || grid < 1 || grid > tiles) return cudaErrorInvalidValue;
  q.tiles = static_cast<int>(tiles);
  q.nkt = (p.K + W_KEL - 1) / W_KEL;
  const bool blocks = acc && bk < p.K;  // bk is then a multiple of 32
  const int ck = blocks && bk % 64 ? 2 : 4;
  q.units = q.nkt * (4 / ck);
  q.nblocks = blocks ? (p.K + bk - 1) / bk : 1;
  q.upb = blocks ? bk / (16 * ck) : q.units;
  const uintptr_t pc = reinterpret_cast<uintptr_t>(p.c);
  q.vec_out = (p.ldc % 2 == 0 && pc % (2 * sizeof(OutT)) == 0) ? 1 : 0;
  CUtensorMap ma, mb;  // boxes of 64 k x 64 rows of A and 64 k-rows x 64 columns of B
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (p.K > 0) {  // K = 0: no stage is loaded, the tile stores zeros
    if (!tma::tensor_map(&ma, p.a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.K, p.M, p.lda, W_KEL, 64) ||
        !tma::tensor_map(&mb, p.b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.N, p.K, p.ldb, 64, W_KEL))
      return cudaErrorInvalidValue;
  }
  if (acc == 0) {
    if (bn == 256) return launch_wgmma_t<OutT, 0, 256, 4>(ma, mb, p, q, grid, st);
    return launch_wgmma_t<OutT, 0, 128, 4>(ma, mb, p, q, grid, st);
  }
  if (acc == 1) {
    if (ck == 2) return launch_wgmma_t<OutT, 1, 128, 2>(ma, mb, p, q, grid, st);
    return launch_wgmma_t<OutT, 1, 128, 4>(ma, mb, p, q, grid, st);
  }
  if (ck == 2) return launch_wgmma_t<OutT, 2, 128, 2>(ma, mb, p, q, grid, st);
  return launch_wgmma_t<OutT, 2, 128, 4>(ma, mb, p, q, grid, st);
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16. A (M, K), B (K, N) and
// C (M, N) with unit column stride and the given row strides (elements).
// acc: the accumulator, 0 = float32, 1 = bfloat16, 2 = float16; a narrow
// one sums blocks of bk k values (a multiple of the kernels' K step, 16 for
// fp32 inputs and 32 for bf16, or at least K), each rounded to it.
// route and plan come from hopper/gemm.py: route 0 = ffma, fp32 inputs, at
// `plan_f32`'s plan: register rows tm (4 or 2), warps wr down and wc
// across, ring stages, B resident or streamed, 16-byte copies (vec) and the
// persistent grid; route 1 = mma, bf16 inputs, no plan; route 2 = wgmma,
// bf16 inputs, at `plan_bf16`'s (bn, stages, grid) in the first three plan
// slots. A route or plan that does not fit the types, shapes, alignment or
// the card is refused (cudaErrorInvalidValue), as is vec with a row that
// is not 16-byte aligned. Returns the launch's cudaError_t.
int repro_gemm(const void* a, const void* b, void* c, int in_dtype, int out_dtype, int acc, int bk, int M, int N,
               int K, long long lda, long long ldb, long long ldc, int route, int tm, int wr, int wc, int stages,
               int resident, int vec, int grid, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) return cudaErrorInvalidValue;
  if (acc < 0 || acc > 2) return cudaErrorInvalidValue;
  if (in_dtype == 0 ? route != 0 : (route != 1 && route != 2)) return cudaErrorInvalidValue;
  const int step = in_dtype == 1 ? H_BK : F_BK;  // the kernels' K step
  if (acc && (bk < 1 || (bk % step && bk < K))) return cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.b = b;
  p.c = c;
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.ldb = ldb;
  p.ldc = ldc;
  p.block_steps = acc ? (bk >= K ? INT_MAX : bk / step) : INT_MAX;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (out_dtype == 0) return launch_mma<float>(acc, p, st);
    return launch_mma<__nv_bfloat16>(acc, p, st);
  }
  if (route == 2) {  // plan: bn, stages, grid
    if (out_dtype == 0) return launch_wgmma<float>(acc, bk, p, tm, wr, wc, st);
    return launch_wgmma<__nv_bfloat16>(acc, bk, p, tm, wr, wc, st);
  }
  if (tm != 2 && tm != 4) return cudaErrorInvalidValue;
  if (wr < 1 || wc < 1 || 32 * wr * wc > F_MAX_THREADS)
    return cudaErrorInvalidValue;
  if (stages < 2 || stages > F_MAX_STAGES) return cudaErrorInvalidValue;
  Plan q;
  q.wr = wr;
  q.wc = wc;
  q.stages = stages;
  q.col_tiles = (N + 48 * wc - 1) / (48 * wc);
  q.resident = resident ? 1 : 0;
  q.vec = vec ? 1 : 0;
  // grid = col_tiles x groups: each CTA one column tile and an even share of
  // its row units (8 tm rows each)
  const long long units = (static_cast<long long>(M) + 8 * tm - 1) / (8 * tm);
  const long long nk = K > 0 ? (K + F_BK - 1) / F_BK : 1;
  if (grid < 1 || grid % q.col_tiles != 0 || grid / q.col_tiles > units) return cudaErrorInvalidValue;
  const long long most_units = (units + grid / q.col_tiles - 1) / (grid / q.col_tiles);
  if ((most_units + wr - 1) / wr * nk > INT_MAX) return cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a), pb = reinterpret_cast<uintptr_t>(b);
  if (q.vec && (pa % 16 || pb % 16 || lda % 4 || ldb % 4)) return cudaErrorInvalidValue;
  const uintptr_t pc = reinterpret_cast<uintptr_t>(c);
  q.vec_out = (N % 4 == 0 && ldc % 4 == 0 && pc % (out_dtype == 0 ? 16 : 8) == 0) ? 1 : 0;
  const long long smem = f_smem_bytes(tm, wr, wc, K, stages, q.resident);
  if (smem > F_SMEM_MAX) return cudaErrorInvalidValue;
  if (tm == 2) {
    if (out_dtype == 0) return launch_f32_acc<2, float>(acc, p, q, grid, smem, st);
    return launch_f32_acc<2, __nv_bfloat16>(acc, p, q, grid, smem, st);
  }
  if (out_dtype == 0) return launch_f32_acc<4, float>(acc, p, q, grid, smem, st);
  return launch_f32_acc<4, __nv_bfloat16>(acc, p, q, grid, smem, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
