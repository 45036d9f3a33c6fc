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
// so a tile never mixes two blocks' values under one scale. Any bk >= 1
// is taken.
//
// Design. One block per (BM x BN) output tile; a loop over K-blocks, and
// inside it over K tiles, takes the place of the TPU grid's sequential K
// axis. The partial and the accumulator tiles live in registers.
//
//  - bf16, e4m3, e5m2: tensor cores through mma.sync m16n8k16 with fp32
//    accumulation, the tiling of gemm.cu's bf16 kernel (128 x 64 tiles, K
//    tiles of 32, 4 warps of 32 x 64): bf16 MMAs for bf16 values, fp16 MMAs
//    for fp8 values, which the card's cvt.rn.f16x2.e4m3x2 / .e5m2x2 widen
//    exactly as they are staged into shared memory (every e4m3 and e5m2
//    value is an fp16 value). A product of two 16-bit values is exact in
//    fp32, so the partial sums are those of the narrow values. The fp8
//    tensor-core MMA is not used: it would double the rate at the cost of
//    a shorter accumulator, which is later work. Tiles move in chunks of 8
//    values (one 16-byte bf16 or 8-byte fp8 load where the chunk is whole
//    and aligned, single loads at ragged edges), and the next tile's chunks
//    load into registers while the current tile's MMAs run.
//  - fp32 (the fp32 policy, unit scales): CUDA-core FFMA with gemm.cu's
//    fp32 tiling (128 x 64, K tiles of 16, 8 x 8 register tiles per
//    thread), exact fp32 products as the reference computes them.
//
// Each thread reads the scales of its own rows and columns once per
// K-block (4 + 16 loads on the tensor-core path, 8 + 8 on FFMA), straight
// from device memory: a_s is column-strided (one column per K-block), so
// the read is one strided element per row, not one per element.
//
// Bound on this card. At the ladder's card shape (the occamy-gptj MLP
// up-projection of a 2048-token prefill, (2048, 4096) . (4096, 16384)) the
// product does 2MNK = 275 GFLOP; over the compute type's peak (fp32 67,
// bf16 989, fp8 1979 TFLOP/s) that takes longer than moving the values,
// scales and output over 3.35 TB/s, so the function is bound by operations.
// The kernel has one tile in shared memory at a time, synchronises twice
// per K tile and runs fp8 at the 16-bit MMA rate, so it stays well above
// that bound: a ring of TMA-fed tiles, wgmma and the native fp8 MMA are
// the next steps.
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  int vec_a, vec_b;  // 16-byte aligned base and a row stride that is a multiple of 8
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

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

// ---------------------------------------------------------------------------
// fp32 values: CUDA cores, 8 x 8 register tiles
// ---------------------------------------------------------------------------

constexpr int F_BM = 128, F_BN = 64, F_BK = 16, F_THREADS = 128;
constexpr int F_AS = F_BM + 4;  // padded row stride of the transposed A tile

template <typename OutT>
__global__ void __launch_bounds__(F_THREADS) gemm_scaled_f32_kernel(const Params p) {
  __shared__ __align__(16) float sA[F_BK * F_AS];  // (BK, BM + 4): A transposed
  __shared__ __align__(16) float sB[F_BK * F_BN];  // (BK, BN)

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;  // 8 column groups x 16 row groups
  const long long m0 = static_cast<long long>(blockIdx.x) * F_BM;
  const int n0 = blockIdx.y * F_BN;
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < p.nk; ++kb) {
    const int kb0 = kb * p.bk;
    const int kb1 = min(kb0 + p.bk, p.K);
    float part[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;

    for (int k0 = kb0; k0 < kb1; k0 += F_BK) {
#pragma unroll
      for (int i = 0; i < F_BM * F_BK / F_THREADS; ++i) {
        const int idx = tid + i * F_THREADS;
        const int r = idx / F_BK, c = idx % F_BK;
        const long long m = m0 + r;
        const int k = k0 + c;
        sA[c * F_AS + r] = (m < p.M && k < kb1) ? A[m * p.lda + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < F_BK * F_BN / F_THREADS; ++i) {
        const int idx = tid + i * F_THREADS;
        const int r = idx / F_BN, c = idx % F_BN;
        const int k = k0 + r, n = n0 + c;
        sB[r * F_BN + c] = (k < kb1 && n < p.N) ? B[static_cast<long long>(k) * p.ldb + n] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(sA + kk * F_AS + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(sA + kk * F_AS + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(sB + kk * F_BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(sB + kk * F_BN + 32 + tx * 4);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }

    // acc += part * (a_s (x) b_s): this thread's 8 rows and 8 columns
    float sa[8], sb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      sa[i] = m < p.M ? p.as[m * p.as0 + kb * p.as1] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
      sb[j] = n < p.N ? p.bs[kb * p.bs0 + n * p.bs1] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j] * (sa[i] * sb[j]);
  }

  OutT* C = static_cast<OutT*>(p.c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
      if (n < p.N) C[m * p.ldc + n] = from_f32<OutT>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp8 values: tensor cores (mma.sync m16n8k16 bf16, fp32 accumulation)
// ---------------------------------------------------------------------------

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

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int bm, int bn, int threads, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(p.M) + bm - 1) / bm),
                  static_cast<unsigned>((static_cast<long long>(p.N) + bn - 1) / bn));
  kernel<<<grid, threads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_out(const Params& p, int vtype, cudaStream_t st) {
  switch (vtype) {
    case VT_F32: return launch(gemm_scaled_f32_kernel<OutT>, p, F_BM, F_BN, F_THREADS, st);
    case VT_BF16: return launch(gemm_scaled_mma_kernel<VT_BF16, OutT>, p, H_BM, H_BN, H_THREADS, st);
    case VT_E4M3: return launch(gemm_scaled_mma_kernel<VT_E4M3, OutT>, p, H_BM, H_BN, H_THREADS, st);
    case VT_E5M2: return launch(gemm_scaled_mma_kernel<VT_E5M2, OutT>, p, H_BM, H_BN, H_THREADS, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// vtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = float8_e5m2 (A and
// B values); otype: 0 = float32, 1 = bfloat16. A (M, K), B (K, N) and C (M, N)
// with unit column stride and the given row strides (elements); a_s (M, nk)
// and b_s (nk, N) fp32 with the given element strides, nk = ceil(K / bk).
// Returns the launch's cudaError_t.
int repro_gemm_scaled(const void* a, const void* b, const float* as, const float* bs, void* c, int vtype,
                      int otype, int M, int N, int K, int bk, long long lda, long long ldb, long long ldc,
                      long long as0, long long as1, long long bs0, long long bs1, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || bk <= 0) return cudaErrorInvalidValue;
  if ((static_cast<long long>(N) + F_BN - 1) / F_BN > 65535) return cudaErrorInvalidValue;  // grid.y
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (otype == 0) return launch_out<float>(p, vtype, st);
  if (otype == 1) return launch_out<__nv_bfloat16>(p, vtype, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
