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
// Design. One block per (BM x BN) output tile; a loop over K tiles inside
// the block takes the place of the TPU grid's sequential K axis, and the
// accumulator it keeps in VMEM scratch lives in registers.
//
//  - fp32 (the GCN path): CUDA-core FFMA, not TF32 (the reference computes
//    exact fp32). 128 x 64 tiles, K tiles of 16, 128 threads, each thread
//    an 8 x 8 register tile: 64 FMAs for every 16 floats it reads from
//    shared memory. A is stored transposed (k-major, rows padded by 4) so
//    each thread reads its 8 rows as two float4; a thread's rows and
//    columns are two groups of 4, 64 rows / 32 columns apart, so the
//    float4 reads of a quarter-warp hit distinct banks.
//  - bf16: tensor cores through mma.sync m16n8k16 with fp32 accumulation.
//    128 x 64 tiles, K tiles of 32, 4 warps of 32 rows x 64 columns each.
//    A is stored row-major and B transposed (n-major), both with rows
//    padded by 8 elements, so every fragment load of a warp hits 32
//    distinct banks.
//
// Bound on this card. At the GCN shape (M = nodes, K = N = 144, fp32) the
// product does 2MNK operations and moves (MK + KN + MN) * 4 bytes; over
// 67 TFLOP/s fp32 and 3.35 TB/s the operations take the longer time, so
// the fp32 kernel is bound by operations, and N = 144 fills 144 of the
// 192 columns of its three column tiles. Loads are synchronous and
// unvectorised from device memory, so each K step waits on them; cp.async
// or TMA double buffering is the next step (and wgmma for bf16).
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  long long lda, ldb, ldc;  // row strides in elements
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// ---------------------------------------------------------------------------
// fp32: CUDA cores, 8 x 8 register tiles
// ---------------------------------------------------------------------------

constexpr int F_BM = 128, F_BN = 64, F_BK = 16, F_THREADS = 128;
constexpr int F_AS = F_BM + 4;  // padded row stride of the transposed A tile

template <typename OutT>
__global__ void __launch_bounds__(F_THREADS) gemm_f32_kernel(const Params p) {
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

  for (int k0 = 0; k0 < p.K; k0 += F_BK) {
    // A tile: 16 consecutive threads read one row's 16 k values
#pragma unroll
    for (int i = 0; i < F_BM * F_BK / F_THREADS; ++i) {
      const int idx = tid + i * F_THREADS;
      const int r = idx / F_BK, c = idx % F_BK;
      const long long m = m0 + r;
      const int k = k0 + c;
      sA[c * F_AS + r] = (m < p.M && k < p.K) ? A[m * p.lda + k] : 0.f;
    }
    // B tile: a warp reads 32 consecutive columns of one k row
#pragma unroll
    for (int i = 0; i < F_BK * F_BN / F_THREADS; ++i) {
      const int idx = tid + i * F_THREADS;
      const int r = idx / F_BN, c = idx % F_BN;
      const int k = k0 + r, n = n0 + c;
      sB[r * F_BN + c] = (k < p.K && n < p.N) ? B[static_cast<long long>(k) * p.ldb + n] : 0.f;
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
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
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
template <typename OutT>
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

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += H_BK) {
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
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
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

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16. A (M, K), B (K, N) and
// C (M, N) with unit column stride and the given row strides (elements).
// Returns the launch's cudaError_t.
int repro_gemm(const void* a, const void* b, void* c, int in_dtype, int out_dtype, int M, int N, int K,
               long long lda, long long ldb, long long ldc, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) return cudaErrorInvalidValue;
  if ((static_cast<long long>(N) + F_BN - 1) / F_BN > 65535) return cudaErrorInvalidValue;  // grid.y
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    if (out_dtype == 0) return launch(gemm_f32_kernel<float>, p, F_BM, F_BN, F_THREADS, st);
    return launch(gemm_f32_kernel<__nv_bfloat16>, p, F_BM, F_BN, F_THREADS, st);
  }
  if (out_dtype == 0) return launch(gemm_bf16_kernel<float>, p, H_BM, H_BN, H_THREADS, st);
  return launch(gemm_bf16_kernel<__nv_bfloat16>, p, H_BM, H_BN, H_THREADS, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
