// Sparse x sparse product by index intersection for Hopper (sm_90a), CUDA C++
// with a plain C interface (loaded with ctypes by repro_torch/hopper/spmspm.py).
//
// Replaces: src/repro/kernels/spmspm.py `_spmspm_kernel` (as built by
// `spmspm_program` and `spmspm_pallas`).
//
// What it computes. out (R, C) fp32, out[m, n] = sum over the pairs (i, j)
// with a_cols[m, i] == b_rows[n, j] of a_vals[m, i] * b_vals[n, j]: A is ELL
// rows (R, La), B is ELL columns (C, Lb), both over a contraction dim K.
// Values are fp32 or bf16; products are summed in fp32.
//
// Design. The TPU kernel compares all index pairs of a (bm, La) x (bn, Lb)
// tile, bm*bn*La*Lb comparisons per tile (the paper's GCOMP count). Here the
// same sum is computed as out[m, n] = sum_j b_vals[n, j] * a_dense_m[b_rows[n,
// j]]: a block scatter-adds RB = 3 rows of A into K-wide fp32 rows in shared
// memory (3 x 64 KB at K = 16384; duplicate indices add, ELL padding adds
// 0), then each warp takes 32 consecutive outputs n at a time: for each, its
// lanes walk B's row n (coalesced), gather the three A rows at b_rows[n, j],
// reduce across the warp, and the lane n % 32 keeps the sums, so the 32
// outputs of a row are stored as one 128-byte line. That is R*C*Lb gathers
// instead of R*C*La*Lb comparisons. Where K exceeds KT_MAX = 16384 the
// contraction runs in passes over K tiles of KT_MAX: each pass densifies the
// A entries in its tile, gathers only B entries in it, and adds into out (a
// block owns its rows of out, so no atomics). An index outside [0, K)
// contributes nothing.
//
// Bound on this card. The function must read A and B once and write out
// once (R*C*4 bytes, 67 MB at 4096 x 4096), and do 2 operations per
// matching index pair, a few per output at the paper's densities: it is
// bound by bytes. This kernel reads all of B (from L2) once per block of 3
// A rows and does R*C*Lb shared-memory gathers, most of them of zeros, so
// expect it to be bound by those gathers and the warp reductions, far from
// its bound. Gathering with the shorter side, or compressing the densified
// rows, is a later step.
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 3;          // A rows per block
constexpr int THREADS = 1024;  // 32 warps
constexpr int WARPS = THREADS / 32;
constexpr int KT_MAX = 16384;  // K columns densified per pass (RB * 64 KB)

struct Params {
  const void* a_vals;
  const int* a_cols;
  const void* b_vals;
  const int* b_rows;
  float* out;
  int R, C, La, Lb, K, KT;
  long long ldav, ldac, ldbv, ldbr, ldo;  // row strides in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename AT, typename BT>
__global__ void __launch_bounds__(THREADS) spmspm_kernel(const Params p) {
  extern __shared__ float sA[];  // [RB][KT]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * RB;
  const AT* a_vals = static_cast<const AT*>(p.a_vals);
  const BT* b_vals = static_cast<const BT*>(p.b_vals);
  const int KT = p.KT;

  for (int kt0 = 0; kt0 < p.K; kt0 += KT) {
    __syncthreads();  // the previous pass's readers are done
    for (int i = tid; i < RB * KT; i += THREADS) sA[i] = 0.f;
    __syncthreads();
    for (int i = tid; i < RB * p.La; i += THREADS) {
      const int r = i / p.La, j = i % p.La;
      const long long m = m0 + r;
      if (m >= p.R) continue;
      const int k = p.a_cols[m * p.ldac + j] - kt0;
      if (static_cast<unsigned>(k) < static_cast<unsigned>(KT) && kt0 + k < p.K)
        atomicAdd(&sA[r * KT + k], to_f32(a_vals[m * p.ldav + j]));
    }
    __syncthreads();

    for (int n0 = warp * 32; n0 < p.C; n0 += WARPS * 32) {
      float mine[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) mine[r] = 0.f;
      const int nq = min(32, p.C - n0);
      for (int q = 0; q < nq; ++q) {
        const long long n = n0 + q;
        const int* brow = p.b_rows + n * p.ldbr;
        const BT* bval = b_vals + n * p.ldbv;
        float part[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) part[r] = 0.f;
#pragma unroll 4
        for (int j = lane; j < p.Lb; j += 32) {
          const int k = brow[j] - kt0;
          if (static_cast<unsigned>(k) < static_cast<unsigned>(KT) && kt0 + k < p.K) {
            const float v = to_f32(bval[j]);
#pragma unroll
            for (int r = 0; r < RB; ++r) part[r] = fmaf(v, sA[r * KT + k], part[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int s = 16; s > 0; s >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], s);
          if (lane == q) mine[r] = part[r];
        }
      }
      if (lane < nq) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const long long m = m0 + r;
          if (m >= p.R) break;
          float* o = p.out + m * p.ldo + n0 + lane;
          *o = kt0 == 0 ? mine[r] : *o + mine[r];
        }
      }
    }
  }
}

template <typename AT, typename BT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t smem = sizeof(float) * RB * p.KT;
  cudaError_t err = cudaFuncSetAttribute(spmspm_kernel<AT, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(p.R) + RB - 1) / RB));
  spmspm_kernel<AT, BT><<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a_dtype / b_dtype: 0 = float32, 1 = bfloat16. a_vals/a_cols (R, La),
// b_vals/b_rows (C, Lb), indices int32 into [0, K); out (R, C) fp32; each
// with unit column stride and the given row strides (elements). Returns the
// launch's cudaError_t.
int repro_spmspm(const void* a_vals, const int* a_cols, const void* b_vals, const int* b_rows,
                 float* out, int a_dtype, int b_dtype, int R, int C, int La, int Lb, int K,
                 long long ldav, long long ldac, long long ldbv, long long ldbr, long long ldo,
                 void* stream) {
  if (R <= 0 || C <= 0 || La < 0 || Lb < 0 || K <= 0) return cudaErrorInvalidValue;
  if ((a_dtype != 0 && a_dtype != 1) || (b_dtype != 0 && b_dtype != 1)) return cudaErrorInvalidValue;
  Params p;
  p.a_vals = a_vals;
  p.a_cols = a_cols;
  p.b_vals = b_vals;
  p.b_rows = b_rows;
  p.out = out;
  p.R = R;
  p.C = C;
  p.La = La;
  p.Lb = Lb;
  p.K = K;
  p.KT = K < KT_MAX ? K : KT_MAX;
  p.ldav = ldav;
  p.ldac = ldac;
  p.ldbv = ldbv;
  p.ldbr = ldbr;
  p.ldo = ldo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0) {
    if (b_dtype == 0) return launch<float, float>(p, st);
    return launch<float, __nv_bfloat16>(p, st);
  }
  if (b_dtype == 0) return launch<__nv_bfloat16, float>(p, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(p, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
