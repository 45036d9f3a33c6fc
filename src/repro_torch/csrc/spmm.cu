// ELL sparse-dense product for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by repro_torch/hopper/spmm.py).
//
// Replaces: src/repro/kernels/spmm.py `_ell_kernel` (as built by
// `ell_spmm_program` and `spmm_pallas`).
//
// What it computes. out (R, F) = sum over slots j of values[:, j] *
// dense[cols[:, j], :], with values/cols (R, L) ELL rows (cols int32,
// padding slots value 0 / col 0) and dense (C, F). Sums are fp32; out has
// dense's type. values and dense are each fp32 or bf16. Each slot adds its
// product to the row's sum in slot order j = 0..L-1, product and sum each
// rounded to fp32 (__fmul_rn / __fadd_rn, no FMA contraction): the Pallas
// body's order and rounding, and the plain version's, so in fp32 the kernel
// and `blocked.spmm_blocked` agree bitwise.
//
// Design. One block of 8 warps per 32 rows; each warp owns 4 rows and its
// lanes run across F (lane + 32 * c, NC column groups per lane, NC a
// template parameter up to 8, more columns as further blocks along
// grid.y), so every gathered row dense[col, :] is read as whole 128-byte
// lines. The (col, value) pairs of the block's rows are staged in shared
// memory 32 slots at a time; a warp walks its 4 rows together, slot by
// slot, so it has 4 * NC independent gathers in flight. Padding slots are
// read like any other (they add 0); rows past R are skipped.
//
// Differences from the TPU kernel. The TPU keeps all of `dense` resident in
// VMEM, which caps C * F; here it is read through L2 and device memory, so
// there is no such cap.
//
// Bound on this card. The function must read values and cols once, dense
// once and write out once; it does 2 * nnz * F operations, far below the
// fp32 peak's share, so it is bound by bytes. The kernel reads each
// gathered row once per slot that names it (nnz * F elements, L times
// dense's size for a graph with L slots per row); only L2 hits bring that
// towards the bound. Ordering the rows for locality is a later step.
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 32;              // rows per block
constexpr int WARPS = 8;            // 256 threads
constexpr int RPW = BR / WARPS;     // rows per warp
constexpr int SC = 32;              // slots staged per chunk
constexpr int THREADS = WARPS * 32;
constexpr int MAX_NC = 8;           // column groups per lane: 256 columns per block

struct Params {
  const void* values;
  const int* cols;
  const void* dense;
  void* out;
  int R, L, F;
  long long ldv, ldcol, ldd, ldo;  // row strides in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename VT, typename DT, int NC>
__global__ void __launch_bounds__(THREADS) ell_spmm_kernel(const Params p) {
  __shared__ int sCol[BR][SC];
  __shared__ float sVal[BR][SC];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long r0 = static_cast<long long>(blockIdx.x) * BR;
  const int f0 = blockIdx.y * 32 * MAX_NC;
  const VT* values = static_cast<const VT*>(p.values);
  const DT* dense = static_cast<const DT*>(p.dense);

  float acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;

  bool live[RPW];  // this warp's rows that exist
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) live[rr] = r0 + warp * RPW + rr < p.R;

  for (int j0 = 0; j0 < p.L; j0 += SC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < BR * SC; i += THREADS) {
      const int r = i / SC, j = i % SC;
      const long long row = r0 + r;
      const int slot = j0 + j;
      const bool ok = row < p.R && slot < p.L;
      sCol[r][j] = ok ? p.cols[row * p.ldcol + slot] : 0;
      sVal[r][j] = ok ? to_f32(values[row * p.ldv + slot]) : 0.f;
    }
    __syncthreads();

    const int nj = min(SC, p.L - j0);
    for (int j = 0; j < nj; ++j) {
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        if (!live[rr]) continue;
        const int r = warp * RPW + rr;
        const float v = sVal[r][j];
        const DT* drow = dense + static_cast<long long>(sCol[r][j]) * p.ldd;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int f = f0 + lane + 32 * c;
          if (f < p.F) acc[rr][c] = __fadd_rn(acc[rr][c], __fmul_rn(v, to_f32(drow[f])));
        }
      }
    }
  }

  DT* out = static_cast<DT*>(p.out);
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    if (!live[rr]) continue;
    const long long row = r0 + warp * RPW + rr;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = f0 + lane + 32 * c;
      if (f < p.F) out[row * p.ldo + f] = from_f32<DT>(acc[rr][c]);
    }
  }
}

template <typename VT, typename DT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const int groups = (p.F + 31) / 32;
  const int nc = groups < MAX_NC ? groups : MAX_NC;
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(p.R) + BR - 1) / BR),
                  static_cast<unsigned>((p.F + 32 * MAX_NC - 1) / (32 * MAX_NC)));
  switch (nc) {
    case 1: ell_spmm_kernel<VT, DT, 1><<<grid, THREADS, 0, st>>>(p); break;
    case 2: ell_spmm_kernel<VT, DT, 2><<<grid, THREADS, 0, st>>>(p); break;
    case 3: ell_spmm_kernel<VT, DT, 3><<<grid, THREADS, 0, st>>>(p); break;
    case 4: ell_spmm_kernel<VT, DT, 4><<<grid, THREADS, 0, st>>>(p); break;
    case 5: ell_spmm_kernel<VT, DT, 5><<<grid, THREADS, 0, st>>>(p); break;
    case 6: ell_spmm_kernel<VT, DT, 6><<<grid, THREADS, 0, st>>>(p); break;
    case 7: ell_spmm_kernel<VT, DT, 7><<<grid, THREADS, 0, st>>>(p); break;
    default: ell_spmm_kernel<VT, DT, 8><<<grid, THREADS, 0, st>>>(p); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// val_dtype / dense_dtype: 0 = float32, 1 = bfloat16; out has dense's type.
// values/cols (R, L), dense (C, F), out (R, F), each with unit column
// stride and the given row strides (elements); every col in [0, C).
// Returns the launch's cudaError_t.
int repro_ell_spmm(const void* values, const int* cols, const void* dense, void* out, int val_dtype,
                   int dense_dtype, int R, int L, int F, long long ldv, long long ldcol, long long ldd,
                   long long ldo, void* stream) {
  if (R <= 0 || L < 0 || F <= 0) return cudaErrorInvalidValue;
  if ((val_dtype != 0 && val_dtype != 1) || (dense_dtype != 0 && dense_dtype != 1)) return cudaErrorInvalidValue;
  Params p;
  p.values = values;
  p.cols = cols;
  p.dense = dense;
  p.out = out;
  p.R = R;
  p.L = L;
  p.F = F;
  p.ldv = ldv;
  p.ldcol = ldcol;
  p.ldd = ldd;
  p.ldo = ldo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_dtype == 0) {
    if (dense_dtype == 0) return launch<float, float>(p, st);
    return launch<float, __nv_bfloat16>(p, st);
  }
  if (dense_dtype == 0) return launch<__nv_bfloat16, float>(p, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(p, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
