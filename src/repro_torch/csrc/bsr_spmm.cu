// Block-sparse-row (BSR) x dense product for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by repro_torch/hopper/bsr_spmm.py).
//
// Replaces: src/repro/kernels/spmm.py `_bsr_kernel` (as built by
// `bsr_spmm_program` and `bsr_spmm_pallas`).
//
// What it computes. out (num_rows, F) fp32 = for every tile t,
// out[rows[t]*bm : +bm, :] += vals[t] (bm, bk) . dense[cols[t]*bk : +bk, :],
// with the tiles sorted by block row. Tile values and dense are each fp32 or
// bf16; every product is summed in fp32 (FFMA on the CUDA cores, not TF32:
// the reference is exact fp32). A block row with no tiles is written as 0.
//
// Design. The TPU kernel walks a sequential tile axis and zeroes an output
// block on a row's first tile; that carry does not exist between CUDA
// blocks. Here one block owns one group of RG = 8 rows of one block row and
// one slice of FS = 256 columns, finds the row's tiles through a row pointer
// (rowptr[r] .. rowptr[r+1], computed on the device by the wrapper), and
// loops over them in tile order with the 8 x 256 sum in registers: no
// atomics, the Pallas body's tile order, every output element written once.
// 128 threads; thread i owns columns f0 + i and f0 + 128 + i, so a warp's
// dense loads are whole 128-byte lines. Each tile's rows of the group are
// staged in shared memory KC = 128 columns of the tile at a time (thread i
// loads column i of the 8 rows, coalesced, and stores them as two 16-byte
// words), transposed to [k][row], so one thread reads the 8 row values of a
// k as two 16-byte broadcasts for its 16 FFMAs. bm is any size (groups of 8 rows
// along grid.y, the rows past bm staged as 0 and not stored), bk any size
// (KC chunks), F any size (the ragged slice masked; dense is not padded).
//
// Bound on this card. The function reads the tiles (T*bm*bk values), the
// dense operand and writes out once, and does 2*T*bm*bk*F operations (every
// tile is a dense product). At the paper's densities the tiles hold few
// nonzeros and the operation count bounds it. This kernel reads a 128-row
// slab of dense from L2 for every tile and row group (T * 128 * F * 4 bytes,
// ~17 GB at bk=128, F=256 and 131k tiles), so expect it to be bound by L2
// bandwidth, not by its bound; sharing slabs between block rows with the
// same tile columns is a later step.
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RG = 8;           // output rows per block
constexpr int THREADS = 128;
constexpr int CPT = 2;          // columns per thread
constexpr int FS = THREADS * CPT;  // columns per block
constexpr int KC = THREADS;     // tile columns staged per chunk, one per thread

struct Params {
  const void* vals;    // (T, bm, bk), contiguous
  const int* rowptr;   // (nr + 1,)
  const int* cols;     // (T,)
  const void* dense;   // (K, F), unit column stride
  float* out;          // (num_rows, F), unit column stride
  int nr, bm, bk, F;
  long long ldd, ldo;  // row strides in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename VT, typename DT>
__global__ void __launch_bounds__(THREADS) bsr_spmm_kernel(const Params p) {
  __shared__ __align__(16) float sT[KC][RG];  // one chunk of the tile, [k][row]

  const int tid = threadIdx.x;
  const int br = blockIdx.x;                  // block row
  const int g0 = blockIdx.y * RG;             // first tile row of this group
  const int f0 = blockIdx.z * FS;
  const VT* vals = static_cast<const VT*>(p.vals);
  const DT* dense = static_cast<const DT*>(p.dense);

  int fcol[CPT];
  bool fok[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    fcol[c] = f0 + c * THREADS + tid;
    fok[c] = fcol[c] < p.F;
  }

  float acc[RG][CPT];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  const int t_begin = p.rowptr[br], t_end = p.rowptr[br + 1];
  const long long tile_size = static_cast<long long>(p.bm) * p.bk;
  for (int t = t_begin; t < t_end; ++t) {
    const VT* tile = vals + t * tile_size;
    const DT* slab = dense + static_cast<long long>(p.cols[t]) * p.bk * p.ldd;
    for (int k0 = 0; k0 < p.bk; k0 += KC) {
      const int kc = min(KC, p.bk - k0);
      __syncthreads();  // the previous chunk's readers are done
      {  // thread tid stages column k0 + tid of the group's 8 rows
        float v[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const int row = g0 + r;
          v[r] = (row < p.bm && tid < kc)
                     ? to_f32(tile[static_cast<long long>(row) * p.bk + k0 + tid])
                     : 0.f;
        }
        *reinterpret_cast<float4*>(&sT[tid][0]) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(&sT[tid][4]) = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        const float4 lo = *reinterpret_cast<const float4*>(&sT[k][0]);
        const float4 hi = *reinterpret_cast<const float4*>(&sT[k][4]);
        const float a[RG] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const DT* drow = slab + static_cast<long long>(k0 + k) * p.ldd;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float d = fok[c] ? to_f32(drow[fcol[c]]) : 0.f;
#pragma unroll
          for (int r = 0; r < RG; ++r) acc[r][c] = fmaf(a[r], d, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const int row = g0 + r;
    if (row >= p.bm) break;
    float* orow = p.out + (static_cast<long long>(br) * p.bm + row) * p.ldo;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (fok[c]) orow[fcol[c]] = acc[r][c];
  }
}

template <typename VT, typename DT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(p.nr), static_cast<unsigned>((p.bm + RG - 1) / RG),
                  static_cast<unsigned>((p.F + FS - 1) / FS));
  bsr_spmm_kernel<VT, DT><<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// val_dtype / dense_dtype: 0 = float32, 1 = bfloat16. vals (T, bm, bk)
// contiguous; rowptr (nr + 1,) int32 with the tiles of block row r at
// [rowptr[r], rowptr[r+1]); cols (T,) int32 with cols[t] * bk + bk <= K;
// dense (K, F) and out (nr * bm, F) fp32, each with unit column stride and
// the given row strides (elements). Returns the launch's cudaError_t.
int repro_bsr_spmm(const void* vals, const int* rowptr, const int* cols, const void* dense,
                   float* out, int val_dtype, int dense_dtype, int nr, int bm, int bk, int F,
                   long long ldd, long long ldo, void* stream) {
  if (nr <= 0 || bm <= 0 || bk <= 0 || F <= 0) return cudaErrorInvalidValue;
  if ((bm + RG - 1) / RG > 65535 || (F + FS - 1) / FS > 65535) return cudaErrorInvalidValue;
  if ((val_dtype != 0 && val_dtype != 1) || (dense_dtype != 0 && dense_dtype != 1))
    return cudaErrorInvalidValue;
  Params p;
  p.vals = vals;
  p.rowptr = rowptr;
  p.cols = cols;
  p.dense = dense;
  p.out = out;
  p.nr = nr;
  p.bm = bm;
  p.bk = bk;
  p.F = F;
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
