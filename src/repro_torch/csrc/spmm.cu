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
// and `blocked.spmm_blocked` agree bitwise. Every route keeps that order:
// the columns of a row are independent sums, and no route splits a row's
// slots.
//
// Bound on this card. The function must read values and cols once, dense
// once and write out once; it does 2 * nnz * F operations. A kernel that
// gathers dense[col] per slot moves nnz * F elements from L2 (1.46 GB for
// the GCN's ogbn-arxiv-size graph), L times dense's size: L2 bandwidth,
// not the byte bound, sets its floor.
//
// Design. The wrapper's planner (`hopper/spmm.py` `plan`) picks the tiles
// from the shapes and types. A thread owns one (row, vector of VEC
// columns) pair: VEC = 16 bytes of dense where F, the row strides and the
// pointers allow it, else one element, so a row's lanes read whole 16-byte
// pieces of the gathered row and F = 144 (36 float4) leaves no lane idle.
// A thread loads U slots' (col, value) at once and then their U gathers,
// so it keeps U independent 16-byte loads in flight (the first version
// kept 4 rows x 5 groups of 4-byte loads a warp, synchronising every 32
// slots): U = 16 where a row has 16 slots or more, else 8, since a larger
// batch costs registers and so resident warps (the GCN's L = 15 runs
// fastest at 8, the sparse trio's L = 164 and 459 at 16). F is cut into
// slabs whose slice of dense (C x slab) fits the L2, in whole 128-byte
// lines (32 of the GCN's 144 columns: 21.7 MB of 97.5 MB, 5 slabs, which
// measured faster than 3 of 48 or 6 of 24), and the 1-D grid is
// slab-major, so one slab's blocks run together and its gathers hit L2;
// the DRAM then reads dense about once.
//
// A staged route for rows whose columns are sorted (a block of 128 rows
// copied dense's rows range by range into shared memory by cp.async and
// consumed each row's slots as their columns came up) measured slower than
// this one at every density of the sparse trio, and was removed (PERF.md,
// PR 21).
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {


struct Params {
  const void* values;
  const int* cols;
  const void* dense;
  void* out;
  int R, L, F;
  long long ldv, ldcol, ldd, ldo;  // row strides in elements
  int slab;        // columns a block covers
  int lanes;       // threads a row
  int rows;        // rows a block covers
  int row_blocks;  // blocks along R
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC consecutive elements of p as fp32 (one 16-byte load where VEC fills 16 bytes)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    if constexpr (sizeof(T) == 4) {
      x[0] = __uint_as_float(raw.x);
      x[1] = __uint_as_float(raw.y);
      x[2] = __uint_as_float(raw.z);
      x[3] = __uint_as_float(raw.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) p[0] = x[0];
    else p[0] = __float2bfloat16_rn(x[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <typename VT, typename DT, int VEC, int U>
__global__ void __launch_bounds__(256) ell_gather_kernel(const Params p) {
  const int slab = blockIdx.x / p.row_blocks, rb = blockIdx.x % p.row_blocks;
  const int lane = threadIdx.x % p.lanes;
  const long long row = static_cast<long long>(rb) * p.rows + threadIdx.x / p.lanes;
  const int f = slab * p.slab + lane * VEC;
  if (row >= p.R || f >= p.F) return;  // no barrier in this kernel
  const int* crow = p.cols + row * p.ldcol;
  const VT* vrow = static_cast<const VT*>(p.values) + row * p.ldv;
  const DT* dense = static_cast<const DT*>(p.dense) + f;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  int j = 0;
  for (; j + U <= p.L; j += U) {  // U slots at a time, in slot order
    int c[U];
    float v[U], d[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c[u] = __ldg(crow + j + u);
      v[u] = to_f32(vrow[j + u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) load_vec<DT, VEC>(dense + static_cast<long long>(c[u]) * p.ldd, d[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(v[u], d[u][e]));
  }
  for (; j < p.L; ++j) {  // the last L % U slots, one at a time
    float d[VEC];
    const float v = to_f32(vrow[j]);
    load_vec<DT, VEC>(dense + static_cast<long long>(__ldg(crow + j)) * p.ldd, d);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(v, d[e]));
  }
  store_vec<DT, VEC>(static_cast<DT*>(p.out) + row * p.ldo + f, acc);
}

template <typename VT, typename DT, int VEC>
cudaError_t launch_batch(const Params& p, int batch, dim3 grid, int threads, cudaStream_t st) {
  if (batch == 8) ell_gather_kernel<VT, DT, VEC, 8><<<grid, threads, 0, st>>>(p);
  else if (batch == 16) ell_gather_kernel<VT, DT, VEC, 16><<<grid, threads, 0, st>>>(p);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename VT, typename DT>
cudaError_t launch(const Params& p, int vec, int batch, cudaStream_t st) {
  constexpr int V16 = 16 / sizeof(DT);
  const long long blocks = static_cast<long long>(p.row_blocks) * ((p.F + p.slab - 1) / p.slab);
  const int threads = p.rows * p.lanes;
  if (blocks <= 0 || blocks > 0x7fffffffLL || threads <= 0 || threads > 256 ||
      p.lanes * vec != p.slab || static_cast<long long>(p.row_blocks) * p.rows < p.R)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec == V16) return launch_batch<VT, DT, V16>(p, batch, grid, threads, st);
  if (vec == 1) return launch_batch<VT, DT, 1>(p, batch, grid, threads, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// val_dtype / dense_dtype: 0 = float32, 1 = bfloat16; out has dense's type.
// values/cols (R, L), dense (C, F), out (R, F), each with unit column
// stride and the given row strides (elements); every col in [0, C). The
// plan (hopper/spmm.py `plan`): vec elements a load (1, or 16 bytes'
// worth, which F, the row strides and the pointers must allow), batch
// slots a thread loads together (8 or 16), slab columns a block, lanes
// threads a row, rows a block, row_blocks blocks along R. Returns the
// launch's cudaError_t.
int repro_ell_spmm(const void* values, const int* cols, const void* dense, void* out, int val_dtype,
                   int dense_dtype, int R, int L, int F, long long ldv, long long ldcol, long long ldd,
                   long long ldo, int vec, int batch, int slab, int lanes, int rows, int row_blocks,
                   void* stream) {
  if (R <= 0 || L < 0 || F <= 0 || slab <= 0 || row_blocks <= 0) return cudaErrorInvalidValue;
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
  p.slab = slab;
  p.lanes = lanes;
  p.rows = rows;
  p.row_blocks = row_blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_dtype == 0) {
    if (dense_dtype == 0) return launch<float, float>(p, vec, batch, st);
    return launch<float, __nv_bfloat16>(p, vec, batch, st);
  }
  if (dense_dtype == 0) return launch<__nv_bfloat16, float>(p, vec, batch, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(p, vec, batch, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
