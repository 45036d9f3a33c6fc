// Block-sparse-row (BSR) x dense product for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by repro_torch/hopper/bsr_spmm.py).
//
// Replaces: src/repro/kernels/spmm.py `_bsr_kernel` (as built by
// `bsr_spmm_program` and `bsr_spmm_pallas`).
//
// What it computes. out (num_rows, F) fp32 = for every tile t,
// out[rows[t]*bm : +bm, :] += vals[t] (bm, bk) . dense[cols[t]*bk : +bk, :],
// with the tiles sorted by block row (any column order, repeats summed).
// Tile values and dense are each fp32 or bf16; every product is summed in
// fp32 (FFMA on the CUDA cores, not TF32: the reference is exact fp32). A
// block row with no tiles is written as 0. A zero tile value does no work,
// so a non-finite dense value facing a zero tile value does not turn the
// sum into NaN as the dense product 0 * inf would (the plain version keeps
// the dense product).
//
// Bound on this card. At the paper's densities the tiles are mostly
// zeros: at 2.8 % an 8 x 128 tile holds ~29 nonzeros, yet nearly every one
// of the 1024 x 128 tile slots of the card case is present. The function
// reads the tiles once (537 MB in fp32 there: 0.16 ms at 3.35 TB/s, which
// sets the bound) and needs 2 * nnz * F operations (1.9 GFLOP). A kernel
// that multiplies whole tiles does 2 * T * bm * bk * F = 68.7 GFLOP, at
// least 1.03 ms on the 67 TFLOP/s of the CUDA cores; a kernel that reads a
// dense slab from L2 for every tile moves ~17 GB.
//
// Design. A warp owns one output row and a slice of FS = 256 columns, 8 a
// lane (two 16-byte groups, 128 columns apart, so each load of a warp is
// 512 contiguous bytes): its sum stays in 8 registers, each output element
// is written once, by one lane, with no atomics. It walks its block row's
// tiles (rowptr, built by the wrapper on the device) and for each takes its
// own row of the tile, in chunks of KC = 128 values:
//  - the chunks are copied to a per-warp ring of S = 4 stages in shared
//    memory by 16-byte cp.async.cg (bypassing L1; L2 evict-first, since
//    each tile is read from HBM exactly once), with the tile's column,
//    S - 1 chunks ahead of the one being used;
//  - four warp ballots find the chunk's nonzeros, whose (column, value)
//    pairs the lanes holding them write, compacted by a popcount prefix,
//    to a per-warp list in shared memory; only those do work: U = 2 at a
//    time, each pair read by a broadcast load, its dense row's slice
//    loaded (16-byte loads, L2 evict-last, so the tile stream does not
//    push dense out of L2), then 8 FFMAs a lane for each.
// A CTA is the 8 rows of one row group (a block row at bm = 8; bm > 8
// takes ceil(bm / 8) groups, bm < 8 leaves warps idle): its warps walk the
// same tiles in step, so a dense row one of them brings into L1 can serve
// another's nonzero in that column. ~50-60 registers and 25.6 KB of shared
// memory a CTA (fp32 tiles) let 4 CTAs share an SM, 32 warps with their
// loads in flight; the card case is 1024 CTAs.
//
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at the
// densest card case the tile stream is about a third of the time; the
// dense gathers are bound by the warps' latency and instructions more than
// by L2 (pointing every gather at one row, so all hit L1, gains little),
// fewer registers a thread (U = 2) beat more loads in flight (U = 4, 8),
// and row groups walked in step by a CTA barrier (for L1 reuse across
// block rows) were slower than these free-running 8-row CTAs.
//
// A granule of 16 bytes is the copy's unit. A tile row need not start on
// one (bk * 2 bytes is odd for bf16 at odd bk), so each staged row covers
// the granules that hold it and remembers its offset in the first; a
// granule read before the first or after the last element of vals lies in
// the same 16-byte-aligned block as a byte of vals, so it never leaves
// vals' page.
//
// Dense is read with 16-byte (fp32) or 8-byte (bf16) vector loads where its
// pointer, row stride and F allow (the VEC instantiation), else element by
// element; ragged F is masked. Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;       // rows of a CTA: one row group
constexpr int THREADS = 32 * WARPS;
constexpr int RW = WARPS;      // rows of a row group
constexpr int CPL = 8;         // columns a lane
constexpr int FS = 32 * CPL;   // columns of a slice
constexpr int KC = 128;        // tile columns a stage
constexpr int S = 4;           // stages of a warp's ring
constexpr int U = 2;           // nonzeros whose dense rows are loaded together

struct Params {
  const void* vals;    // (T, bm, bk), contiguous
  const int* rowptr;   // (nr + 1,)
  const int* cols;     // (T,)
  const void* dense;   // (K, F), unit column stride
  float* out;          // (num_rows, F), unit column stride
  int nr, bm, bk, F;
  int groups;          // row groups of a block row: ceil(bm / RW)
  int slices;          // column slices: ceil(F / FS)
  long long ldd, ldo;  // row strides in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint64_t l2_policy(bool evict_first) {
  uint64_t pol;
  if (evict_first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  else
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "l"(pol));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_ring() { asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1)); }
__device__ __forceinline__ float4 ldg_f4(const void* src, uint64_t pol) {
  float4 x;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
      : "l"(src), "l"(pol));
  return x;
}
__device__ __forceinline__ uint2 ldg_u2(const void* src, uint64_t pol) {
  uint2 x;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;\n" : "=r"(x.x), "=r"(x.y) : "l"(src), "l"(pol));
  return x;
}

// CPL dense values of row `drow` at this lane's columns: groups of 4, group
// h at c0 + 128 h (a warp's group h is 128 consecutive columns); 0 past F.
template <typename DT, bool VEC>
__device__ __forceinline__ void load_dense(const DT* drow, int c0, int F, uint64_t pol, float (&d)[CPL]) {
#pragma unroll
  for (int h = 0; h < CPL / 4; ++h) {
    const int c = c0 + 128 * h;
    float* dh = d + 4 * h;
    if (VEC) {
      if (c < F) {
        if constexpr (sizeof(DT) == 4) {
          const float4 x = ldg_f4(drow + c, pol);
          dh[0] = x.x; dh[1] = x.y; dh[2] = x.z; dh[3] = x.w;
        } else {
          const uint2 x = ldg_u2(drow + c, pol);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
          dh[0] = lo.x; dh[1] = lo.y; dh[2] = hi.x; dh[3] = hi.y;
        }
      } else {
        dh[0] = dh[1] = dh[2] = dh[3] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[j] = c + j < F ? to_f32(drow[c + j]) : 0.f;
    }
  }
}

template <typename VT, typename DT, bool VEC>
__global__ void __launch_bounds__(THREADS) bsr_spmm_kernel(const Params p) {
  constexpr int ES = sizeof(VT);
  constexpr int RB = KC * ES + 16;  // a staged chunk: its granules, then room for the column
  __shared__ __align__(16) unsigned char smem[WARPS * S * (RB + 16)];
  __shared__ float2 lists[WARPS][KC];  // each warp's compacted nonzeros of its current chunk

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = blockIdx.x % p.slices;
  const long long group = blockIdx.x / p.slices;
  const int br = static_cast<int>(group / p.groups);
  const int row = static_cast<int>(group % p.groups) * RW + warp;  // this warp's tile row
  if (br >= p.nr || row >= p.bm) return;  // no barrier spans warps
  const int c0 = slice * FS + lane * 4;

  unsigned char* ring = smem + warp * S * (RB + 16);
  float2* list = lists[warp];
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const unsigned long long vals = reinterpret_cast<uintptr_t>(p.vals);
  const DT* dense = static_cast<const DT*>(p.dense);
  const uint64_t pol_tiles = l2_policy(true), pol_dense = l2_policy(false);

  const int t_begin = p.rowptr[br], t_end = p.rowptr[br + 1];
  const int chunks = (p.bk + KC - 1) / KC;
  const int items = (t_end - t_begin) * chunks;
  // the first byte of item i's chunk (tile t_begin + i / chunks, this row,
  // columns k0 .. k0 + kc - 1)
  auto first_byte = [&](int i) {
    const long long t = t_begin + i / chunks;
    return vals + ((t * p.bm + row) * p.bk + (i % chunks) * KC) * ES;
  };

  // copy item i into its stage: the granules holding its bytes, then cols[t]
  auto issue = [&](int i) {
    const int kc = min(KC, p.bk - (i % chunks) * KC);
    const uint32_t stage = ring_s + (i % S) * (RB + 16);
    const unsigned long long a = first_byte(i);
    for (int g = lane; 16ULL * g < (a & 15) + kc * ES; g += 32)
      cp_async16(stage + 16 * g, reinterpret_cast<const void*>((a & ~15ULL) + 16ULL * g), pol_tiles);
    if (lane == 0) cp_async4(stage + RB, p.cols + t_begin + i / chunks);
  };

  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < items) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < items; ++i) {
    if (i + S - 1 < items) issue(i + S - 1);
    cp_async_commit();
    cp_async_wait_ring();  // item i's group has landed
    __syncwarp();

    const int k0 = (i % chunks) * KC, kc = min(KC, p.bk - k0);
    const unsigned char* stage = ring + (i % S) * (RB + 16);
    const VT* vrow = reinterpret_cast<const VT*>(stage + (first_byte(i) & 15));
    const int col = *reinterpret_cast<const int*>(stage + RB);
    const DT* slab = dense + (static_cast<long long>(col) * p.bk + k0) * p.ldd;
    // the chunk's nonzeros, compacted in column order: (k, value) pairs
    int n = 0;
#pragma unroll
    for (int w = 0; w < KC / 32; ++w) {
      const int k = 32 * w + lane;
      const float v = k < kc ? to_f32(vrow[k]) : 0.f;
      const unsigned mask = __ballot_sync(0xffffffffu, v != 0.f);
      if (v != 0.f) list[n + __popc(mask & ((1u << lane) - 1))] = make_float2(__int_as_float(k), v);
      n += __popc(mask);
    }
    __syncwarp();
    for (int j = 0; j < n; j += U) {  // U nonzeros a round, their dense rows in flight together
      float a[U], d[U][CPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < n) {
          const float2 e = list[j + u];
          a[u] = e.y;
          load_dense<DT, VEC>(slab + static_cast<long long>(__float_as_int(e.x)) * p.ldd, c0, p.F, pol_dense,
                              d[u]);
        } else {
          a[u] = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) d[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = fmaf(a[u], d[u][c], acc[c]);
    }
    __syncwarp();  // the stage is read before item i + S overwrites it
  }

  float* orow = p.out + (static_cast<long long>(br) * p.bm + row) * p.ldo;
#pragma unroll
  for (int h = 0; h < CPL / 4; ++h) {
    const int c = c0 + 128 * h;
    const float* x = acc + 4 * h;
    if (VEC) {
      if (c < p.F) *reinterpret_cast<float4*>(orow + c) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < p.F) orow[c + j] = x[j];
    }
  }
}

template <typename VT, typename DT>
cudaError_t launch(const Params& p, long long ctas, bool vec, cudaStream_t st) {
  if (vec)
    bsr_spmm_kernel<VT, DT, true><<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(p);
  else
    bsr_spmm_kernel<VT, DT, false><<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(p);
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
  p.groups = (bm + RW - 1) / RW;
  p.slices = (F + FS - 1) / FS;
  p.ldd = ldd;
  p.ldo = ldo;
  const long long ctas = static_cast<long long>(nr) * p.groups * p.slices;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int dsize = dense_dtype == 0 ? 4 : 2;
  // vector loads: 4 elements at a time, aligned, never straddling F
  const bool vec = F % 4 == 0 && ldd % 4 == 0 && ldo % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dense) % (dsize * 4) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_dtype == 0) {
    if (dense_dtype == 0) return launch<float, float>(p, ctas, vec, st);
    return launch<float, __nv_bfloat16>(p, ctas, vec, st);
  }
  if (dense_dtype == 0) return launch<__nv_bfloat16, float>(p, ctas, vec, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(p, ctas, vec, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
