// Sparse x sparse product by index intersection for Hopper (sm_90a), CUDA C++
// with a plain C interface (loaded with ctypes by repro_torch/hopper/spmspm.py).
//
// Replaces: src/repro/kernels/spmspm.py `_spmspm_kernel` (as built by
// `spmspm_program` and `spmspm_pallas`).
//
// What it computes. out (R, C) fp32, out[m, n] = sum over the pairs (i, j)
// with a_cols[m, i] == b_rows[n, j] of a_vals[m, i] * b_vals[n, j]: A is ELL
// rows (R, La), B is ELL columns (C, Lb), both over a contraction dim K.
// Values are fp32 or bf16; products are summed in fp32. An index outside
// [0, K) contributes nothing, and so does a value of 0 (ELL padding): it
// would add 0 * x = 0 for any finite x.
//
// Bound on this card. The function must read A and B once and write out
// once (R*C*4 bytes, 67 MB at 4096 x 4096: 0.02 ms at 3.35 TB/s), and do 2
// operations per index pair that matches, about 4.6 per output at 2.8%
// density: it is bound by bytes, by the output's.
//
// Design. The TPU kernel compares all index pairs of an A-row tile and a
// B-column tile; an earlier form here densified A's rows and gathered them
// at all of B's indices, R*C*Lb gathers of which ~97% found a zero. Here
// the product is row-wise (Gustavson), over a copy of B indexed by k, so
// the work follows the nonzeros:
//   1. `spmspm_count`, a warp per column n of B: counts each (tile, k) the
//      column holds, where tile = n / ct (the output's columns go in tiles
//      of ct <= 4096, so that a row's tile of fp32 sums fits in 16 KB of
//      shared memory). A column's repeated index counts once: its values
//      are merged (step 3).
//   2. `spmspm_scan`, one CTA: the exclusive scan of the counts, the start
//      of each (tile, k)'s list.
//   3. `spmspm_scatter`, a warp per column: writes (n - tile * ct, b) into
//      its (tile, k) list, b the sum, in column order, of the column's
//      values at k; each (tile, k, n) appears once, so a list never holds
//      one output column twice.
//   4. `spmspm_rows`, a warp per (row m of A, tile): zeroes its tile of
//      fp32 sums in shared memory, walks A's row in order and, for each
//      entry (k, a), adds a * b at each (n, b) of the (tile, k) list,
//      lanes along the list: the list's n are distinct, so the lanes'
//      read-modify-writes never meet, and the warp synchronises between
//      entries. Lists are loaded eight entries ahead (two list slots a
//      lane), so 16 loads are in flight per lane. The tile is then stored
//      with 16-byte streaming stores (the output is written once).
// The copy of B (tiles * K + 1 offsets and nnz(B) pairs, 5.4 MB at the
// sparse trio's card size) stays in L2 for step 4: its reads are R * La *
// (C * Lb / K) list entries, ~77 M at 2.8% (~616 MB from L2), instead of
// R * C * Lb gathers. All four launches count as the one kernel, on the
// caller's stream, with no host synchronisation; the wrapper allocates the
// scratch. The summation order is fixed: out[m, n] adds A's entries in row
// order, each once, and a repeated index of B is merged in column order, so
// a call's result does not change from run to run.
//
// What bounds it (probe runs on the card, PERF.md): step 4 by the load/store
// pipe (a list entry's global load and its shared-memory read and write at a
// random column, with bank conflicts; shared-memory atomics in place of the
// plain read-modify-write were slower, deeper prefetch or other CTA shapes no
// faster); steps 1 and 3 by L2 atomics on contended counters (each k is
// counted by ~41 columns at the sparse trio's card size), a fixed cost at
// every density.
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT_MAX = 4096;    // output columns a warp sums on chip: 16 KB of fp32
constexpr int WARPS = 4;        // (row, tile) items of a CTA, one a warp
constexpr int AHEAD = 8;        // A entries whose lists are loaded together
constexpr int BUILD_THREADS = 256;
constexpr int WIN = 8;  // entries of B a lane loads at once in the build
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 16;  // a multiple of 4

struct Params {
  const void* a_vals;
  const int* a_cols;
  const void* b_vals;
  const int* b_rows;
  float* out;
  int* count;  // [tiles * K + 1]: entries per (tile, k); the scatter counts them down
  int* ptr;    // [tiles * K + 1]: exclusive scan of count
  int2* list;  // B's entries by (tile, k): (n - tile * ct, the value's bits)
  int R, C, La, Lb, K, ct, tiles, vec;
  long long ldav, ldac, ldbv, ldbr, ldo;  // row strides in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Column n of B, entry j: its index k and value; kept if k is in range and
// the value is not 0. `first`: no kept entry before j has the same k.
// `sorted`: the column's indices strictly increase, so none repeats.
template <typename BT>
struct Column {
  const int* rows;
  const BT* vals;
  int K;
  bool sorted;

  __device__ bool kept(int k, float v) const { return static_cast<unsigned>(k) < static_cast<unsigned>(K) && v != 0.f; }
  __device__ bool first(int j, int k) const {
    if (sorted) return true;
    for (int i = 0; i < j; ++i)
      if (rows[i] == k && to_f32(vals[i]) != 0.f) return false;
    return true;
  }
};

// The warp's column (a warp per column of B); false past the last column.
// Loads are issued a window of WIN entries a lane at a time, so that they
// are in flight together.
template <typename BT>
__device__ __forceinline__ bool column_of_warp(const Params& p, Column<BT>& col, long long& n) {
  n = (static_cast<long long>(blockIdx.x) * BUILD_THREADS + threadIdx.x) / 32;
  if (n >= p.C) return false;
  const int lane = threadIdx.x & 31;
  col.rows = p.b_rows + n * p.ldbr;
  col.vals = static_cast<const BT*>(p.b_vals) + n * p.ldbv;
  col.K = p.K;
  bool up = true;
  for (int j0 = 0; j0 < p.Lb; j0 += 32 * WIN) {
    int a[WIN], b[WIN];
#pragma unroll
    for (int q = 0; q < WIN; ++q) {
      const int j = j0 + 32 * q + lane;
      a[q] = j + 1 < p.Lb ? col.rows[j] : 0;
      b[q] = j + 1 < p.Lb ? col.rows[j + 1] : 1;
    }
#pragma unroll
    for (int q = 0; q < WIN; ++q) up &= a[q] < b[q];
  }
  col.sorted = __all_sync(0xffffffffu, up);
  return true;
}

// 1. counts per (tile, k)
template <typename BT>
__global__ void __launch_bounds__(BUILD_THREADS) spmspm_count(const Params p) {
  Column<BT> col;
  long long n;
  if (!column_of_warp(p, col, n)) return;
  const long long base = (n / p.ct) * p.K;
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < p.Lb; j0 += 32 * WIN) {
    int k[WIN];
    float v[WIN];
#pragma unroll
    for (int q = 0; q < WIN; ++q) {
      const int j = j0 + 32 * q + lane;
      k[q] = j < p.Lb ? col.rows[j] : -1;
      v[q] = j < p.Lb ? to_f32(col.vals[j]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < WIN; ++q)
      if (col.kept(k[q], v[q]) && col.first(j0 + 32 * q + lane, k[q])) atomicAdd(p.count + base + k[q], 1);
  }
}

// 2. ptr = exclusive scan of count, SCAN_ITEMS consecutive values a thread
// in passes of SCAN_THREADS * SCAN_ITEMS (one pass at the sparse trio's K)
__global__ void __launch_bounds__(SCAN_THREADS) spmspm_scan(const int* count, int* ptr, long long L) {
  __shared__ int sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (long long base = 0; base < L; base += SCAN_THREADS * SCAN_ITEMS) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * SCAN_ITEMS;
    int v[SCAN_ITEMS], mine = 0;
    if (i0 + SCAN_ITEMS <= L) {  // 16-byte aligned: count starts on 16 bytes, i0 is a multiple of 4
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; j += 4) {
        const int4 q = *reinterpret_cast<const int4*>(count + i0 + j);
        v[j] = q.x;
        v[j + 1] = q.y;
        v[j + 2] = q.z;
        v[j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; ++j) v[j] = i0 + j < L ? count[i0 + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) mine += v[j];
    int x = mine;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += y;
      }
      sums[lane] = s;
    }
    __syncthreads();
    int at = carry + (warp ? sums[warp - 1] : 0) + x - mine;
    if (i0 + SCAN_ITEMS <= L) {  // ptr starts on 16 bytes too
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; j += 4) {
        int4 q;
        q.x = at;
        q.y = q.x + v[j];
        q.z = q.y + v[j + 1];
        q.w = q.z + v[j + 2];
        at = q.w + v[j + 3];
        *reinterpret_cast<int4*>(ptr + i0 + j) = q;
      }
    } else {
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; ++j) {
        if (i0 + j < L) ptr[i0 + j] = at;
        at += v[j];
      }
    }
    carry += sums[31];
    __syncthreads();  // sums is rewritten by the next pass
  }
}

// 3. the k-indexed copy of B
template <typename BT>
__global__ void __launch_bounds__(BUILD_THREADS) spmspm_scatter(const Params p) {
  Column<BT> col;
  long long n;
  if (!column_of_warp(p, col, n)) return;
  const int tile = static_cast<int>(n / p.ct);
  const long long base = static_cast<long long>(tile) * p.K;
  const int lane = threadIdx.x & 31, nl = static_cast<int>(n) - tile * p.ct;
  for (int j0 = 0; j0 < p.Lb; j0 += 32 * WIN) {
    int k[WIN];
    float v[WIN];
#pragma unroll
    for (int q = 0; q < WIN; ++q) {
      const int j = j0 + 32 * q + lane;
      k[q] = j < p.Lb ? col.rows[j] : -1;
      v[q] = j < p.Lb ? to_f32(col.vals[j]) : 0.f;
      if (!col.kept(k[q], v[q]) || !col.first(j, k[q])) k[q] = -1;
      if (k[q] >= 0 && !col.sorted)  // merge the column's later entries at k, in column order
        for (int i = j + 1; i < p.Lb; ++i) {
          const int ki = col.rows[i];
          const float vi = to_f32(col.vals[i]);
          if (ki == k[q] && col.kept(ki, vi)) v[q] += vi;
        }
    }
    int at[WIN];
#pragma unroll
    for (int q = 0; q < WIN; ++q)
      if (k[q] >= 0) at[q] = p.ptr[base + k[q]] + atomicSub(p.count + base + k[q], 1) - 1;
#pragma unroll
    for (int q = 0; q < WIN; ++q)
      if (k[q] >= 0) p.list[at[q]] = make_int2(nl, __float_as_int(v[q]));
  }
}

// 4. a warp per (row m, tile): out[m, tile] from the lists of A's entries
template <typename AT>
__global__ void __launch_bounds__(32 * WARPS) spmspm_rows(const Params p) {
  extern __shared__ __align__(16) float tile_sums[];  // [WARPS][ct]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (item >= static_cast<long long>(p.R) * p.tiles) return;
  const long long m = item / p.tiles;
  const int tile = static_cast<int>(item % p.tiles);
  const int n0 = tile * p.ct, cw = min(p.ct, p.C - n0);
  float* row = tile_sums + warp * p.ct;
  for (int c = 4 * lane; c < p.ct; c += 128) *reinterpret_cast<float4*>(row + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();

  const int* acol = p.a_cols + m * p.ldac;
  const AT* aval = static_cast<const AT*>(p.a_vals) + m * p.ldav;
  const int* ptr = p.ptr + static_cast<long long>(tile) * p.K;
  const int2* list = p.list;
  for (int i0 = 0; i0 < p.La; i0 += 32) {
    int beg = 0, len = 0;
    float a = 0.f;
    if (i0 + lane < p.La) {
      const int k = acol[i0 + lane];
      a = to_f32(aval[i0 + lane]);
      if (static_cast<unsigned>(k) < static_cast<unsigned>(p.K) && a != 0.f) {
        beg = __ldg(ptr + k);
        len = __ldg(ptr + k + 1) - beg;
      }
    }
    const int cnt = min(32, p.La - i0);
    for (int q0 = 0; q0 < cnt; q0 += AHEAD) {
      int bq[AHEAD], lq[AHEAD];
      float aq[AHEAD];
      int2 e[AHEAD][2];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int q = q0 + u;
        bq[u] = __shfl_sync(0xffffffffu, beg, q & 31);
        lq[u] = q < cnt ? __shfl_sync(0xffffffffu, len, q & 31) : 0;
        aq[u] = __shfl_sync(0xffffffffu, a, q & 31);
#pragma unroll
        for (int s = 0; s < 2; ++s)
          e[u][s] = lane + 32 * s < lq[u] ? __ldg(list + bq[u] + lane + 32 * s) : make_int2(-1, 0);
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (e[u][s].x >= 0) row[e[u][s].x] = fmaf(aq[u], __int_as_float(e[u][s].y), row[e[u][s].x]);
        for (int o = 64 + lane; o < lq[u]; o += 32) {  // a list longer than two slots a lane
          const int2 x = __ldg(list + bq[u] + o);
          row[x.x] = fmaf(aq[u], __int_as_float(x.y), row[x.x]);
        }
        __syncwarp();  // the next entry's list may hold the same n
      }
    }
  }

  float* out = p.out + m * p.ldo + n0;
  if (p.vec) {
    for (int c = 4 * lane; c < cw; c += 128) {
      if (c + 4 <= cw) {
        __stcs(reinterpret_cast<float4*>(out + c), *reinterpret_cast<const float4*>(row + c));
      } else {
        for (int j = c; j < cw; ++j) __stcs(out + j, row[j]);
      }
    }
  } else {
    for (int c = lane; c < cw; c += 32) __stcs(out + c, row[c]);
  }
}

template <typename AT, typename BT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const long long L = static_cast<long long>(p.tiles) * p.K + 1;
  cudaError_t err = cudaMemsetAsync(p.count, 0, sizeof(int) * L, st);
  if (err != cudaSuccess) return err;
  const unsigned build_grid = static_cast<unsigned>((static_cast<long long>(p.C) * 32 + BUILD_THREADS - 1) /
                                                    BUILD_THREADS);
  if (p.Lb > 0) {
    spmspm_count<BT><<<build_grid, BUILD_THREADS, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  spmspm_scan<<<1, SCAN_THREADS, 0, st>>>(p.count, p.ptr, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.Lb > 0) {
    spmspm_scatter<BT><<<build_grid, BUILD_THREADS, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = sizeof(float) * WARPS * p.ct;
  err = cudaFuncSetAttribute(spmspm_rows<AT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.R) * p.tiles;
  spmspm_rows<AT><<<static_cast<unsigned>((items + WARPS - 1) / WARPS), 32 * WARPS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints in each of the count and offset arrays: tiles * K + 1, rounded up to
// 4 so that each array starts on 16 bytes.
inline long long offsets_len(long long tiles, int K) { return (tiles * K + 1 + 3) / 4 * 4; }

// Bytes of scratch `repro_spmspm` needs for B (C, Lb) over K with output
// tiles of ct columns: the count and offset arrays and C * Lb (int, float)
// pairs; -1 for arguments it refuses.
long long repro_spmspm_scratch_bytes(int C, int Lb, int K, int ct) {
  if (C <= 0 || Lb < 0 || K <= 0 || ct <= 0 || ct % 4 || ct > CT_MAX) return -1;
  const long long tiles = (C + ct - 1) / ct;
  return 8 * offsets_len(tiles, K) + 8LL * C * Lb;
}

// a_dtype / b_dtype: 0 = float32, 1 = bfloat16. a_vals/a_cols (R, La),
// b_vals/b_rows (C, Lb), indices int32 into [0, K); out (R, C) fp32; each
// with unit column stride and the given row strides (elements). ct: the
// output columns of a tile, a multiple of 4 up to 4096. scratch: of
// repro_spmspm_scratch_bytes, 16-byte aligned. Returns the first failing
// launch's cudaError_t, else 0.
int repro_spmspm(const void* a_vals, const int* a_cols, const void* b_vals, const int* b_rows, float* out,
                 void* scratch, int a_dtype, int b_dtype, int R, int C, int La, int Lb, int K, int ct,
                 long long ldav, long long ldac, long long ldbv, long long ldbr, long long ldo, void* stream) {
  if (R <= 0 || C <= 0 || La < 0 || Lb < 0 || K <= 0) return cudaErrorInvalidValue;
  if (ct <= 0 || ct % 4 || ct > CT_MAX) return cudaErrorInvalidValue;
  if ((a_dtype != 0 && a_dtype != 1) || (b_dtype != 0 && b_dtype != 1)) return cudaErrorInvalidValue;
  const long long tiles = (C + ct - 1) / ct;
  if (tiles * K + 1 > 0x7fffffffLL || static_cast<long long>(C) * Lb > 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p;
  p.a_vals = a_vals;
  p.a_cols = a_cols;
  p.b_vals = b_vals;
  p.b_rows = b_rows;
  p.out = out;
  p.count = static_cast<int*>(scratch);
  p.ptr = p.count + offsets_len(tiles, K);
  p.list = reinterpret_cast<int2*>(p.ptr + offsets_len(tiles, K));
  p.R = R;
  p.C = C;
  p.La = La;
  p.Lb = Lb;
  p.K = K;
  p.ct = ct;
  p.tiles = static_cast<int>(tiles);
  p.vec = ldo % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
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
