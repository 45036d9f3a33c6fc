// Periodic star/box stencil for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by repro_torch/hopper/stencil.py).
//
// Replaces: src/repro/kernels/stencil.py `_stencil_kernel` (as built by
// `stencil_program` and `stencil_pallas`).
//
// What it computes. out (X, Y, Z), in the grid's type (fp32 or bf16):
// out[x, y, z] = sum over points p of w_p * grid[(x+dx_p) mod X,
// (y+dy_p) mod Y, (z+dz_p) mod Z], summed in fp32 in point order, the
// product and the sum each rounded to fp32 (__fmul_rn / __fadd_rn, no FMA
// contraction), then one rounding to the grid's type: the Pallas body's
// order and roundings, and the plain version's, so in fp32 the kernel and
// `blocked.stencil_blocked` agree bitwise.
//
// Bound on this card. The function reads the grid once and writes out
// once, and does 2 operations per point per output: bound by bytes (0.32 ms
// for a 512^3 fp32 grid at 3.35 TB/s). The fmul/fadd pair the contract
// requires costs 0.24 ms of FP32 issue at 27 points on 512^3, so a kernel
// that spends more than a few instructions per point and output beside it
// leaves the byte bound.
//
// Design (route "march"; the wrapper's planner `hopper/stencil.py` `plan`
// picks the route, the tile and the x cut). The TPU kernel stages the
// previous, current and next x-blocks in VMEM and applies each offset as a
// static slice plus a lane rotate. Here a block owns a (TY, TZ) tile of the
// (y, z) plane (lanes along z, or along y when Z < 32, so a 2-D grid keeps
// 256 lanes along y) and marches along x over `runs` runs of XR = 16
// planes, each thread summing the XR outputs of its (y, z) column in
// registers. The run's window, XR + 2 rx planes of the tile plus its y/z
// halo, sits in shared memory at a fixed pitch of PITCH floats a plane, so
// a point's operand for output k is one shared-memory load at a constant
// offset k * PITCH from the point's base: per point and output one load, a
// multiply and an add, the point's offset and weight read once per XR
// outputs. Each thread stages at most 2 cells of every plane, their
// wrapped in-plane offsets computed once. While run r is summed, run r+1's
// XR new planes are already in flight into registers; after a barrier the
// window's last 2 rx planes move to its front and the new planes land
// behind them. So device memory is read once per block (plus 2 rx planes
// per march and the tile's y/z halo, mostly from L2, since neighbouring
// tiles march together), and the loads overlap the sums, which the first
// version of this kernel (one window of 16 planes per block, loaded and
// then summed) did not.
//
// Route "direct": one thread per (y, z) column, each point read from L2,
// for offsets whose halo outgrows the window (more than 2 cells a thread,
// or a window past MAX_SMEM).
//
// Offsets arrive reduced to (-dim/2, dim/2] and travel, with the fp32
// weights, by value in the kernel's parameters (at most MAX_POINTS): a
// launch copies nothing to the device. Neither of the TPU kernel's
// restrictions applies here; the wrapper keeps them so the accepted inputs
// are the reference kernel's. Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_POINTS = 64;
constexpr int THREADS = 256;
constexpr int XR = 16;      // x outputs a thread sums at a time (a run)
constexpr int CPT = 2;      // cells of a plane a thread stages, at most
constexpr int PITCH = CPT * THREADS;  // floats a window plane holds
constexpr int MAX_SMEM = 100 * 1024;  // the window's shared memory, at most

struct Params {
  const void* grid;
  void* out;
  int X, Y, Z, P;
  int rx, ry, rz;  // halo per axis: max |offset|
  int TY, TZ;      // march: the (y, z) tile
  int runs;        // march: runs of XR planes a block marches
  int dx[MAX_POINTS], dy[MAX_POINTS], dz[MAX_POINTS];  // in (-dim/2, dim/2]
  int off[MAX_POINTS];  // march: the point's offset in the window from (x, y, z)
  float w[MAX_POINTS];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ int wrap(int v, int n) {  // v in (-n, 2n)
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

__device__ __forceinline__ int wrap_any(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) stencil_march_kernel(const __grid_constant__ Params p) {
  extern __shared__ float window[];  // [XR + 2 rx][PITCH]

  const int TY = p.TY, TZ = p.TZ, threads = TY * TZ;
  const int SZ = TZ + 2 * p.rz;
  const int cells = (TY + 2 * p.ry) * SZ;
  const int halo = 2 * p.rx, planes = XR + halo;
  const int ntz = (p.Z + TZ - 1) / TZ, tiles = ((p.Y + TY - 1) / TY) * ntz;
  const int tile = blockIdx.x % tiles, xs = blockIdx.x / tiles;
  const int y0 = (tile / ntz) * TY, z0 = (tile % ntz) * TZ;
  const int tz = threadIdx.x % TZ, ty = threadIdx.x / TZ;
  const int y = y0 + ty, z = z0 + tz;
  const long long plane = static_cast<long long>(p.Y) * p.Z;
  const int xa = xs * p.runs * XR;
  const int nr = min(p.runs, (p.X - xa + XR - 1) / XR);
  const T* grid = static_cast<const T*>(p.grid);

  // the cells this thread stages, and where each lies in a plane (wrapped)
  long long off[CPT];
  bool mine[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * threads;
    mine[c] = i < cells;
    const int gy = wrap_any(y0 - p.ry + i / SZ, p.Y), gz = wrap_any(z0 - p.rz + i % SZ, p.Z);
    off[c] = static_cast<long long>(gy) * p.Z + gz;
  }
  float* mycell = window + threadIdx.x;  // + c * threads: this thread's cells in a plane

  // run 0's window: planes xa - rx .. xa + XR + rx - 1, four at a time
  for (int i0 = 0; i0 < planes; i0 += 4) {
    float v[4][CPT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        v[u][c] = mine[c] && i0 + u < planes
                      ? to_f32(grid[wrap_any(xa - p.rx + i0 + u, p.X) * plane + off[c]]) : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (mine[c] && i0 + u < planes) mycell[(i0 + u) * PITCH + c * threads] = v[u][c];
  }
  // the next run's new planes, in flight while a run is summed
  T pre[XR][CPT];
  auto prefetch = [&](int r) {
    const int xn = wrap_any(xa + r * XR + p.rx, p.X);
#pragma unroll
    for (int j = 0; j < XR; ++j) {
      const int x = xn + j < p.X ? xn + j : (xn + j) % p.X;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (mine[c]) pre[j][c] = grid[x * plane + off[c]];
    }
  };
  if (nr > 1) prefetch(1);

  const bool writes = y < p.Y && z < p.Z;
  T* out = static_cast<T*>(p.out) + static_cast<long long>(y) * p.Z + z;
  const float* centre = window + (ty + p.ry) * SZ + tz + p.rz;  // (x = run start - rx, y, z)
  for (int r = 0; r < nr; ++r) {
    __syncthreads();  // run r's window is in place
    float acc[XR];
#pragma unroll
    for (int k = 0; k < XR; ++k) acc[k] = 0.f;
    for (int q = 0; q < p.P; ++q) {  // the points in order; each into the XR sums
      const float wq = p.w[q];
      const float* src = centre + p.off[q];
#pragma unroll
      for (int k = 0; k < XR; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wq, src[k * PITCH]));
    }
    if (writes) {
      const int x0 = xa + r * XR, nx = min(XR, p.X - x0);
#pragma unroll
      for (int k = 0; k < XR; ++k)
        if (k < nx) out[(x0 + k) * plane] = from_f32<T>(acc[k]);
    }
    if (r + 1 < nr) {
      __syncthreads();  // every read of this window is done
      for (int i = 0; i < halo; ++i)  // its last 2 rx planes become the next window's first
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (mine[c]) mycell[i * PITCH + c * threads] = mycell[(XR + i) * PITCH + c * threads];
#pragma unroll
      for (int j = 0; j < XR; ++j)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (mine[c]) mycell[(halo + j) * PITCH + c * threads] = to_f32(pre[j][c]);
      if (r + 2 < nr) prefetch(r + 2);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) stencil_direct_kernel(const __grid_constant__ Params p) {
  const long long plane = static_cast<long long>(p.Y) * p.Z;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= plane) return;
  const int y = static_cast<int>(i / p.Z), z = static_cast<int>(i % p.Z);
  const T* grid = static_cast<const T*>(p.grid);

  for (int x = blockIdx.y; x < p.X; x += gridDim.y) {
    float acc = 0.f;
#pragma unroll 4
    for (int q = 0; q < p.P; ++q) {
      const int xs = wrap(x + p.dx[q], p.X), ys = wrap(y + p.dy[q], p.Y), zs = wrap(z + p.dz[q], p.Z);
      const float v = to_f32(grid[xs * plane + static_cast<long long>(ys) * p.Z + zs]);
      acc = __fadd_rn(acc, __fmul_rn(p.w[q], v));
    }
    static_cast<T*>(p.out)[x * plane + i] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(Params& p, int route, int grid, cudaStream_t st) {
  if (route == 0) {
    const long long threads = static_cast<long long>(p.TY) * p.TZ;
    const long long cells = static_cast<long long>(p.TY + 2 * p.ry) * (p.TZ + 2 * p.rz);
    const long long tiles = static_cast<long long>((p.Y + p.TY - 1) / p.TY) * ((p.Z + p.TZ - 1) / p.TZ);
    const long long nruns = (p.X + XR - 1) / XR;
    const size_t smem = sizeof(float) * PITCH * (XR + 2 * p.rx);
    if (threads <= 0 || threads > THREADS || cells > CPT * threads || p.runs <= 0 ||
        grid != tiles * ((nruns + p.runs - 1) / p.runs) || smem > MAX_SMEM)
      return cudaErrorInvalidValue;
    const int SZ = p.TZ + 2 * p.rz;
    for (int q = 0; q < p.P; ++q) p.off[q] = (p.rx + p.dx[q]) * PITCH + p.dy[q] * SZ + p.dz[q];
    const int block = static_cast<int>(threads);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(stencil_march_kernel<T>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    stencil_march_kernel<T><<<grid, block, smem, st>>>(p);
    return cudaGetLastError();
  }
  const long long plane = static_cast<long long>(p.Y) * p.Z;
  if ((plane + THREADS - 1) / THREADS > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid_dim(static_cast<unsigned>((plane + THREADS - 1) / THREADS),
                      static_cast<unsigned>(p.X < 65535 ? p.X : 65535));  // x planes, strided
  stencil_direct_kernel<T><<<grid_dim, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

int abs_int(int v) { return v < 0 ? -v : v; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; grid and out (X, Y, Z) contiguous.
// dx/dy/dz (P,) offsets reduced to (-dim/2, dim/2] of their axis; w (P,)
// fp32 weights; P <= 64. The plan (hopper/stencil.py `plan`): route 0 =
// march (tile ty x tz, runs of XR planes a block, grid blocks), 1 = direct
// (the plan's other fields unread). Returns the launch's cudaError_t.
int repro_stencil(const void* grid, void* out, int dtype, int X, int Y, int Z, int P, const int* dx,
                  const int* dy, const int* dz, const float* w, int route, int ty, int tz, int runs,
                  int grid_blocks, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || P < 0 || P > MAX_POINTS) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (route != 0 && route != 1) return cudaErrorInvalidValue;
  Params p;
  p.grid = grid;
  p.out = out;
  p.X = X;
  p.Y = Y;
  p.Z = Z;
  p.P = P;
  p.rx = p.ry = p.rz = 0;
  for (int q = 0; q < P; ++q) {
    if (2 * dx[q] <= -X || 2 * dx[q] > X || 2 * dy[q] <= -Y || 2 * dy[q] > Y || 2 * dz[q] <= -Z ||
        2 * dz[q] > Z)
      return cudaErrorInvalidValue;
    p.dx[q] = dx[q];
    p.dy[q] = dy[q];
    p.dz[q] = dz[q];
    p.w[q] = w[q];
    p.rx = abs_int(dx[q]) > p.rx ? abs_int(dx[q]) : p.rx;
    p.ry = abs_int(dy[q]) > p.ry ? abs_int(dy[q]) : p.ry;
    p.rz = abs_int(dz[q]) > p.rz ? abs_int(dz[q]) : p.rz;
  }
  p.TY = ty;
  p.TZ = tz;
  p.runs = runs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, route, grid_blocks, st);
  return launch<__nv_bfloat16>(p, route, grid_blocks, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
