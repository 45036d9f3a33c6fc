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
// Design. The TPU kernel stages the previous, current and next x-blocks of
// bx planes in VMEM and applies each offset as a static slice plus a lane
// rotate, so |dx| <= bx and X % bx == 0. Here a block owns a (TY, TZ) tile
// of the (y, z) plane and a run of XR = 16 planes of x. It stages the run's
// planes plus rx on each side, its tile plus the y/z halo (ry, rz), in
// shared memory (each cell's place in a plane, wrapped periodically, is
// computed once), reading the grid once; then each thread walks the points
// in order and adds each into the XR sums of its (y, z) column, kept in
// registers: per point and output one shared-memory read, a multiply and an
// add, the point's offset and weight loaded once per XR outputs. Device
// memory is read about once (plus 2*rx/XR planes and the halo; a thread
// keeps LU = 8 loads in flight while staging), and a
// neighbour is never re-fetched from L2, which bounded the first, direct
// version of this kernel (one thread per point, P loads of the grid each;
// 5.2 ms for 27 points on 512^3, 16x its bound). Lanes run along z, or
// along y when Z < 32 (TZ = Z, TY = 256 / TZ), so the 2-D grids (Z = 1)
// keep all 32 lanes busy. Offsets arrive reduced to (-dim/2, dim/2] and
// travel, with the fp32 weights, by value in the kernel's parameters (at
// most MAX_POINTS): a launch copies nothing to the device. Where the slab
// would exceed 48 KB of shared memory (offsets of more than a few planes),
// the direct kernel runs instead.
// Neither of the TPU kernel's restrictions applies here; the wrapper keeps
// them so the accepted inputs are the reference kernel's.
//
// Bound on this card. The function reads the grid once and writes out
// once, and does 2 operations per point per output: bound by bytes (0.32 ms
// for a 512^3 fp32 grid at 3.35 TB/s).
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_POINTS = 64;
constexpr int THREADS = 256;
constexpr int XR = 16;                     // planes of x per block in the tiled kernel
constexpr int LU = 8;                      // planes a thread loads at once while staging
constexpr int MAX_SLAB_BYTES = 48 * 1024;  // shared memory of the tiled kernel

struct Params {
  const void* grid;
  void* out;
  int X, Y, Z, P;
  int rx, ry, rz;  // halo per axis: max |offset|
  int TY, TZ;      // the tiled kernel's (y, z) tile
  int dx[MAX_POINTS], dy[MAX_POINTS], dz[MAX_POINTS];  // in (-dim/2, dim/2]
  int off[MAX_POINTS];  // the tiled kernel: the point's offset in its slab
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
__global__ void __launch_bounds__(THREADS) stencil_tiled_kernel(const Params p) {
  // the cells' offsets in a plane, then the slab [XR + 2 rx][TY + 2 ry][TZ + 2 rz]
  extern __shared__ long long src_off[];

  const int TY = p.TY, TZ = p.TZ;
  const int SZ = TZ + 2 * p.rz;
  const int cells = (TY + 2 * p.ry) * SZ;
  const int ntz = (p.Z + TZ - 1) / TZ;
  const int y0 = (blockIdx.x / ntz) * TY, z0 = (blockIdx.x % ntz) * TZ;
  const int tz = threadIdx.x % TZ, ty = threadIdx.x / TZ;  // blockDim.x = TY * TZ
  const int y = y0 + ty, z = z0 + tz;
  const int xa = blockIdx.y * XR, nx = min(XR, p.X - xa);
  const long long plane = static_cast<long long>(p.Y) * p.Z;
  const T* grid = static_cast<const T*>(p.grid);
  float* slab = reinterpret_cast<float*>(src_off + cells);

  // where each cell of the tile plus halo lies in a plane (wrapped)
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int gy = wrap_any(y0 - p.ry + i / SZ, p.Y), gz = wrap_any(z0 - p.rz + i % SZ, p.Z);
    src_off[i] = static_cast<long long>(gy) * p.Z + gz;
  }
  __syncthreads();
  // planes xa - rx .. xa + nx + rx - 1 (wrapped), each read once, LU planes
  // of a cell in flight per thread
  const int np = nx + 2 * p.rx;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const T* src = grid + src_off[i];
    for (int j0 = 0; j0 < np; j0 += LU) {
      float v[LU];
#pragma unroll
      for (int u = 0; u < LU; ++u)
        v[u] = j0 + u < np ? to_f32(src[wrap(xa - p.rx + j0 + u, p.X) * plane]) : 0.f;
#pragma unroll
      for (int u = 0; u < LU; ++u)
        if (j0 + u < np) slab[(j0 + u) * cells + i] = v[u];
    }
  }
  __syncthreads();
  if (y >= p.Y || z >= p.Z) return;

  // point by point, in order, into the XR outputs of this (y, z)
  float acc[XR];
#pragma unroll
  for (int k = 0; k < XR; ++k) acc[k] = 0.f;
  const float* centre = slab + p.rx * cells + (ty + p.ry) * SZ + tz + p.rz;  // (xa, y, z)
  for (int q = 0; q < p.P; ++q) {
    const float wq = p.w[q];
    const float* src = centre + p.off[q];
#pragma unroll
    for (int k = 0; k < XR; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wq, src[k * cells]));
  }
  T* out = static_cast<T*>(p.out) + static_cast<long long>(y) * p.Z + z;
#pragma unroll
  for (int k = 0; k < XR; ++k)
    if (k < nx) out[(xa + k) * plane] = from_f32<T>(acc[k]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) stencil_direct_kernel(const Params p) {
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
cudaError_t launch(Params& p, cudaStream_t st) {
  const long long plane = static_cast<long long>(p.Y) * p.Z;
  p.TZ = p.Z < 32 ? p.Z : 32;
  p.TY = THREADS / p.TZ;
  const long long cells = static_cast<long long>(p.TY + 2 * p.ry) * (p.TZ + 2 * p.rz);
  const long long smem = 8 * cells + 4 * (XR + 2 * p.rx) * cells;  // cell offsets + slab
  if (smem <= MAX_SLAB_BYTES) {
    for (int q = 0; q < p.P; ++q)
      p.off[q] = static_cast<int>((p.dx[q] * (p.TY + 2 * p.ry) + p.dy[q]) * (p.TZ + 2 * p.rz) + p.dz[q]);
    const long long tiles = ((p.Y + p.TY - 1) / p.TY) * static_cast<long long>((p.Z + p.TZ - 1) / p.TZ);
    const long long runs = (p.X + XR - 1) / XR;
    if (tiles > 0x7fffffffLL || runs > 65535) return cudaErrorInvalidValue;
    const dim3 grid_dim(static_cast<unsigned>(tiles), static_cast<unsigned>(runs));
    stencil_tiled_kernel<T><<<grid_dim, p.TY * p.TZ, static_cast<size_t>(smem), st>>>(p);
  } else {
    if ((plane + THREADS - 1) / THREADS > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid_dim(static_cast<unsigned>((plane + THREADS - 1) / THREADS),
                        static_cast<unsigned>(p.X < 65535 ? p.X : 65535));  // x planes, strided
    stencil_direct_kernel<T><<<grid_dim, THREADS, 0, st>>>(p);
  }
  return cudaGetLastError();
}

int abs_int(int v) { return v < 0 ? -v : v; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; grid and out (X, Y, Z) contiguous.
// dx/dy/dz (P,) offsets reduced to (-dim/2, dim/2] of their axis; w (P,)
// fp32 weights; P <= 64. Returns the launch's cudaError_t.
int repro_stencil(const void* grid, void* out, int dtype, int X, int Y, int Z, int P,
                  const int* dx, const int* dy, const int* dz, const float* w, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || P < 0 || P > MAX_POINTS) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  return launch<__nv_bfloat16>(p, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
