// One forward ring hop for Hopper (sm_90a): the sender's block pushed into
// the receiver's landing buffer. CUDA C++ with a plain C interface (loaded
// with ctypes by repro_torch/hopper/ring_hop.py).
//
// Replaces: src/repro/core/streams.py `remote_ring_hop` (its pallas_call
// programs `make_async_remote_copy` to push the local buffer to rank
// (me + 1) % n and waits on the DMA send/recv semaphores; semantically
// `ppermute(x, axis, ring_fwd)`).
//
// What it computes. dst[i] = src[i] for every byte i < nbytes. The block
// is taken as bytes, so any dtype moves. The kernel runs on the sender's
// stream; dst is the receiver's buffer: on the same card a device-to-
// device write, on another card a store through the peer mapping (after
// `repro_ring_hop_enable_peer`). The DMA semaphores of the TPU kernel are
// two CUDA events the wrapper's caller records and waits on in program
// order (parallel/collectives.py): "landing buffer free" before the push,
// "landed" after it.
//
// Design. A grid-stride loop of 16-byte (uint4) loads and stores, four in
// flight per thread, over the part of the buffer where src and dst are
// both 16-byte aligned; the bytes before it (when both start off 16 bytes
// by the same amount) and after it go one at a time. When src and dst are
// misaligned with respect to each other the whole block goes byte by byte.
//
// Bound on this card. The hop reads nbytes and writes nbytes: on one H100
// 2 * nbytes / 3.35 TB/s; across cards nbytes / 450 GB/s each way over
// NVLink. Below a few MB the launch latency (a few microseconds) is larger
// than either: the latency-to-bandwidth curve of the paper's Fig. 13b.
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks of 256 per SM of an H100

__global__ void __launch_bounds__(kThreads)
ring_hop_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                long long head, long long n16, long long nbytes) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4* __restrict__ s16 = reinterpret_cast<const uint4*>(src + head);
  uint4* __restrict__ d16 = reinterpret_cast<uint4*>(dst + head);
  long long i = tid;
  // kUnroll independent 16-byte loads in flight before their stores
  for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = s16[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d16[i + u * stride] = r[u];
  }
  for (; i < n16; i += stride) d16[i] = s16[i];
  // bytes before the aligned body, and after it
  for (long long j = tid; j < head; j += stride) dst[j] = src[j];
  for (long long j = head + n16 * 16 + tid; j < nbytes; j += stride) dst[j] = src[j];
}

}  // namespace

extern "C" {

// Push nbytes from src (on the sender's card) into dst (the receiver's
// buffer) on `stream`. Returns cudaGetLastError() after the launch.
int repro_ring_hop(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes <= 0) return 0;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  long long head = 0, n16 = 0;
  if (s % 16 == d % 16) {
    head = (long long)((16 - s % 16) % 16);
    if (head > nbytes) head = nbytes;
    n16 = (nbytes - head) / 16;
  }
  const long long work = n16 > 0 ? n16 : nbytes;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ring_hop_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), head, n16, nbytes);
  return static_cast<int>(cudaGetLastError());
}

// Let kernels on `src_device` store into `dst_device`'s memory. Returns 0
// when peer access is enabled (or already was), cudaErrorPeerAccessUnsupported
// when the pair cannot reach each other, else the CUDA error. The caller's
// current device is restored.
int repro_ring_hop_enable_peer(int src_device, int dst_device) {
  if (src_device == dst_device) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, src_device, dst_device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(src_device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(dst_device, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it leaves behind
    err = cudaSuccess;
  }
  cudaError_t restore = cudaSetDevice(prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(restore);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
