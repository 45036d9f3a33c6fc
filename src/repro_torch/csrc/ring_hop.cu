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
// Design. Two kernels, chosen per call by the wrapper's planner
// (hopper/ring_hop.py `hop_plan`):
//  - words (small blocks, and every push to another card): a grid sized to
//    the block (one 256-thread CTA for each 256 16-byte words, at most 2
//    CTAs an SM), each thread moving its words in passes of up to kUnroll:
//    a pass's loads are all issued (predicated at the end of the block)
//    before its stores, so a block below the cap is one round trip to
//    memory spread over as many SMs as it can use. Loads take the
//    read-only path without L1 allocation; stores are plain, so the block
//    lands in L2 for the receiver's next kernel.
//  - bulk (large blocks on one card): one thread a CTA moves the CTA's
//    chunks (16 KB each, every grid-th chunk of the block) by TMA bulk
//    copies, global -> shared completed on an mbarrier, then shared ->
//    global, four chunks in flight; no thread spends registers or issue
//    slots on the bytes. At 4 and 64 MiB it matched copy_ cold where the
//    words kernel stayed 3-7% short.
// Both move the part of the buffer where src and dst are both 16-byte
// aligned; the bytes before it (when both start off 16 bytes by the same
// amount) and after it go one at a time. When src and dst are misaligned
// with respect to each other the whole block goes byte by byte, kUnroll
// bytes a pass, in a third kernel (kept apart so that the words kernel's
// code stays small: its launches follow other kernels, with a cold
// instruction cache).
//
// Bound on this card. The hop reads nbytes and writes nbytes: on one H100
// 2 * nbytes / 3.35 TB/s; across cards nbytes / 450 GB/s each way over
// NVLink. Below a few MB the launch latency (a few microseconds) is larger
// than either: the latency-to-bandwidth curve of the paper's Fig. 13b.
// Across cards the stores are plain generic stores through the peer
// mapping (the NVLink path is not verified on a run with two cards yet).
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = 16 << 10;  // bulk: bytes a stage
constexpr int kStages = 4;        // bulk: chunks in flight a CTA

__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 x;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "l"(p));
  return x;
}
__device__ __forceinline__ uint8_t load_nc(const uint8_t* p) { return *p; }

// Move n items of T from s to d: item i by thread i % threads, in passes
// of kUnroll items a thread, loads before stores.
template <typename T>
__device__ __forceinline__ void copy_items(const T* __restrict__ s, T* __restrict__ d, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += kUnroll * stride) {
    T r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < n) r[u] = load_nc(s + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < n) d[i + u * stride] = r[u];
  }
}

// The bytes before the aligned body (head of them) and after it, by the
// first `threads` threads of CTA 0.
__device__ __forceinline__ void copy_edges(const uint8_t* src, uint8_t* dst, long long head, long long body_end,
                                           long long nbytes, int threads) {
  if (blockIdx.x != 0) return;
  for (long long j = threadIdx.x; j < head; j += threads) dst[j] = src[j];
  for (long long j = body_end + threadIdx.x; j < nbytes; j += threads) dst[j] = src[j];
}

__global__ void __launch_bounds__(kThreads)
hop_words_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 long long head, long long n16, long long nbytes) {
  copy_items(reinterpret_cast<const uint4*>(src + head), reinterpret_cast<uint4*>(dst + head), n16);
  copy_edges(src, dst, head, head + n16 * 16, nbytes, blockDim.x);
}

// src and dst misaligned with respect to each other (or a block too short
// for a 16-byte word): byte by byte. A kernel of its own, so that the
// words kernel's code stays small (a cold instruction cache costs each
// launch after another kernel).
__global__ void __launch_bounds__(kThreads)
hop_bytes_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long nbytes) {
  copy_items(src, dst, nbytes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One warp a CTA: lane 0 drives the TMA bulk copies of the CTA's chunks
// (chunk c = blockIdx.x + i * gridDim.x of the 16-byte-aligned body),
// the other lanes move the edge bytes.
__global__ void __launch_bounds__(32)
hop_bulk_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                long long head, long long n16, long long nbytes) {
  extern __shared__ __align__(128) uint8_t buf[];  // kStages x kChunk
  __shared__ __align__(8) uint64_t full[kStages];
  copy_edges(src, dst, head, head + n16 * 16, nbytes, 32);
  if (threadIdx.x != 0) return;
  const uint8_t* s = src + head;
  uint8_t* d = dst + head;
  const long long body = n16 * 16;
  const long long chunks = (body + kChunk - 1) / kChunk;
  if ((long long)blockIdx.x >= chunks) return;
  const int mine = (int)((chunks - 1 - blockIdx.x) / gridDim.x + 1);
  for (int i = 0; i < kStages; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[i])));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto load = [&](int i) {
    const int st = i % kStages;
    const long long off = (blockIdx.x + (long long)i * gridDim.x) * kChunk;
    const int bytes = (int)(body - off < kChunk ? body - off : kChunk);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(&full[st])), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_u32(buf + st * kChunk)),
                 "l"(s + off), "r"(bytes), "r"(smem_u32(&full[st]))
                 : "memory");
  };
  for (int i = 0; i < kStages && i < mine; ++i) load(i);
  for (int i = 0; i < mine; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(&full[st])), "r"(parity)
          : "memory");
    const long long off = (blockIdx.x + (long long)i * gridDim.x) * kChunk;
    const int bytes = (int)(body - off < kChunk ? body - off : kChunk);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(d + off),
                 "r"(smem_u32(buf + st * kChunk)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (i + kStages < mine) {  // stage st is reused: its store must have read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      load(i + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

// Push nbytes from src (on the sender's card) into dst (the receiver's
// buffer) on `stream`, by the words kernel (bulk = 0) with `grid` CTAs of
// 256 threads or by the bulk kernel (bulk = 1) with `grid` CTAs of one
// warp (hopper/ring_hop.py `hop_plan`). A relatively misaligned pair goes
// byte by byte (a kernel of its own) whatever `bulk` says. Returns
// cudaGetLastError() after the launch.
int repro_ring_hop(const void* src, void* dst, long long nbytes, int bulk, int grid, void* stream) {
  if (nbytes <= 0) return 0;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  long long head = 0, n16 = 0;
  if (s % 16 == d % 16) {
    head = (long long)((16 - s % 16) % 16);
    if (head > nbytes) head = nbytes;
    n16 = (nbytes - head) / 16;
  }
  const uint8_t* sp = static_cast<const uint8_t*>(src);
  uint8_t* dp = static_cast<uint8_t*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n16 == 0) {
    hop_bytes_kernel<<<(unsigned)grid, kThreads, 0, st>>>(sp, dp, nbytes);
  } else if (bulk) {
    static std::atomic<unsigned long long> ready{0};  // the shared-memory attribute, once per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!(ready.load() & (1ULL << (dev & 63)))) {
      err = cudaFuncSetAttribute(hop_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStages * kChunk);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready.fetch_or(1ULL << (dev & 63));
    }
    hop_bulk_kernel<<<(unsigned)grid, 32, kStages * kChunk, st>>>(sp, dp, head, n16, nbytes);
  } else {
    hop_words_kernel<<<(unsigned)grid, kThreads, 0, st>>>(sp, dp, head, n16, nbytes);
  }
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
