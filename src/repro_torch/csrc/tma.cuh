// Hopper's Tensor Memory Accelerator and shared-memory barriers for the
// kernels of this directory (sm_90a): mbarrier waits and arrives written in
// PTX, a 2D TMA load, and the host side that encodes a tensor map (looked
// up with cudaGetDriverEntryPoint: no link against libcuda).
//
// ptxas serialises every wgmma of a function when a branch it cannot prove
// warp-uniform sits among them, so the wait loop and the consumers' release
// are PTX's own (a labelled loop, a predicated arrive).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace tma {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` to complete. A wait that has not
// ended after 2^26 tries (seconds) traps: a fault in a ring's protocol then
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra.uni WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// arrive on the mbarrier at `bar` from lane 0 of the warp, by a predicated
// instruction rather than a branch
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}
// the box of `map` at coordinates (c0 inner, c1 outer) into shared memory at
// `dst`, its bytes counted on the mbarrier at `bar`; zeros past the edges
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// cuTensorMapEncodeTiled, looked up once
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      f = reinterpret_cast<EncodeTiled>(ptr);
      fn.store(f);
    }
  }
  return f;
}

// A 2D row-major (outer, inner) matrix with row stride `ld` elements, read
// in boxes of (box_outer, box_inner) with the 128-byte swizzle; zeros past
// its edges
inline bool tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esize, long long inner,
                       long long outer, long long ld, int box_inner, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
