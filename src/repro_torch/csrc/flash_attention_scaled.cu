// Scaled FlashAttention-2 forward for Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded with ctypes by repro_torch/hopper/flash_attention_scaled.py).
//
// Replaces: src/repro/kernels/flash_attention.py `_fa_kernel(scaled=True)`
// (as built by `flash_attention_program(scaled=True)` and
// `flash_attention_scaled_pallas`).
//
// What it computes. q (B, H, Sq, D), k/v (B, K, Sk, D) arrive quantized per
// row over D: values in one compute type (fp32, bf16, fp8 e4m3 or fp8 e5m2)
// and one fp32 scale per (b, h, s) row, q_s (B, H, Sq, 1), k_s/v_s
// (B, K, Sk, 1), each tensor with its own element strides. GQA reads kv head
// h / (H / K). The score of row i and key j is (q_i . k_j) * q_s[i] * scale
// * k_s[j] in fp32 (scale = 1/sqrt(D) by default); the online softmax, the
// masks (k_pos < Sk; causal or a lookback window adds k_pos <= q_pos; a
// window adds k_pos > q_pos - window; q_pos includes q_offset), NEG = -1e30,
// exact zeros for masked entries, l clamped at 1e-30 and the optional
// (B, H, Sq) fp32 lse = m + log(max(l, 1e-30)) are those of `_fa_kernel`.
// v_s[j] is folded into P's column j. The output is fp32 whatever the value
// type. The quantization itself runs before the kernel (core/precision.py),
// as it runs outside the Pallas body in the reference.
//
// Bound on this card. At the ladder's card shape (B=1, H=K=16, S=2048,
// D=256, causal) the function does 4*H*D*S(S+1)/2 = 34.4 GFLOP and moves
// the values, scales and the fp32 output once (~75 MB for fp8). Over the
// compute type's peak (fp32 67, bf16 989, fp8 1979 TFLOP/s) and 3.35 TB/s
// the operations take longer for fp32 and bf16 and the bytes for fp8
// (chip_smoke.py prints the bound per policy).
//
// Design. One block per (q tile, head, batch), q tiles in reverse order so
// that under a causal mask the tiles with the most KV tiles start first; a
// loop over KV tiles takes the place of the TPU grid's sequential nk axis,
// and its bounds skip the tiles every row of the q tile masks (the TPU
// kernel's pl.when skip). The (m, l, acc) state stays on chip.
//
//  - bf16, e4m3, e5m2: flash_attention.cu's wgmma pipeline. One
//    warpgroup per 64-row q tile, one or two a CTA (two, sharing each K/V
//    tile, once the 64-row grid exceeds a wave); S = Q K^T as wgmma
//    m64n64k16 from shared memory, O += P V as wgmma m64nDk16 with P in
//    registers and V read MN-major; K and V tiles of 64 keys in the
//    swizzled layout wgmma reads, the next tile's cp.async copies in flight
//    during the current tile's products; exp as one ex2.approx; the mask
//    computed only on tiles some row cannot wholly see. bf16 values land
//    in that layout directly. fp8 values land raw in a two-stage ring and
//    are widened exactly to bf16 (cvt.rn.f16x2.e4m3x2 / .e5m2x2, then
//    bf16: every e4m3 and e5m2 value is a bf16 value) into the swizzled
//    tiles before the products: the products of the narrow values are
//    exact in fp32. q_s[i] * scale and k_s[j] (staged per tile in shared
//    memory) scale S in registers after Q K^T; v_s[j] is folded into P's
//    column j before P is split into two bf16 terms (hi + lo, two
//    products): P then keeps ~16 mantissa bits, where one bf16 rounding
//    would cost ~1e-3 relative.
//  - fp32 (the fp32 policy): exact fp32 FFMA on the CUDA cores. 256
//    threads per 64-row q tile; Q, a 64-key K tile, a 64-key V tile and P
//    in shared memory (216 KB at D = 256), K and V filled by cp.async one
//    phase ahead (the next K lands during this tile's softmax and P V, the
//    next V during the next Q K^T). A thread holds a 4 x 4 block of S
//    (rows rg + 16 i, keys kg + 16 j: a row's 16 lanes share a half-warp,
//    so its max and sum are four shuffles) and the same 4 rows x D / 16
//    columns of O, so the softmax's rescale stays in registers. Per 4
//    depth steps a thread loads 4 float4 of Q and 4 of K for 64 FFMA; per
//    4 keys 4 float4 of P and D / 16 float4 of V for D FFMA. Rows of Q, K
//    and P are padded to 4 mod 32 floats, so a warp's float4 loads of
//    different rows fall on distinct banks.
//
// Tile sizes are compile-time constants of this file.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr float NEG = -1e30f;

enum ValueType { VT_F32 = 0, VT_BF16 = 1, VT_E4M3 = 2, VT_E5M2 = 3 };

using wgmma::WgTile;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* qsc;  // (B, H, Sq, 1)
  const float* ksc;  // (B, K, Sk, 1)
  const float* vsc;  // (B, K, Sk, 1)
  float* o;
  float* lse;  // null when not requested
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, s); d is unit-stride
  long long qss[3], kss[3], vss[3];  // element strides of the scales' (b, h, s)
  int H, G, Sq, Sk;
  float scale;
  int bounded;  // causal or window: k_pos <= q_pos
  int window;
  int q_offset;
  int vec;  // fp32: q, k, v rows start on 16 bytes (16-byte copies)
};

// The KV tiles of width bk that some row of the q tile [q0, q0 + bq) can
// see: keys past the last row's position (causal/window) and keys older
// than the first row's window are masked for every row.
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int bq, int bk, int* t_begin, int* t_end) {
  const int q_first = p.q_offset + q0;
  const int q_last = p.q_offset + min(q0 + bq, p.Sq) - 1;
  int k_end = p.Sk;
  if (p.bounded) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  *t_begin = k_begin / bk;
  *t_end = k_end > 0 ? (k_end + bk - 1) / bk : 0;
}

__device__ __forceinline__ bool visible(const Params& p, int q_pos, int k_pos) {
  bool keep = k_pos < p.Sk;
  if (p.bounded) keep = keep && k_pos <= q_pos;
  if (p.window > 0) keep = keep && k_pos > q_pos - p.window;
  return keep;
}

// No key of [k0, k0 + bk) is hidden from any row of [q_first, q_first + bq)
__device__ __forceinline__ bool whole_tile(const Params& p, int q_first, int bq, int k0, int bk) {
  return k0 + bk <= p.Sk && (!p.bounded || k0 + bk - 1 <= q_first) &&
         (p.window <= 0 || k0 > q_first + bq - 1 - p.window);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// two fp8 values (the low byte first) to two bf16 values in one word: the
// card's own cvt.rn.f16x2.e4m3x2 / .e5m2x2 (sm_89+) widens them to fp16,
// then to fp32 and bf16, every step exact for these types; NaN stays NaN
template <int VT>
__device__ __forceinline__ uint32_t fp8x2_to_bf16x2(uint32_t x) {
  uint32_t h;
  const uint16_t x16 = static_cast<uint16_t>(x & 0xFFFFu);
  if constexpr (VT == VT_E4M3) {
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h) : "h"(x16));
  } else {
    asm("cvt.rn.f16x2.e5m2x2 %0, %1;" : "=r"(h) : "h"(x16));
  }
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return bits(__floats2bfloat162_rn(f.x, f.y));
}

template <int VT>
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  return make_uint4(fp8x2_to_bf16x2<VT>(raw.x), fp8x2_to_bf16x2<VT>(raw.x >> 16), fp8x2_to_bf16x2<VT>(raw.y),
                    fp8x2_to_bf16x2<VT>(raw.y >> 16));
}

// e^x as one ex2.approx (relative error ~2^-22), for the softmax
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// (x0, x1) as two bf16 pairs, hi + lo: their sum keeps ~16 mantissa bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// ---------------------------------------------------------------------------
// bf16 / fp8 values: warpgroup MMA (wgmma) with fp32 accumulators
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 64;        // q rows of a warpgroup: its m64 tile
constexpr int WG_BK = 64;        // keys of a KV tile
constexpr int WG_THREADS = 128;  // a warpgroup

// Q of each warpgroup and four 64-row tiles: bf16, two stages of K and V;
// fp8, K and V widened and two raw stages of both (each half a tile); then
// k_s and v_s of two stages, and 1 KB to align the tiles
template <int D, int NWG>
constexpr size_t wg_smem_bytes() {
  return size_t(NWG + 4) * WgTile<D>::BYTES + 4 * 64 * sizeof(float) + 1024;
}

// Rows s0 .. s0 + 63 of a (S, D) bf16 matrix with row stride `ld` into a
// tile at shared address `tile`, by the CTA's NT threads; rows past S are
// zero-filled. Thread i copies the 16-byte chunk i % CH of rows i / CH,
// i / CH + NT / CH, ..., so its column, and with it most of the swizzled
// offset, is fixed.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, long long ld, int s0, int S) {
  using L = WgTile<D>;
  constexpr int CH = D / 8;      // 16-byte chunks a row
  constexpr int STEP = NT / CH;  // rows between a thread's chunks
  const int r0 = threadIdx.x / CH, d0 = (threadIdx.x % CH) * 8;
  const uint32_t base = tile + (d0 / L::CB) * 64 * L::Z;
  const uint32_t col = (d0 % L::CB) * 2;
  if constexpr (STEP > 64) {  // more threads than the tile has chunks
    if (r0 >= 64) return;
  }
  const __nv_bfloat16* g = src + static_cast<long long>(s0 + r0) * ld + d0;
#pragma unroll
  for (int j = 0; j < (STEP > 64 ? 1 : 64 / STEP); ++j) {
    const int r = r0 + STEP * j;
    const bool in = s0 + r < S;
    cp_async16(base + wgmma::swizzle(r * L::Z + col, L::Z), in ? g + static_cast<long long>(STEP * j) * ld : src,
               in);
  }
}

// Rows s0 .. s0 + 63 of a (S, D) fp8 matrix, raw and row-major (64 x D
// bytes at `raw`), in 8-byte chunks; rows past S are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void load_raw(uint32_t raw, const uint8_t* src, long long ld, int s0, int S) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const bool in = s0 + r < S;
    cp_async8(raw + r * D + d0, in ? src + static_cast<long long>(s0 + r) * ld + d0 : src, in);
  }
}

// A raw fp8 tile widened to bf16 into the swizzled tile layout
template <int D, int NT, int VT>
__device__ __forceinline__ void widen_tile(uint32_t tile, const uint8_t* raw) {
  using L = WgTile<D>;
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const uint4 w = widen8<VT>(*reinterpret_cast<const uint2*>(raw + r * D + d0));
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(tile + L::chunk(r, d0)), "r"(w.x), "r"(w.y),
                 "r"(w.z), "r"(w.w)
                 : "memory");
  }
}

// The scales of keys s0 .. s0 + 63 (zero past S), 4-byte copies
template <int NT>
__device__ __forceinline__ void load_scales(float* dst, const float* src, long long ld, int s0, int S) {
  if (threadIdx.x < 64) {
    const int s = s0 + threadIdx.x;
    cp_async4(smem_u32(dst + threadIdx.x), s < S ? src + s * ld : src, s < S);
  }
}

template <int D, int NWG, int VT>
__global__ void __launch_bounds__(NWG * WG_THREADS) fa_scaled_wgmma_kernel(const Params p) {
  using L = WgTile<D>;
  constexpr int NT = NWG * WG_THREADS;
  constexpr int OD = D / 2;  // accumulator floats a thread of O (64 x D)
  constexpr bool NARROW = VT != VT_BF16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw_base);  // the same bytes, generic address
  // warpgroup w's Q at base + w * BYTES. bf16: stage i's K at base + (NWG +
  // 2 i) * BYTES, V right after it. fp8: K and V (widened) at NWG and NWG +
  // 1, raw stage i's K at (NWG + 2) * BYTES + i * BYTES, V half a tile on.
  auto sK = [&](int i) { return base + (NARROW ? NWG : NWG + 2 * i) * L::BYTES; };
  auto sV = [&](int i) { return base + (NARROW ? NWG + 1 : NWG + 1 + 2 * i) * L::BYTES; };
  const uint32_t raw0 = (NWG + 2) * L::BYTES;  // offset of the raw ring from base
  float* const scales = reinterpret_cast<float*>(gbase + (NWG + 4) * L::BYTES);  // k_s[2][64], v_s[2][64]

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = (tid % WG_THREADS) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_cta = (gridDim.x - 1 - blockIdx.x) * NWG * WG_BQ;
  const int q0 = q_cta + wg * WG_BQ;  // this warpgroup's first row
  const uint32_t sQ = base + wg * L::BYTES;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.G;
  const int row0 = warp * 16 + g;  // this thread's rows of its warpgroup's tile: row0 and row0 + 8

  using VT_T = typename std::conditional<NARROW, uint8_t, __nv_bfloat16>::type;
  const VT_T* Q = static_cast<const VT_T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const VT_T* Kg = static_cast<const VT_T*>(p.k) + b * p.ks[0] + kh * p.ks[1];
  const VT_T* Vg = static_cast<const VT_T*>(p.v) + b * p.vs[0] + kh * p.vs[1];
  const float* Ks = p.ksc + b * p.kss[0] + kh * p.kss[1];
  const float* Vs = p.vsc + b * p.vss[0] + kh * p.vss[1];

  // the CTA walks the KV tiles some of its rows see; a warpgroup computes
  // on those its own rows see
  int t_begin, t_end, my_begin, my_end;
  kv_tiles(p, q_cta, NWG * WG_BQ, WG_BK, &t_begin, &t_end);
  kv_tiles(p, q0, WG_BQ, WG_BK, &my_begin, &my_end);
  if (q0 >= p.Sq) my_end = my_begin;

  auto load_kv = [&](int stage, int kt) {
    if constexpr (NARROW) {
      load_raw<D, NT>(base + raw0 + stage * L::BYTES, Kg, p.ks[2], kt * WG_BK, p.Sk);
      load_raw<D, NT>(base + raw0 + stage * L::BYTES + L::BYTES / 2, Vg, p.vs[2], kt * WG_BK, p.Sk);
    } else {
      load_tile<D, NT>(sK(stage), Kg, p.ks[2], kt * WG_BK, p.Sk);
      load_tile<D, NT>(sV(stage), Vg, p.vs[2], kt * WG_BK, p.Sk);
    }
    load_scales<NT>(scales + stage * 64, Ks, p.kss[2], kt * WG_BK, p.Sk);
    load_scales<NT>(scales + 128 + stage * 64, Vs, p.vss[2], kt * WG_BK, p.Sk);
  };

  if constexpr (NARROW) {  // Q widened once, straight from device memory
    constexpr int CH = D / 8;
    for (int c = tid; c < NWG * 64 * CH; c += NT) {
      const int w = c / (64 * CH), r = (c / CH) % 64, d0 = (c % CH) * 8;
      const int s = q_cta + w * WG_BQ + r;
      const uint2 raw = s < p.Sq ? *reinterpret_cast<const uint2*>(Q + static_cast<long long>(s) * p.qs[2] + d0)
                                 : make_uint2(0u, 0u);
      const uint4 x = widen8<VT>(raw);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(base + w * L::BYTES + L::chunk(r, d0)),
                   "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
                   : "memory");
    }
  } else {
#pragma unroll
    for (int w = 0; w < NWG; ++w) load_tile<D, NT>(base + w * L::BYTES, Q, p.qs[2], q_cta + w * WG_BQ, p.Sq);
  }
  if (t_begin < t_end) load_kv(0, t_begin);
  cp_async_commit();

  // q_s[i] * scale for the rows row0 and row0 + 8
  float qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + row0 + 8 * i;
    qrow[i] = s < p.Sq ? p.qsc[b * p.qss[0] + h * p.qss[1] + s * p.qss[2]] * p.scale : 0.f;
  }

  float o[OD];
#pragma unroll
  for (int j = 0; j < OD; ++j) o[j] = 0.f;
  float m_r[2] = {NEG, NEG};
  float l_r[2] = {0.f, 0.f};

  for (int kt = t_begin, it = 0; kt < t_end; ++kt, ++it) {
    const int st = it & 1;
    if (kt + 1 < t_end) load_kv(st ^ 1, kt + 1);  // the stage the last step released
    cp_async_commit();
    cp_async_wait<1>();  // this step's tiles and scales have landed
    if constexpr (NARROW) {
      __syncthreads();  // every thread's copies are in; the last step's products are done
      const unsigned char* raw = gbase + raw0 + st * L::BYTES;
      widen_tile<D, NT, VT>(sK(0), raw);
      widen_tile<D, NT, VT>(sV(0), raw + L::BYTES / 2);
    }
    wgmma::fence_proxy_async();
    __syncthreads();
    if constexpr (NWG > 1) {
      if (kt < my_begin || kt >= my_end) {  // no row of this warpgroup sees the tile
        __syncthreads();
        continue;
      }
    }

    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    wgmma::fence_operands(sc);
    wgmma::fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma::mma_ss_n64(sc, L::kmajor(sQ, ks), L::kmajor(sK(st), ks), 1);
    wgmma::commit();

    // this thread's 16 keys: column (j / 4) 8 + 2 t + (j & 1) of accumulator j
    const float* ksc = scales + st * 64;
    const float* vsc = scales + 128 + st * 64;
    float kscale[16], vscale[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      kscale[c] = ksc[(c / 2) * 8 + 2 * t + (c & 1)];
      vscale[c] = vsc[(c / 2) * 8 + 2 * t + (c & 1)];
    }
    wgmma::wait<0>();
    wgmma::fence_operands(sc);

    // online softmax over the rows row0 and row0 + 8 (a row spans the 4
    // lanes of a quad); the mask is computed only where some key of the
    // tile is hidden from some row of the q tile
    const int k0 = kt * WG_BK;
    const int q_first = p.q_offset + q0;
    unsigned vis = 0xffffffffu;  // bit j: accumulator j is visible
    if (!whole_tile(p, q_first, WG_BQ, k0, WG_BK)) {
      vis = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int q_pos = q_first + row0 + ((j & 2) ? 8 : 0);
        const int k_pos = k0 + (j / 4) * 8 + 2 * t + (j & 1);
        vis |= static_cast<unsigned>(visible(p, q_pos, k_pos)) << j;
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = (j / 4) * 2 + (j & 1);
      sc[j] = ((vis >> j) & 1) ? sc[j] * (qrow[(j >> 1) & 1] * kscale[c]) : NEG;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = fast_exp(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      // fully-masked rows: exp(NEG - NEG) == 1, so zero them by the mask
      const float pr = ((vis >> j) & 1) ? fast_exp(sc[j] - m_r[(j >> 1) & 1]) : 0.f;
      sum[(j >> 1) & 1] += pr;
      sc[j] = pr * vscale[(j / 4) * 2 + (j & 1)];  // v_s folded into P's column
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_r[i] = l_r[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < OD; ++j) o[j] *= corr[(j >> 1) & 1];

    // O += (P diag(v_s)) V, keys 16 kk .. 16 kk + 15: S's accumulators
    // 8 kk .. 8 kk + 7 are P's A fragment, split into hi + lo; every
    // fragment is formed before the products are issued
    uint32_t ph[16], pl[16];  // kk-th fragment at 4 kk .. 4 kk + 3
#pragma unroll
    for (int i = 0; i < 16; ++i) split_bf16(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);
    wgmma::fence_operands(ph);
    wgmma::fence_operands(pl);
    wgmma::fence_operands(o);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      const uint64_t vd = L::mnmajor(sV(st), kk);
      wgmma::RS<D>::mma(o, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], vd);
      wgmma::RS<D>::mma(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], vd);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(o);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

  float* O = p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + row0 + 8 * i;
    if (s >= p.Sq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(O + s * p.os[2] + j * 8 + 2 * t) =
          make_float2(o[4 * j + 2 * i] / l, o[4 * j + 2 * i + 1] / l);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + s] = m_r[i] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 values: CUDA-core FFMA
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;         // q rows a CTA
constexpr int F_BK = 64;         // keys a KV tile
constexpr int F_THREADS = 256;   // 16 row groups x 16 key (column) groups
constexpr int F_PS = F_BK + 4;   // P's row stride (floats)

template <int D>
struct FTile {
  static constexpr int QS = D + 4;   // Q's and K's row stride (floats)
  static constexpr int CT = D / 16;  // O columns a thread
  static constexpr int FLOATS = 2 * F_BQ * QS + F_BK * D + F_BQ * F_PS + 2 * F_BK;
  // column of a thread's c-th O value (cg: its column group, 0 .. 15):
  // float4s 64 columns apart where D >= 64, else CT adjacent columns
  static __device__ __forceinline__ int col(int cg, int c) {
    return CT >= 4 ? cg * 4 + 64 * (c / 4) + (c % 4) : cg * CT + c;
  }
};

template <int D>
constexpr size_t f32_smem_bytes() { return sizeof(float) * FTile<D>::FLOATS; }

// rows s0 .. s0 + 63 of a (S, D) fp32 matrix into shared rows of `ld_s`
// floats, zero-filled past S: 16-byte copies where the rows allow, else 4
template <int D>
__device__ __forceinline__ void f_load(float* dst, int ld_s, const float* src, long long ld, int s0, int S,
                                       bool vec) {
  if (vec) {
    for (int c = threadIdx.x; c < 64 * (D / 4); c += F_THREADS) {
      const int r = c / (D / 4), d = (c % (D / 4)) * 4;
      const bool in = s0 + r < S;
      cp_async16(smem_u32(dst + r * ld_s + d), in ? src + static_cast<long long>(s0 + r) * ld + d : src, in);
    }
  } else {
    for (int c = threadIdx.x; c < 64 * D; c += F_THREADS) {
      const int r = c / D, d = c % D;
      const bool in = s0 + r < S;
      cp_async4(smem_u32(dst + r * ld_s + d), in ? src + static_cast<long long>(s0 + r) * ld + d : src, in);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, 1) fa_scaled_ffma_kernel(const Params p) {
  using T = FTile<D>;
  constexpr int QS = T::QS, CT = T::CT;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                 // (64, QS)
  float* sK = sQ + F_BQ * QS;       // (64, QS)
  float* sV = sK + F_BK * QS;       // (64, D)
  float* sP = sV + F_BK * D;        // (64, F_PS): P diag(v_s)
  float* sKs = sP + F_BQ * F_PS;    // (64,) k_s of the tile
  float* sVs = sKs + F_BK;          // (64,) v_s of the tile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = warp * 2 + lane / 16;  // rows rg + 16 i of S and O
  const int kg = lane % 16;             // keys kg + 16 j of S; O's column group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.G;

  const float* Q = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* Kg = static_cast<const float*>(p.k) + b * p.ks[0] + kh * p.ks[1];
  const float* Vg = static_cast<const float*>(p.v) + b * p.vs[0] + kh * p.vs[1];
  const float* Ks = p.ksc + b * p.kss[0] + kh * p.kss[1];
  const float* Vs = p.vsc + b * p.vss[0] + kh * p.vss[1];
  const bool vec = p.vec != 0;

  auto load_k = [&](int kt) {  // K and both scales of tile kt: one group
    f_load<D>(sK, QS, Kg, p.ks[2], kt * F_BK, p.Sk, vec);
    if (tid < F_BK) {
      const int s = kt * F_BK + tid;
      cp_async4(smem_u32(sKs + tid), s < p.Sk ? Ks + s * p.kss[2] : Ks, s < p.Sk);
      cp_async4(smem_u32(sVs + tid), s < p.Sk ? Vs + s * p.vss[2] : Vs, s < p.Sk);
    }
  };

  int t_begin, t_end;
  kv_tiles(p, q0, F_BQ, F_BK, &t_begin, &t_end);
  // groups: [Q, K(t_begin)], [V(t_begin)], then two a tile: [K(kt + 1)], [V(kt + 1)]
  f_load<D>(sQ, QS, Q, p.qs[2], q0, p.Sq, vec);
  if (t_begin < t_end) load_k(t_begin);
  cp_async_commit();
  if (t_begin < t_end) f_load<D>(sV, D, Vg, p.vs[2], t_begin * F_BK, p.Sk, vec);
  cp_async_commit();

  float qrow[4];  // q_s * scale of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + rg + 16 * i;
    qrow[i] = s < p.Sq ? p.qsc[b * p.qss[0] + h * p.qss[1] + s * p.qss[2]] * p.scale : 0.f;
  }
  float o[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) o[i][c] = 0.f;
  float m_r[4], l_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = NEG;
    l_r[i] = 0.f;
  }

  for (int kt = t_begin; kt < t_end; ++kt) {
    cp_async_wait<1>();  // Q, K(kt) and its scales are in (V(kt) may not be)
    __syncthreads();

    // S = Q K^T: rows rg + 16 i, keys kg + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (rg + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(sK + (kg + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    float kscale[4], vscale[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kscale[j] = sKs[kg + 16 * j];
      vscale[j] = sVs[kg + 16 * j];
    }
    __syncthreads();  // K and the scales are read: the next tile's may land
    if (kt + 1 < t_end) load_k(kt + 1);
    cp_async_commit();

    // online softmax: a row's 64 keys lie in the 16 lanes of a half-warp
    const int k0 = kt * F_BK;
    const bool whole = whole_tile(p, p.q_offset + q0, F_BQ, k0, F_BK);
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = p.q_offset + q0 + rg + 16 * i;
      bool keep[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = whole || visible(p, q_pos, k0 + kg + 16 * j);
        s[i][j] = keep[j] ? s[i][j] * qrow[i] * kscale[j] : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      corr[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // fully-masked rows: exp(NEG - NEG) == 1, so zero them by the mask
        const float pr = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pr;
        sP[(rg + 16 * i) * F_PS + kg + 16 * j] = pr * vscale[j];  // v_s folded into P's column
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_r[i] = l_r[i] * corr[i] + sum;
    }
    cp_async_wait<1>();  // V(kt) is in (K(kt + 1) may not be)
    __syncthreads();     // and P is written

    // O = O corr + P V: rows rg + 16 i, columns FTile::col(kg, c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) o[i][c] *= corr[i];
#pragma unroll 2
    for (int j = 0; j < F_BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sP + (rg + 16 * i) * F_PS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = sV + (j + jj) * D;
        float vv[CT];
        if constexpr (CT >= 4) {
#pragma unroll
          for (int c = 0; c < CT; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + T::col(kg, c));
            vv[c] = x.x;
            vv[c + 1] = x.y;
            vv[c + 2] = x.z;
            vv[c + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CT; ++c) vv[c] = vrow[T::col(kg, c)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < CT; ++c) o[i][c] = fmaf(pij, vv[c], o[i][c]);
        }
      }
    }
    __syncthreads();  // V and P are read: the next V may land
    if (kt + 1 < t_end) f_load<D>(sV, D, Vg, p.vs[2], (kt + 1) * F_BK, p.Sk, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* O = p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + rg + 16 * i;
    if (s >= p.Sq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CT; ++c) O[s * p.os[2] + T::col(kg, c)] = o[i][c] / l;
    if (p.lse != nullptr && kg == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + s] = m_r[i] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The dynamic shared memory above 48 KB is allowed once per device and
// kernel, not on every launch (the call costs host time).
template <typename Kernel>
cudaError_t smem_attribute_once(Kernel kernel, size_t bytes, std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

// SMs of the current device, read once per device
int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = counts[dev & 63].load();
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    counts[dev & 63].store(n);
  return n;
}

template <int D, int NWG, int VT>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};  // devices whose attribute is set
  cudaError_t err = smem_attribute_once(fa_scaled_wgmma_kernel<D, NWG, VT>, wg_smem_bytes<D, NWG>(), ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + NWG * WG_BQ - 1) / (NWG * WG_BQ), p.H, B);
  fa_scaled_wgmma_kernel<D, NWG, VT><<<grid, NWG * WG_THREADS, wg_smem_bytes<D, NWG>(), st>>>(p);
  return cudaGetLastError();
}

template <int D, int VT>
cudaError_t launch_wgmma_grid(const Params& p, int B, cudaStream_t st) {
  // one warpgroup a CTA while 64-row CTAs fit in one wave; two, sharing
  // each K/V tile, once they do not (flash_attention.cu's rule)
  const long long ctas = static_cast<long long>((p.Sq + WG_BQ - 1) / WG_BQ) * p.H * B;
  if (ctas > sm_count()) return launch_wgmma<D, 2, VT>(p, B, st);
  return launch_wgmma<D, 1, VT>(p, B, st);
}

template <int D>
cudaError_t launch_d(const Params& p, int B, int vtype, cudaStream_t st) {
  switch (vtype) {
    case VT_F32: {
      static std::atomic<unsigned long long> ready{0};
      cudaError_t err = smem_attribute_once(fa_scaled_ffma_kernel<D>, f32_smem_bytes<D>(), ready);
      if (err != cudaSuccess) return err;
      const dim3 grid((p.Sq + F_BQ - 1) / F_BQ, p.H, B);
      fa_scaled_ffma_kernel<D><<<grid, F_THREADS, f32_smem_bytes<D>(), st>>>(p);
      return cudaGetLastError();
    }
    case VT_BF16: return launch_wgmma_grid<D, VT_BF16>(p, B, st);
    case VT_E4M3: return launch_wgmma_grid<D, VT_E4M3>(p, B, st);
    case VT_E5M2: return launch_wgmma_grid<D, VT_E5M2>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// vtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = float8_e5m2 (q, k
// and v values; bf16 pointers 16-byte and fp8 pointers 8-byte aligned, their
// (b, h, s) strides multiples of 8). strides: 21 element strides, (b, h, s)
// for q, k, v, o, q_s, k_s and v_s in that order. o is fp32. Returns the
// launch's cudaError_t.
int repro_fa_scaled_fwd(const void* q, const void* k, const void* v, const float* qsc, const float* ksc,
                        const float* vsc, float* o, float* lse, int vtype, int B, int H, int K, int Sq, int Sk,
                        int D, const long long* strides, float scale, int causal, int window, int q_offset,
                        void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk < 0) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.qsc = qsc;
  p.ksc = ksc;
  p.vsc = vsc;
  p.o = o;
  p.lse = lse;
  bool vec = true;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
    p.qss[i] = strides[12 + i];
    p.kss[i] = strides[15 + i];
    p.vss[i] = strides[18 + i];
    vec = vec && p.qs[i] % 4 == 0 && p.ks[i] % 4 == 0 && p.vs[i] % 4 == 0;
  }
  for (const void* x : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec = vec ? 1 : 0;
  p.H = H;
  p.G = H / K;
  p.Sq = Sq;
  p.Sk = Sk;
  p.scale = scale;
  p.bounded = (causal != 0 || window > 0) ? 1 : 0;
  p.window = window;
  p.q_offset = q_offset;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(p, B, vtype, st);
    case 32: return launch_d<32>(p, B, vtype, st);
    case 64: return launch_d<64>(p, B, vtype, st);
    case 128: return launch_d<128>(p, B, vtype, st);
    case 256: return launch_d<256>(p, B, vtype, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
