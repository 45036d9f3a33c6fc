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
// The output is fp32 whatever the value type. The rescale happens inside
// the fp32 block compute, as the TPU kernel's dequantize-at-use does; the
// quantization itself runs before the kernel (core/precision.py), as it
// runs outside the Pallas body in the reference.
//
// Design, from flash_attention.cu. One block per (q tile, head, batch); a
// loop over KV tiles takes the place of the TPU grid's sequential nk axis,
// and its bounds skip the tiles every row of the q tile masks (the TPU
// kernel's pl.when skip). The (m, l, acc) state stays on chip.
//
//  - bf16, e4m3, e5m2: tensor cores through mma.sync m16n8k16 bf16 with
//    fp32 accumulation, 4 warps of 16 q rows each. Values are widened to
//    bf16 as they are staged into shared memory (fp8 through the card's
//    cvt.rn.f16x2.e4m3x2 / .e5m2x2; exact for every type taken), so the
//    MMA sums products of the narrow values exactly in fp32.
//    Each tile's k_s and v_s sit in shared memory beside it; a warp's q_s
//    stays in registers. v_s[j] is folded into P's column j before P is
//    split into two bf16 terms (hi + lo, two MMAs): P then keeps ~16
//    mantissa bits, where one bf16 rounding would cost ~1e-3 relative
//    (flash_attention.cu records the same for its bf16 kernel). Head dim 256
//    takes 32-key tiles (71 KB of shared memory), smaller head dims 64-key
//    tiles; the (16, D) fp32 accumulator of a warp lives in registers and
//    goes to the fp32 output from there, so the wider output costs no
//    shared memory.
//  - fp32 (the fp32 policy): fp32 FMA on the CUDA cores, values dequantized
//    as they are staged (q * q_s * scale, k * k_s, v * v_s), as the TPU
//    kernel dequantizes in its fp32 block compute.
//
// Bound on this card. At the ladder's card shape (B=1, H=K=16, S=2048,
// D=256, causal) the function does 4*H*D*S(S+1)/2 = 34.4 GFLOP and moves
// the values, scales and the fp32 output once (~75 MB for fp8). Over the
// compute type's peak (fp32 67, bf16 989, fp8 1979 TFLOP/s) and 3.35 TB/s
// the operations take longer for fp32 and bf16 and the bytes for fp8
// (chip_smoke.py prints the bound per policy). Tiles are staged through
// registers with synchronous loads and fp8 runs at the bf16 MMA rate, so
// the kernel stays well above that bound; TMA, wgmma and the fp8 MMA are
// the next steps.
//
// Tile sizes are compile-time constants of this file.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

enum ValueType { VT_F32 = 0, VT_BF16 = 1, VT_E4M3 = 2, VT_E5M2 = 3 };

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

// Eight consecutive values at `src` (element index) as eight bf16 values in
// one 16-byte word; bf16 rows move as one 16-byte load, fp8 rows as one
// 8-byte load whose bytes are widened exactly.
template <int VT>
__device__ __forceinline__ uint4 load8(const void* base, long long i) {
  if constexpr (VT == VT_BF16) {
    return *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + i);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(base) + i);
    return make_uint4(fp8x2_to_bf16x2<VT>(raw.x), fp8x2_to_bf16x2<VT>(raw.x >> 16),
                      fp8x2_to_bf16x2<VT>(raw.y), fp8x2_to_bf16x2<VT>(raw.y >> 16));
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp8 values: tensor cores (mma.sync m16n8k16 bf16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;
constexpr int MMA_THREADS = 128;

template <int D>
__host__ __device__ constexpr int mma_bk() { return D >= 256 ? 32 : 64; }

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
             (size_t(MMA_BQ) * (D + 8) + size_t(mma_bk<D>()) * (D + 8) + size_t(D) * (mma_bk<D>() + 8)) +
         sizeof(float) * 2 * mma_bk<D>();
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// (x0, x1) as two bf16 pairs, hi + lo: their sum keeps ~16 mantissa bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * g + t.
// A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..). B (16 x 8, k-major pairs): b0 (k 2t..2t+1, n g), b1
// (k 2t+8.., n g). C (16 x 8): c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..).
template <int D, int VT>
__global__ void __launch_bounds__(MMA_THREADS) fa_scaled_mma_kernel(const Params p) {
  constexpr int BK = mma_bk<D>();
  constexpr int QS = D + 8;   // padded row stride (elements) of the q and k tiles
  constexpr int VS = BK + 8;  // padded row stride of the transposed v tile
  constexpr int CH = D / 8;   // 8-value chunks per row
  constexpr int NT = BK / 8;  // score n-tiles per warp
  constexpr int OT = D / 8;   // output n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BQ, QS)
  __nv_bfloat16* sK = sQ + MMA_BQ * QS;                               // (BK, QS)
  __nv_bfloat16* sVt = sK + BK * QS;                                  // (D, VS): v transposed
  float* sKs = reinterpret_cast<float*>(sVt + D * VS);                // (BK,) k_s of the tile
  float* sVs = sKs + BK;                                              // (BK,) v_s of the tile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * MMA_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.G;
  const int row0 = warp * 16;  // this warp's first row in the q tile

  const long long qoff = b * p.qs[0] + h * p.qs[1];
  const long long koff = b * p.ks[0] + kh * p.ks[1];
  const long long voff = b * p.vs[0] + kh * p.vs[1];
  const float* Ks = p.ksc + b * p.kss[0] + kh * p.kss[1];
  const float* Vs = p.vsc + b * p.vss[0] + kh * p.vss[1];
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < MMA_BQ * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    *reinterpret_cast<uint4*>(sQ + r * QS + c) = s < p.Sq ? load8<VT>(p.q, qoff + s * p.qs[2] + c) : zero;
  }
  // q_s[i] * scale for the rows g and g + 8 of this warp
  float qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + row0 + g + 8 * i;
    qrow[i] = s < p.Sq ? p.qsc[b * p.qss[0] + h * p.qss[1] + s * p.qss[2]] * p.scale : 0.f;
  }

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {NEG, NEG};  // rows g and g + 8
  float l_r[2] = {0.f, 0.f};

  int t_begin, t_end;
  kv_tiles(p, q0, MMA_BQ, BK, &t_begin, &t_end);
  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * CH; i += MMA_THREADS) {  // K: coalesced rows
      const int r = i / CH, c = (i % CH) * 8, s = k0 + r;
      *reinterpret_cast<uint4*>(sK + r * QS + c) = s < p.Sk ? load8<VT>(p.k, koff + s * p.ks[2] + c) : zero;
    }
    for (int i = tid; i < BK * CH; i += MMA_THREADS) {  // V: lanes walk keys, so the
      const int r = i % BK, c = (i / BK) * 8, s = k0 + r;  // transposed stores spread
      const uint4 raw = s < p.Sk ? load8<VT>(p.v, voff + s * p.vs[2] + c) : zero;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * VS + r] = e[j];
    }
    for (int i = tid; i < BK; i += MMA_THREADS) {
      const int s = k0 + i;
      sKs[i] = s < p.Sk ? Ks[s * p.kss[2]] : 0.f;
      sVs[i] = s < p.Sk ? Vs[s * p.vss[2]] : 0.f;
    }
    __syncthreads();

    // raw scores q_i . k_j of the narrow values for this warp's 16 rows x BK keys
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const __nv_bfloat16* qa = sQ + (row0 + g) * QS + ks * 16 + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * QS), a2 = ld32(qa + 8), a3 = ld32(qa + 8 * QS + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = sK + (n * 8 + g) * QS + ks * 16 + 2 * t;
        mma_bf16(sc[n], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    // rescale, then online softmax over the rows g and g + 8 (a row spans
    // the 4 lanes of a quad)
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q_pos = p.q_offset + q0 + row0 + g + (e >= 2 ? 8 : 0);
        const int kc = n * 8 + 2 * t + (e & 1);
        sc[n][e] = visible(p, q_pos, k0 + kc) ? sc[n][e] * qrow[e >> 1] * sKs[kc] : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q_pos = p.q_offset + q0 + row0 + g + (e >= 2 ? 8 : 0);
        const int kc = n * 8 + 2 * t + (e & 1);
        // fully-masked rows: exp(NEG - NEG) == 1, so zero them by the mask
        const float pr = visible(p, q_pos, k0 + kc) ? expf(sc[n][e] - m_r[e >> 1]) : 0.f;
        sum[e >> 1] += pr;
        sc[n][e] = pr * sVs[kc];  // v_s folded into P's column
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_r[i] = l_r[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // o += (P diag(v_s)) V: the accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment, split into hi + lo bf16 terms so it keeps ~16 mantissa bits
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], h0, l0);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], h1, l1);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], h2, l2);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], h3, l3);
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const __nv_bfloat16* vb = sVt + (j * 8 + g) * VS + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(vb), b1 = ld32(vb + 8);
        mma_bf16(o[j], h0, h1, h2, h3, b0, b1);
        mma_bf16(o[j], l0, l1, l2, l3, b0, b1);
      }
    }
  }

  float* O = p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + row0 + g + 8 * i;
    if (s >= p.Sq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      *reinterpret_cast<float2*>(O + s * p.os[2] + j * 8 + 2 * t) = make_float2(o[j][2 * i] / l, o[j][2 * i + 1] / l);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + s] = m_r[i] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 values: CUDA-core FMA, dequantized as they are staged
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;        // query rows per block
constexpr int F32_BK = 32;        // keys per KV tile (one lane per key in the softmax pass)
constexpr int F32_THREADS = 256;  // a 16 x 16 grid of threads
constexpr int RPT = F32_BQ / 16;  // accumulator rows per thread

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (size_t(F32_BQ) * (D + 1) + size_t(F32_BK) * (D + 1) + size_t(F32_BK) * D +
                          size_t(F32_BQ) * (F32_BK + 1) + 3 * F32_BQ);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) fa_scaled_f32_kernel(const Params p) {
  constexpr int BQ = F32_BQ, BK = F32_BK;
  constexpr int DP = D + 1;    // padded row stride of the q and k tiles
  constexpr int CPT = D / 16;  // accumulator columns per thread
  constexpr int PS = BK + 1;   // padded row stride of the score tile

  extern __shared__ float smem[];
  float* sQ = smem;            // (BQ, DP)  q * q_s * scale
  float* sK = sQ + BQ * DP;    // (BK, DP)  k * k_s
  float* sV = sK + BK * DP;    // (BK, D)   v * v_s
  float* sP = sV + BK * D;     // (BQ, PS)  scores, then probabilities
  float* sM = sP + BQ * PS;    // (BQ,) running max
  float* sL = sM + BQ;         // (BQ,) running denominator
  float* sC = sL + BQ;         // (BQ,) this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.G;

  const float* Q = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* Kg = static_cast<const float*>(p.k) + b * p.ks[0] + kh * p.ks[1];
  const float* Vg = static_cast<const float*>(p.v) + b * p.vs[0] + kh * p.vs[1];
  const float* Qs = p.qsc + b * p.qss[0] + h * p.qss[1];
  const float* Ks = p.ksc + b * p.kss[0] + kh * p.kss[1];
  const float* Vs = p.vsc + b * p.vss[0] + kh * p.vss[1];

  for (int i = tid; i < BQ * D; i += F32_THREADS) {
    const int r = i / D, d = i % D, s = q0 + r;
    sQ[r * DP + d] = s < p.Sq ? Q[s * p.qs[2] + d] * Qs[s * p.qss[2]] * p.scale : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG;
    sL[tid] = 0.f;
  }

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int t_begin, t_end;
  kv_tiles(p, q0, BQ, BK, &t_begin, &t_end);
  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += F32_THREADS) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool in = s < p.Sk;
      sK[r * DP + d] = in ? Kg[s * p.ks[2] + d] * Ks[s * p.kss[2]] : 0.f;
      sV[r * D + d] = in ? Vg[s * p.vs[2] + d] * Vs[s * p.vss[2]] : 0.f;
    }
    __syncthreads();

    // scores: this thread's rows ty*RPT.., keys tx*2, tx*2+1
    float sc[RPT][2];
#pragma unroll
    for (int i = 0; i < RPT; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * DP + d];
      const float k0v = sK[(tx * 2) * DP + d];
      const float k1v = sK[(tx * 2 + 1) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        sc[i][0] = fmaf(qv[i], k0v, sc[i][0]);
        sc[i][1] = fmaf(qv[i], k1v, sc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      sP[(ty * RPT + i) * PS + tx * 2] = sc[i][0];
      sP[(ty * RPT + i) * PS + tx * 2 + 1] = sc[i][1];
    }
    __syncthreads();

    // online softmax: each warp takes BQ/8 rows, one lane per key
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const bool keep = visible(p, p.q_offset + q0 + r, k0 + lane);
      const float s = keep ? sP[r * PS + lane] : NEG;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      // fully-masked rows: exp(NEG - NEG) == 1, so zero them by the mask
      const float pr = keep ? expf(s - m_new) : 0.f;
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sP[r * PS + lane] = pr;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: this thread's rows ty*RPT.., columns tx + 16*j
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float c = sC[ty * RPT + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = sV[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // sL / sM final values are visible

  float* O = p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i, s = q0 + r;
    if (s >= p.Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) O[s * p.os[2] + tx + 16 * j] = acc[i][j] / l;
  }
  if (p.lse != nullptr && tid < BQ && q0 + tid < p.Sq) {
    p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + q0 + tid] = sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int B, int bq, int threads, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + bq - 1) / bq, p.H, B);
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int B, int vtype, cudaStream_t st) {
  switch (vtype) {
    case VT_F32: return launch(fa_scaled_f32_kernel<D>, p, B, F32_BQ, F32_THREADS, f32_smem_bytes<D>(), st);
    case VT_BF16:
      return launch(fa_scaled_mma_kernel<D, VT_BF16>, p, B, MMA_BQ, MMA_THREADS, mma_smem_bytes<D>(), st);
    case VT_E4M3:
      return launch(fa_scaled_mma_kernel<D, VT_E4M3>, p, B, MMA_BQ, MMA_THREADS, mma_smem_bytes<D>(), st);
    case VT_E5M2:
      return launch(fa_scaled_mma_kernel<D, VT_E5M2>, p, B, MMA_BQ, MMA_THREADS, mma_smem_bytes<D>(), st);
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
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
    p.qss[i] = strides[12 + i];
    p.kss[i] = strides[15 + i];
    p.vss[i] = strides[18 + i];
  }
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
