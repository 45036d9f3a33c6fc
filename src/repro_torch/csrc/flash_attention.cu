// FlashAttention-2 forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by repro_torch/hopper/flash_attention.py).
//
// Replaces: src/repro/kernels/flash_attention.py `_fa_kernel` (plain form,
// as built by `flash_attention_program` and `flash_attention_pallas`).
//
// What it computes. q (B, H, Sq, D), k/v (B, K, Sk, D), GQA with kv head
// h / (H / K). Scores are q . k * scale in fp32 with scale = 1/sqrt(D) by
// default. Masks: k_pos < Sk; causal or a lookback window adds
// k_pos <= q_pos; a window adds k_pos > q_pos - window; q_pos includes
// q_offset. Online softmax in fp32 with NEG = -1e30; masked entries add
// exactly 0, so a fully-masked row gives o = 0 (l clamped at 1e-30).
// o has q's dtype; the optional lse (B, H, Sq) fp32 is m + log(max(l, 1e-30)).
//
// Design shared by both kernels. One block per (q tile, head, batch); a
// loop over KV tiles takes the place of the TPU grid's sequential nk axis,
// and its bounds skip the tiles that every row of the q tile masks (the TPU
// kernel's pl.when skip). The (m, l, acc) state the TPU kernel keeps in VMEM
// scratch stays on chip for the whole loop.
//
//  - bf16 (the serving path, the ring, hymba): one warpgroup per 64-row q
//    tile; S = Q K^T and O += P V both as wgmma with fp32 accumulators
//    (`fa_fwd_wgmma_kernel`, wrappers in wgmma.cuh); each warpgroup's Q
//    and a two-stage ring of 64-key K and V tiles in shared memory in the
//    swizzled layout wgmma reads (V in its natural layout, read MN-major:
//    no transpose), filled by 16-byte cp.async with the next tile's copies
//    in flight during the current tile's products; q tiles in reverse
//    order, so the causal mask's heaviest tiles start first. A CTA holds
//    one warpgroup while the grid of 64-row tiles fits in one wave (the
//    S = 512 prefill: the most SMs at work) and two, sharing each K/V
//    tile, once it does not (the ring's blocks, long prompts): each SM
//    scheduler then holds two warps, one's softmax hiding behind the
//    other's products, and a tile's loads serve twice the rows. At
//    D = 256 the shared memory is (1 or 2) x Q 32 KB + 2 x (K 32 KB +
//    V 32 KB) = 160 or 192 KB (one CTA an SM) and a thread holds 128 O
//    accumulators and 32 of S.
//  - fp32 (the REDUCED configs and tests): fp32 FMA on the CUDA cores, 256
//    threads, q tile and K/V tiles in shared memory as fp32, (64, D)
//    accumulator in registers: exact to fp32 rounding.
//
// Bound on this card. At the serving prefill shape (B=1, H=K=16, D=256,
// causal, bf16) the function moves 4*S*H*D*2 bytes and does 4*H*D*S(S+1)/2
// operations; over 3.35 TB/s and 989 TFLOP/s the bytes take the longer
// time at every S the engine buckets to (chip_smoke.py prints the bound as
// bound_ms), so the function is bound by bytes. P.V runs twice (hi + lo),
// and one warpgroup an SM waits on its own products and softmax in turn,
// so the tensor cores are far from busy; at S = 512 the grid is 8 x 16 =
// 128 CTAs, one wave, set by the 8 KV tiles of the last q tile.
//
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): in the
// first wgmma version the softmax was the largest share of the time (one
// warp a scheduler, so its dependent chains go unhidden), then the tile
// loads' address arithmetic; so the softmax's exp is one ex2.approx (e^x as
// 2^(x log2 e), relative error ~2^-22, far below the bf16 output's 2^-8),
// the mask is computed only for tiles that some row cannot wholly see, and
// a thread's chunks share one column and most of their swizzled offset.
//
// Tile sizes are compile-time constants of this file (the plain forms'
// bq/bk in repro_torch.hopper.dispatch do not apply here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // null when not requested
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, s); d is unit-stride
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

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA (wgmma) with fp32 accumulators
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 64;        // q rows of a warpgroup: its m64 tile
constexpr int WG_BK = 64;        // keys of a KV tile
constexpr int WG_THREADS = 128;  // a warpgroup

using wgmma::WgTile;

template <int D, int NWG>
constexpr size_t wg_smem_bytes() {  // Q of each warpgroup, two stages of K and V, 1024-byte alignment
  return size_t(NWG + 4) * WgTile<D>::BYTES + 1024;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

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
  if constexpr (STEP > 64) {  // more threads than the tile has chunks (D = 16, two warpgroups)
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

// e^x as one ex2.approx (relative error ~2^-22), for the softmax
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// (x0, x1) as two bf16 pairs, hi + lo: their sum keeps ~16 mantissa bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// One CTA of NWG warpgroups per (NWG 64-row q tiles, head, batch); q tiles
// in reverse order, so under a causal mask the tiles with the most KV tiles
// start first. Each warpgroup's Q and a ring of two K/V stages in shared
// memory, filled by all the CTA's threads with 16-byte cp.async
// (zero-filled past Sq / Sk): the next KV tile's copies are in flight
// while the current one is used. Per KV tile a warpgroup's rows see: S = Q K^T
// (D / 16 wgmma m64n64k16 from shared memory), the online softmax on S's
// accumulators (rows g and g + 8 of each warp's 16 span a lane quad), then
// O += P V as wgmma m64nDk16 with P in registers (S's accumulators are P's
// A fragments) and V read MN-major; P is split into hi + lo bf16 terms,
// two products for each 16 keys: rounding P to one bf16 flips output
// roundings often enough that a deep model amplifies them, while q, k and
// v are exact bf16 and their products exact in fp32.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * WG_THREADS) fa_fwd_wgmma_kernel(const Params p) {
  using L = WgTile<D>;
  constexpr int NT = NWG * WG_THREADS;
  constexpr int OD = D / 2;  // accumulator floats a thread of O (64 x D)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  // warpgroup w's Q at base + w * BYTES; stage i: K at base + (NWG + 2 i) *
  // BYTES, V right after it
  auto sK = [&](int i) { return base + (NWG + 2 * i) * L::BYTES; };
  auto sV = [&](int i) { return base + (NWG + 1 + 2 * i) * L::BYTES; };

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = (tid % WG_THREADS) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_cta = (gridDim.x - 1 - blockIdx.x) * NWG * WG_BQ;
  const int q0 = q_cta + wg * WG_BQ;  // this warpgroup's first row
  const uint32_t sQ = base + wg * L::BYTES;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.G;
  const int row0 = warp * 16 + g;  // this thread's rows of its warpgroup's tile: row0 and row0 + 8

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const __nv_bfloat16* Kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.ks[0] + kh * p.ks[1];
  const __nv_bfloat16* Vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.vs[0] + kh * p.vs[1];

  // the CTA walks the KV tiles some of its rows see; a warpgroup computes
  // on those its own rows see
  int t_begin, t_end, my_begin, my_end;
  kv_tiles(p, q_cta, NWG * WG_BQ, WG_BK, &t_begin, &t_end);
  kv_tiles(p, q0, WG_BQ, WG_BK, &my_begin, &my_end);
  if (q0 >= p.Sq) my_end = my_begin;
#pragma unroll
  for (int w = 0; w < NWG; ++w) load_tile<D, NT>(base + w * L::BYTES, Q, p.qs[2], q_cta + w * WG_BQ, p.Sq);
  if (t_begin < t_end) {
    load_tile<D, NT>(sK(0), Kg, p.ks[2], t_begin * WG_BK, p.Sk);
    load_tile<D, NT>(sV(0), Vg, p.vs[2], t_begin * WG_BK, p.Sk);
  }
  cp_async_commit();

  float o[OD];
#pragma unroll
  for (int j = 0; j < OD; ++j) o[j] = 0.f;
  float m_r[2] = {NEG, NEG};
  float l_r[2] = {0.f, 0.f};

  for (int kt = t_begin, it = 0; kt < t_end; ++kt, ++it) {
    const int st = it & 1;
    if (kt + 1 < t_end) {  // stage st ^ 1 was released by the barrier ending the last step
      load_tile<D, NT>(sK(st ^ 1), Kg, p.ks[2], (kt + 1) * WG_BK, p.Sk);
      load_tile<D, NT>(sV(st ^ 1), Vg, p.vs[2], (kt + 1) * WG_BK, p.Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and this step's K, V have landed
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
    wgmma::wait<0>();
    wgmma::fence_operands(sc);

    // online softmax over the rows row0 and row0 + 8 (a row spans the 4
    // lanes of a quad); the mask is computed only where some key of the
    // tile is hidden from some row of the q tile
    const int k0 = kt * WG_BK;
    const int q_first = p.q_offset + q0;
    const bool whole = k0 + WG_BK <= p.Sk && (!p.bounded || k0 + WG_BK - 1 <= q_first) &&
                       (p.window <= 0 || k0 > q_first + WG_BQ - 1 - p.window);
    unsigned vis = 0xffffffffu;  // bit j: accumulator j is visible
    if (!whole) {
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
      sc[j] = ((vis >> j) & 1) ? sc[j] * p.scale : NEG;
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
      sc[j] = ((vis >> j) & 1) ? fast_exp(sc[j] - m_r[(j >> 1) & 1]) : 0.f;
      sum[(j >> 1) & 1] += sc[j];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_r[i] = l_r[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < OD; ++j) o[j] *= corr[(j >> 1) & 1];

    // O += P V, keys 16 kk .. 16 kk + 15: S's accumulators 8 kk .. 8 kk + 7
    // are P's A fragment, split into hi + lo; every fragment is formed
    // before the products are issued, so they queue back to back
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

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + row0 + 8 * i;
    if (s >= p.Sq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(O + s * p.os[2] + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / l, o[4 * j + 2 * i + 1] / l);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + s] = m_r[i] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA
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
__global__ void __launch_bounds__(F32_THREADS) fa_fwd_f32_kernel(const Params p) {
  constexpr int BQ = F32_BQ, BK = F32_BK;
  constexpr int DP = D + 1;    // padded row stride of the q and k tiles
  constexpr int CPT = D / 16;  // accumulator columns per thread
  constexpr int PS = BK + 1;   // padded row stride of the score tile

  extern __shared__ float smem[];
  float* sQ = smem;            // (BQ, DP)  q * scale
  float* sK = sQ + BQ * DP;    // (BK, DP)
  float* sV = sK + BK * DP;    // (BK, D)
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

  for (int i = tid; i < BQ * D; i += F32_THREADS) {
    const int r = i / D, d = i % D, s = q0 + r;
    sQ[r * DP + d] = s < p.Sq ? Q[s * p.qs[2] + d] * p.scale : 0.f;
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
      sK[r * DP + d] = in ? Kg[s * p.ks[2] + d] : 0.f;
      sV[r * D + d] = in ? Vg[s * p.vs[2] + d] : 0.f;
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

  float* O = static_cast<float*>(p.o) + b * p.os[0] + h * p.os[1];
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

template <int D, int NWG>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};  // devices whose attribute is set
  cudaError_t err = smem_attribute_once(fa_fwd_wgmma_kernel<D, NWG>, wg_smem_bytes<D, NWG>(), ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + NWG * WG_BQ - 1) / (NWG * WG_BQ), p.H, B);
  fa_fwd_wgmma_kernel<D, NWG><<<grid, NWG * WG_THREADS, wg_smem_bytes<D, NWG>(), st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int B, int dtype, int nwg, cudaStream_t st) {
  if (dtype == 1) {
    // nwg 0: one warpgroup a CTA while 64-row CTAs fit in one wave (the
    // S = 512 prefill: the most SMs at work); two, sharing each K/V tile,
    // once they do not (the ring's blocks, long prompts): each SM
    // scheduler then holds two warps, one's softmax hiding behind the
    // other's products, and a tile's loads serve twice the rows. 1 or 2
    // takes that many (a tuned plan, hopper/flash_attention.py).
    if (nwg == 0) {
      const long long ctas = static_cast<long long>((p.Sq + WG_BQ - 1) / WG_BQ) * p.H * B;
      nwg = ctas > sm_count() ? 2 : 1;
    }
    if (nwg == 2) return launch_wgmma<D, 2>(p, B, st);
    if (nwg == 1) return launch_wgmma<D, 1>(p, B, st);
    return cudaErrorInvalidValue;
  }
  if (nwg != 0) return cudaErrorInvalidValue;  // the fp32 kernel has no warpgroups
  static std::atomic<unsigned long long> ready_f32{0};
  cudaError_t err = smem_attribute_once(fa_fwd_f32_kernel<D>, f32_smem_bytes<D>(), ready_f32);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + F32_BQ - 1) / F32_BQ, p.H, B);
  fa_fwd_f32_kernel<D><<<grid, F32_THREADS, f32_smem_bytes<D>(), st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (bf16 pointers 16-byte aligned and
// (b, h, s) strides multiples of 8). strides: 12 element strides, (b, h, s)
// for q, k, v and o in that order. nwg: the bf16 kernel's warpgroups a
// CTA, 1 or 2, or 0 for the rule in launch_d (fp32: 0). Returns the
// launch's cudaError_t.
int repro_fa_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B, int H,
                 int K, int Sq, int Sk, int D, const long long* strides, float scale, int causal, int window,
                 int q_offset, int nwg, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk < 0) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
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
    case 16: return launch_d<16>(p, B, dtype, nwg, st);
    case 32: return launch_d<32>(p, B, dtype, nwg, st);
    case 64: return launch_d<64>(p, B, dtype, nwg, st);
    case 128: return launch_d<128>(p, B, dtype, nwg, st);
    case 256: return launch_d<256>(p, B, dtype, nwg, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
