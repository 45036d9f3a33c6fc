// Split-KV decode attention (the flash-decoding form of FlashAttention) for
// Hopper (sm_90a), CUDA C++ with a plain C interface (loaded with ctypes by
// repro_torch/hopper/decode_attention.py).
//
// Replaces no TPU kernel. The reference's decode attention is its XLA
// blocked form (src/repro/kernels/ops.py `decode_attention`, impl "xla"; it
// has no Pallas body), and the port ran that form's plain counterpart,
// hopper/blocked.py `decode_attention_blocked`, on the card: a gather of
// every table column into a contiguous copy, then a Python loop over the
// columns that widens each page to fp32 and runs two batched GEMVs and ~20
// small elementwise kernels. That loop set the serving engine's pace: ~430
// of a layer's ~452 launches, the null pages walked like live ones, and
// the card busy ~20x longer than the step's bytes take.
//
// What it computes, for q (B, H, D) and a cache of K = H / G kv heads:
//   - paged: pools (P, K, bs, D) addressed through block_table (B, NB);
//     logical row r of sequence b is row r % bs of page table[b, r / bs];
//   - contiguous: a cache (B, K, S, D), cut into blocks of bs rows (the
//     plain form's block partition), addressed as the identity table.
// Row r (absolute position pos_offset + r) is live for sequence b when
// r < S (NB * bs paged), pos_offset + r <= position[b] and, with a window,
// pos_offset + r > position[b] - window: the plain form's mask. Scores are
// fp32 with q scaled before the dot; where the pools are narrow with
// per-row fp32 scales (fp8, or the contiguous path under precision=), a
// row's score is the dot times its k scale and its value row is weighted
// by p times its v scale. Online softmax in fp32 with NEG = -1e30; masked
// rows are never read, which adds exactly the plain form's 0; l is clamped
// at 1e-30, so a sequence with no live row gives o = 0. o has q's dtype;
// the optional lse (B, H) fp32 is m + log(max(l, 1e-30)).
//
// Bound on this card. The function reads each live K and V row once and
// does ~2 G operations a byte, far below the H100's ~295 operations a byte
// in bf16, so it is bound by bytes. At the serving cell's shapes (B 64,
// K = H = 16, D 256, bs 128, bf16, ~577 live pages of 128 rows) a layer
// reads ~1.2 GB of live KV: ~0.36 ms at 3.35 TB/s.
//
// Design.
//  - Live pages only. A block (split s, kv head, sequence) finds the
//    sequence's live rows from position on the device and takes the
//    pages [first + s * pps, first + (s + 1) * pps) of them; a block past
//    the live pages exits at once. The grid (nsplit, K, B) comes from
//    shapes alone (hopper/decode_attention.py `plan`), so nothing waits on
//    the host, and the summation order depends on (B, K, bs, NB) and the
//    positions only: paged and contiguous calls at one partition give the
//    same bits.
//  - The pools as they are stored. Each page's live rows stream through
//    shared memory in chunks of 8 KB of K and 8 KB of V (T rows, never
//    across a page), two stages: every thread issues 16-byte cp.async
//    copies of the next chunk while the block computes on the current one.
//    No gathered or widened copy exists in device memory; values widen to
//    fp32 in registers.
//  - One block serves the G = H / K query heads of its kv head, so a page
//    is read once for all of them. Each of the 4 warps takes groups of up
//    to 4 rows of a chunk; a lane holds D / 32 elements of each of the G
//    q rows and of its fp32 accumulators, a row's score is a butterfly sum
//    over the warp, and the warp rescales its (m, l, acc) once a group.
//    At the end the 4 warps' states merge in warp order through shared
//    memory.
//  - Split-KV. 64 x 16 (sequence, kv head) pairs of ~9 live pages each do
//    not balance over 132 SMs, so a pair's pages split over blocks of pps
//    pages (~256 rows). With one split a block writes o itself; with more,
//    each writes an fp32 partial (acc, m, l) and a second kernel merges a
//    pair's live splits in split order.
//
// Kernel names start with flash_decode_: it is the split-KV decode form of
// FlashAttention. Offsets are 64-bit throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 8192;  // of K, and again of V, in one stage
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  void* o;      // (B, H, D) contiguous, q's dtype
  float* lse;   // (B, H) or null
  const void* k;
  const void* v;
  const float* ks;  // per-row scales or null
  const float* vs;
  const void* table;  // (B, NB) or null: contiguous
  const void* pos;    // (B,)
  float* part;        // nsplit > 1: (B, H, nsplit, D) partial sums
  float* part_ml;     //             (B, H, nsplit, 2) their m and l
  long long qs[2];    // q's (b, h) element strides; d is unit-stride
  long long kst[2], vst[2];    // (page | batch, head) element strides; rows are D apart
  long long kss[2], vss[2];    // the scales' (page | batch, head) strides; rows are 1 apart
  long long tstride;           // block_table's row stride
  int B, H, K, G, bs, S, window, pos_offset, pps, nsplit;
  int qdtype;  // 0 float32, 1 bfloat16, 2 float16 (q and o)
  int table64, pos64;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(s)), "l"(g) : "memory");
}
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(s)), "l"(g) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 32-bit word of stored values to fp32, exactly (every value of each
// type is a float).
template <typename KV>
struct Cvt;
template <>
struct Cvt<float> {
  static constexpr int kPerWord = 1;
  __device__ static void word(uint32_t w, float* x) { x[0] = __uint_as_float(w); }
};
template <>
struct Cvt<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static void word(uint32_t w, float* x) {
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <>
struct Cvt<__half> {
  static constexpr int kPerWord = 2;
  __device__ static void word(uint32_t w, float* x) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
    x[0] = f.x;
    x[1] = f.y;
  }
};
template <__nv_fp8_interpretation_t I>
__device__ __forceinline__ void fp8_pair(uint32_t w16, float* x) {
  __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w16 & 0xffffu), I);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&r));
  x[0] = f.x;
  x[1] = f.y;
}
template <>
struct Cvt<__nv_fp8_e4m3> {
  static constexpr int kPerWord = 4;
  __device__ static void pair(uint32_t w, float* x) { fp8_pair<__NV_E4M3>(w, x); }
  __device__ static void word(uint32_t w, float* x) {
    pair(w, x);
    pair(w >> 16, x + 2);
  }
};
template <>
struct Cvt<__nv_fp8_e5m2> {
  static constexpr int kPerWord = 4;
  __device__ static void pair(uint32_t w, float* x) { fp8_pair<__NV_E5M2>(w, x); }
  __device__ static void word(uint32_t w, float* x) {
    pair(w, x);
    pair(w >> 16, x + 2);
  }
};

// E consecutive stored values from shared memory, widened to fp32.
template <typename KV, int E>
__device__ __forceinline__ void load_row(const unsigned char* src, float (&x)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(KV));
  constexpr int kPer = Cvt<KV>::kPerWord;
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[c];
      Cvt<KV>::word(u.x, x + c * 4 * kPer);
      Cvt<KV>::word(u.y, x + c * 4 * kPer + kPer);
      Cvt<KV>::word(u.z, x + c * 4 * kPer + 2 * kPer);
      Cvt<KV>::word(u.w, x + c * 4 * kPer + 3 * kPer);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    Cvt<KV>::word(u.x, x);
    Cvt<KV>::word(u.y, x + kPer);
  } else if constexpr (kBytes == 4) {
    Cvt<KV>::word(*reinterpret_cast<const uint32_t*>(src), x);
  } else {
    static_assert(kBytes == 2 && kPer == 4, "two bytes a lane: fp8 at D = 64");
    Cvt<KV>::pair(*reinterpret_cast<const uint16_t*>(src), x);
  }
}

__device__ __forceinline__ float load_q(const Params& p, long long off) {
  if (p.qdtype == 1) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.q)[off]);
  if (p.qdtype == 2) return __half2float(reinterpret_cast<const __half*>(p.q)[off]);
  return reinterpret_cast<const float*>(p.q)[off];
}

__device__ __forceinline__ void store_o(const Params& p, long long off, float x) {
  if (p.qdtype == 1)
    reinterpret_cast<__nv_bfloat16*>(p.o)[off] = __float2bfloat16(x);
  else if (p.qdtype == 2)
    reinterpret_cast<__half*>(p.o)[off] = __float2half(x);
  else
    reinterpret_cast<float*>(p.o)[off] = x;
}

// Sequence b's live rows [lo, hi) of its logical cache, the pages that
// hold them, and the splits that take them (at least one, which writes a
// sequence with no live row as m = NEG, l = 0).
struct Live {
  long long lo, hi;
  int first, npages, nact;
};

__device__ __forceinline__ Live live_range(const Params& p, int b) {
  const long long pos =
      p.pos64 ? reinterpret_cast<const long long*>(p.pos)[b] : reinterpret_cast<const int*>(p.pos)[b];
  Live L;
  L.hi = min(pos - p.pos_offset + 1, static_cast<long long>(p.S));
  L.lo = p.window > 0 ? max(0LL, pos - p.window + 1 - p.pos_offset) : 0LL;
  if (L.hi > L.lo) {
    L.first = static_cast<int>(L.lo / p.bs);
    L.npages = static_cast<int>((L.hi - 1) / p.bs) - L.first + 1;
  } else {
    L.first = 0;
    L.npages = 0;
  }
  L.nact = L.npages > 0 ? (L.npages + p.pps - 1) / p.pps : 1;
  return L;
}

template <typename KV, int D, int MAXG>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(const Params p) {
  constexpr int E = D / 32;                               // elements a lane, per row
  constexpr int ES = static_cast<int>(sizeof(KV));
  constexpr int T = kStageBytes / (D * ES);               // rows a chunk
  constexpr int RG = MAXG >= 8 ? 2 : (T / kWarps < 4 ? T / kWarps : 4);  // rows a warp group
  static_assert(T >= kWarps && RG >= 1, "a chunk gives every warp a row");
  extern __shared__ __align__(16) unsigned char smem[];
  float* sscale = reinterpret_cast<float*>(smem + 4 * kStageBytes);  // [stage][k | v][T]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Live L = live_range(p, b);
  if (split >= L.nact) return;

  long long r0 = 0, r1 = 0;  // this block's live rows
  if (L.npages > 0) {
    const int pg0 = L.first + split * p.pps;
    const int pg1 = min(L.first + L.npages, pg0 + p.pps);
    r0 = max(L.lo, static_cast<long long>(pg0) * p.bs);
    r1 = min(L.hi, static_cast<long long>(pg1) * p.bs);
  }

  float q[MAXG][E], acc[MAXG][E], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const long long qoff = b * p.qs[0] + static_cast<long long>(kh * p.G + g) * p.qs[1] + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      q[g][e] = g < p.G ? load_q(p, qoff + e) * p.scale : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = NEG;
    l[g] = 0.f;
  }

  // Chunks: each page's rows in runs of T from the page's start, clipped
  // to [r0, r1); chunk c is run c % cpp of page c / cpp.
  const int cpp = (p.bs + T - 1) / T;
  long long c_begin = 0, c_end = 0;
  if (r1 > r0) {
    c_begin = (r0 / p.bs) * cpp + (r0 % p.bs) / T;
    c_end = ((r1 - 1) / p.bs) * cpp + ((r1 - 1) % p.bs) / T + 1;
  }
  const bool scaled = p.ks != nullptr;

  auto chunk_rows = [&](long long c, long long& lo, int& n) {
    const long long pg = c / cpp, j = c % cpp;
    const long long start = pg * p.bs + j * T;
    lo = max(r0, start);
    n = static_cast<int>(min(r1, pg * p.bs + min(static_cast<long long>(p.bs), (j + 1) * T)) - lo);
  };
  auto issue = [&](long long c, int st) {
    long long lo;
    int n;
    chunk_rows(c, lo, n);
    const long long pg = c / cpp;
    long long kb, vb, ksb, vsb;  // element offsets of the chunk's first row
    if (p.table != nullptr) {
      const long long at = b * p.tstride + pg;
      const long long page = p.table64 ? reinterpret_cast<const long long*>(p.table)[at]
                                       : reinterpret_cast<const int*>(p.table)[at];
      const long long row = lo - pg * p.bs;
      kb = page * p.kst[0] + kh * p.kst[1] + row * D;
      vb = page * p.vst[0] + kh * p.vst[1] + row * D;
      ksb = page * p.kss[0] + kh * p.kss[1] + row;
      vsb = page * p.vss[0] + kh * p.vss[1] + row;
    } else {
      kb = b * p.kst[0] + kh * p.kst[1] + lo * D;
      vb = b * p.vst[0] + kh * p.vst[1] + lo * D;
      ksb = b * p.kss[0] + kh * p.kss[1] + lo;
      vsb = b * p.vss[0] + kh * p.vss[1] + lo;
    }
    const unsigned char* gk = reinterpret_cast<const unsigned char*>(p.k) + kb * ES;
    const unsigned char* gv = reinterpret_cast<const unsigned char*>(p.v) + vb * ES;
    unsigned char* sk = smem + st * 2 * kStageBytes;
    unsigned char* sv = sk + kStageBytes;
    const int n16 = n * D * ES / 16;
    for (int i = tid; i < n16; i += kThreads) {
      cp_async16(sk + 16 * i, gk + 16 * i);
      cp_async16(sv + 16 * i, gv + 16 * i);
    }
    if (scaled) {
      for (int i = tid; i < n; i += kThreads) {
        cp_async4(sscale + (2 * st) * T + i, p.ks + ksb + i);
        cp_async4(sscale + (2 * st + 1) * T + i, p.vs + vsb + i);
      }
    }
  };

  if (c_begin < c_end) issue(c_begin, 0);
  cp_async_commit();
  int st = 0;
  for (long long c = c_begin; c < c_end; ++c, st ^= 1) {
    if (c + 1 < c_end) issue(c + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk has landed
    __syncthreads();
    long long lo;
    int n;
    chunk_rows(c, lo, n);
    const unsigned char* sk = smem + st * 2 * kStageBytes;
    const unsigned char* sv = sk + kStageBytes;
    const float* skscale = sscale + (2 * st) * T;
    const float* svscale = skscale + T;
    for (int base = warp * RG; base < n; base += kWarps * RG) {
      float s[RG][MAXG];
#pragma unroll
      for (int u = 0; u < RG; ++u) {
        if (base + u < n) {
          float kf[E];
          load_row<KV, E>(sk + (base + u) * D * ES + lane * E * ES, kf);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(q[g][e], kf[e], d);
            s[u][g] = d;
          }
        } else {
#pragma unroll
          for (int g = 0; g < MAXG; ++g) s[u][g] = 0.f;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < RG; ++u) {
#pragma unroll
          for (int g = 0; g < MAXG; ++g) s[u][g] += __shfl_xor_sync(kFull, s[u][g], off);
        }
      }
      // the group's scores, then one rescale of (m, l, acc) per head
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= p.G) break;
        float mx = NEG;
#pragma unroll
        for (int u = 0; u < RG; ++u) {
          if (base + u < n) {
            if (scaled) s[u][g] *= skscale[base + u];
            mx = fmaxf(mx, s[u][g]);
          }
        }
        const float mn = fmaxf(m[g], mx);
        const float corr = expf(m[g] - mn);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < RG; ++u) {
          s[u][g] = base + u < n ? expf(s[u][g] - mn) : 0.f;  // now the probability
          sum += s[u][g];
        }
        l[g] = l[g] * corr + sum;
        m[g] = mn;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < RG; ++u) {
        if (base + u < n) {
          float vf[E];
          load_row<KV, E>(sv + (base + u) * D * ES + lane * E * ES, vf);
          const float vsc = scaled ? svscale[base + u] : 1.f;
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g >= p.G) break;
            const float pw = scaled ? s[u][g] * vsc : s[u][g];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pw, vf[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the chunk after next
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' states, merged in warp order, head by head
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][D], then [kWarps][m, l]
  float* red_ml = red + kWarps * D;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= p.G) break;
#pragma unroll
    for (int e = 0; e < E; ++e) red[warp * D + lane * E + e] = acc[g][e];
    if (lane == 0) {
      red_ml[2 * warp] = m[g];
      red_ml[2 * warp + 1] = l[g];
    }
    __syncthreads();
    float M = red_ml[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_ml[2 * w]);
    float wt[kWarps], Ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wt[w] = expf(red_ml[2 * w] - M);
      Ls += red_ml[2 * w + 1] * wt[w];
    }
    const long long bh = static_cast<long long>(b) * p.H + kh * p.G + g;
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a = fmaf(red[w * D + d], wt[w], a);
      if (p.nsplit == 1)
        store_o(p, bh * D + d, a / fmaxf(Ls, 1e-30f));
      else
        p.part[(bh * p.nsplit + split) * D + d] = a;
    }
    if (tid == 0) {
      if (p.nsplit == 1) {
        if (p.lse != nullptr) p.lse[bh] = M + logf(fmaxf(Ls, 1e-30f));
      } else {
        p.part_ml[(bh * p.nsplit + split) * 2] = M;
        p.part_ml[(bh * p.nsplit + split) * 2 + 1] = Ls;
      }
    }
    __syncthreads();
  }
}

// One block a (sequence, head): the live splits' partials, merged in split
// order.
__global__ void __launch_bounds__(kThreads) flash_decode_merge_kernel(const Params p, int D) {
  extern __shared__ float wts[];  // [nsplit]
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / p.H);
  const int nact = live_range(p, b).nact;
  const float* ml = p.part_ml + bh * p.nsplit * 2;
  float M = NEG;
  for (int s = 0; s < nact; ++s) M = fmaxf(M, ml[2 * s]);
  for (int s = threadIdx.x; s < nact; s += blockDim.x) wts[s] = expf(ml[2 * s] - M);
  __syncthreads();
  float Ls = 0.f;
  for (int s = 0; s < nact; ++s) Ls += ml[2 * s + 1] * wts[s];
  const float* part = p.part + bh * p.nsplit * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nact; ++s) a = fmaf(part[static_cast<long long>(s) * D + d], wts[s], a);
    store_o(p, bh * D + d, a / fmaxf(Ls, 1e-30f));
  }
  if (threadIdx.x == 0 && p.lse != nullptr) p.lse[bh] = M + logf(fmaxf(Ls, 1e-30f));
}

template <typename KV, int D, int MAXG>
cudaError_t launch_t(const Params& p, cudaStream_t st) {
  constexpr int T = kStageBytes / (D * static_cast<int>(sizeof(KV)));
  const size_t smem = 4 * kStageBytes + 4 * T * sizeof(float);  // < 48 KB: no opt-in
  const dim3 grid(p.nsplit, p.K, p.B);
  flash_decode_split_kernel<KV, D, MAXG><<<grid, kThreads, smem, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  flash_decode_merge_kernel<<<p.B * p.H, kThreads, p.nsplit * sizeof(float), st>>>(p, D);
  return cudaGetLastError();
}

template <typename KV, int D>
cudaError_t launch_g(const Params& p, cudaStream_t st) {
  if (p.G <= 1) return launch_t<KV, D, 1>(p, st);
  if (p.G <= 2) return launch_t<KV, D, 2>(p, st);
  if (p.G <= 4) return launch_t<KV, D, 4>(p, st);
  if (p.G <= 8) return launch_t<KV, D, 8>(p, st);
  return cudaErrorInvalidValue;
}

template <typename KV>
cudaError_t launch_d(const Params& p, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch_g<KV, 64>(p, st);
    case 128: return launch_g<KV, 128>(p, st);
    case 256: return launch_g<KV, 256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kvdtype: 0 float32, 1 bfloat16, 2 float16, 3 fp8 e4m3, 4 fp8 e5m2 (k and
// v); qdtype: 0 float32, 1 bfloat16, 2 float16 (q and o). table null:
// contiguous. S: rows of the logical cache (NB * bs paged). ks/vs null:
// unscaled. part: nsplit > 1 only, B*H*nsplit*(D+2)
// floats. strides: 11 element strides, q (b, h), k (0, 1), v (0, 1),
// k_scale (0, 1), v_scale (0, 1), table row. Returns the launches'
// cudaError_t.
int repro_flash_decode(const void* q, void* o, float* lse, const void* k, const void* v, const float* ks,
                       const float* vs, const void* table, const void* pos, float* part, int kvdtype, int qdtype,
                       int table64, int pos64, int B, int H, int K, int D, int bs, int S, int window,
                       int pos_offset, int pps, int nsplit, const long long* strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || bs <= 0 || S <= 0 || pps <= 0 || nsplit <= 0)
    return cudaErrorInvalidValue;
  if ((ks == nullptr) != (vs == nullptr) || (nsplit > 1 && part == nullptr)) return cudaErrorInvalidValue;
  if (qdtype < 0 || qdtype > 2) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.o = o;
  p.lse = lse;
  p.k = k;
  p.v = v;
  p.ks = ks;
  p.vs = vs;
  p.table = table;
  p.pos = pos;
  p.part = part;
  p.part_ml = nsplit > 1 ? part + static_cast<long long>(B) * H * nsplit * D : nullptr;
  p.qs[0] = strides[0];
  p.qs[1] = strides[1];
  p.kst[0] = strides[2];
  p.kst[1] = strides[3];
  p.vst[0] = strides[4];
  p.vst[1] = strides[5];
  p.kss[0] = strides[6];
  p.kss[1] = strides[7];
  p.vss[0] = strides[8];
  p.vss[1] = strides[9];
  p.tstride = strides[10];
  p.B = B;
  p.H = H;
  p.K = K;
  p.G = H / K;
  p.bs = bs;
  p.S = S;
  p.window = window;
  p.pos_offset = pos_offset;
  p.pps = pps;
  p.nsplit = nsplit;
  p.qdtype = qdtype;
  p.table64 = table64;
  p.pos64 = pos64;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kvdtype) {
    case 0: return launch_d<float>(p, D, st);
    case 1: return launch_d<__nv_bfloat16>(p, D, st);
    case 2: return launch_d<__half>(p, D, st);
    case 3: return launch_d<__nv_fp8_e4m3>(p, D, st);
    case 4: return launch_d<__nv_fp8_e5m2>(p, D, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
