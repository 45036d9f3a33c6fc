// Chunked linear attention with data-dependent decay (RWKV6 / SSD) for Hopper
// (sm_90a), CUDA C++ with a plain C interface (loaded with ctypes by
// repro_torch/hopper/linear_attention.py).
//
// Replaces: src/repro/kernels/rwkv6.py `_la_kernel` (as built by
// `linear_attention_program` and `linear_attention_pallas`).
//
// What it computes. The scan S_t = diag(exp w_t) S_{t-1} + k_t v_t^T over
// T steps for each (b, h), from S_0 = s0 (or 0), in chunks of C steps, all
// in fp32 (r, k, v fp32 or bf16; w fp32):
//   inc = inclusive cumsum of w over the chunk, exc = inc - w,
//   e = inc (SSD) | exc (RWKV), total = inc at the chunk's last step,
//   r_dec = r exp(e), k_dec = k exp(-inc), k_tail = k exp(total - inc),
//   o = r_dec . S + mask(r_dec k_dec^T) . v  [+ sum_n(r u k) v, RWKV]
//   S = exp(total) S + k_tail^T v
// with the mask t >= s (SSD, u absent) or t > s (RWKV). A step past T acts
// as the reference's zero padding (w = 0, k = v = 0): the last, short chunk
// leaves S as the padded one does. o has the inputs' type (fp32 or bf16),
// S_final is fp32.
//
// Design. The TPU kernel carries the state in VMEM over a sequential chunk
// grid axis (one core walks the chunks in order) and computes the cumsum as
// a lower-triangular MXU product. On the GPU, only the state update
// depends on the previous chunk, so the scan runs as three launches:
//   1. `la_chunk_state`, one block per (b, h, chunk) and 64 state columns,
//      all in parallel: the chunk's state contribution dS = k_tail^T v
//      (N x M) and its total decay, into an fp32 scratch;
//   2. `la_state_pass`, one thread per state entry (b, h, n, m): the only
//      sequential part, S_{c+1} = exp(total_c) S_c + dS_c over the chunks,
//      writing each chunk's incoming state S_c over dS_c, and S_final;
//   3. `la_output`, one block per (b, h, chunk) and 64 columns, in
//      parallel: the read-out o = r_dec . S_c + mask(scores) . v (+ bonus).
// Inside a chunk kernel, in shared memory: r, k, w staged transposed
// ([n][t], so a warp's lanes run along t) and v as [t][m]; one warp per
// column n takes the inclusive cumsum of w by shuffles, in fp64 (a second
// half of 32 lanes only for chunks 33 and 34) and scales r and k by their decays; the products run on
// CUDA cores (FFMA), each thread computing a 4 x 2 tile with one float4
// read of the shared operand per step. The scratch holds B*H*ceil(T/C)*N*M
// fp32 states (N / C times o's element count) and the chunks' totals; the
// wrapper allocates it. Inputs travel with their element strides (the models hand in
// transposed views and, for the SSD read-out, head-broadcast r/k and an
// N-broadcast w with stride 0), so nothing is copied to fit. A chunk kernel
// loads its operands in register batches before it stores them to shared
// memory, so that a batch's loads are in flight together.
//
// A one-launch form that carries each head's state on chip across the
// chunks (a CTA per head and 32 state columns walking the chunks in order,
// no scratch) was built and measured slower at both models' card shapes:
// its chunk walk is a chain of barrier-separated phases with few warps an
// SM, where these launches run a block per chunk (PERF.md).
//
// Bound on this card. The function reads r, k, v, w once and writes o and
// S_final once; its fp32 work per (b, h) and chunk of c steps is 2 N and
// 2 M per unmasked score pair and 4 c N M for the read-out against the
// state and the state update. At rwkv6-3b's shape (B=4 H=40 T=2048
// N=M=64, bf16 r/k/v, fp32 w) that is ~254 MB (0.076 ms at 3.35 TB/s)
// against ~6.8 GFLOP (0.10 ms at 67 TFLOP/s): bound by operations. The
// split adds the scratch's traffic (written twice, read twice: ~0.67 GB
// at that shape) and a second pass over k, w, v.
//
// Offsets are 64-bit (long long) throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MG = 64;         // state columns per chunk block: lanes take m and m + 32
constexpr int MAX_CHUNK = 34;  // ops.linear_attention's overflow guard: 34 * 2.5 <= 85
constexpr int MAX_N = 128;
constexpr int MAX_SMEM = 227 * 1024;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;   // (H, N) contiguous; null for the SSD read-out
  const float* s0;  // (B, H, N, M) contiguous; null for zeros
  void* o;
  float* s_out;     // (B, H, N, M) contiguous
  float* dstate;    // (B*H, nc, N, M): dS_c, then the state entering chunk c
  float* dtot;      // (B*H, nc, N): the chunk's total log-decay
  long long sr[4], sk[4], sv[4], sw[4], so[4];  // element strides (b, h, t, n|m)
  int H, T, N, M, C, nc;
  int N4, C4, CP, NP;  // N and C rounded up to 4; row strides of [n][t] and [t][n]
  // shared-memory offsets, in floats
  int off_rt, off_kdt, off_wt, off_kt, off_v, off_at, off_s, off_bp;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// The running sum is fp64: a chain of fp32 adds rounds at every step, and
// each rounding of an exponent of up to ~85 scales a decayed term by
// ~85 * 6e-8, which a near-zero output (terms of ~10-100 cancelling)
// magnifies. Each exponent is rounded to fp32 once, where it is taken.
__device__ __forceinline__ double warp_inclusive_scan(double x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// The block's chunk: (b, h), its first step t0, its steps nt <= C, and
// its state columns m0 .. m0 + mw - 1.
struct Chunk {
  int bh, b, h, c, m0, mw, nt;
  long long t0;
};

__device__ __forceinline__ Chunk chunk_of_block(const Params& p) {
  Chunk q;
  q.bh = blockIdx.x / p.nc;
  q.c = blockIdx.x % p.nc;
  q.b = q.bh / p.H;
  q.h = q.bh % p.H;
  q.m0 = blockIdx.y * MG;
  q.mw = min(MG, p.M - q.m0);
  q.t0 = static_cast<long long>(q.c) * p.C;
  q.nt = static_cast<int>(min(static_cast<long long>(p.C), p.T - q.t0));
  return q;
}

// Stage the chunk's k and w (and r when RT is given) transposed, [n][t],
// and v as [t][m]; steps past T and rows past N are 0. Each thread loads
// LB elements of an array into registers before it stores any of them, so
// that their loads are in flight together (a store to shared memory
// between two loads would hold the second back); LB is 8 where a thread
// stages 8 elements of r, k and w a chunk (rwkv6-3b), 1 (one element at a
// time) where it stages fewer (hymba-1.5b): there batches of 2 and 8 were
// slower (PERF.md).
template <typename T, int LB>
__device__ __forceinline__ void stage(const Params& p, const Chunk& q, float* RT, float* KDT, float* WT,
                                      float* V) {
  const T* r = static_cast<const T*>(p.r) + q.b * p.sr[0] + q.h * p.sr[1] + q.t0 * p.sr[2];
  const T* k = static_cast<const T*>(p.k) + q.b * p.sk[0] + q.h * p.sk[1] + q.t0 * p.sk[2];
  const float* w = p.w + q.b * p.sw[0] + q.h * p.sw[1] + q.t0 * p.sw[2];
  const T* v = static_cast<const T*>(p.v) + q.b * p.sv[0] + q.h * p.sv[1] + q.t0 * p.sv[2] + q.m0 * p.sv[3];
  const int N = p.N, N4 = p.N4, CP = p.CP;
  if constexpr (LB == 1) {
    for (int e = threadIdx.x; e < p.C4 * N4; e += THREADS) {
      const int t = e / N4, n = e % N4;
      const bool in = t < q.nt && n < N;
      if (RT != nullptr) RT[n * CP + t] = in ? to_f32(r[t * p.sr[2] + n * p.sr[3]]) : 0.f;
      KDT[n * CP + t] = in ? to_f32(k[t * p.sk[2] + n * p.sk[3]]) : 0.f;
      WT[n * CP + t] = in ? w[t * p.sw[2] + n * p.sw[3]] : 0.f;
    }
    for (int e = threadIdx.x; e < p.C4 * MG; e += THREADS) {
      const int t = e / MG, m = e % MG;
      V[e] = (t < q.nt && m < q.mw) ? to_f32(v[t * p.sv[2] + m * p.sv[3]]) : 0.f;
    }
  } else {
    const int E = p.C4 * N4;
    for (int e0 = threadIdx.x; e0 < E; e0 += LB * THREADS) {
      float rv[LB], kv[LB], wv[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int e = e0 + j * THREADS, t = e / N4, n = e % N4;
        const bool in = e < E && t < q.nt && n < N;
        rv[j] = in && RT != nullptr ? to_f32(r[t * p.sr[2] + n * p.sr[3]]) : 0.f;
        kv[j] = in ? to_f32(k[t * p.sk[2] + n * p.sk[3]]) : 0.f;
        wv[j] = in ? w[t * p.sw[2] + n * p.sw[3]] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int e = e0 + j * THREADS, t = e / N4, n = e % N4;
        if (e < E) {
          if (RT != nullptr) RT[n * CP + t] = rv[j];
          KDT[n * CP + t] = kv[j];
          WT[n * CP + t] = wv[j];
        }
      }
    }
    for (int e0 = threadIdx.x; e0 < p.C4 * MG; e0 += LB * THREADS) {
      float vv[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int e = e0 + j * THREADS, t = e / MG, m = e % MG;
        vv[j] = (e < p.C4 * MG && t < q.nt && m < q.mw) ? to_f32(v[t * p.sv[2] + m * p.sv[3]]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < LB; ++j)
        if (e0 + j * THREADS < p.C4 * MG) V[e0 + j * THREADS] = vv[j];
    }
  }
}

// The inclusive cumsum of w's column n in fp64 (lane holds steps lane and
// lane + 32; the second half holds steps only for chunks 33 and 34), and
// the chunk's total.
struct Scan {
  float w0, w1;
  double i0, i1, total;
};

__device__ __forceinline__ Scan scan_column(const Params& p, const float* wrow, int lane) {
  Scan s;
  s.w0 = lane < p.C4 ? wrow[lane] : 0.f;
  s.w1 = lane + 32 < p.C4 ? wrow[lane + 32] : 0.f;
  s.i0 = warp_inclusive_scan(static_cast<double>(s.w0), lane);
  if (p.C <= 32) {  // the second half holds no step
    s.i1 = 0.0;
    s.total = __shfl_sync(0xffffffffu, s.i0, p.C - 1);
  } else {
    s.i1 = warp_inclusive_scan(static_cast<double>(s.w1), lane) + __shfl_sync(0xffffffffu, s.i0, 31);
    s.total = __shfl_sync(0xffffffffu, s.i1, p.C - 33);
  }
  return s;
}

// 1. The chunk's state contribution dS = k_tail^T v and total decay.
template <typename T, int LB>
__global__ void __launch_bounds__(THREADS) la_chunk_state(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* KDT = sm + p.off_kdt;  // [N4][CP]: k
  float* WT = sm + p.off_wt;    // [N4][CP]: w
  float* KT = sm + p.off_kt;    // [C4][NP]: k_tail
  float* V = sm + p.off_v;      // [C4][MG]
  const Chunk q = chunk_of_block(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = p.N, N4 = p.N4, CP = p.CP, NP = p.NP;
  stage<T, LB>(p, q, nullptr, KDT, WT, V);
  __syncthreads();

  float* dtot = p.dtot + (static_cast<long long>(q.bh) * p.nc + q.c) * N;
  for (int n = warp; n < N4; n += WARPS) {
    const Scan s = scan_column(p, WT + n * CP, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = lane + 32 * half;
      if (t < p.C4) KT[t * NP + n] = KDT[n * CP + t] * expf(static_cast<float>(s.total - (half ? s.i1 : s.i0)));
    }
    if (lane == 0 && n < N && blockIdx.y == 0) dtot[n] = static_cast<float>(s.total);
  }
  __syncthreads();

  // dS[n..n+3][m, m+32] = sum_s k_tail[s][n..n+3] v[s][m, m+32]
  float* ds = p.dstate + (static_cast<long long>(q.bh) * p.nc + q.c) * N * p.M + q.m0;
  for (int e = threadIdx.x; e < (N4 / 4) * 32; e += THREADS) {
    const int m = e % 32, n = 4 * (e / 32);
    float a[4][2] = {};
    for (int s = 0; s < q.nt; ++s) {
      const float4 k4 = *reinterpret_cast<const float4*>(KT + s * NP + n);
      const float v0 = V[s * MG + m], v1 = V[s * MG + m + 32];
      a[0][0] += k4.x * v0; a[0][1] += k4.x * v1;
      a[1][0] += k4.y * v0; a[1][1] += k4.y * v1;
      a[2][0] += k4.z * v0; a[2][1] += k4.z * v1;
      a[3][0] += k4.w * v0; a[3][1] += k4.w * v1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n + i >= N) break;
      if (m < q.mw) ds[static_cast<long long>(n + i) * p.M + m] = a[i][0];
      if (m + 32 < q.mw) ds[static_cast<long long>(n + i) * p.M + m + 32] = a[i][1];
    }
  }
}

// 2. The sequential pass over the chunks, one thread per state entry:
// dstate[c] <- S_c (the state entering chunk c); S_{c+1} = exp(total_c) S_c + dS_c.
__global__ void __launch_bounds__(THREADS) la_state_pass(const Params p, long long entries) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= entries) return;
  const long long NM = static_cast<long long>(p.N) * p.M;
  const long long bh = i / NM, nm = i % NM;
  const int n = static_cast<int>(nm / p.M);
  float S = p.s0 != nullptr ? p.s0[i] : 0.f;
  float* ds = p.dstate + bh * p.nc * NM + nm;
  const float* tot = p.dtot + bh * p.nc * p.N + n;
  constexpr int U = 8;  // chunks whose loads are in flight together
  for (int c0 = 0; c0 < p.nc; c0 += U) {
    float d[U], e[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long c = c0 + j;
      d[j] = c < p.nc ? ds[c * NM] : 0.f;
      e[j] = c < p.nc ? tot[c * p.N] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long c = c0 + j;
      if (c < p.nc) {
        ds[c * NM] = S;
        S = expf(e[j]) * S + d[j];
      }
    }
  }
  p.s_out[i] = S;
}

// 3. The read-out of one chunk against its incoming state.
template <typename T, int LB>
__global__ void __launch_bounds__(THREADS) la_output(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* RT = sm + p.off_rt;    // [N4][CP]: r, then r_dec
  float* KDT = sm + p.off_kdt;  // [N4][CP]: k, then k_dec
  float* WT = sm + p.off_wt;    // [N4][CP]: w
  float* V = sm + p.off_v;      // [C4][MG]
  float* AT = sm + p.off_at;    // [C4][CP]: masked scores, AT[s][t]
  float* S = sm + p.off_s;      // [N4][MG]: the state entering the chunk
  float* BP = sm + p.off_bp;    // [WARPS][C4]: each warp's share of the bonus sum_n r u k
  const Chunk q = chunk_of_block(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = p.N, N4 = p.N4, C4 = p.C4, CP = p.CP;
  const bool ssd = p.u == nullptr;

  stage<T, LB>(p, q, RT, KDT, WT, V);
  const float* sc = p.dstate + (static_cast<long long>(q.bh) * p.nc + q.c) * N * p.M + q.m0;
  if constexpr (LB == 1) {
    for (int e = tid; e < N4 * MG; e += THREADS) {
      const int n = e / MG, m = e % MG;
      S[e] = (n < N && m < q.mw) ? sc[static_cast<long long>(n) * p.M + m] : 0.f;
    }
  } else {
    for (int e0 = tid; e0 < N4 * MG; e0 += LB * THREADS) {
      float sv[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int e = e0 + j * THREADS, n = e / MG, m = e % MG;
        sv[j] = (e < N4 * MG && n < N && m < q.mw) ? sc[static_cast<long long>(n) * p.M + m] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < LB; ++j)
        if (e0 + j * THREADS < N4 * MG) S[e0 + j * THREADS] = sv[j];
    }
  }
  __syncthreads();

  // decays per column n (one warp each), and the bonus from the raw r, k
  const float* u = ssd ? nullptr : p.u + static_cast<long long>(q.h) * N;
  float bp0 = 0.f, bp1 = 0.f;
  for (int n = warp; n < N4; n += WARPS) {
    const Scan s = scan_column(p, WT + n * CP, lane);
    const float un = (ssd || n >= N) ? 0.f : u[n];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = lane + 32 * half;
      if (t < C4) {
        const double inc = half ? s.i1 : s.i0;
        const double ex = ssd ? inc : inc - (half ? s.w1 : s.w0);
        const float rraw = RT[n * CP + t], kraw = KDT[n * CP + t];
        if (half) bp1 += rraw * un * kraw;
        else bp0 += rraw * un * kraw;
        RT[n * CP + t] = rraw * expf(static_cast<float>(ex));
        KDT[n * CP + t] = kraw * expf(static_cast<float>(-inc));
      }
    }
  }
  if (!ssd) {
    if (lane < C4) BP[warp * C4 + lane] = bp0;
    if (lane + 32 < C4) BP[warp * C4 + lane + 32] = bp1;
  }
  __syncthreads();

  // masked scores AT[s][t..t+3] = r_dec[t] . k_dec[s]; lanes along s
  for (int e = tid; e < (C4 / 4) * C4; e += THREADS) {
    const int s = e % C4, t = 4 * (e / C4);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (t + 3 >= s + (ssd ? 0 : 1)) {
      for (int n = 0; n < N; ++n) {
        const float kd = KDT[n * CP + s];
        const float4 r4 = *reinterpret_cast<const float4*>(RT + n * CP + t);
        a[0] += r4.x * kd;
        a[1] += r4.y * kd;
        a[2] += r4.z * kd;
        a[3] += r4.w * kd;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (!(ssd ? t + i >= s : t + i > s)) a[i] = 0.f;
    *reinterpret_cast<float4*>(AT + s * CP + t) = make_float4(a[0], a[1], a[2], a[3]);
  }
  __syncthreads();

  // o[t..t+3][m, m+32] = r_dec . S + scores . v (+ bonus v); lanes along m
  T* o = static_cast<T*>(p.o) + q.b * p.so[0] + q.h * p.so[1] + q.t0 * p.so[2] + q.m0 * p.so[3];
  for (int e = tid; e < (C4 / 4) * 32; e += THREADS) {
    const int m = e % 32, t = 4 * (e / 32);
    if (t >= q.nt) continue;
    float o1[4][2] = {}, o2[4][2] = {};
    for (int n = 0; n < N; ++n) {
      const float4 r4 = *reinterpret_cast<const float4*>(RT + n * CP + t);
      const float s0 = S[n * MG + m], s1 = S[n * MG + m + 32];
      o1[0][0] += r4.x * s0; o1[0][1] += r4.x * s1;
      o1[1][0] += r4.y * s0; o1[1][1] += r4.y * s1;
      o1[2][0] += r4.z * s0; o1[2][1] += r4.z * s1;
      o1[3][0] += r4.w * s0; o1[3][1] += r4.w * s1;
    }
    const int smax = min(q.nt, t + 4);
    for (int s = 0; s < smax; ++s) {
      const float4 a4 = *reinterpret_cast<const float4*>(AT + s * CP + t);
      const float v0 = V[s * MG + m], v1 = V[s * MG + m + 32];
      o2[0][0] += a4.x * v0; o2[0][1] += a4.x * v1;
      o2[1][0] += a4.y * v0; o2[1][1] += a4.y * v1;
      o2[2][0] += a4.z * v0; o2[2][1] += a4.z * v1;
      o2[3][0] += a4.w * v0; o2[3][1] += a4.w * v1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = t + i;
      if (tt >= q.nt) break;
      float bonus = 0.f;
      if (!ssd)
        for (int j = 0; j < WARPS; ++j) bonus += BP[j * C4 + tt];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int mm = m + 32 * j;
        if (mm < q.mw) {
          float val = o1[i][j] + o2[i][j];
          if (!ssd) val += bonus * V[tt * MG + mm];
          o[tt * p.so[2] + mm * p.so[3]] = from_f32<T>(val);
        }
      }
    }
  }
}

inline int round4(int x) { return (x + 3) / 4 * 4; }

// Fills the padded sizes and shared-memory offsets; returns the bytes of
// the read-out's layout and sets `state_bytes` to the state kernel's (its
// k_tail takes the place of the read-out's r).
long long layout(Params& p, long long& state_bytes) {
  p.N4 = round4(p.N);
  p.C4 = round4(p.C);
  p.CP = p.C4 + 4;  // float4-aligned rows
  p.NP = p.N4 + 4;
  long long off = 0;
  auto take = [&off](long long n) {
    const long long at = off;
    off += (n + 3) / 4 * 4;
    return static_cast<int>(at);
  };
  p.off_kdt = take(static_cast<long long>(p.N4) * p.CP);
  p.off_wt = take(static_cast<long long>(p.N4) * p.CP);
  p.off_v = take(static_cast<long long>(p.C4) * MG);
  p.off_kt = static_cast<int>(off);
  state_bytes = 4 * (off + static_cast<long long>(p.C4) * p.NP);
  p.off_rt = take(static_cast<long long>(p.N4) * p.CP);
  p.off_at = take(static_cast<long long>(p.C4) * p.CP);
  p.off_s = take(static_cast<long long>(p.N4) * MG);
  p.off_bp = take(static_cast<long long>(WARPS) * p.C4);
  return off * 4;
}

template <typename T, int LB>
cudaError_t launch_lb(const Params& p, long long BH, long long smem, long long state_smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(la_chunk_state<T, LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(state_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(la_output<T, LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(BH * p.nc), static_cast<unsigned>((p.M + MG - 1) / MG));
  if (p.nc > 0) {
    la_chunk_state<T, LB><<<grid, THREADS, static_cast<size_t>(state_smem), st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long entries = BH * p.N * p.M;
  la_state_pass<<<static_cast<unsigned>((entries + THREADS - 1) / THREADS), THREADS, 0, st>>>(p, entries);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nc == 0) return err;
  la_output<T, LB><<<grid, THREADS, static_cast<size_t>(smem), st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, long long BH, long long smem, long long state_smem, cudaStream_t st) {
  if (p.C4 * p.N4 >= 8 * THREADS) return launch_lb<T, 8>(p, BH, smem, state_smem, st);
  return launch_lb<T, 1>(p, BH, smem, state_smem, st);
}

}  // namespace

extern "C" {

// Bytes of fp32 scratch `repro_linear_attention` needs: (B*H, nc, N, M)
// states then (B*H, nc, N) totals, nc = ceil(T / chunk).
long long repro_linear_attention_scratch_bytes(int B, int H, int T, int N, int M, int chunk) {
  if (chunk < 1) return -1;
  const long long nc = (static_cast<long long>(T) + chunk - 1) / chunk;
  const long long BH = static_cast<long long>(B) * H;
  return 4 * BH * nc * N * (static_cast<long long>(M) + 1);
}

// dtype: r, k, v and o, 0 = float32, 1 = bfloat16; w is float32.
// r, k, w (B, H, T, N); v, o (B, H, T, M), each with its (b, h, t, last)
// element strides in `strides` (20 values: r, k, v, w, o). u (H, N) fp32
// contiguous or null (SSD read-out); s0 (B, H, N, M) fp32 contiguous or null
// (zeros); s_out (B, H, N, M) fp32 contiguous; scratch of
// repro_linear_attention_scratch_bytes, 16-byte aligned. 1 <= chunk <= 34,
// N <= 128. Returns the first failing launch's cudaError_t, else 0.
int repro_linear_attention(const void* r, const void* k, const void* v, const float* w, const float* u,
                           const float* s0, void* o, float* s_out, void* scratch, int dtype,
                           int B, int H, int T, int N, int M, int chunk, const long long* strides,
                           void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || N <= 0 || N > MAX_N || M <= 0) return cudaErrorInvalidValue;
  if (chunk < 1 || chunk > MAX_CHUNK) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const long long BH = static_cast<long long>(B) * H;
  const long long nc = (static_cast<long long>(T) + chunk - 1) / chunk;
  if (BH * nc > 0x7fffffffLL || (M + MG - 1) / MG > 65535) return cudaErrorInvalidValue;
  if ((BH * N * M + THREADS - 1) / THREADS > 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.s0 = s0;
  p.o = o;
  p.s_out = s_out;
  p.dstate = static_cast<float*>(scratch);
  p.dtot = p.dstate + BH * nc * N * M;
  for (int i = 0; i < 4; ++i) {
    p.sr[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.sw[i] = strides[12 + i];
    p.so[i] = strides[16 + i];
  }
  p.H = H;
  p.T = T;
  p.N = N;
  p.M = M;
  p.C = chunk;
  p.nc = static_cast<int>(nc);
  long long state_smem = 0;
  const long long smem = layout(p, state_smem);
  if (smem > MAX_SMEM || state_smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, BH, smem, state_smem, st);
  return launch<__nv_bfloat16>(p, BH, smem, state_smem, st);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
