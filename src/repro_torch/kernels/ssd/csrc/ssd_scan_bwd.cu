// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// The gradients (dx, ddt, da_log, dB, dC) of the forward in ssd_scan.cu,
// given dy and optionally the final state's gradient dh_final. The Pallas
// TPU kernel src/repro/kernels/ssd/kernel.py (ssd_scan) has no backward: the
// reference trains through XLA's autodiff of its plain chunked scan
// (src/repro/models/ssm.py, ssd_chunked). This kernel reverses the chunked
// algorithm the forward runs, per (batch, head), with a = -exp(A_log),
// seg = cumsum(dt a) within a chunk, G = (C B^T) exp(seg_i - seg_j) and
// PD = (dy (x dt)^T) exp(seg_i - seg_j) on j <= i (ref.py's ssd_bwd_passes
// is its plain mirror, pass by pass):
//
//  1. chunk_dstate, one block per (batch, chunk, head): each chunk's own
//     share of its incoming state's gradient, Sd = sum_i exp(seg_i) dy_i C_i.
//  2. state_pass, sequential over the chunks per 4 state elements: for bf16
//     inputs first the forward's state passing again, in fp32, from the
//     chunk states the forward left in its workspace (for fp32 inputs the
//     workspace already holds each chunk's fp32 incoming state h_in); then
//     in reverse dh_out[c] = dh_in[c + 1] (dh_final for the last chunk),
//     dh_in[c] = exp(seg_last) dh_out[c] + Sd[c].
//  3. chunk_dx: d(x dt) = G^T dy + exp(seg_last - seg) B dh_out^T, which
//     gives dx = d(x dt) dt and ddt's share d(x dt) . x; and M = PD (C B^T)
//     = (dy (x dt)^T) G, whose row sums less its column sums (fp64) are the
//     intra-chunk term's gradient of seg.
//  4. chunk_dc: dC = PD B + exp(seg) dy h_in per head, and the carried-state
//     term's gradient of seg, C_i . (exp(seg_i) h_in^T dy_i).
//  5. chunk_db: dB = PD^T C + exp(seg_last - seg) (x dt) dh_out per head,
//     then d(dt a)_k = sum_{i >= k} (M's row less column sums + the carried
//     term)_i + exp(seg_last) dh_out . h_in + sum_{j < k} u_j, with u_j =
//     B_j . (exp(seg_last - seg_j) dh_out^T (x dt)_j), in fp64 (the
//     exclusive form: each exponent's own rows; the sums cancel otherwise,
//     by 1e-5 of da_log in fp32); it adds d(dt a) a to ddt and writes each
//     block's share of da_log = sum d(dt a) dt a.
//  6. reduce_heads: dB and dC summed over the heads (B and C are shared by
//     all heads, one group), in a fixed order; 7. reduce_alog: da_log.
// Every sum runs in a fixed order: the gradients are the same bits on every
// run.
//
// The chunk states: the backward reads the forward's workspace (kept by the
// autograd Function beside the inputs) rather than recompute pass 1: for
// fp32 inputs its incoming states, for bf16 its chunk states, which pass 2
// turns into fp32 incoming states in a buffer of its own. At mamba2-130m's
// train shape (B 8, S 2048, H 24, P 64, N 128) that is 16 chunks x 100.7 MB
// of fp32 states per layer, held from the layer's forward to its backward.
//
// What bounds it on this card: the function reads x, dy, B, C and dt and
// writes dx, dB, dC, ddt and da_log once: at that train shape in bf16 about
// 160 MB, 0.05 ms at 3.35 TB/s; its products (about 80 GFLOP) take less on
// the tensor cores. Bound by bytes. This first version computes in fp32 on
// the CUDA cores (for bf16 inputs too, loaded into fp32 tiles) with the
// tiling of the forward's fp32 passes, and writes fp32 per-head partials of
// dB and dC (400 MB there): it is far from the bound. Rewriting passes 3-5
// on the tensor cores is later work.
//
// Ragged sequences are masked as in the forward: rows past S load as zeros
// and are not written. x, B, C, dt and dy are read through element strides;
// the outputs are contiguous. The kernels launch on the caller's stream and
// allocate nothing: the wrapper passes the workspace (ssd/kernel.py's
// bwd_workspace_numel). The small helpers (the chunk's seg, its rows) repeat
// the forward's: each source builds on its own.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int QMAX = 128;  // rows per chunk at most
constexpr int PMAX = 64;   // head dim at most
constexpr int NMAX = 128;  // state size at most
constexpr int BATCH = 8;   // loads a thread has in flight at once

struct Params {
  const void* x;             // (B, S, H, P), unit stride over P
  const float* dt;           // (B, S, H)
  const float* a_log;        // (H,), contiguous
  const void* b;             // (B, S, N), unit stride over N
  const void* c;             // (B, S, N), unit stride over N
  const void* dy;            // (B, S, H, P), unit stride over P
  const float* dh_final;     // (B, H, P, N) contiguous, or null (zeros)
  const float* fwd_states;   // forward's workspace: (B, NC, H, P, N) h_in
                             // (fp32 inputs) or chunk states (bf16)
  const float* totals;       // forward's workspace: (B, NC, H) seg_last
  float* h_in32;             // bf16 inputs: (B, NC, H, P, N) h_in; else null
  float* dh;                 // (B, NC, H, P, N): Sd, then dh_out
  double* dsegm;             // (B, S, H): M's row less column sums
  double* alog_part;         // (B, NC, H): each block's share of da_log
  float* carried;            // (B, S, H): C_i . dC_i's carried-state part
  float* db_part;            // (B, S, H, N)
  float* dc_part;            // (B, S, H, N)
  void* dx;                  // (B, S, H, P) contiguous, x's type
  float* ddt;                // (B, S, H) contiguous
  void* db;                  // (B, S, N) contiguous, B's type
  void* dc;                  // (B, S, N) contiguous, C's type
  float* da_log;             // (H,)
  int B, S, H, P, N, Q, NC;  // Q: rows per chunk (1..QMAX); NC chunks
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, c_sb, c_ss;
  long long dy_sb, dy_ss, dy_sh;

  __device__ const float* h_in() const {
    return h_in32 != nullptr ? h_in32 : fwd_states;
  }
};

__host__ __device__ constexpr int round16(int q) { return (q + 15) & ~15; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Rows [0, rows) of a (rows, cols) matrix at src (row stride ss elements,
// unit column stride) into fp32 shared memory at dst (row stride ld); rows
// in [live, rows) as zeros. BATCH loads in flight a thread.
template <typename T>
__device__ __forceinline__ void load_f32(float* dst, int ld, const T* src,
                                         long long ss, int rows, int live,
                                         int cols) {
  const int total = rows * cols;
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * blockDim.x) {
    float v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * blockDim.x, r = e / cols;
      v[k] = e < total && r < live ? to_f(src[r * ss + e % cols]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < total) dst[(e / cols) * ld + e % cols] = v[k];
    }
  }
}

// seg[j] = sum_{i <= j} fp32(dt_i a) in fp64 for j < Qp (<= 128), as the
// forward sums it. Warp 0 scans, four rows a lane.
__device__ __forceinline__ void chunk_seg(const float* dts, float a, int Qp,
                                          double* seg) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = lane * 4 + k;
    run += j < Qp ? static_cast<double>(dts[j] * a) : 0.0;
    v[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const double before = incl - run;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = lane * 4 + k;
    if (j < Qp) seg[j] = before + v[k];
  }
}

// The chunk of this block: batch bi, chunk ci, head hi, rows [s0, s0 + cq)
struct Chunk {
  int bi, ci, hi, s0, cq, Qp;
  float a;
  __device__ Chunk(const Params& p) {
    bi = blockIdx.x / p.NC;
    ci = blockIdx.x % p.NC;
    hi = blockIdx.y;
    s0 = ci * p.Q;
    cq = min(p.Q, p.S - s0);
    Qp = round16(p.Q);
    a = -expf(p.a_log[hi]);
  }
  __device__ long long slot(const Params& p) const {  // (batch, chunk, head)
    return (static_cast<long long>(bi) * p.NC + ci) * p.H + hi;
  }
  __device__ long long row(const Params& p, int i) const {  // (b, s0 + i, h)
    return (static_cast<long long>(bi) * p.S + s0 + i) * p.H + hi;
  }
};

__device__ __forceinline__ void load_dt(const Params& p, const Chunk& ch,
                                        float* dts) {
  const float* dt = p.dt + ch.bi * p.dt_sb + ch.hi * p.dt_sh;
  for (int j = threadIdx.x; j < ch.Qp; j += blockDim.x)
    dts[j] = j < ch.cq ? dt[static_cast<long long>(ch.s0 + j) * p.dt_ss] : 0.f;
}

template <typename T>
__device__ __forceinline__ const T* x_rows(const Params& p, const Chunk& ch) {
  return static_cast<const T*>(p.x) + ch.bi * p.x_sb + ch.hi * p.x_sh +
         ch.s0 * p.x_ss;
}
template <typename T>
__device__ __forceinline__ const T* dy_rows(const Params& p, const Chunk& ch) {
  return static_cast<const T*>(p.dy) + ch.bi * p.dy_sb + ch.hi * p.dy_sh +
         ch.s0 * p.dy_ss;
}
template <typename T>
__device__ __forceinline__ const T* b_rows(const Params& p, const Chunk& ch) {
  return static_cast<const T*>(p.b) + ch.bi * p.b_sb + ch.s0 * p.b_ss;
}
template <typename T>
__device__ __forceinline__ const T* c_rows(const Params& p, const Chunk& ch) {
  return static_cast<const T*>(p.c) + ch.bi * p.c_sb + ch.s0 * p.c_ss;
}

// Sum over the 8 lanes of one row group (lanes 8 r .. 8 r + 7)
template <typename V>
__device__ __forceinline__ V sum8(V v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The lower triangle of a Qp x Qp matrix W[i][j] = (sum_k A[i][k] Bm[j][k])
// * exp(seg_i - seg_j) on j <= i, 0 above and past the live rows (their
// inputs are zeros), written into out (row stride lo). Thread (gi, gj) =
// (tid / 16, tid % 16) owns rows gi + 16 u and columns gj + 16 v; tiles
// (u, v) with v > u lie above the diagonal and are skipped.
__device__ __forceinline__ void decayed_products(
    const float* A, int la, const float* Bm, int lb, int K, int Qp,
    const double* seg, float* out, int lo) {
  const int gi = threadIdx.x >> 4, gj = threadIdx.x & 15, U = Qp / 16;
  float g[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) g[u][v] = 0.f;
  for (int k = 0; k < K; ++k) {
    float av[8], bv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) av[u] = u < U ? A[(gi + 16 * u) * la + k] : 0.f;
#pragma unroll
    for (int v = 0; v < 8; ++v)
      bv[v] = v < U ? Bm[(gj + 16 * v) * lb + k] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v <= u; ++v) g[u][v] += av[u] * bv[v];
  }
  __syncthreads();  // out may alias A: every thread is done reading it
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if (u >= U) break;
    const int i = gi + 16 * u;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (v >= U) break;
      const int j = gj + 16 * v;
      out[i * lo + j] =
          (v <= u && j <= i)
              ? g[u][v] * expf(static_cast<float>(seg[i] - seg[j]))
              : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1: each chunk's share of its incoming state's gradient
// ---------------------------------------------------------------------------

// shared memory: seg (Qp doubles), dt and exp(seg) (Qp floats each), dy
// Qp x (P + 1), C Qp x (N + 1)
__host__ __device__ inline size_t dstate_smem(int Qp, int P, int N) {
  return 8 * Qp + 4 * (2 * Qp + static_cast<size_t>(Qp) * (P + 1) +
                       static_cast<size_t>(Qp) * (N + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) chunk_dstate(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LP = P + 1, LN = N + 1;
  const int tid = threadIdx.x;
  double* seg = smem;
  float* dts = reinterpret_cast<float*>(seg + Qp);
  float* w = dts + Qp;
  float* dys = w + Qp;
  float* cs = dys + Qp * LP;
  load_dt(p, ch, dts);
  load_f32(dys, LP, dy_rows<T>(p, ch), p.dy_ss, Qp, ch.cq, P);
  load_f32(cs, LN, c_rows<T>(p, ch), p.c_ss, Qp, ch.cq, N);
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  for (int j = tid; j < Qp; j += THREADS)
    w[j] = expf(static_cast<float>(seg[j]));
  __syncthreads();

  // Sd[sp + 16 u][sn + 16 v] = sum_i (dy[i] exp(seg_i)) C[i]
  const int sp = tid >> 4, sn = tid & 15;
  const int UP = P / 16, VN = N / 16;
  float hv[PMAX / 16][NMAX / 16];
#pragma unroll
  for (int u = 0; u < PMAX / 16; ++u)
#pragma unroll
    for (int v = 0; v < NMAX / 16; ++v) hv[u][v] = 0.f;
  for (int i = 0; i < ch.cq; ++i) {
    const float r = w[i];
    float dv[PMAX / 16], cv[NMAX / 16];
#pragma unroll
    for (int u = 0; u < PMAX / 16; ++u)
      dv[u] = u < UP ? dys[i * LP + sp + 16 * u] * r : 0.f;
#pragma unroll
    for (int v = 0; v < NMAX / 16; ++v)
      cv[v] = v < VN ? cs[i * LN + sn + 16 * v] : 0.f;
#pragma unroll
    for (int u = 0; u < PMAX / 16; ++u)
#pragma unroll
      for (int v = 0; v < NMAX / 16; ++v) hv[u][v] += dv[u] * cv[v];
  }
  float* out = p.dh + ch.slot(p) * P * N;
#pragma unroll
  for (int u = 0; u < PMAX / 16; ++u)
#pragma unroll
    for (int v = 0; v < NMAX / 16; ++v)
      if (u < UP && v < VN) out[(sp + 16 * u) * N + sn + 16 * v] = hv[u][v];
}

// ---------------------------------------------------------------------------
// pass 2: the incoming states (bf16 inputs), then the states' gradients
// ---------------------------------------------------------------------------

// grid (B * H, P N / (4 * THREADS) rounded up): each thread walks the
// chunks for 4 neighbouring state elements
__global__ void __launch_bounds__(THREADS) state_pass(Params p) {
  const int bi = blockIdx.x / p.H, hi = blockIdx.x % p.H;
  const int pn = p.P * p.N;
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  if (e >= pn) return;
  const long long slot0 = static_cast<long long>(bi) * p.NC * p.H + hi;
  auto at = [&](int ci) { return (slot0 + static_cast<long long>(ci) * p.H) *
                                 pn + e; };
  if (p.h_in32 != nullptr) {  // h_in[c + 1] = exp(seg_last[c]) h_in[c] + S[c]
    float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ci = 0; ci < p.NC; ++ci) {
      const float4 s = *reinterpret_cast<const float4*>(p.fwd_states + at(ci));
      *reinterpret_cast<float4*>(p.h_in32 + at(ci)) = h;
      const float et = expf(p.totals[slot0 + ci * p.H]);
      h.x = h.x * et + s.x;
      h.y = h.y * et + s.y;
      h.z = h.z * et + s.z;
      h.w = h.w * et + s.w;
    }
  }
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.dh_final != nullptr)
    g = *reinterpret_cast<const float4*>(
        p.dh_final + (static_cast<long long>(bi) * p.H + hi) * pn + e);
  for (int ci = p.NC - 1; ci >= 0; --ci) {
    float4* d = reinterpret_cast<float4*>(p.dh + at(ci));
    const float4 sd = *d;
    *d = g;  // dh_out[ci]
    const float et = expf(p.totals[slot0 + ci * p.H]);
    g.x = g.x * et + sd.x;
    g.y = g.y * et + sd.y;
    g.z = g.z * et + sd.z;
    g.w = g.w * et + sd.w;
  }
}

// ---------------------------------------------------------------------------
// pass 3: d(x dt) -> dx and ddt's share; M's row less column sums
// ---------------------------------------------------------------------------

__host__ __device__ inline int g_stride(int Qp, int N) {
  return N + 1 > Qp + 1 ? N + 1 : Qp + 1;
}
__host__ __device__ inline int max_i(int a, int b) { return a > b ? a : b; }

// shared memory: seg and M's row sums (Qp doubles each), M's column sums by
// row group (16 x Qp doubles), dt and exp(seg_last - seg) (Qp floats each),
// C and then G Qp x max(N + 1, Qp + 1), B and then x Qp x max(N + 1, P + 1),
// dy Qp x (P + 1), dh_out P x (N + 1). At chunk 128, N 128, P 64: 217,856
// bytes, one block per SM.
__host__ __device__ inline size_t dx_smem(int Qp, int P, int N) {
  return 8 * (18 * static_cast<size_t>(Qp)) +
         4 * (2 * static_cast<size_t>(Qp) +
              static_cast<size_t>(Qp) * g_stride(Qp, N) +
              static_cast<size_t>(Qp) * max_i(N + 1, P + 1) +
              static_cast<size_t>(Qp) * (P + 1) +
              static_cast<size_t>(P) * (N + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) chunk_dx(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LP = P + 1, LN = N + 1;
  const int LG = g_stride(Qp, N), LB = max_i(LN, LP), U = Qp / 16;
  const int MP = P / 8;
  const int tid = threadIdx.x;
  double* seg = smem;
  double* rowsum = seg + Qp;
  double* colpart = rowsum + Qp;  // [16][Qp]
  float* dts = reinterpret_cast<float*>(colpart + 16 * Qp);
  float* rem = dts + Qp;
  float* cg = rem + Qp;
  float* bs = cg + Qp * LG;  // B, later x
  float* dys = bs + Qp * LB;
  float* dhs = dys + Qp * LP;
  load_dt(p, ch, dts);
  load_f32(cg, LG, c_rows<T>(p, ch), p.c_ss, Qp, ch.cq, N);
  load_f32(bs, LN, b_rows<T>(p, ch), p.b_ss, Qp, ch.cq, N);
  load_f32(dys, LP, dy_rows<T>(p, ch), p.dy_ss, Qp, ch.cq, P);
  load_f32(dhs, LN, p.dh + ch.slot(p) * P * N, N, P, P, N);
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  const double total = seg[Qp - 1];
  for (int j = tid; j < Qp; j += THREADS)
    rem[j] = expf(static_cast<float>(total - seg[j]));
  // G = (C B^T) exp(seg_i - seg_j) over C
  decayed_products(cg, LG, bs, LN, N, Qp, seg, cg, LG);
  __syncthreads();

  // d(x dt) tile: rows j = 4 ry + k, columns p = py + 8 m
  const int ry = tid >> 3, py = tid & 7;
  const bool rows_live = 4 * ry < Qp;
  float dxdt[4][PMAX / 8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < PMAX / 8; ++m) dxdt[k][m] = 0.f;
  if (rows_live) {
    // the chunk state's term: exp(seg_last - seg_j) (dh_out B_j)[p]
    for (int n = 0; n < N; ++n) {
      float bv[4], hv[PMAX / 8];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = bs[(4 * ry + k) * LN + n];
#pragma unroll
      for (int m = 0; m < PMAX / 8; ++m)
        hv[m] = m < MP ? dhs[(py + 8 * m) * LN + n] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < PMAX / 8; ++m) dxdt[k][m] += bv[k] * hv[m];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float r = rem[4 * ry + k];
#pragma unroll
      for (int m = 0; m < PMAX / 8; ++m) dxdt[k][m] *= r;
    }
    // the intra-chunk term: sum_{i >= j} G[i][j] dy[i][p]
    for (int i = 4 * ry; i < Qp; ++i) {
      float gv[4], dv[PMAX / 8];
#pragma unroll
      for (int k = 0; k < 4; ++k) gv[k] = cg[i * LG + 4 * ry + k];
#pragma unroll
      for (int m = 0; m < PMAX / 8; ++m)
        dv[m] = m < MP ? dys[i * LP + py + 8 * m] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < PMAX / 8; ++m) dxdt[k][m] += gv[k] * dv[m];
    }
    T* dx = static_cast<T*>(p.dx) + ch.row(p, 0) * P;
    const long long dx_ss = static_cast<long long>(p.H) * P;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * ry + k;
      if (j < ch.cq) {
#pragma unroll
        for (int m = 0; m < PMAX / 8; ++m)
          if (m < MP) dx[j * dx_ss + py + 8 * m] = from_f<T>(dxdt[k][m] * dts[j]);
      }
    }
  }
  __syncthreads();  // done with B: x goes there
  float* xs = bs;
  load_f32(xs, LP, x_rows<T>(p, ch), p.x_ss, Qp, ch.cq, P);
  __syncthreads();
  // ddt's share: d(x dt)_j . x_j
  if (rows_live) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * ry + k;
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < PMAX / 8; ++m)
        if (m < MP) acc += dxdt[k][m] * xs[j * LP + py + 8 * m];
      acc = sum8(acc);
      if (py == 0 && j < ch.cq) p.ddt[ch.row(p, j)] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < Qp * P; e += THREADS) xs[(e / P) * LP + e % P] *= dts[e / P];
  __syncthreads();

  // M = (dy (x dt)^T) G on the lower triangle: row sums and column sums
  {
    const int gi = tid >> 4, gj = tid & 15;
    float d[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) d[u][v] = 0.f;
    for (int k = 0; k < P; ++k) {
      float dv[8], xv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) dv[u] = u < U ? dys[(gi + 16 * u) * LP + k] : 0.f;
#pragma unroll
      for (int v = 0; v < 8; ++v) xv[v] = v < U ? xs[(gj + 16 * v) * LP + k] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v <= u; ++v) d[u][v] += dv[u] * xv[v];
    }
    double rs[8], cs[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) rs[u] = cs[u] = 0.0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (u >= U) break;
#pragma unroll
      for (int v = 0; v <= u; ++v) {
        // G is 0 above the diagonal and past the live rows
        const double m = static_cast<double>(
            d[u][v] * cg[(gi + 16 * u) * LG + gj + 16 * v]);
        rs[u] += m;
        cs[v] += m;
      }
    }
    // rows gi + 16 u: over the 16 lanes of one gi, in a fixed order
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      double r = rs[u];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        r += __shfl_xor_sync(0xffffffffu, r, off);
      if (gj == 0 && u < U) rowsum[gi + 16 * u] = r;
    }
#pragma unroll
    for (int v = 0; v < 8; ++v)
      if (v < U) colpart[gi * Qp + gj + 16 * v] = cs[v];
  }
  __syncthreads();
  for (int j = tid; j < ch.cq; j += THREADS) {
    double col = 0.0;
    for (int g = 0; g < 16; ++g) col += colpart[g * Qp + j];
    p.dsegm[ch.row(p, j)] = rowsum[j] - col;
  }
}

// ---------------------------------------------------------------------------
// passes 4 and 5: dC and dB per head
// ---------------------------------------------------------------------------

// shared memory: seg (Qp doubles), dt and exp(seg) or exp(seg_last - seg)
// (Qp floats each), dy and x Qp x (P + 1) each and later B or C Qp x (N + 1)
// in their place, h_in or dh_out P x (N + 1), PD Qp x (Qp + 1), and the
// rows' u and 8 warps' sums (pass 5). At chunk 128, N 128, P 64: 168,224
// bytes.
__host__ __device__ inline size_t dbc_smem(int Qp, int P, int N) {
  return 8 * static_cast<size_t>(Qp) +
         4 * (3 * static_cast<size_t>(Qp) + 8 +
              static_cast<size_t>(Qp) * max_i(2 * (P + 1), N + 1) +
              static_cast<size_t>(P) * (N + 1) +
              static_cast<size_t>(Qp) * (Qp + 1));
}

// Rows 4 ry + k, columns n = py + 8 m of a Qp x N tile, m < N / 8 (<= 16):
// acc[k][m] = scale_r sum_p A[r][p] S[p][n] (S: P x N, row stride LN).
__device__ __forceinline__ void state_term(float (&acc)[4][NMAX / 8],
                                           const float* A, int la,
                                           const float* st, int ls, int P,
                                           int N, const float* scale) {
  const int ry = threadIdx.x >> 3, py = threadIdx.x & 7, MN = N / 8;
  for (int k2 = 0; k2 < P; ++k2) {
    float av[4], sv[NMAX / 8];
#pragma unroll
    for (int k = 0; k < 4; ++k) av[k] = A[(4 * ry + k) * la + k2];
#pragma unroll
    for (int m = 0; m < NMAX / 8; ++m)
      sv[m] = m < MN ? st[k2 * ls + py + 8 * m] : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < NMAX / 8; ++m) acc[k][m] += av[k] * sv[m];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float s = scale[4 * ry + k];
#pragma unroll
    for (int m = 0; m < NMAX / 8; ++m) acc[k][m] *= s;
  }
}

// sum_n acc[k][m] V[row][n] over the row group's 8 lanes (V in global
// memory, T, row stride vs), for each of the thread's 4 rows
template <typename T>
__device__ __forceinline__ void row_dots(const float (&acc)[4][NMAX / 8],
                                         const T* v, long long vs, int live,
                                         int N, float (&out)[4]) {
  const int ry = threadIdx.x >> 3, py = threadIdx.x & 7, MN = N / 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * ry + k;
    float s = 0.f;
    if (r < live) {
#pragma unroll
      for (int m = 0; m < NMAX / 8; ++m)
        if (m < MN) s += acc[k][m] * to_f(v[r * vs + py + 8 * m]);
    }
    out[k] = sum8(s);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) chunk_dc(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LP = P + 1, LN = N + 1, LQ = Qp + 1;
  const int MN = N / 8;
  const int tid = threadIdx.x;
  double* seg = smem;
  float* dts = reinterpret_cast<float*>(seg + Qp);
  float* eseg = dts + Qp;
  float* region = eseg + 2 * Qp + 8;
  float* dys = region;
  float* xs = region + Qp * LP;
  float* hs = region + Qp * max_i(2 * LP, LN);
  float* pd = hs + P * LN;
  load_dt(p, ch, dts);
  load_f32(dys, LP, dy_rows<T>(p, ch), p.dy_ss, Qp, ch.cq, P);
  load_f32(xs, LP, x_rows<T>(p, ch), p.x_ss, Qp, ch.cq, P);
  if (ch.ci > 0) load_f32(hs, LN, p.h_in() + ch.slot(p) * P * N, N, P, P, N);
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  for (int j = tid; j < Qp; j += THREADS)
    eseg[j] = expf(static_cast<float>(seg[j]));
  for (int e = tid; e < Qp * P; e += THREADS) xs[(e / P) * LP + e % P] *= dts[e / P];
  __syncthreads();
  // PD = (dy (x dt)^T) exp(seg_i - seg_j) on j <= i
  decayed_products(dys, LP, xs, LP, P, Qp, seg, pd, LQ);

  const int ry = tid >> 3, py = tid & 7;
  const bool rows_live = 4 * ry < Qp;
  float acc[4][NMAX / 8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < NMAX / 8; ++m) acc[k][m] = 0.f;
  // the carried state's term: exp(seg_i) (dy_i h_in)[n] (0 in chunk 0)
  if (ch.ci > 0 && rows_live) state_term(acc, dys, LP, hs, LN, P, N, eseg);
  {
    float dots[4];
    row_dots(acc, c_rows<T>(p, ch), p.c_ss, rows_live ? ch.cq : 0, N, dots);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (py == 0 && 4 * ry + k < ch.cq) p.carried[ch.row(p, 4 * ry + k)] = dots[k];
  }
  __syncthreads();  // done with dy and x: B goes there
  float* bs = region;
  load_f32(bs, LN, b_rows<T>(p, ch), p.b_ss, Qp, ch.cq, N);
  __syncthreads();
  if (rows_live) {
    const int jmax = min(4 * ry + 3, Qp - 1);
    for (int j = 0; j <= jmax; ++j) {
      float pv[4], bv[NMAX / 8];
#pragma unroll
      for (int k = 0; k < 4; ++k) pv[k] = pd[(4 * ry + k) * LQ + j];
#pragma unroll
      for (int m = 0; m < NMAX / 8; ++m) bv[m] = m < MN ? bs[j * LN + py + 8 * m] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < NMAX / 8; ++m) acc[k][m] += pv[k] * bv[m];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * ry + k;
      if (i < ch.cq) {
        float* out = p.dc_part + ch.row(p, i) * N;
#pragma unroll
        for (int m = 0; m < NMAX / 8; ++m)
          if (m < MN) out[py + 8 * m] = acc[k][m];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) chunk_db(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LP = P + 1, LN = N + 1, LQ = Qp + 1;
  const int MN = N / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double* seg = smem;
  float* dts = reinterpret_cast<float*>(seg + Qp);
  float* rem = dts + Qp;
  float* ub = rem + Qp;      // u_j
  float* red = ub + Qp;      // 8 warps' shares of dh_out . h_in
  float* region = red + 8;
  float* dys = region;
  float* xs = region + Qp * LP;
  float* dhs = region + Qp * max_i(2 * LP, LN);
  float* pd = dhs + P * LN;
  load_dt(p, ch, dts);
  load_f32(dys, LP, dy_rows<T>(p, ch), p.dy_ss, Qp, ch.cq, P);
  load_f32(xs, LP, x_rows<T>(p, ch), p.x_ss, Qp, ch.cq, P);
  load_f32(dhs, LN, p.dh + ch.slot(p) * P * N, N, P, P, N);
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  const double total = seg[Qp - 1];
  for (int j = tid; j < Qp; j += THREADS)
    rem[j] = expf(static_cast<float>(total - seg[j]));
  for (int e = tid; e < Qp * P; e += THREADS) xs[(e / P) * LP + e % P] *= dts[e / P];
  __syncthreads();
  decayed_products(dys, LP, xs, LP, P, Qp, seg, pd, LQ);

  const int ry = tid >> 3, py = tid & 7;
  const bool rows_live = 4 * ry < Qp;
  float acc[4][NMAX / 8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < NMAX / 8; ++m) acc[k][m] = 0.f;
  // the chunk state's term: exp(seg_last - seg_j) ((x dt)_j dh_out)[n]
  if (rows_live) state_term(acc, xs, LP, dhs, LN, P, N, rem);
  {
    float dots[4];
    row_dots(acc, b_rows<T>(p, ch), p.b_ss, rows_live ? ch.cq : 0, N, dots);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (py == 0 && rows_live) ub[4 * ry + k] = dots[k];
  }
  // exp(seg_last) dh_out . h_in (h_in is 0 in chunk 0)
  {
    float s = 0.f;
    if (ch.ci > 0) {
      const float* hin = p.h_in() + ch.slot(p) * P * N;
      for (int e = tid; e < P * N; e += THREADS)
        s += dhs[(e / N) * LN + e % N] * hin[e];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp] = s;
  }
  __syncthreads();  // done with dy and x: C goes there
  float* cs = region;
  load_f32(cs, LN, c_rows<T>(p, ch), p.c_ss, Qp, ch.cq, N);
  __syncthreads();
  if (rows_live) {
    for (int i = 4 * ry; i < Qp; ++i) {
      float pv[4], cv[NMAX / 8];
#pragma unroll
      for (int k = 0; k < 4; ++k) pv[k] = pd[i * LQ + 4 * ry + k];
#pragma unroll
      for (int m = 0; m < NMAX / 8; ++m) cv[m] = m < MN ? cs[i * LN + py + 8 * m] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < NMAX / 8; ++m) acc[k][m] += pv[k] * cv[m];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * ry + k;
      if (j < ch.cq) {
        float* out = p.db_part + ch.row(p, j) * N;
#pragma unroll
        for (int m = 0; m < NMAX / 8; ++m)
          if (m < MN) out[py + 8 * m] = acc[k][m];
      }
    }
  }
  if (warp != 0) return;

  // d(dt a) over the chunk's rows, warp 0, four rows a lane, in fp64
  float ends = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) ends += red[w];
  ends *= expf(static_cast<float>(total));
  double v[4], u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = lane * 4 + k;
    const bool live = r < ch.cq;
    v[k] = live ? p.dsegm[ch.row(p, r)] + p.carried[ch.row(p, r)] : 0.0;
    u[k] = r < Qp ? static_cast<double>(ub[r]) : 0.0;
  }
  // v's sum over rows >= r (suffix) and u's over rows < r (prefix)
  double suf[4], pre[4];
  suf[3] = v[3];
#pragma unroll
  for (int k = 2; k >= 0; --k) suf[k] = suf[k + 1] + v[k];
  pre[0] = 0.0;
#pragma unroll
  for (int k = 1; k < 4; ++k) pre[k] = pre[k - 1] + u[k - 1];
  const double vt = suf[0], ut = pre[3] + u[3];
  double after = vt, before = ut;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double ta = __shfl_down_sync(0xffffffffu, after, off);
    const double tb = __shfl_up_sync(0xffffffffu, before, off);
    if (lane + off < 32) after += ta;
    if (lane >= off) before += tb;
  }
  after -= vt;   // rows of the lanes after this one
  before -= ut;  // rows of the lanes before this one
  double share = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = lane * 4 + k;
    const double dda = after + suf[k] + before + pre[k] + ends;
    if (r < ch.cq) {
      p.ddt[ch.row(p, r)] += static_cast<float>(dda) * ch.a;
      share += dda * static_cast<double>(dts[r]) * ch.a;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    share += __shfl_xor_sync(0xffffffffu, share, off);
  if (lane == 0) p.alog_part[ch.slot(p)] = share;
}

// ---------------------------------------------------------------------------
// passes 6 and 7: sums over the heads and over the chunks
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) reduce_heads(Params p) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long total = static_cast<long long>(p.B) * p.S * p.N;
  if (e >= total) return;
  const long long row = e / p.N, n = e % p.N;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < p.H; ++h) {
    const long long at = (row * p.H + h) * p.N + n;
    sb += p.db_part[at];
    sc += p.dc_part[at];
  }
  static_cast<T*>(p.db)[e] = from_f<T>(sb);
  static_cast<T*>(p.dc)[e] = from_f<T>(sc);
}

// one warp per head
__global__ void reduce_alog(Params p) {
  const int hi = blockIdx.x, lane = threadIdx.x;
  double s = 0.0;
  for (int i = lane; i < p.B * p.NC; i += 32)
    s += p.alog_part[static_cast<long long>(i) * p.H + hi];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.da_log[hi] = static_cast<float>(s);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, size_t bytes,
                       const Params& p, cudaStream_t stream) {
  if (bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Params& p, cudaStream_t s) {
  const int Qp = round16(p.Q);
  const dim3 chunks(p.B * p.NC, p.H);
  const dim3 states(p.B * p.H, (p.P * p.N / 4 + THREADS - 1) / THREADS);
  const long long outs = static_cast<long long>(p.B) * p.S * p.N;
  cudaError_t err = launch_one(chunk_dstate<T>, chunks, THREADS,
                               dstate_smem(Qp, p.P, p.N), p, s);
  if (!err) err = launch_one(state_pass, states, THREADS, 0, p, s);
  if (!err)
    err = launch_one(chunk_dx<T>, chunks, THREADS, dx_smem(Qp, p.P, p.N), p, s);
  if (!err)
    err = launch_one(chunk_dc<T>, chunks, THREADS, dbc_smem(Qp, p.P, p.N), p, s);
  if (!err)
    err = launch_one(chunk_db<T>, chunks, THREADS, dbc_smem(Qp, p.P, p.N), p, s);
  if (!err)
    err = launch_one(reduce_heads<T>,
                     dim3(static_cast<unsigned>((outs + THREADS - 1) / THREADS)),
                     THREADS, 0, p, s);
  if (!err) err = launch_one(reduce_alog, dim3(p.H), 32, 0, p, s);
  return err;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

int ssd_scan_bwd_abi(void) { return 1; }

// dtype (of x, B, C, dy, dx, dB and dC): 0 = float32, 1 = bfloat16. x, dt,
// a_log, b, c and chunk as ssd_scan_fwd takes them; dy: (B, S, H, P) with
// unit stride over P and the given element strides; dh_final: contiguous
// fp32 (B, H, P, N), 16-byte aligned, or null (zeros); fwd_workspace: the
// workspace of the forward call on the same inputs and chunk, as it left
// it. dx: contiguous (B, S, H, P); ddt: contiguous fp32 (B, S, H); da_log:
// fp32 (H,); db, dc: contiguous (B, S, N). workspace: 16-byte aligned, of
// the wrapper's bwd_workspace_numel floats. Returns the CUDA error code of
// the first pass that failed (0 = ok).
int ssd_scan_bwd(const void* x, const float* dt, const float* a_log,
                 const void* b, const void* c, const void* dy,
                 const float* dh_final, const float* fwd_workspace, void* dx,
                 float* ddt, float* da_log, void* db, void* dc,
                 float* workspace, int dtype, int B, int S, int H, int P,
                 int N, int chunk, long long x_sb, long long x_ss,
                 long long x_sh, long long dt_sb, long long dt_ss,
                 long long dt_sh, long long b_sb, long long b_ss,
                 long long c_sb, long long c_ss, long long dy_sb,
                 long long dy_ss, long long dy_sh, void* stream) {
  const int NC = chunk >= 1 ? (S + chunk - 1) / chunk : 0;
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > QMAX ||
      (P != 16 && P != 32 && P != 64) ||
      (N != 16 && N != 32 && N != 64 && N != 128) || H > 65535 ||
      static_cast<long long>(B) * NC > INT_MAX ||
      static_cast<long long>(B) * H > INT_MAX ||
      static_cast<long long>(B) * S * N / THREADS > INT_MAX || dtype < 0 ||
      dtype > 1 || !aligned16(workspace) || !aligned16(fwd_workspace) ||
      (dh_final != nullptr && !aligned16(dh_final)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the forward's workspace: its states, for bf16 its bf16 incoming states,
  // then the seg totals (ssd_scan.cu)
  const long long n_state = static_cast<long long>(B) * NC * H * P * N;
  const long long rows = static_cast<long long>(B) * S * H;
  const float* totals = fwd_workspace + n_state + (dtype == 1 ? n_state / 2 : 0);
  // this one's: dh_out, for bf16 the fp32 incoming states, the fp64 sums
  // (M's rows less columns, the blocks' da_log shares), the carried term,
  // the per-head dB and dC
  float* dh = workspace;
  float* h_in32 = dtype == 1 ? dh + n_state : nullptr;
  double* dsegm = reinterpret_cast<double*>(dh + n_state * (dtype == 1 ? 2 : 1));
  double* alog_part = dsegm + rows;
  float* carried = reinterpret_cast<float*>(alog_part + static_cast<long long>(B) * NC * H);
  float* db_part = carried + rows;
  float* dc_part = db_part + rows * N;
  const Params p{x, dt, a_log, b, c, dy, dh_final, fwd_workspace, totals,
                 h_in32, dh, dsegm, alog_part, carried, db_part, dc_part,
                 dx, ddt, db, dc, da_log, B, S, H, P, N, chunk, NC,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb,
                 c_ss, dy_sb, dy_ss, dy_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? run<float>(p, s) : run<bf16>(p, s);
  return static_cast<int>(err);
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
