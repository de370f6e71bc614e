// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// The gradients (dx, ddt, da_log, dB, dC) of the forward in ssd_scan.cu,
// given dy and optionally the final state's gradient dh_final. The Pallas
// TPU kernel src/repro/kernels/ssd/kernel.py (ssd_scan) has no backward: the
// reference trains through XLA's autodiff of its plain chunked scan
// (src/repro/models/ssm.py, ssd_chunked). This kernel reverses the chunked
// algorithm the forward runs, per (batch, head), with a = -exp(A_log),
// seg = cumsum(dt a) within a chunk, S = C B^T (shared by the heads: B and C
// are one group), L = exp(seg_i - seg_j) on j <= i, G = S L and
// PD = (dy (x dt)^T) L (ref.py's ssd_bwd_passes is its plain mirror):
//
//   Sd        = sum_i exp(seg_i) dy_i^T C_i, each chunk's own share of its
//               incoming state's gradient
//   dh_out[c] = dh_in[c + 1] (dh_final for the last chunk), in reverse over
//               the chunks: dh_in[c] = exp(seg_last) dh_out[c] + Sd[c]
//   d(x dt)   = G^T dy + exp(seg_last - seg) B dh_out^T, which gives
//               dx = d(x dt) dt and ddt's share d(x dt) . x
//   dC        = sum over heads of PD B + exp(seg) dy h_in
//   dB        = sum over heads of PD^T C + exp(seg_last - seg) (x dt) dh_out
//   d(dt a)_k = sum_{i >= k} (M's row sums less its column sums, M = PD S,
//               + the carried term C_i . (exp(seg_i) dy_i h_in))_i
//               + exp(seg_last) dh_out . h_in + sum_{j < k} u_j, with
//               u_j = B_j . (exp(seg_last - seg_j) (x dt)_j dh_out)
//   ddt      += d(dt a) a;  da_log = sum d(dt a) dt a.
//
// d(dt a) is summed in fp64 in its exclusive form (each exponent's own
// rows): M's row and column sums, the carried term and the u_j; in fp32
// those sums cancel by 1e-5 of da_log. Every sum runs in a fixed order,
// without atomics: the gradients are the same bits on every run.
//
// What bounds it on this card: the function reads x, dy, B, C and dt and
// writes dx, dB, dC, ddt and da_log once; at mamba2-130m's train shape (B 8,
// S 2048, H 24, P 64, N 128, chunk 128) in bf16 that is 171 MB, 0.051 ms
// at 3.35 TB/s, and its products at their least are 45 GFLOP, 0.046 ms at
// 989 TFLOP/s: bound by bytes. Beyond those bytes the state gradients make a
// round trip through device memory (Sd in fp32, dh_out in bf16), and the
// forward's incoming states are read back: about 0.3 GB there.
//
// Two routes, by type:
//  - bf16 (the training path), four kernels:
//    1. chunk_dstate_bf16, per (batch, chunk, head): Sd on the tensor cores,
//       with the forward's chunk-state tiling (dy's rows scaled by exp(seg),
//       rounded once).
//    2. state_pass, per 4 state elements of a (batch, head), sequential over
//       the chunks in fp32; dh_out is stored in bf16, the only way pass 3
//       reads it.
//    3. chunk_bwd_bf16, one block of 8 warps per (batch, chunk), walking the
//       heads in order: every product on the tensor cores (mma.sync
//       m16n8k16, bf16 operands by ldmatrix, fp32 accumulate). S is formed
//       once per block and kept in fp32 in shared memory. Warp w owns rows
//       [16 w, 16 w + 16) in two roles: as rows j over the tiles i >= j
//       (d(x dt) += G^T dy, PD^T = (x dy^T) dt L, dB += PD^T C) and as rows i
//       over the tiles j <= i (PD = (dy x^T) dt L, dC += PD B): nine 16 x 16
//       tiles for every warp. The state terms (dy h_in, x dh_out,
//       B dh_out^T) come first. M's column sums are the rows-as-j role's own
//       row sums, its row sums the rows-as-i role's (S read from the S^T
//       tiles), each summed in one thread and its quad in a fixed order. dx
//       is written per head; dB and dC are summed over the heads in
//       registers, in head order, and written once: no per-head partial
//       leaves the chip. The next head's x and dy load (cp.async, two
//       buffers) while this head computes, its incoming state and dh_out
//       while the triangles run. The last warp, whose rows-as-j role is the
//       shortest, also loads the next head's dt and scans its seg, and sums
//       the previous head's d(dt a) into ddt and da_log's share, so that two
//       barriers a head suffice. Each fp32 factor (dt, the decays) goes into
//       the operand that is not an input, rounded once: G and PD; dy x^T and
//       C B^T are products of inputs and stay fp32, so M is fp32 and its sums
//       fp64. The incoming states are the forward's, in bf16 (its pass 2
//       rounds them for its own product). 226 KB of shared memory and 255
//       registers a thread leave 8 warps an SM to hide the products'
//       latencies.
//    4. reduce_alog: da_log over the (batch, chunk) shares, in order.
//  - fp32: seven kernels on the CUDA cores in fp32 (TF32 would miss the fp32
//    checks at 1e-4), with the forward's fp32 tiling: chunk_dstate, the same
//    state_pass (dh_out in place over Sd, in fp32), chunk_dx (d(x dt), M's
//    row less column sums), chunk_dc and chunk_db (dC and dB per head, the
//    carried term, d(dt a)), reduce_heads (dB and dC over the heads) and
//    reduce_alog. Their incoming states are the forward's fp32 ones.
//
// Ragged sequences are masked as in the forward: rows past S load as zeros
// and are not written. x, B, C, dt and dy are read through element strides
// (16 bytes at a time where the rows are aligned so); the outputs are
// contiguous. The kernels launch on the caller's stream and allocate
// nothing: the wrapper passes the workspace (ssd/kernel.py's
// bwd_workspace_numel). The small helpers (the chunk's seg, its rows, the
// tensor-core fragments) repeat the forward's: each source builds on its own.
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
constexpr float LOG2E = 1.4426950408889634f;

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
  const bf16* h_in16;        // bf16: the forward's (B, NC, H, P, N) h_in
  const float* totals;       // forward's workspace: (B, NC, H) seg_last
  float* dh;                 // (B, NC, H, P, N): Sd, then (fp32) dh_out
  bf16* dh16;                // bf16: (B, NC, H, P, N) dh_out; else null
  double* dsegm;             // fp32: (B, S, H) M's row less column sums
  double* alog_part;         // (B, NC, H): each block's share of da_log
  float* carried;            // fp32: (B, S, H) C_i . dC_i's carried part
  float* db_part;            // fp32: (B, S, H, N)
  float* dc_part;            // fp32: (B, S, H, N)
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
  int vec;  // 1: x, B, C and dy rows can be read 16 bytes at a time
};

__host__ __device__ constexpr int round16(int q) { return (q + 15) & ~15; }

// Rows [0, rows) of an fp32 (rows, cols) matrix at src (row stride ss
// elements, unit column stride) into shared memory at dst (row stride ld);
// rows in [live, rows) as zeros. BATCH loads in flight a thread.
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* src,
                                         long long ss, int rows, int live,
                                         int cols) {
  const int total = rows * cols;
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * blockDim.x) {
    float v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * blockDim.x, r = e / cols;
      v[k] = e < total && r < live ? src[r * ss + e % cols] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < total) dst[(e / cols) * ld + e % cols] = v[k];
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; zeros when
// !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [0, rows) of a bf16 (rows, cols) matrix at src (row
// stride ss elements, unit column stride) into shared memory at dst (row
// stride ld); rows in [live, rows) as zeros. Rows aligned to 16 bytes go by
// cp.async (the caller waits with cp_async_wait_all); the rest through
// registers, BATCH loads in flight a thread, done on return.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long ss, int rows, int live,
                                          int cols, bool vec) {
  if (vec) {
    const int per_row = cols / 8;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, cv = (e % per_row) * 8;
      cp_async16(dst + r * ld + cv, src + (r < live ? r * ss + cv : 0),
                 r < live);
    }
    return;
  }
  const int total = rows * cols;
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * blockDim.x) {
    bf16 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * blockDim.x, r = e / cols;
      v[k] = e < total && r < live ? src[r * ss + e % cols]
                                   : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < total) dst[(e / cols) * ld + e % cols] = v[k];
    }
  }
}

// seg[j] = sum_{i <= j} fp32(dt_i a) in fp64 for j < Qp (<= 128), as the
// forward sums it; rows past the live ones have dt 0, so seg[Qp - 1] is the
// chunk's total. Warp 0 scans, four rows a lane.
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

// The chunk of a block of grid (B x NC, H): batch bi, chunk ci, head hi,
// rows [s0, s0 + cq)
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

// Sum over the 4 lanes of one mma row (lanes 4 g .. 4 g + 3)
template <typename V>
__device__ __forceinline__ V sum4(V v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf16x2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores
// ---------------------------------------------------------------------------

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
// fp32, pass 1: each chunk's share of its incoming state's gradient
// ---------------------------------------------------------------------------

// shared memory: seg (Qp doubles), dt and exp(seg) (Qp floats each), dy
// Qp x (P + 1), C Qp x (N + 1)
__host__ __device__ inline size_t dstate_smem(int Qp, int P, int N) {
  return 8 * Qp + 4 * (2 * Qp + static_cast<size_t>(Qp) * (P + 1) +
                       static_cast<size_t>(Qp) * (N + 1));
}

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
  load_f32(dys, LP, dy_rows<float>(p, ch), p.dy_ss, Qp, ch.cq, P);
  load_f32(cs, LN, c_rows<float>(p, ch), p.c_ss, Qp, ch.cq, N);
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
// pass 2 (both types): the states' gradients
// ---------------------------------------------------------------------------

// grid (B * H, P N / (4 * THREADS) rounded up): each thread walks the
// chunks in reverse for 4 neighbouring state elements, the next chunk's
// loads issued before this chunk's store. dh_out goes over Sd in fp32, or
// into dh16 in bf16.
__global__ void __launch_bounds__(THREADS) state_pass(Params p) {
  const int bi = blockIdx.x / p.H, hi = blockIdx.x % p.H;
  const int pn = p.P * p.N;
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  if (e >= pn) return;
  const long long slot0 = static_cast<long long>(bi) * p.NC * p.H + hi;
  auto at = [&](int ci) { return (slot0 + static_cast<long long>(ci) * p.H) *
                                 pn + e; };
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.dh_final != nullptr)
    g = *reinterpret_cast<const float4*>(
        p.dh_final + (static_cast<long long>(bi) * p.H + hi) * pn + e);
  float4 sd_next = *reinterpret_cast<const float4*>(p.dh + at(p.NC - 1));
  float t_next = p.totals[slot0 + (p.NC - 1) * p.H];
  for (int ci = p.NC - 1; ci >= 0; --ci) {
    const float4 sd = sd_next;
    const float et = expf(t_next);
    if (ci > 0) {
      sd_next = *reinterpret_cast<const float4*>(p.dh + at(ci - 1));
      t_next = p.totals[slot0 + (ci - 1) * p.H];
    }
    if (p.dh16 != nullptr) {  // dh_out[ci], rounded for pass 3's products
      uint2 packed;
      packed.x = pack_bf16(g.x, g.y);
      packed.y = pack_bf16(g.z, g.w);
      *reinterpret_cast<uint2*>(p.dh16 + at(ci)) = packed;
    } else {
      *reinterpret_cast<float4*>(p.dh + at(ci)) = g;
    }
    g.x = g.x * et + sd.x;
    g.y = g.y * et + sd.y;
    g.z = g.z * et + sd.z;
    g.w = g.w * et + sd.w;
  }
}

// ---------------------------------------------------------------------------
// fp32, pass 3: d(x dt) -> dx and ddt's share; M's row less column sums
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
  load_f32(cg, LG, c_rows<float>(p, ch), p.c_ss, Qp, ch.cq, N);
  load_f32(bs, LN, b_rows<float>(p, ch), p.b_ss, Qp, ch.cq, N);
  load_f32(dys, LP, dy_rows<float>(p, ch), p.dy_ss, Qp, ch.cq, P);
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
    float* dx = static_cast<float*>(p.dx) + ch.row(p, 0) * P;
    const long long dx_ss = static_cast<long long>(p.H) * P;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * ry + k;
      if (j < ch.cq) {
#pragma unroll
        for (int m = 0; m < PMAX / 8; ++m)
          if (m < MP) dx[j * dx_ss + py + 8 * m] = dxdt[k][m] * dts[j];
      }
    }
  }
  __syncthreads();  // done with B: x goes there
  float* xs = bs;
  load_f32(xs, LP, x_rows<float>(p, ch), p.x_ss, Qp, ch.cq, P);
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
// fp32, passes 4 and 5: dC and dB per head
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
__device__ __forceinline__ void row_dots(const float (&acc)[4][NMAX / 8],
                                         const float* v, long long vs, int live,
                                         int N, float (&out)[4]) {
  const int ry = threadIdx.x >> 3, py = threadIdx.x & 7, MN = N / 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * ry + k;
    float s = 0.f;
    if (r < live) {
#pragma unroll
      for (int m = 0; m < NMAX / 8; ++m)
        if (m < MN) s += acc[k][m] * v[r * vs + py + 8 * m];
    }
    out[k] = sum8(s);
  }
}

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
  load_f32(dys, LP, dy_rows<float>(p, ch), p.dy_ss, Qp, ch.cq, P);
  load_f32(xs, LP, x_rows<float>(p, ch), p.x_ss, Qp, ch.cq, P);
  if (ch.ci > 0) load_f32(hs, LN, p.fwd_states + ch.slot(p) * P * N, N, P, P, N);
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
    row_dots(acc, c_rows<float>(p, ch), p.c_ss, rows_live ? ch.cq : 0, N, dots);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (py == 0 && 4 * ry + k < ch.cq) p.carried[ch.row(p, 4 * ry + k)] = dots[k];
  }
  __syncthreads();  // done with dy and x: B goes there
  float* bs = region;
  load_f32(bs, LN, b_rows<float>(p, ch), p.b_ss, Qp, ch.cq, N);
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
  load_f32(dys, LP, dy_rows<float>(p, ch), p.dy_ss, Qp, ch.cq, P);
  load_f32(xs, LP, x_rows<float>(p, ch), p.x_ss, Qp, ch.cq, P);
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
    row_dots(acc, b_rows<float>(p, ch), p.b_ss, rows_live ? ch.cq : 0, N, dots);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (py == 0 && rows_live) ub[4 * ry + k] = dots[k];
  }
  // exp(seg_last) dh_out . h_in (h_in is 0 in chunk 0)
  {
    float s = 0.f;
    if (ch.ci > 0) {
      const float* hin = p.fwd_states + ch.slot(p) * P * N;
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
  load_f32(cs, LN, c_rows<float>(p, ch), p.c_ss, Qp, ch.cq, N);
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
// fp32, pass 6: dB and dC over the heads; both types: da_log over the chunks
// ---------------------------------------------------------------------------

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
  static_cast<float*>(p.db)[e] = sb;
  static_cast<float*>(p.dc)[e] = sc;
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
// bf16: the products on the tensor cores
// ---------------------------------------------------------------------------

// Two bf16 (low, high) times (w.x, w.y) in fp32, rounded to bf16 once.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float2 w) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16(f.x * w.x, f.y * w.y);
}

// 2^x (the hardware's approximation, relative error 2^-22; 0 for -inf)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives row l / 4, columns 2 (l % 4) + {0, 1} of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: lane l receives rows 2 (l % 4) + {0, 1}, column
// l / 4 of each matrix.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row major) * b (16x8, column major), fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Operand loads for a warp, from bf16 shared memory with row stride ld:
// the A operand (16 x 16, rows m, columns k) from a row-major tile at p
// (m rows, k contiguous), ...
__device__ __forceinline__ void a_rows(uint32_t (&r)[4], const bf16* p,
                                       int ld) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  ldsm_x4(r, p + (lr + 8 * (lm & 1)) * ld + 8 * (lm >> 1));
}
// ... the B operands of two n8 tiles (k 16 x n 16) from n rows with k
// contiguous (r[0], r[1]: n 0-7; r[2], r[3]: n 8-15), ...
__device__ __forceinline__ void b_rows(uint32_t (&r)[4], const bf16* p,
                                       int ld) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  ldsm_x4(r, p + (lr + 8 * (lm >> 1)) * ld + 8 * (lm & 1));
}
// ... and the same from k rows with n contiguous.
__device__ __forceinline__ void b_cols(uint32_t (&r)[4], const bf16* p,
                                       int ld) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  ldsm_x4_t(r, p + (lr + 8 * (lm & 1)) * ld + 8 * (lm >> 1));
}

// Two 16 x 8 fp32 accumulator tiles (columns 0-7, 8-15) as the bf16 A
// operand of the next product: each value rounded once.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// ---------------------------------------------------------------------------
// bf16, pass 1: each chunk's share of its incoming state's gradient
// ---------------------------------------------------------------------------

// shared memory: seg (Qp doubles), dt and exp(seg) (Qp floats each), then in
// bf16 with rows padded by 16 bytes (ldmatrix rows hit distinct banks): dy
// Qp x (P + 8), C Qp x (N + 8)
__host__ __device__ inline size_t dstate_smem_bf16(int Qp, int P, int N) {
  return 16 * Qp + 2 * (static_cast<size_t>(Qp) * (P + 8) +
                        static_cast<size_t>(Qp) * (N + 8));
}

__global__ void __launch_bounds__(THREADS) chunk_dstate_bf16(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LX = P + 8, LB = N + 8;
  const int tid = threadIdx.x;
  double* seg = smem;
  float* dts = reinterpret_cast<float*>(seg + Qp);
  float* w = dts + Qp;
  bf16* dys = reinterpret_cast<bf16*>(w + Qp);
  bf16* cs = dys + Qp * LX;
  load_dt(p, ch, dts);
  load_rows(dys, LX, dy_rows<bf16>(p, ch), p.dy_ss, Qp, ch.cq, P, p.vec);
  load_rows(cs, LB, c_rows<bf16>(p, ch), p.c_ss, Qp, ch.cq, N, p.vec);
  cp_async_wait_all();
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  for (int j = tid; j < Qp; j += THREADS)
    w[j] = expf(static_cast<float>(seg[j]));
  __syncthreads();

  // Sd (P x N) = (dy w)^T C over the chunk's rows: warp -> 16 rows of P
  // (warp % 4) and half of N (warp / 4)
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int pt = warp & 3, n_base = (warp >> 2) * (N / 2);
  const int NT = N / 16;  // n8 tiles in half of N
  if (pt >= P / 16) return;
  float acc[NMAX / 16][4];
#pragma unroll
  for (int i = 0; i < NMAX / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int k0 = 0; k0 < Qp; k0 += 16) {
    uint32_t a[4];  // A[p][i] = dy[i][p]: transposed from (i, p) rows
    ldsm_x4_t(a, dys + (k0 + lr + 8 * (lm >> 1)) * LX + pt * 16 + 8 * (lm & 1));
    // the factor goes into dy, rounded to bf16 once: a[0], a[1] hold rows
    // i = k0 + 2 t (+1), a[2], a[3] rows i + 8 (+1)
    const float2 w0 = make_float2(w[k0 + 2 * t], w[k0 + 2 * t + 1]);
    const float2 w8 = make_float2(w[k0 + 2 * t + 8], w[k0 + 2 * t + 9]);
    a[0] = scale_bf16x2(a[0], w0);
    a[1] = scale_bf16x2(a[1], w0);
    a[2] = scale_bf16x2(a[2], w8);
    a[3] = scale_bf16x2(a[3], w8);
#pragma unroll
    for (int nt = 0; nt < NMAX / 16; nt += 2) {
      if (nt < NT) {
        uint32_t bb[4];  // C[i][n], (i, n) rows: two n8 tiles
        b_cols(bb, cs + k0 * LB + n_base + nt * 8, LB);
        mma_16816(acc[nt], a, bb[0], bb[1]);
        mma_16816(acc[nt + 1], a, bb[2], bb[3]);
      }
    }
  }
  float* out = p.dh + ch.slot(p) * P * N;
  const int r = pt * 16 + g;
#pragma unroll
  for (int nt = 0; nt < NMAX / 16; ++nt) {
    if (nt < NT) {
      const int n = n_base + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + r * N + n) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * N + n) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, pass 3: every gradient of a (batch, chunk), walking the heads
// ---------------------------------------------------------------------------

// The block's last warp also keeps the books: it loads the next head's dt,
// scans its seg, and sums the previous head's d(dt a), while the others
// run their triangles (the rows-as-j role of row tile 0 is the longest).
constexpr int TAIL = THREADS / 32 - 1;

// Shared memory of chunk_bwd_bf16, byte offsets, each 16-byte aligned: the
// S^T tiles (fp32, 1 KB each: U (U + 1) / 2 of them for U = Qp / 16 row
// tiles); by head parity, seg and M's row and column sums (fp64, Qp each),
// the carried term, u and ddt's share (fp32, Qp each) and the warps' shares
// of dh_out . h_in (8 floats); dt (three buffers of Qp floats); then in
// bf16 with rows padded by 16 bytes: C and B (Qp x (N + 8) each), x and dy
// (two buffers each, Qp x (P + 8)), h_in and dh_out (P x (N + 8) each). At
// chunk 128, P 64, N 128: 225,856 bytes, one block per SM.
struct BwdSmem {
  int st, seg, rowsum, colsum, carried, u, share, ends, dt;
  int c, b, x, dy, hin, dho, total;
  __host__ __device__ BwdSmem(int Qp, int P, int N) {
    const int U = Qp / 16, LB = N + 8, LX = P + 8;
    int o = 0;
    st = o;
    o += U * (U + 1) / 2 * 1024;
    seg = o;
    o += 2 * 8 * Qp;
    rowsum = o;
    o += 2 * 8 * Qp;
    colsum = o;
    o += 2 * 8 * Qp;
    carried = o;
    o += 2 * 4 * Qp;
    u = o;
    o += 2 * 4 * Qp;
    share = o;
    o += 2 * 4 * Qp;
    ends = o;
    o += 2 * 32;
    dt = o;
    o += 3 * 4 * Qp;
    o = (o + 15) & ~15;
    c = o;
    o += 2 * Qp * LB;
    b = o;
    o += 2 * Qp * LB;
    x = o;
    o += 4 * Qp * LX;
    dy = o;
    o += 4 * Qp * LX;
    hin = o;
    o += 2 * P * LB;
    dho = o;
    o += 2 * P * LB;
    total = o;
  }
};

// the S^T tile of rows j in tile jt and columns i in tile it >= jt; its
// element (h2, e) of lane l (the mma accumulator layout) at slot 4 h2 + e
// of the lane
__device__ __forceinline__ int tile_at(int it, int jt) {
  return (it * (it + 1) / 2 + jt) * 256;
}

// The tail warp: seg = cumsum(dt a) (fp64) of a head's rows from their dt
// (rows 4 lane .. 4 lane + 3 in dtv, zeros past the live ones), into seg
// and dts.
__device__ __forceinline__ void tail_seg(const float (&dtv)[4], float a,
                                         int Qp, double* seg, float* dts) {
  const int lane = threadIdx.x & 31;
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += static_cast<double>(dtv[k] * a);
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
    if (j < Qp) {
      seg[j] = before + v[k];
      dts[j] = dtv[k];
    }
  }
}

// The tail warp: head h's dt rows into registers (zeros past the live ones)
__device__ __forceinline__ void tail_dt(const Params& p, int bi, int h,
                                        int s0, int cq, float (&dtv)[4]) {
  const int lane = threadIdx.x & 31;
  const float* dt = p.dt + bi * p.dt_sb + h * p.dt_sh;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = lane * 4 + k;
    dtv[k] = j < cq ? dt[static_cast<long long>(s0 + j) * p.dt_ss] : 0.f;
  }
}

// The tail warp: d(dt a) over a head's rows, four rows a lane, in fp64:
// v_k = M's row less column sum + the carried term, summed over rows >= k;
// u summed over rows < k; the chunk state's term. Writes ddt and the
// block's share of da_log.
__device__ __forceinline__ void tail_dda(
    const Params& p, int h, int ci, int cq, long long row0, long long slot,
    const double* seg, const double* rowsum, const double* colsum,
    const float* carried, const float* ub, const float* share,
    const float* ends, const float* dts, int Qp) {
  const int lane = threadIdx.x & 31;
  const float a = -expf(p.a_log[h]);
  float e_sum = 0.f;
  if (ci > 0) {
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) e_sum += ends[w];
    e_sum *= expf(static_cast<float>(seg[Qp - 1]));
  }
  double v[4], u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = lane * 4 + k;
    v[k] = u[k] = 0.0;
    if (row < cq) {
      v[k] = rowsum[row] - colsum[row] + static_cast<double>(carried[row]);
      u[k] = static_cast<double>(ub[row]);
    }
  }
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
  double alog = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = lane * 4 + k;
    const double dda = after + suf[k] + before + pre[k] + e_sum;
    if (row < cq) {
      p.ddt[(row0 + row) * p.H + h] = share[row] + static_cast<float>(dda) * a;
      alog += dda * static_cast<double>(dts[row]) * a;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    alog += __shfl_xor_sync(0xffffffffu, alog, off);
  if (lane == 0) p.alog_part[slot + h] = alog;
}

__global__ void __launch_bounds__(THREADS, 1) chunk_bwd_bf16(Params p) {
  extern __shared__ double smem[];
  char* base = reinterpret_cast<char*>(smem);
  const int Qp = round16(p.Q), P = p.P, N = p.N, LX = P + 8, LB = N + 8;
  const int U = Qp / 16, KP = P / 16, KN = N / 16;
  const BwdSmem at(Qp, P, N);
  float* sts = reinterpret_cast<float*>(base + at.st);
  double* segb = reinterpret_cast<double*>(base + at.seg);
  double* rowsumb = reinterpret_cast<double*>(base + at.rowsum);
  double* colsumb = reinterpret_cast<double*>(base + at.colsum);
  float* carriedb = reinterpret_cast<float*>(base + at.carried);
  float* ubb = reinterpret_cast<float*>(base + at.u);
  float* shareb = reinterpret_cast<float*>(base + at.share);
  float* endsb = reinterpret_cast<float*>(base + at.ends);
  float* dtb = reinterpret_cast<float*>(base + at.dt);
  bf16* cs = reinterpret_cast<bf16*>(base + at.c);
  bf16* bs = reinterpret_cast<bf16*>(base + at.b);
  bf16* xb = reinterpret_cast<bf16*>(base + at.x);
  bf16* dyb = reinterpret_cast<bf16*>(base + at.dy);
  bf16* hs = reinterpret_cast<bf16*>(base + at.hin);
  bf16* dhs = reinterpret_cast<bf16*>(base + at.dho);

  const int bi = blockIdx.x / p.NC, ci = blockIdx.x % p.NC;
  const int s0 = ci * p.Q, cq = min(p.Q, p.S - s0);
  const long long row0 = static_cast<long long>(bi) * p.S + s0;
  const long long slot0 = (static_cast<long long>(bi) * p.NC + ci) * p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // warp r owns the chunk's rows [16 r, 16 r + 16): this thread's lo and hi
  const int r = warp;
  const bool live = r < U;
  const int lo = 16 * r + g, hi = lo + 8;

  // x and dy of head h into buffer buf; h_in and dh_out of head h
  auto load_head = [&](int h, int buf) {
    load_rows(xb + buf * Qp * LX, LX,
              static_cast<const bf16*>(p.x) + bi * p.x_sb + h * p.x_sh +
                  s0 * p.x_ss,
              p.x_ss, Qp, cq, P, p.vec);
    load_rows(dyb + buf * Qp * LX, LX,
              static_cast<const bf16*>(p.dy) + bi * p.dy_sb + h * p.dy_sh +
                  s0 * p.dy_ss,
              p.dy_ss, Qp, cq, P, p.vec);
  };
  auto load_states = [&](int h) {
    if (ci > 0)  // h_in is 0 in chunk 0
      load_rows(hs, LB, p.h_in16 + (slot0 + h) * P * N, N, P, P, N, true);
    load_rows(dhs, LB, p.dh16 + (slot0 + h) * P * N, N, P, P, N, true);
  };
  // the tail warp's d(dt a) of head h (its sums are in buffer h & 1)
  auto dda = [&](int h) {
    const int pb = h & 1;
    tail_dda(p, h, ci, cq, row0, slot0, segb + pb * Qp, rowsumb + pb * Qp,
             colsumb + pb * Qp, carriedb + pb * Qp, ubb + pb * Qp,
             shareb + pb * Qp, endsb + pb * 8, dtb + (h % 3) * Qp, Qp);
  };

  load_rows(cs, LB, static_cast<const bf16*>(p.c) + bi * p.c_sb + s0 * p.c_ss,
            p.c_ss, Qp, cq, N, p.vec);
  load_rows(bs, LB, static_cast<const bf16*>(p.b) + bi * p.b_sb + s0 * p.b_ss,
            p.b_ss, Qp, cq, N, p.vec);
  load_head(0, 0);
  load_states(0);
  float dtv[4];  // the tail warp: the next head's dt
  if (warp == TAIL) {
    tail_dt(p, bi, 0, s0, cq, dtv);
    tail_seg(dtv, -expf(p.a_log[0]), Qp, segb, dtb);
  }
  cp_async_wait_all();
  __syncthreads();

  // S^T = B C^T, the tiles (r, it >= r), read back by this warp as rows j
  // and by warp it as rows i
  if (live) {
    uint32_t ba[NMAX / 16][4];
#pragma unroll
    for (int ks = 0; ks < NMAX / 16; ++ks)
      if (ks < KN) a_rows(ba[ks], bs + 16 * r * LB + ks * 16, LB);
    for (int it = r; it < U; ++it) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < NMAX / 16; ++ks) {
        if (ks >= KN) continue;
        uint32_t cb[4];
        b_rows(cb, cs + 16 * it * LB + ks * 16, LB);
        mma_16816(acc[0], ba[ks], cb[0], cb[1]);
        mma_16816(acc[1], ba[ks], cb[2], cb[3]);
      }
      float* dst = sts + tile_at(it, r) + lane;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(4 * h2 + e) * 32] = acc[h2][e];
    }
  }

  // dC (rows i = lo, hi) and dB (rows j = lo, hi), summed over the heads
  float dc[NMAX / 8][4], db[NMAX / 8][4];
#pragma unroll
  for (int nt = 0; nt < NMAX / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[nt][e] = db[nt][e] = 0.f;

  for (int h = 0; h < p.H; ++h) {
    const int buf = h & 1;
    if (h > 0) {  // head h's tiles, dt and seg are in
      cp_async_wait_all();
      __syncthreads();
    }
    if (h + 1 < p.H) {
      load_head(h + 1, buf ^ 1);
      if (warp == TAIL) tail_dt(p, bi, h + 1, s0, cq, dtv);
    }
    const bf16* xs = xb + buf * Qp * LX;
    const bf16* dys = dyb + buf * Qp * LX;
    const double* seg = segb + buf * Qp;
    const float* dts = dtb + (h % 3) * Qp;
    double* rowsum = rowsumb + buf * Qp;
    double* colsum = colsumb + buf * Qp;
    float* carried = carriedb + buf * Qp;
    float* ub = ubb + buf * Qp;
    float* share = shareb + buf * Qp;
    const double total = seg[Qp - 1];
    const double seg_lo = seg[lo], seg_hi = seg[hi];
    const float dt_lo = dts[lo], dt_hi = dts[hi];

    // the state terms, rows lo and hi
    float dxdt[PMAX / 8][4];  // d(x dt), rows j = lo, hi
    if (live) {
      // dC += exp(seg_i) dy_i h_in, and the carried term = its row dots
      // with C (h_in is 0 in chunk 0)
      float car_lo = 0.f, car_hi = 0.f;
      if (ci > 0) {
        uint32_t ya[PMAX / 16][4];
#pragma unroll
        for (int ks = 0; ks < PMAX / 16; ++ks)
          if (ks < KP) a_rows(ya[ks], dys + 16 * r * LX + ks * 16, LX);
        const float e_lo = expf(static_cast<float>(seg_lo));
        const float e_hi = expf(static_cast<float>(seg_hi));
#pragma unroll
        for (int np = 0; np < NMAX / 16; ++np) {
          if (np >= KN) continue;
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < PMAX / 16; ++ks) {
            if (ks >= KP) continue;
            uint32_t hb[4];
            b_cols(hb, hs + ks * 16 * LB + np * 16, LB);
            mma_16816(acc[0], ya[ks], hb[0], hb[1]);
            mma_16816(acc[1], ya[ks], hb[2], hb[3]);
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int n = np * 16 + h2 * 8 + 2 * t;
            const float2 c_lo = bf16x2_at(cs + lo * LB + n);
            const float2 c_hi = bf16x2_at(cs + hi * LB + n);
            const float v0 = acc[h2][0] * e_lo, v1 = acc[h2][1] * e_lo;
            const float v2 = acc[h2][2] * e_hi, v3 = acc[h2][3] * e_hi;
            car_lo += v0 * c_lo.x + v1 * c_lo.y;
            car_hi += v2 * c_hi.x + v3 * c_hi.y;
            dc[2 * np + h2][0] += v0;
            dc[2 * np + h2][1] += v1;
            dc[2 * np + h2][2] += v2;
            dc[2 * np + h2][3] += v3;
          }
        }
      }
      car_lo = sum4(car_lo);
      car_hi = sum4(car_hi);

      // dB += exp(seg_last - seg_j) dt_j x_j dh_out, and u = its row dots
      // with B
      float u_lo = 0.f, u_hi = 0.f;
      {
        uint32_t xa[PMAX / 16][4];
#pragma unroll
        for (int ks = 0; ks < PMAX / 16; ++ks)
          if (ks < KP) a_rows(xa[ks], xs + 16 * r * LX + ks * 16, LX);
        const float w_lo = dt_lo * expf(static_cast<float>(total - seg_lo));
        const float w_hi = dt_hi * expf(static_cast<float>(total - seg_hi));
#pragma unroll
        for (int np = 0; np < NMAX / 16; ++np) {
          if (np >= KN) continue;
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < PMAX / 16; ++ks) {
            if (ks >= KP) continue;
            uint32_t hb[4];
            b_cols(hb, dhs + ks * 16 * LB + np * 16, LB);
            mma_16816(acc[0], xa[ks], hb[0], hb[1]);
            mma_16816(acc[1], xa[ks], hb[2], hb[3]);
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int n = np * 16 + h2 * 8 + 2 * t;
            const float2 b_lo = bf16x2_at(bs + lo * LB + n);
            const float2 b_hi = bf16x2_at(bs + hi * LB + n);
            const float v0 = acc[h2][0] * w_lo, v1 = acc[h2][1] * w_lo;
            const float v2 = acc[h2][2] * w_hi, v3 = acc[h2][3] * w_hi;
            u_lo += v0 * b_lo.x + v1 * b_lo.y;
            u_hi += v2 * b_hi.x + v3 * b_hi.y;
            db[2 * np + h2][0] += v0;
            db[2 * np + h2][1] += v1;
            db[2 * np + h2][2] += v2;
            db[2 * np + h2][3] += v3;
          }
        }
      }
      u_lo = sum4(u_lo);
      u_hi = sum4(u_hi);
      if (t == 0) {
        carried[lo] = car_lo;
        carried[hi] = car_hi;
        ub[lo] = u_lo;
        ub[hi] = u_hi;
      }

      // d(x dt) = exp(seg_last - seg_j) B_j dh_out^T, before G^T dy
#pragma unroll
      for (int q = 0; q < PMAX / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxdt[q][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NMAX / 16; ++ks) {
        if (ks >= KN) continue;
        uint32_t ba[4];
        a_rows(ba, bs + 16 * r * LB + ks * 16, LB);
#pragma unroll
        for (int pp = 0; pp < PMAX / 16; ++pp) {
          if (pp >= KP) continue;
          uint32_t hb[4];
          b_rows(hb, dhs + pp * 16 * LB + ks * 16, LB);
          mma_16816(dxdt[2 * pp], ba, hb[0], hb[1]);
          mma_16816(dxdt[2 * pp + 1], ba, hb[2], hb[3]);
        }
      }
      const float r_lo = expf(static_cast<float>(total - seg_lo));
      const float r_hi = expf(static_cast<float>(total - seg_hi));
#pragma unroll
      for (int q = 0; q < PMAX / 8; ++q) {
        dxdt[q][0] *= r_lo;
        dxdt[q][1] *= r_lo;
        dxdt[q][2] *= r_hi;
        dxdt[q][3] *= r_hi;
      }
    }
    // this warp's share of dh_out . h_in (0 in chunk 0)
    {
      float s = 0.f;
      if (ci > 0) {
        for (int e = tid * 8; e < P * N; e += THREADS * 8) {
          const int at_e = (e / N) * LB + e % N;
          const uint4 hv = *reinterpret_cast<const uint4*>(hs + at_e);
          const uint4 dv = *reinterpret_cast<const uint4*>(dhs + at_e);
          const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
          const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 hf = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&hw[k]));
            const float2 df = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&dw[k]));
            s += hf.x * df.x + hf.y * df.y;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) endsb[buf * 8 + warp] = s;
    }
    __syncthreads();  // done with h_in and dh_out: the next head's go there
    if (h + 1 < p.H) load_states(h + 1);

    if (live) {
      // rows j = lo, hi over the tiles it >= r: d(x dt) += G^T dy,
      // PD^T = (x dy^T) dt_j L, M's column sums, dB += PD^T C
      double col_lo = 0.0, col_hi = 0.0;
      for (int it = r; it < U; ++it) {
        const float* stt = sts + tile_at(it, r) + lane;
        float st[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[h2][e] = stt[(4 * h2 + e) * 32];
        float dec[2][4];  // exp(seg_i - seg_j) on i >= j
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * it + 8 * h2 + 2 * t + (e & 1);
            const int j = e < 2 ? lo : hi;
            dec[h2][e] = i >= j ? fast_exp2(static_cast<float>(
                                      seg[i] - (e < 2 ? seg_lo : seg_hi)) *
                                  LOG2E)
                                : 0.f;
          }
        {
          float gv[2][4];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 4; ++e) gv[h2][e] = st[h2][e] * dec[h2][e];
          uint32_t ga[4];
          to_a(ga, gv);
#pragma unroll
          for (int pp = 0; pp < PMAX / 16; ++pp) {
            if (pp >= KP) continue;
            uint32_t yb[4];
            b_cols(yb, dys + 16 * it * LX + pp * 16, LX);
            mma_16816(dxdt[2 * pp], ga, yb[0], yb[1]);
            mma_16816(dxdt[2 * pp + 1], ga, yb[2], yb[3]);
          }
        }
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < PMAX / 16; ++ks) {
          if (ks >= KP) continue;
          uint32_t xa[4], yb[4];
          a_rows(xa, xs + 16 * r * LX + ks * 16, LX);
          b_rows(yb, dys + 16 * it * LX + ks * 16, LX);
          mma_16816(d[0], xa, yb[0], yb[1]);
          mma_16816(d[1], xa, yb[2], yb[3]);
        }
        // M^T = PD^T S^T: its row sums are M's column sums at j
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d[h2][e] *= (e < 2 ? dt_lo : dt_hi) * dec[h2][e];
            const double m = static_cast<double>(d[h2][e] * st[h2][e]);
            if (e < 2)
              col_lo += m;
            else
              col_hi += m;
          }
        uint32_t pa[4];
        to_a(pa, d);
#pragma unroll
        for (int np = 0; np < NMAX / 16; ++np) {
          if (np >= KN) continue;
          uint32_t cb[4];
          b_cols(cb, cs + 16 * it * LB + np * 16, LB);
          mma_16816(db[2 * np], pa, cb[0], cb[1]);
          mma_16816(db[2 * np + 1], pa, cb[2], cb[3]);
        }
      }
      col_lo = sum4(col_lo);
      col_hi = sum4(col_hi);

      // dx = d(x dt) dt and ddt's share d(x dt) . x
      {
        bf16* dx = static_cast<bf16*>(p.dx) + (row0 * p.H + h) * P;
        const long long dx_ss = static_cast<long long>(p.H) * P;
        float sh_lo = 0.f, sh_hi = 0.f;
#pragma unroll
        for (int q = 0; q < PMAX / 8; ++q) {
          if (q >= P / 8) continue;
          const int col = q * 8 + 2 * t;
          const float2 x_lo = bf16x2_at(xs + lo * LX + col);
          const float2 x_hi = bf16x2_at(xs + hi * LX + col);
          sh_lo += dxdt[q][0] * x_lo.x + dxdt[q][1] * x_lo.y;
          sh_hi += dxdt[q][2] * x_hi.x + dxdt[q][3] * x_hi.y;
          if (lo < cq)
            *reinterpret_cast<uint32_t*>(dx + lo * dx_ss + col) =
                pack_bf16(dxdt[q][0] * dt_lo, dxdt[q][1] * dt_lo);
          if (hi < cq)
            *reinterpret_cast<uint32_t*>(dx + hi * dx_ss + col) =
                pack_bf16(dxdt[q][2] * dt_hi, dxdt[q][3] * dt_hi);
        }
        sh_lo = sum4(sh_lo);
        sh_hi = sum4(sh_hi);
        if (t == 0) {
          colsum[lo] = col_lo;
          colsum[hi] = col_hi;
          share[lo] = sh_lo;
          share[hi] = sh_hi;
        }
      }

      // rows i = lo, hi over the tiles jt <= r: PD = (dy x^T) dt_j L, M's
      // row sums (S from warp jt's S^T tile), dC += PD B
      uint32_t ya[PMAX / 16][4];
#pragma unroll
      for (int ks = 0; ks < PMAX / 16; ++ks)
        if (ks < KP) a_rows(ya[ks], dys + 16 * r * LX + ks * 16, LX);
      // S[i][j] (i = lo + 8 (e / 2), j = 8 h2 + 2 t + e % 2 in tile jt) is
      // S^T tile (jt, r)'s element (e / 2, 2 h2 + g % 2) of lane
      // 4 (2 t + e % 2) + g / 2
      const int s_at = 32 * (g & 1) + 8 * t + (g >> 1);
      double row_lo = 0.0, row_hi = 0.0;
      for (int jt = 0; jt <= r; ++jt) {
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < PMAX / 16; ++ks) {
          if (ks >= KP) continue;
          uint32_t xb4[4];
          b_rows(xb4, xs + 16 * jt * LX + ks * 16, LX);
          mma_16816(d[0], ya[ks], xb4[0], xb4[1]);
          mma_16816(d[1], ya[ks], xb4[2], xb4[3]);
        }
        const float* stt = sts + tile_at(r, jt) + s_at;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * jt + 8 * h2 + 2 * t + (e & 1);
            const int i = e < 2 ? lo : hi;
            d[h2][e] = j <= i
                           ? d[h2][e] * dts[j] *
                                 fast_exp2(static_cast<float>(
                                               (e < 2 ? seg_lo : seg_hi) -
                                               seg[j]) *
                                           LOG2E)
                           : 0.f;
            const double m = static_cast<double>(
                d[h2][e] * stt[(4 * (e >> 1) + 2 * h2) * 32 + 4 * (e & 1)]);
            if (e < 2)
              row_lo += m;
            else
              row_hi += m;
          }
        uint32_t pa[4];
        to_a(pa, d);
#pragma unroll
        for (int np = 0; np < NMAX / 16; ++np) {
          if (np >= KN) continue;
          uint32_t bb4[4];
          b_cols(bb4, bs + 16 * jt * LB + np * 16, LB);
          mma_16816(dc[2 * np], pa, bb4[0], bb4[1]);
          mma_16816(dc[2 * np + 1], pa, bb4[2], bb4[3]);
        }
      }
      row_lo = sum4(row_lo);
      row_hi = sum4(row_hi);
      if (t == 0) {
        rowsum[lo] = row_lo;
        rowsum[hi] = row_hi;
      }
    }
    // the tail warp: d(dt a) of the previous head, then the next head's seg
    if (warp == TAIL) {
      if (h > 0) dda(h - 1);
      __syncwarp();
      if (h + 1 < p.H)
        tail_seg(dtv, -expf(p.a_log[h + 1]), Qp, segb + (buf ^ 1) * Qp,
                 dtb + ((h + 1) % 3) * Qp);
    }
  }
  __syncthreads();  // the last head's sums are in
  if (warp == TAIL) dda(p.H - 1);

  // dB and dC, summed over the heads
  if (live) {
    bf16* dcs = static_cast<bf16*>(p.dc) + row0 * N;
    bf16* dbs = static_cast<bf16*>(p.db) + row0 * N;
#pragma unroll
    for (int nt = 0; nt < NMAX / 8; ++nt) {
      if (nt >= N / 8) continue;
      const int n = nt * 8 + 2 * t;
      if (lo < cq) {
        *reinterpret_cast<uint32_t*>(dcs + lo * N + n) =
            pack_bf16(dc[nt][0], dc[nt][1]);
        *reinterpret_cast<uint32_t*>(dbs + lo * N + n) =
            pack_bf16(db[nt][0], db[nt][1]);
      }
      if (hi < cq) {
        *reinterpret_cast<uint32_t*>(dcs + hi * N + n) =
            pack_bf16(dc[nt][2], dc[nt][3]);
        *reinterpret_cast<uint32_t*>(dbs + hi * N + n) =
            pack_bf16(db[nt][2], db[nt][3]);
      }
    }
  }
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

cudaError_t run_f32(const Params& p, cudaStream_t s) {
  const int Qp = round16(p.Q);
  const dim3 chunks(p.B * p.NC, p.H);
  const dim3 states(p.B * p.H, (p.P * p.N / 4 + THREADS - 1) / THREADS);
  const long long outs = static_cast<long long>(p.B) * p.S * p.N;
  cudaError_t err = launch_one(chunk_dstate, chunks, THREADS,
                               dstate_smem(Qp, p.P, p.N), p, s);
  if (!err) err = launch_one(state_pass, states, THREADS, 0, p, s);
  if (!err)
    err = launch_one(chunk_dx, chunks, THREADS, dx_smem(Qp, p.P, p.N), p, s);
  if (!err)
    err = launch_one(chunk_dc, chunks, THREADS, dbc_smem(Qp, p.P, p.N), p, s);
  if (!err)
    err = launch_one(chunk_db, chunks, THREADS, dbc_smem(Qp, p.P, p.N), p, s);
  if (!err)
    err = launch_one(reduce_heads,
                     dim3(static_cast<unsigned>((outs + THREADS - 1) / THREADS)),
                     THREADS, 0, p, s);
  if (!err) err = launch_one(reduce_alog, dim3(p.H), 32, 0, p, s);
  return err;
}

cudaError_t run_bf16(const Params& p, cudaStream_t s) {
  const int Qp = round16(p.Q);
  const dim3 chunks(p.B * p.NC, p.H);
  const dim3 states(p.B * p.H, (p.P * p.N / 4 + THREADS - 1) / THREADS);
  cudaError_t err = launch_one(chunk_dstate_bf16, chunks, THREADS,
                               dstate_smem_bf16(Qp, p.P, p.N), p, s);
  if (!err) err = launch_one(state_pass, states, THREADS, 0, p, s);
  if (!err)
    err = launch_one(chunk_bwd_bf16, dim3(p.B * p.NC), THREADS,
                     BwdSmem(Qp, p.P, p.N).total, p, s);
  if (!err) err = launch_one(reduce_alog, dim3(p.H), 32, 0, p, s);
  return err;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// The version of this C interface: 2 changed the bf16 workspace (no
// per-head dB / dC rows; dh_out in bf16).
int ssd_scan_bwd_abi(void) { return 2; }

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
  // 16 bytes a load: 8 bf16 per aligned row segment (bf16 loads only)
  const int vec = aligned16(x) && aligned16(b) && aligned16(c) &&
                  aligned16(dy) && x_sb % 8 == 0 && x_ss % 8 == 0 &&
                  x_sh % 8 == 0 && b_sb % 8 == 0 && b_ss % 8 == 0 &&
                  c_sb % 8 == 0 && c_ss % 8 == 0 && dy_sb % 8 == 0 &&
                  dy_ss % 8 == 0 && dy_sh % 8 == 0;
  // the forward's workspace: its states, for bf16 its bf16 incoming states,
  // then the seg totals (ssd_scan.cu)
  const long long n_state = static_cast<long long>(B) * NC * H * P * N;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long slots = static_cast<long long>(B) * NC * H;
  const bf16* h_in16 = dtype == 1
      ? reinterpret_cast<const bf16*>(fwd_workspace + n_state) : nullptr;
  const float* totals = fwd_workspace + n_state + (dtype == 1 ? n_state / 2 : 0);
  // this one's: Sd (then for fp32 dh_out); for bf16 dh_out in bf16 and the
  // blocks' da_log shares; for fp32 the fp64 sums (M's rows less columns,
  // the blocks' da_log shares), the carried term, the per-head dB and dC
  float* dh = workspace;
  bf16* dh16 = nullptr;
  double *dsegm = nullptr, *alog_part;
  float *carried = nullptr, *db_part = nullptr, *dc_part = nullptr;
  if (dtype == 1) {
    dh16 = reinterpret_cast<bf16*>(dh + n_state);
    alog_part = reinterpret_cast<double*>(dh + n_state + n_state / 2);
  } else {
    dsegm = reinterpret_cast<double*>(dh + n_state);
    alog_part = dsegm + rows;
    carried = reinterpret_cast<float*>(alog_part + slots);
    db_part = carried + rows;
    dc_part = db_part + rows * N;
  }
  const Params p{x, dt, a_log, b, c, dy, dh_final, fwd_workspace, h_in16,
                 totals, dh, dh16, dsegm, alog_part, carried, db_part,
                 dc_part, dx, ddt, db, dc, da_log, B, S, H, P, N, chunk, NC,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb,
                 c_ss, dy_sb, dy_ss, dy_sh, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? run_f32(p, s) : run_bf16(p, s);
  return static_cast<int>(err);
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
