// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py (ssd_scan,
// body _ssd_kernel). It computes the same function, per (batch, head), with
// a = -exp(A_log) and an fp32 (P, N) state h carried from chunk to chunk:
//
//   seg     = cumsum(dt * a) over the chunk's rows
//   y       = ((C B^T) * exp(seg_i - seg_j) on j <= i) (x * dt)   intra-chunk
//           + exp(seg_i) * (C h_in)                              carried state
//   h_out   = exp(seg_last) h_in + B^T ((x * dt) * exp(seg_last - seg))
//
// B and C are shared by all heads (one group). Unlike the Pallas kernel, it
// also writes the final state h (B, H, P, N) in fp32, which the model's
// prefill cache needs.
//
// What bounds it on this card: at mamba2-130m's prefill (B 4, S 512, H 24,
// P 64, N 128, chunk 128) the function moves about 17 MB (x and y, B and C
// once, dt, the final state), 5 us at 3.35 TB/s, and needs about 2.5 GFLOP
// on the tensor cores: bound by bytes.
//
// What the design does about it: one call launches three kernels on the
// caller's stream, the chunked algorithm's three passes (ref.py's
// ssd_passes is their plain mirror):
//  1. chunk_state, one block per (batch, chunk, head): seg and each chunk's
//     own contribution to the state, B^T ((x * dt) * exp(seg_last - seg)),
//     a P x N tile, into a workspace, with the chunk's total seg_last.
//  2. state_pass, one thread per 4 state elements of a (batch, head),
//     sequential over the chunks in fp32: h_in[c + 1] = exp(seg_last[c])
//     h_in[c] + S[c]. It writes each chunk's incoming state (fp32 over its
//     S; for bf16 inputs rounded to bf16, the only way pass 3 reads it) and
//     h_final.
//  3. chunk_output, one block per (batch, chunk, head): y from the chunk's
//     incoming state and its own rows.
// The TPU kernel walks the chunks as a sequential grid axis with the state
// in VMEM; here only pass 2 is sequential, and passes 1 and 3 have B x
// chunks x H blocks (384 at mamba2's prefill, 3,072 at B 8, S 2048).
//  - bf16 inputs: the products run on the tensor cores (mma.sync m16n8k16,
//    fp32 accumulate, operands by ldmatrix). x, B and C enter unrounded;
//    each fp32 factor is folded into the operand that is not an input and
//    rounded once: x * dt * exp(seg_last - seg) for the chunk state (pass
//    1), the decayed C B^T with its columns scaled by dt for the intra-chunk
//    term, and the incoming state for C h_in (pass 3). C B^T is formed by
//    each block on the tensor cores, 16 x 16 tile by tile, on the lower
//    triangle only, and turned into the next product's A operand in
//    registers; the carried state stays fp32 in pass 2 and h_final. Pass
//    1 scales x in its A fragments; the decays, which bf16 rounds anyway,
//    take the hardware's exp2.
//  - fp32 inputs: the same passes on the CUDA cores in fp32 (TF32 would miss
//    the fp32 check), with the arithmetic of the earlier one-pass kernel:
//    register tiles from shared memory, rows padded by one float.
//  - seg is summed in fp64: over a chunk of 128 rows it reaches -100 on
//    random inputs and -1000 at mamba2-130m's init, where an fp32 ulp is
//    1e-5 and 6e-5, and every decay exp(seg_i - seg_j) inherits that error,
//    which the sequential recurrence never makes. Each dt * a is rounded to
//    fp32 first, as in the recurrence. The decays are taken only on
//    j <= i, where seg_i - seg_j <= 0.
//  - Ragged sequences (S not a multiple of the chunk, S < chunk, S = 1) are
//    masked: rows past S load as zeros. The Pallas kernel asserts that the
//    chunk divides S; the function is the same at any blocking.
//  - x, B, C and dt are read through element strides, so the model passes
//    its views of the conv output without a copy; 16 bytes at a time when
//    the rows are aligned so.
//
// The kernels launch on the caller's stream and allocate nothing: the
// wrapper passes the workspace (the chunk states and seg totals, B x chunks
// x H x (P N + 1) floats, and for bf16 the incoming states, P N / 2 more
// each).
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
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* x;        // (B, S, H, P), unit stride over P
  const float* dt;      // (B, S, H)
  const float* a_log;   // (H,), contiguous
  const void* b;        // (B, S, N), unit stride over N
  const void* c;        // (B, S, N), unit stride over N
  void* y;              // (B, S, H, P), contiguous
  float* h_final;       // (B, H, P, N), contiguous
  float* states;        // (B, NC, H, P, N): S[c], then (fp32) h_in[c]
  bf16* h_in16;         // bf16 inputs: (B, NC, H, P, N) h_in[c] in bf16
  float* totals;        // (B, NC, H): seg_last of each chunk
  int B, S, H, P, N, Q, NC;  // Q: rows per chunk (1..QMAX); NC chunks
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, c_sb, c_ss;
  int vec;  // 1: x, B and C rows can be read 16 bytes at a time
};

__host__ __device__ constexpr int round16(int q) { return (q + 15) & ~15; }

constexpr int BATCH = 8;  // loads a thread has in flight at once

// 16 bytes global -> shared without passing through registers; zeros when
// !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [0, rows) of a (rows, cols) matrix at src (row stride
// ss elements, unit column stride) into shared memory at dst (row stride
// ld); rows in [live, rows) as zeros. bf16 rows aligned to 16 bytes go by
// cp.async (the caller waits with cp_async_wait_all); the rest through
// registers, BATCH loads in flight a thread, done on return.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long ss, int rows, int live,
                                          int cols, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && sizeof(T) == 2) {
    const int per_row = cols / V;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, cv = (e % per_row) * V;
      cp_async16(dst + r * ld + cv, src + (r < live ? r * ss + cv : 0),
                 r < live);
    }
  } else if (vec) {
    const int per_row = cols / V, total = rows * per_row;
    for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * blockDim.x) {
      uint4 v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int e = e0 + k * blockDim.x, r = e / per_row;
        v[k] = make_uint4(0, 0, 0, 0);
        if (e < total && r < live)
          v[k] = *reinterpret_cast<const uint4*>(src + r * ss +
                                                 (e % per_row) * V);
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int e = e0 + k * blockDim.x;
        if (e >= total) break;
        const T* el = reinterpret_cast<const T*>(&v[k]);
        T* d = dst + (e / per_row) * ld + (e % per_row) * V;
#pragma unroll
        for (int i = 0; i < V; ++i) d[i] = el[i];
      }
    }
  } else {
    const int total = rows * cols;
    for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * blockDim.x) {
      T v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int e = e0 + k * blockDim.x, r = e / cols;
        v[k] = e < total && r < live ? src[r * ss + e % cols] : T(0.f);
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int e = e0 + k * blockDim.x;
        if (e < total) dst[(e / cols) * ld + e % cols] = v[k];
      }
    }
  }
}

// seg[j] = sum_{i <= j} fp32(dt_i a) in fp64 for j < Qp (<= 128); rows past
// the live ones have dt 0 and add 0, so seg[Qp - 1] is the chunk's total.
// Warp 0 scans, four rows a lane.
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
};

// dt of the chunk's rows, zeros past the live ones
__device__ __forceinline__ void load_dt(const Params& p, const Chunk& ch,
                                        float* dts) {
  const float* dt = p.dt + ch.bi * p.dt_sb + ch.hi * p.dt_sh;
  for (int j = threadIdx.x; j < ch.Qp; j += blockDim.x)
    dts[j] = j < ch.cq ? dt[static_cast<long long>(ch.s0 + j) * p.dt_ss] : 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// pass 2: state passing (shared by both types)
// ---------------------------------------------------------------------------

// grid (B * H, P N / (4 * THREADS) rounded up): each thread walks the
// chunks for 4 neighbouring state elements
__global__ void __launch_bounds__(THREADS) state_pass(Params p) {
  const int bi = blockIdx.x / p.H, hi = blockIdx.x % p.H;
  const int pn = p.P * p.N;
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  if (e >= pn) return;
  // chunk ci's slot is slot0 + ci H; the next chunk's loads are issued
  // before this chunk's store
  const long long slot0 = static_cast<long long>(bi) * p.NC * p.H + hi;
  float4* sp = reinterpret_cast<float4*>(p.states + slot0 * pn + e);
  const long long step = static_cast<long long>(p.H) * pn / 4;  // float4s
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s_next = sp[0];
  float t_next = p.totals[slot0];
  for (int ci = 0; ci < p.NC; ++ci) {
    const float4 s = s_next;
    const float et = expf(t_next);
    if (ci + 1 < p.NC) {
      s_next = sp[(ci + 1) * step];
      t_next = p.totals[slot0 + (ci + 1) * p.H];
    }
    if (p.h_in16 == nullptr) {
      sp[ci * step] = h;  // the chunk's incoming state
    } else {              // the same, rounded to bf16 for pass 3's product
      uint2 packed;
      packed.x = pack_bf16(h.x, h.y);
      packed.y = pack_bf16(h.z, h.w);
      *reinterpret_cast<uint2*>(p.h_in16 + (slot0 + ci * p.H) * pn + e) =
          packed;
    }
    h.x = h.x * et + s.x;
    h.y = h.y * et + s.y;
    h.z = h.z * et + s.z;
    h.w = h.w * et + s.w;
  }
  *reinterpret_cast<float4*>(
      p.h_final + (static_cast<long long>(bi) * p.H + hi) * pn + e) = h;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Two matrices, transposed (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// ---------------------------------------------------------------------------
// pass 1: chunk states
// ---------------------------------------------------------------------------

// fp32 shared memory: seg (Qp doubles), dt and exp(seg_last - seg) (Qp
// floats each), x * dt (Qp x (P + 1)), B (Qp x (N + 1))
__host__ __device__ inline size_t state_smem_f32(int Qp, int P, int N) {
  return 8 * Qp + 4 * (2 * Qp + static_cast<size_t>(Qp) * (P + 1) +
                       static_cast<size_t>(Qp) * (N + 1));
}

__global__ void __launch_bounds__(THREADS) chunk_state_f32(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LP = P + 1, LN = N + 1;
  const int tid = threadIdx.x;
  double* seg = smem;
  float* dts = reinterpret_cast<float*>(seg + Qp);
  float* rem = dts + Qp;
  float* xs = rem + Qp;
  float* bs = xs + Qp * LP;
  load_dt(p, ch, dts);
  load_rows(xs, LP,
            static_cast<const float*>(p.x) + ch.bi * p.x_sb + ch.hi * p.x_sh +
                ch.s0 * p.x_ss,
            p.x_ss, Qp, ch.cq, P, p.vec);
  load_rows(bs, LN,
            static_cast<const float*>(p.b) + ch.bi * p.b_sb + ch.s0 * p.b_ss,
            p.b_ss, Qp, ch.cq, N, p.vec);
  cp_async_wait_all();
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  const double total = seg[Qp - 1];
  for (int j = tid; j < Qp; j += THREADS)
    rem[j] = expf(static_cast<float>(total - seg[j]));
  for (int e = tid; e < Qp * P; e += THREADS)
    xs[(e / P) * LP + e % P] *= dts[e / P];
  __syncthreads();

  // S[sp + 16 u][sn + 16 v] = sum_j ((x dt)[j] rem[j]) B[j]
  const int sp = tid >> 4, sn = tid & 15;
  const int UP = P / 16, VN = N / 16;
  float hv[PMAX / 16][NMAX / 16];
#pragma unroll
  for (int u = 0; u < PMAX / 16; ++u)
#pragma unroll
    for (int v = 0; v < NMAX / 16; ++v) hv[u][v] = 0.f;
  for (int j = 0; j < ch.cq; ++j) {
    const float r = rem[j];
    float xv[PMAX / 16], bv[NMAX / 16];
#pragma unroll
    for (int u = 0; u < PMAX / 16; ++u)
      xv[u] = u < UP ? xs[j * LP + sp + 16 * u] * r : 0.f;
#pragma unroll
    for (int v = 0; v < NMAX / 16; ++v)
      bv[v] = v < VN ? bs[j * LN + sn + 16 * v] : 0.f;
#pragma unroll
    for (int u = 0; u < PMAX / 16; ++u)
#pragma unroll
      for (int v = 0; v < NMAX / 16; ++v) hv[u][v] += xv[u] * bv[v];
  }
  float* out = p.states + ch.slot(p) * P * N;
#pragma unroll
  for (int u = 0; u < PMAX / 16; ++u)
#pragma unroll
    for (int v = 0; v < NMAX / 16; ++v)
      if (u < UP && v < VN) out[(sp + 16 * u) * N + sn + 16 * v] = hv[u][v];
  if (tid == 0) p.totals[ch.slot(p)] = static_cast<float>(total);
}

// bf16 shared memory: seg (Qp doubles), dt and dt exp(seg_last - seg) (Qp
// floats each), x (then x dt exp(seg_last - seg)) Qp x (P + 8) and B
// Qp x (N + 8) in bf16 (rows padded by 16 bytes: ldmatrix rows hit
// distinct banks)
__host__ __device__ inline size_t state_smem_bf16(int Qp, int P, int N) {
  return 16 * Qp + 2 * (static_cast<size_t>(Qp) * (P + 8) +
                        static_cast<size_t>(Qp) * (N + 8));
}

__global__ void __launch_bounds__(THREADS) chunk_state_bf16(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LX = P + 8, LB = N + 8;
  const int tid = threadIdx.x;
  double* seg = smem;
  float* dts = reinterpret_cast<float*>(seg + Qp);
  float* w = dts + Qp;
  bf16* xs = reinterpret_cast<bf16*>(w + Qp);
  bf16* bs = xs + Qp * LX;
  load_dt(p, ch, dts);
  load_rows(xs, LX,
            static_cast<const bf16*>(p.x) + ch.bi * p.x_sb + ch.hi * p.x_sh +
                ch.s0 * p.x_ss,
            p.x_ss, Qp, ch.cq, P, p.vec);
  load_rows(bs, LB,
            static_cast<const bf16*>(p.b) + ch.bi * p.b_sb + ch.s0 * p.b_ss,
            p.b_ss, Qp, ch.cq, N, p.vec);
  cp_async_wait_all();
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  const double total = seg[Qp - 1];
  for (int j = tid; j < Qp; j += THREADS)
    w[j] = dts[j] * expf(static_cast<float>(total - seg[j]));
  __syncthreads();

  // S (P x N) = (x w)^T B over the chunk's rows: warp -> 16 rows of P
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
    uint32_t a[4];  // A[p][j] = x[j][p]: transposed from (j, p) rows
    ldsm_x4_t(a, xs + (k0 + lr + 8 * (lm >> 1)) * LX + pt * 16 + 8 * (lm & 1));
    // the factor goes into x, which is rounded to bf16 once: a[0], a[1]
    // hold rows j = k0 + 2 t (+1), a[2], a[3] rows j + 8 (+1)
    const float2 w0 = make_float2(w[k0 + 2 * t], w[k0 + 2 * t + 1]);
    const float2 w8 = make_float2(w[k0 + 2 * t + 8], w[k0 + 2 * t + 9]);
    a[0] = scale_bf16x2(a[0], w0);
    a[1] = scale_bf16x2(a[1], w0);
    a[2] = scale_bf16x2(a[2], w8);
    a[3] = scale_bf16x2(a[3], w8);
#pragma unroll
    for (int nt = 0; nt < NMAX / 16; ++nt) {
      if (nt < NT) {
        uint32_t bb[2];  // B[j][n], (j, n) rows: transposed
        ldsm_x2_t(bb, bs + (k0 + lr + 8 * (lm & 1)) * LB + n_base + nt * 8);
        mma_16816(acc[nt], a, bb[0], bb[1]);
      }
    }
  }
  float* out = p.states + ch.slot(p) * P * N;
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
  if (tid == 0) p.totals[ch.slot(p)] = static_cast<float>(total);
}

// ---------------------------------------------------------------------------
// pass 3: chunk outputs
// ---------------------------------------------------------------------------

__host__ __device__ inline int g_stride(int Qp, int N) {
  return N + 1 > Qp + 1 ? N + 1 : Qp + 1;
}

// fp32 shared memory, in floats, after seg (Qp doubles): B Qp (N + 1), C
// and then the decayed C B^T Qp max(N + 1, Qp + 1), x * dt Qp (P + 1),
// h_in P (N + 1), exp(seg) and dt (Qp each). At chunk 128, N 128, P 64
// that is 200,448 bytes: one block per SM.
__host__ __device__ inline size_t output_smem_f32(int Qp, int P, int N) {
  return 8 * Qp + 4 * (static_cast<size_t>(Qp) * (N + 1) +
                       static_cast<size_t>(Qp) * g_stride(Qp, N) +
                       static_cast<size_t>(Qp) * (P + 1) +
                       static_cast<size_t>(P) * (N + 1) + 2 * Qp);
}

__global__ void __launch_bounds__(THREADS, 1) chunk_output_f32(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LP = P + 1, LN = N + 1;
  const int LG = g_stride(Qp, N), U = Qp / 16, MP = P / 8;
  const int tid = threadIdx.x;
  double* seg = smem;
  float* bs = reinterpret_cast<float*>(seg + Qp);
  float* cg = bs + Qp * LN;
  float* xs = cg + Qp * LG;
  float* hs = xs + Qp * LP;
  float* eseg = hs + P * LN;
  float* dts = eseg + Qp;
  load_dt(p, ch, dts);
  const long long row0 = ch.s0;
  load_rows(xs, LP,
            static_cast<const float*>(p.x) + ch.bi * p.x_sb + ch.hi * p.x_sh +
                row0 * p.x_ss,
            p.x_ss, Qp, ch.cq, P, p.vec);
  load_rows(bs, LN,
            static_cast<const float*>(p.b) + ch.bi * p.b_sb + row0 * p.b_ss,
            p.b_ss, Qp, ch.cq, N, p.vec);
  load_rows(cg, LG,
            static_cast<const float*>(p.c) + ch.bi * p.c_sb + row0 * p.c_ss,
            p.c_ss, Qp, ch.cq, N, p.vec);
  if (ch.ci > 0)
    load_rows(hs, LN, p.states + ch.slot(p) * P * N, N, P, P, N, true);
  cp_async_wait_all();
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  for (int j = tid; j < Qp; j += THREADS)
    eseg[j] = expf(static_cast<float>(seg[j]));
  for (int e = tid; e < Qp * P; e += THREADS)
    xs[(e / P) * LP + e % P] *= dts[e / P];
  __syncthreads();

  // output tile: rows 4 ry + k, columns py + 8 m
  const int ry = tid >> 3, py = tid & 7;
  const bool rows_live = 4 * ry < Qp;
  // C B^T tile: rows gi + 16 u, columns gj + 16 v
  const int gi = tid >> 4, gj = tid & 15;

  // carried state: acc = exp(seg_i) (C h_in)[i][p] (h_in is 0 in chunk 0)
  float acc[4][PMAX / 8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < PMAX / 8; ++m) acc[k][m] = 0.f;
  if (ch.ci > 0 && rows_live) {
    for (int n = 0; n < N; ++n) {
      float cv[4], hv[PMAX / 8];
#pragma unroll
      for (int k = 0; k < 4; ++k) cv[k] = cg[(4 * ry + k) * LG + n];
#pragma unroll
      for (int m = 0; m < PMAX / 8; ++m)
        hv[m] = m < MP ? hs[(py + 8 * m) * LN + n] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < PMAX / 8; ++m) acc[k][m] += cv[k] * hv[m];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float e = eseg[4 * ry + k];
#pragma unroll
      for (int m = 0; m < PMAX / 8; ++m) acc[k][m] *= e;
    }
  }

  // G = (C B^T) exp(seg_i - seg_j) on j <= i, 0 above; overwrites C.
  // Tiles (u, v) with v > u lie wholly above the diagonal: skipped.
  {
    float g[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) g[u][v] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        cv[u] = u < U ? cg[(gi + 16 * u) * LG + n] : 0.f;
#pragma unroll
      for (int v = 0; v < 8; ++v)
        bv[v] = v < U ? bs[(gj + 16 * v) * LN + n] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v <= u; ++v) g[u][v] += cv[u] * bv[v];
    }
    __syncthreads();  // every thread is done reading C
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (u >= U) break;
      const int i = gi + 16 * u;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        if (v >= U) break;
        const int j = gj + 16 * v;
        cg[i * LG + j] =
            (v <= u && j <= i)
                ? g[u][v] * expf(static_cast<float>(seg[i] - seg[j]))
                : 0.f;
      }
    }
  }
  __syncthreads();

  // intra-chunk term: acc += sum_{j <= i} G[i][j] (x dt)[j][p]; store y
  if (rows_live) {
    const int jmax = 4 * ry + 3;
    for (int j = 0; j <= jmax; ++j) {
      float gv[4], xv[PMAX / 8];
#pragma unroll
      for (int k = 0; k < 4; ++k) gv[k] = cg[(4 * ry + k) * LG + j];
#pragma unroll
      for (int m = 0; m < PMAX / 8; ++m)
        xv[m] = m < MP ? xs[j * LP + py + 8 * m] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < PMAX / 8; ++m) acc[k][m] += gv[k] * xv[m];
    }
    float* y = static_cast<float*>(p.y) +
               ((static_cast<long long>(ch.bi) * p.S + ch.s0) * p.H + ch.hi) *
                   P;
    const long long y_ss = static_cast<long long>(p.H) * P;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * ry + k;
      if (i < ch.cq) {
#pragma unroll
        for (int m = 0; m < PMAX / 8; ++m)
          if (m < MP) y[i * y_ss + py + 8 * m] = acc[k][m];
      }
    }
  }
}

// bf16 shared memory: seg (Qp doubles), dt and exp(seg) (Qp floats each),
// then in bf16 with rows padded by 16 bytes: C and B Qp x (N + 8) each
// (C's rows later stage y), x Qp x (P + 8), h_in P x (N + 8). At chunk 128,
// N 128, P 64 that is 107,520 bytes: two blocks per SM.
__host__ __device__ inline size_t output_smem_bf16(int Qp, int P, int N) {
  return 16 * Qp + 2 * (2 * static_cast<size_t>(Qp) * (N + 8) +
                        static_cast<size_t>(Qp) * (P + 8) +
                        static_cast<size_t>(P) * (N + 8));
}

__global__ void __launch_bounds__(THREADS, 2) chunk_output_bf16(Params p) {
  extern __shared__ double smem[];
  const Chunk ch(p);
  const int Qp = ch.Qp, P = p.P, N = p.N, LX = P + 8, LB = N + 8;
  const int tid = threadIdx.x;
  double* seg = smem;
  float* dts = reinterpret_cast<float*>(seg + Qp);
  float* eseg = dts + Qp;
  bf16* cs = reinterpret_cast<bf16*>(eseg + Qp);
  bf16* bs = cs + Qp * LB;
  bf16* xs = bs + Qp * LB;
  bf16* hs = xs + Qp * LX;
  load_dt(p, ch, dts);
  const long long row0 = ch.s0;
  load_rows(xs, LX,
            static_cast<const bf16*>(p.x) + ch.bi * p.x_sb + ch.hi * p.x_sh +
                row0 * p.x_ss,
            p.x_ss, Qp, ch.cq, P, p.vec);
  load_rows(bs, LB,
            static_cast<const bf16*>(p.b) + ch.bi * p.b_sb + row0 * p.b_ss,
            p.b_ss, Qp, ch.cq, N, p.vec);
  load_rows(cs, LB,
            static_cast<const bf16*>(p.c) + ch.bi * p.c_sb + row0 * p.c_ss,
            p.c_ss, Qp, ch.cq, N, p.vec);
  if (ch.ci > 0)  // the incoming state, rounded to bf16 by pass 2
    load_rows(hs, LB, p.h_in16 + ch.slot(p) * P * N, N, P, P, N, true);
  cp_async_wait_all();
  __syncthreads();
  chunk_seg(dts, ch.a, Qp, seg);
  __syncthreads();
  for (int j = tid; j < Qp; j += THREADS)
    eseg[j] = expf(static_cast<float>(seg[j]));
  __syncthreads();

  // warp w owns the chunk's rows [16 w, 16 w + 16): r_lo, r_hi = r_lo + 8
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int rt = warp;
  const bool live = 16 * rt < Qp;
  const int r_lo = 16 * rt + g, r_hi = r_lo + 8;
  const int KS = N / 16, PP = P / 16;
  float acc[PMAX / 8][4];  // y rows r_lo / r_hi, n8 tile of P
#pragma unroll
  for (int i = 0; i < PMAX / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  if (live) {
    uint32_t ca[NMAX / 16][4];  // this warp's rows of C, A operand by k-step
#pragma unroll
    for (int ks = 0; ks < NMAX / 16; ++ks)
      if (ks < KS)
        ldsm_x4(ca[ks], cs + (16 * rt + lr + 8 * (lm & 1)) * LB + ks * 16 +
                            8 * (lm >> 1));

    // carried state: exp(seg_i) (C h_in^T), h_in (P, N) rows as B's columns
    if (ch.ci > 0) {
#pragma unroll
      for (int ks = 0; ks < NMAX / 16; ++ks) {
        if (ks >= KS) continue;
#pragma unroll
        for (int pp = 0; pp < PMAX / 16; ++pp) {
          if (pp >= PP) continue;
          uint32_t hb[4];
          ldsm_x4(hb, hs + (pp * 16 + lr + 8 * (lm >> 1)) * LB + ks * 16 +
                          8 * (lm & 1));
          mma_16816(acc[2 * pp], ca[ks], hb[0], hb[1]);
          mma_16816(acc[2 * pp + 1], ca[ks], hb[2], hb[3]);
        }
      }
      const float e_lo = eseg[r_lo], e_hi = eseg[r_hi];
#pragma unroll
      for (int i = 0; i < PMAX / 8; ++i) {
        acc[i][0] *= e_lo;
        acc[i][1] *= e_lo;
        acc[i][2] *= e_hi;
        acc[i][3] *= e_hi;
      }
    }

    // intra-chunk: for each 16-column tile kt <= rt of the lower triangle,
    // C B^T on the tensor cores, decayed and scaled by dt (fp32), rounded
    // once to bf16 as the A operand of G' x
    const double seg_lo = seg[r_lo], seg_hi = seg[r_hi];
    for (int kt = 0; kt <= rt; ++kt) {
      float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < NMAX / 16; ++ks) {
        if (ks >= KS) continue;
        uint32_t bb[4];  // B rows [16 kt, 16 kt + 16) as B^T's columns
        ldsm_x4(bb, bs + (kt * 16 + lr + 8 * (lm >> 1)) * LB + ks * 16 +
                        8 * (lm & 1));
        mma_16816(cb[0], ca[ks], bb[0], bb[1]);
        mma_16816(cb[1], ca[ks], bb[2], bb[3]);
      }
      float gv[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? r_lo : r_hi;
          const int j = kt * 16 + h2 * 8 + 2 * t + (e & 1);
          const double si = e < 2 ? seg_lo : seg_hi;
          gv[h2][e] =
              j <= i ? cb[h2][e] *
                           fast_exp2(static_cast<float>(si - seg[j]) * LOG2E) *
                           dts[j]
                     : 0.f;
        }
      const uint32_t ga[4] = {pack_bf16(gv[0][0], gv[0][1]),
                              pack_bf16(gv[0][2], gv[0][3]),
                              pack_bf16(gv[1][0], gv[1][1]),
                              pack_bf16(gv[1][2], gv[1][3])};
#pragma unroll
      for (int pp = 0; pp < PMAX / 16; ++pp) {
        if (pp >= PP) continue;
        uint32_t xb[4];  // x rows [16 kt, 16 kt + 16): (j, p) rows
        ldsm_x4_t(xb, xs + (kt * 16 + lr + 8 * (lm & 1)) * LX + pp * 16 +
                          8 * (lm >> 1));
        mma_16816(acc[2 * pp], ga, xb[0], xb[1]);
        mma_16816(acc[2 * pp + 1], ga, xb[2], xb[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with C: its rows stage y
  bf16* ys = cs;
  if (live) {
#pragma unroll
    for (int i = 0; i < PMAX / 8; ++i) {
      if (i >= P / 8) continue;
      const int col = i * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ys + r_lo * LX + col) =
          pack_bf16(acc[i][0], acc[i][1]);
      *reinterpret_cast<uint32_t*>(ys + r_hi * LX + col) =
          pack_bf16(acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  bf16* y = static_cast<bf16*>(p.y) +
            ((static_cast<long long>(ch.bi) * p.S + ch.s0) * p.H + ch.hi) * P;
  const long long y_ss = static_cast<long long>(p.H) * P;
  const int per_row = P / 8;
  for (int e = tid; e < ch.cq * per_row; e += THREADS) {
    const int r = e / per_row, cv = (e % per_row) * 8;
    *reinterpret_cast<uint4*>(y + r * y_ss + cv) =
        *reinterpret_cast<const uint4*>(ys + r * LX + cv);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t bytes, const Params& p,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// The version of this C interface: 2 added the workspace and runs the
// three passes.
int ssd_scan_abi(void) { return 2; }

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. x: (B, S, H, P) with
// unit stride over P; dt: (B, S, H) float32; a_log: (H,) float32,
// contiguous; b, c: (B, S, N) with unit stride over N; all with the given
// element strides over the other axes. y: contiguous (B, S, H, P) in x's
// type; h_final: contiguous (B, H, P, N) float32. chunk: rows per chunk,
// 1..128. P in {16, 32, 64}, N in {16, 32, 64, 128}. workspace, 16-byte
// aligned, of B x ceil(S / chunk) x H x (P N + 1) floats, and P N / 2 more
// each for bf16 (see the wrapper's workspace_numel). Returns the
// CUDA error code of the first pass that failed (0 = ok).
int ssd_scan_fwd(const void* x, const float* dt, const float* a_log,
                 const void* b, const void* c, void* y, float* h_final,
                 float* workspace, int dtype, int B, int S, int H, int P,
                 int N, int chunk, long long x_sb, long long x_ss,
                 long long x_sh, long long dt_sb, long long dt_ss,
                 long long dt_sh, long long b_sb, long long b_ss,
                 long long c_sb, long long c_ss, void* stream) {
  const int NC = chunk >= 1 ? (S + chunk - 1) / chunk : 0;
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > QMAX ||
      (P != 16 && P != 32 && P != 64) ||
      (N != 16 && N != 32 && N != 64 && N != 128) || H > 65535 ||
      static_cast<long long>(B) * NC > INT_MAX ||
      static_cast<long long>(B) * H > INT_MAX || dtype < 0 || dtype > 1 ||
      !aligned16(workspace))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16 bytes a load: 8 bf16 or 4 floats per aligned row segment
  const long long v = dtype == 1 ? 8 : 4;
  const int vec = aligned16(x) && aligned16(b) && aligned16(c) &&
                  x_sb % v == 0 && x_ss % v == 0 && x_sh % v == 0 &&
                  b_sb % v == 0 && b_ss % v == 0 && c_sb % v == 0 &&
                  c_ss % v == 0;
  // workspace: the fp32 states, then for bf16 inputs the incoming states in
  // bf16, then the seg totals
  const long long n_state = static_cast<long long>(B) * NC * H * P * N;
  bf16* h_in16 =
      dtype == 1 ? reinterpret_cast<bf16*>(workspace + n_state) : nullptr;
  float* totals = workspace + n_state + (dtype == 1 ? n_state / 2 : 0);
  const Params p{x, dt, a_log, b, c, y, h_final, workspace, h_in16, totals,
                 B, S, H, P, N, chunk, NC,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb,
                 c_ss, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Qp = round16(chunk);
  const dim3 chunks(B * NC, H);
  const dim3 states(B * H, (P * N / 4 + THREADS - 1) / THREADS);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_one(chunk_state_f32, chunks, state_smem_f32(Qp, P, N), p, s);
    if (!err) err = launch_one(state_pass, states, 0, p, s);
    if (!err)
      err = launch_one(chunk_output_f32, chunks, output_smem_f32(Qp, P, N), p,
                       s);
  } else {
    err = launch_one(chunk_state_bf16, chunks, state_smem_bf16(Qp, P, N), p,
                     s);
    if (!err) err = launch_one(state_pass, states, 0, p, s);
    if (!err)
      err = launch_one(chunk_output_bf16, chunks, output_smem_bf16(Qp, P, N),
                       p, s);
  }
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
