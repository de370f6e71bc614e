// Causal / sliding-window / softcap GQA flash attention, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _flash_kernel). It computes the same function:
// softmax(mask(cap(q k^T / sqrt(d)))) v with an fp32 online softmax (m, l,
// acc), GQA with KV head h / (H / KV), bf16 or fp32 inputs, fp32
// accumulation. Query row i sits at position i + Sk - Sq (the right
// alignment of ref.py); the model calls it with Sq == Sk.
//
// What bounds it on this card: at smollm's shapes (S 512-2048, D 64)
// attention does ~S/2 multiply-adds per byte it must move, far above the
// H100's ~295 operations per byte, so it is bound by operations: the two
// products of each tile, which only the tensor cores run at speed.
// recurrentgemma's local layers (16 query heads on 1 KV head, D 256,
// window 2048) are bound by operations too.
//
// What the design does about it:
//  - One block per (batch * head, q tile of 64 rows). The TPU kernel walks
//    the KV blocks as a sequential grid axis and skips masked ones with
//    pl.when; here the KV loop runs inside the block and is bounded to the
//    causal / window range, so masked tiles cost nothing.
//  - bf16 (the model's type): the two products run on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate). Each of the four warps
//    owns 16 query rows; up to D 128 its Q fragments stay in registers (at
//    D 256 the output alone takes 128 registers a thread, so Q is read
//    again from shared memory for each KV tile), the scores stay in
//    registers and are re-packed as the A operand of P V (P rounded to
//    bf16, as the reference's chunked path does), and each row's m / l live
//    in the four lanes that hold it. K and V tiles are double-buffered in
//    shared memory by cp.async (the next tile's copy overlaps this tile's
//    products) with rows padded by 16 bytes, and read as fragments with
//    ldmatrix (V transposed on the way), so they hit distinct banks. Only
//    tiles that some (row, key) pair cannot see are masked, and the softmax
//    runs in base 2 (one multiply folds the scale and log2 e). wgmma / TMA
//    with warp specialisation is later work.
//  - fp32: the tensor cores would round to TF32, so fp32 runs on the CUDA
//    cores (67 TFLOP/s): tiles staged in shared memory, each thread keeping
//    a 4x4 block of scores and a 4 x D/16 block of the output.
//  - Ragged tails (S not a multiple of 64) are masked, not asserted away.
//  - The kernel launches on the caller's stream and allocates nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per KV tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk;
  long long q_sb, q_sh, q_ss;  // element strides of q over (batch, head, seq)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float scale;
};

// Scaled, capped and masked score of query position qpos and key kpos.
__device__ __forceinline__ float masked_score(const Params& p, float dot,
                                              int qpos, int kpos) {
  float x = dot * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && qpos - kpos < p.window;
  return ok ? x : -INFINITY;
}

// The KV tiles a q tile can see: up to its last row's position (causal),
// from its first row's window start (sliding window).
__device__ __forceinline__ void kv_range(const Params& p, int q0, int& lo,
                                         int& hi) {
  const int offset = p.Sk - p.Sq;
  const int q_first = q0 + offset;
  const int q_last = min(q0 + BQ, p.Sq) - 1 + offset;
  lo = 0;
  hi = p.Sk;
  if (p.causal) hi = min(p.Sk, q_last + 1);
  if (p.window > 0) lo = max(0, q_first - p.window + 1);
  lo = (lo / BK) * BK;
}

// The q tile of this block. The grid runs over (batch * head, q tile) with
// batch * head fastest, so blocks start tile by tile; causal tiles start
// from the last (the one that sees the most keys), so the cheap ones fill
// the tail of the launch.
__device__ __forceinline__ int q_tile(const Params& p) {
  return p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
}

// exp base of a row max: a row that has seen only masked keys keeps
// m = -inf; subtract 0 then, so exp gives 0 and not NaN.
__device__ __forceinline__ float exp_base(float m) {
  return m == -INFINITY ? 0.f : m;
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int SIMT_THREADS = 256;  // 16 x 16 threads, each owning 4 rows

template <int D>
constexpr int simt_smem_bytes() {
  // Qs, Ks: rows of D + 1; Vs: rows of D; Ss: BQ rows of BK + 1;
  // m, l, corr: BQ each.
  return 4 * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_fwd_f32(const Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1;   // odd row strides: column walks hit distinct
  constexpr int SP = BK + 1;  // banks
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ss = Vs + BK * D;
  float* m_s = Ss + BQ * SP;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = q_tile(p) * BQ;
  const int offset = p.Sk - p.Sq;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o) + static_cast<long long>(bh) * p.Sq * D;

  for (int i = tid; i < BQ * D; i += SIMT_THREADS) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    Qs[r * DP + c] = qi < p.Sq ? q[qi * p.q_ss + c] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  int kv_lo, kv_hi;
  kv_range(p, q0, kv_lo, kv_hi);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += SIMT_THREADS) {
      const int r = i / D, c = i % D;
      const int ki = k0 + r;
      const bool in = ki < p.Sk;
      Ks[r * DP + c] = in ? k[ki * p.k_ss + c] : 0.f;
      Vs[r * D + c] = in ? v[ki * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ss[r * SP + c] = masked_score(p, s[i][j], q0 + r + offset, k0 + c);
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, Ss[r * SP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float base = exp_base(m_new);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float e = expf(Ss[r * SP + c] - base);
        Ss[r * SP + c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - base);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[static_cast<long long>(q0 + r) * D + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // four warps of 16 query rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int mma_smem_bytes() {
  // Qs, then two K and two V buffers: 64 rows of D + 8 bf16 each
  return 2 * 5 * BQ * (D + 8);
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives row l / 4, columns 2 (l % 4) + {0, 1} of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, transposed: lane l receives rows 2 (l % 4) + {0, 1}, column
// l / 4 of each matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// 16 bytes global -> shared without passing through registers; zeros when
// !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start copying rows [r0, r0 + 64) of a (rows, D) bf16 matrix with row
// stride ld into shared memory (row stride D + 8); zeros past row n.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int r0, int n) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < BQ * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool valid = r0 + r < n;
    cp_async16(dst + r * (D + 8) + c, src + (valid ? (r0 + r) * ld + c : 0),
               valid);
  }
}

// The A fragment of Q for rows r0, r0 + 8 and head dims [16 kd, 16 kd + 16)
// from shared memory (row stride ld).
__device__ __forceinline__ void q_fragment(uint32_t (&f)[4], const bf16* Qs,
                                           int ld, int r0, int kd, int t) {
  const int c = kd * 16 + 2 * t;
  f[0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * ld + c]);
  f[1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * ld + c]);
  f[2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * ld + c + 8]);
  f[3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * ld + c + 8]);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16(const Params p) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int LD = D + 8;   // shared row stride (bf16): 16 bytes of pad
  constexpr int KD = D / 16;  // k-steps of Q K^T over head_dim
  constexpr int ND = D / 8;   // n-tiles of P V over head_dim
  constexpr int NK = BK / 8;  // n-tiles of Q K^T over keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;      // two buffers
  bf16* Vs = Ks + 2 * BK * LD;  // two buffers

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = q_tile(p) * BQ;
  const int offset = p.Sk - p.Sq;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + static_cast<long long>(bh) * p.Sq * D;

  int kv_lo, kv_hi;
  kv_range(p, q0, kv_lo, kv_hi);
  const int n_tiles = (kv_hi - kv_lo + BK - 1) / BK;

  // pipeline: Q and the first K/V tile in flight together; each step
  // starts the next tile's copy before computing on the current one
  load_tile<D>(Qs, q, p.q_ss, q0, p.Sq);
  cp_async_commit();
  load_tile<D>(Ks, k, p.k_ss, kv_lo, p.Sk);
  load_tile<D>(Vs, v, p.v_ss, kv_lo, p.Sk);
  cp_async_commit();
  cp_async_wait_one();
  __syncthreads();

  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  // D <= 128: the Q fragments stay in registers for the whole KV loop. At
  // D 256 they would take 64 registers beside the output's 128, so they are
  // read again from shared memory (where Q stays) for each KV tile.
  constexpr bool Q_IN_REGS = D <= 128;
  uint32_t qf[Q_IN_REGS ? KD : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) q_fragment(qf[kd], Qs, LD, r0, kd, t);
  }

  // scores are kept in base-2 units: y = x log2(e), p = 2^(y - m)
  const float scale2 = p.scale * LOG2E;
  const int qpos0 = q0 + r0 + offset;
  const int qpos1 = qpos0 + 8;
  const int q_last = min(q0 + BQ, p.Sq) - 1 + offset;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r0 + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the row sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix row addresses of this lane: K (keys x dims, plain) and V
  // (keys x dims, transposed)
  const int lrow = lane & 7, lmat = lane >> 3;
  const int k_off = lrow * LD + lmat * 8;
  const int v_off = ((lmat & 1) * 8 + lrow) * LD + (lmat >> 1) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_lo + it * BK;
    const bf16* Kb = Ks + (it & 1) * BK * LD;
    const bf16* Vb = Vs + (it & 1) * BK * LD;
    if (it + 1 < n_tiles) {
      load_tile<D>(Ks + ((it + 1) & 1) * BK * LD, k, p.k_ss, k0 + BK, p.Sk);
      load_tile<D>(Vs + ((it + 1) & 1) * BK * LD, v, p.v_ss, k0 + BK, p.Sk);
    }
    cp_async_commit();
    cp_async_wait_one();  // the current tile has landed
    __syncthreads();

    // S = Q K^T: n-tile j holds keys k0 + 8 j + 2 t (+1) of rows r0, r0 + 8
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; kd += 2) {
      uint32_t qs[2][4];
      if constexpr (!Q_IN_REGS) {
        q_fragment(qs[0], Qs, LD, r0, kd, t);
        q_fragment(qs[1], Qs, LD, r0, kd + 1, t);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kb + j * 8 * LD + kd * 16 + k_off);
        if constexpr (Q_IN_REGS) {
          mma_16816(s[j], qf[kd], kf[0], kf[1]);
          mma_16816(s[j], qf[kd + 1], kf[2], kf[3]);
        } else {
          mma_16816(s[j], qs[0], kf[0], kf[1]);
          mma_16816(s[j], qs[1], kf[2], kf[3]);
        }
      }
    }

    if (p.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = p.softcap * tanhf(s[j][e] * p.scale / p.softcap) * LOG2E;
    } else {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }
    // mask only a tile that some (row, key) pair of this block cannot see
    const bool whole = k0 + BK <= p.Sk &&
                       (!p.causal || k0 + BK - 1 <= q0 + offset) &&
                       (p.window <= 0 || q_last - k0 < p.window);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = kpos < p.Sk;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          if (!ok) s[j][e] = -INFINITY;
        }
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float base0 = exp_base(mn0), base1 = exp_base(mn1);
    const float corr0 = exp2f(m0 - base0), corr1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = exp2f(s[j][0] - base0);
      s[j][1] = exp2f(s[j][1] - base0);
      s[j][2] = exp2f(s[j][2] - base1);
      s[j][3] = exp2f(s[j][3] - base1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // acc += P V: the score accumulators of n-tiles 2 kk, 2 kk + 1 are the
    // A fragment of keys [16 kk, 16 kk + 16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vb + kk * 16 * LD + n * 8 + v_off);
        mma_16816(acc[n], a, vf[0], vf[1]);
        mma_16816(acc[n + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();  // all warps are done with this buffer
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (qi0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(&o[qi0 * static_cast<long long>(D) +
                                            c]) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (qi1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(&o[qi1 * static_cast<long long>(D) +
                                            c]) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0)
    return launch(flash_fwd_f32<D>, SIMT_THREADS, simt_smem_bytes<D>(), p,
                  stream);
  if (dtype == 1)
    return launch(flash_fwd_bf16<D>, MMA_THREADS, mma_smem_bytes<D>(), p,
                  stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q: (B, H, Sq, D), k/v: (B, KV, Sk, D)
// with unit stride over D and the given element strides over the other
// axes (bf16: 16-byte aligned rows); o: contiguous (B, H, Sq, D). Returns
// the CUDA error code (0 = ok).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KV, int Sq, int Sk, int D,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        int causal, int window, float softcap, float scale,
                        void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, B, H, KV, Sq, Sk,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_dtype<32>(dtype, p, s); break;
    case 64: err = launch_dtype<64>(dtype, p, s); break;
    case 128: err = launch_dtype<128>(dtype, p, s); break;
    case 256: err = launch_dtype<256>(dtype, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
