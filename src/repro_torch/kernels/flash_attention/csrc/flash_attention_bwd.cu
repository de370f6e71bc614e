// Causal / sliding-window / softcap GQA flash attention, backward, for
// Hopper (sm_90a).
//
// The TPU kernel (src/repro/kernels/flash_attention/kernel.py) has no
// backward: the reference trains through XLA's autodiff of its chunked
// attention. This kernel is the backward of flash_attention.cu's forward:
// given q (B, H, Sq, D), k / v (B, KV, Sk, D), the output o, the rows'
// log-sum-exp lse (B, H, Sq) that the forward wrote and the output's
// gradient do, it writes dq, dk and dv of o = softmax(mask(cap(q k^T /
// sqrt(d)))) v, in bf16 or fp32, at D 32-256, with the forward's masks
// (query row i at position i + Sk - Sq) and GQA (head h reads KV head
// h / (H / KV)). It follows FlashAttention-2:
//
//   delta_i = sum_d do_id o_id                    (a pass of its own)
//   s_ij    = cap(q_i . k_j scale), masked        (recomputed)
//   p_ij    = exp(s_ij - lse_i)                   (recomputed, no softmax)
//   dv_j   += sum_i p_ij do_i
//   dp_ij   = do_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i) (1 - tanh^2) scale
//   dk_j   += sum_i ds_ij q_i,     dq_i += sum_j ds_ij k_j
//
// with (1 - tanh^2) only under a softcap (c tanh(x / c) has derivative
// 1 - tanh^2(x / c)).
//
// What bounds it on this card: five products of 2 D flops for each (query,
// key) pair the mask lets through, against reading q, k, v, o, do, lse and
// writing dq, dk, dv once: at smollm's training shape (S 2048, D 64) it is
// bound by operations (~0.1 ms at the dense bf16 rate).
//
// What the design does about it (a first, simple design; wgmma and TMA
// are later work):
//  - One block of 8 warps per (batch, KV head, tile of BN keys). It keeps
//    its K and V tiles in shared memory and dK, dV in registers, and walks
//    every query head of the KV head's group and every query tile that can
//    see its keys (causal and window ranges: masked tiles are skipped), so
//    dK and dV are summed over the group without atomics and written once.
//  - dQ is summed over key tiles by fp32 atomics (two neighbouring head
//    dims per atomic, sm_90's float2 atomicAdd) into a workspace, zeroed by
//    the delta pass, then rounded into dq by a third pass.
//  - bf16: the products run on the tensor cores as mma.sync m16n8k16 (fp32
//    accumulate), their fragments loaded by ldmatrix, transposed where the
//    operand is read k-major (P^T, dS^T; dO, Q and K as B). P and dS are
//    rounded to bf16 for their products, as FlashAttention-2 does.
//  - fp32: the tensor cores would round to TF32, so the same routine runs
//    the products on the CUDA cores, each thread computing the elements an
//    mma.sync accumulator would hold. Tiles of 32 at D >= 128 keep shared
//    memory under the block's limit.
//  - Each query tile's Q, dO, lse and delta are copied in by cp.async
//    while the previous tile is in use (two buffers). No mbarrier: a
//    cp.async wait covers only the thread's own copies, which complete, and
//    the block synchronises with __syncthreads, so no wait can hang.
//  - The kernels launch on the caller's stream and allocate nothing: the
//    wrapper passes the workspace (delta, then dQ's fp32 sums).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq) contiguous
  void* dq;
  void* dk;
  void* dv;
  float* delta;   // workspace: (B, H, Sq)
  float* dq_acc;  // workspace: (B, H, Sq, D) contiguous fp32
  int B, H, KV, Sq, Sk;
  long long q_sb, q_sh, q_ss;  // element strides over (batch, head, seq)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// pass 1: delta = rowsum(do * o); zero dQ's fp32 sums. A warp per row.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta(const Params p) {
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.Sq) return;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh +
               row * p.o_ss;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb +
                  h * p.do_sh + row * p.do_ss;
  float* acc = p.dq_acc + (static_cast<long long>(bh) * p.Sq + row) * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) {
    sum += to_f32(dout[d]) * to_f32(o[d]);
    acc[d] = 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.delta[static_cast<long long>(bh) * p.Sq + row] = sum;
}

// ---------------------------------------------------------------------------
// pass 3: dq = dQ's fp32 sums, in q's type, through dq's strides
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq(const Params p) {
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.Sq) return;
  const float* acc =
      p.dq_acc + (static_cast<long long>(bh) * p.Sq + row) * D;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss;
  for (int d = lane; d < D; d += 32) dq[d] = from_f32<T>(acc[d]);
}

// ---------------------------------------------------------------------------
// pass 2: dK, dV (and dQ's sums)
// ---------------------------------------------------------------------------

// A warp's part of a (rows x cols) product: a group of 16 rows and a chunk
// of this many columns; the warps split the rows / 16 groups, then the
// columns.
constexpr int warp_cols(int rows, int cols) {
  return cols / (WARPS / (rows / 16));
}

// Tiles: BM query rows, BN keys; rows of shared memory padded by 16 bytes
// (rows of fp32 tiles at D >= 128 would not fit twice).
template <typename T, int D>
struct Tile {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BM = (F32 && D >= 128) ? 32 : 64;
  static constexpr int BN = BM;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD;   // Q, dO, K, V rows
  static constexpr int LP = BN + PAD;  // P, dS rows
  static constexpr int WS = warp_cols(BM, BN);   // S and dP: columns a warp
  static constexpr int WKV = warp_cols(BN, D);   // dK and dV
  static constexpr int WQ = warp_cols(BM, D);    // dQ
  // K and V; Q and dO, two tiles each; P and dS; lse and delta, two each
  static constexpr int SMEM =
      sizeof(T) * (2 * BN * LD + 4 * BM * LD + 2 * BM * LP) + 16 * BM;
  // at D <= 64 two blocks share an SM
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  static_assert(WARPS % (BM / 16) == 0 && WARPS % (BN / 16) == 0, "tiles");
  static_assert(WS % 8 == 0 && WKV % 8 == 0 && WQ % 8 == 0, "warp tiles");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives row l / 4, columns 2 (l % 4) + {0, 1} of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: lane l receives rows 2 (l % 4) + {0, 1}, column
// l / 4 of each matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ``bytes`` (4 or 16) global -> shared without passing through registers;
// zeros when !valid (src must still be a mapped address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

// A warp's C (16 x 8 NT) += A (16 x K) B (K x 8 NT), both in shared memory:
// A's element (m, k) at a[m AM + k AK], B's (k, n) at b[k BK + n BN_], one
// of each pair of strides 1 (rows 16-byte aligned). C is held as mma.sync
// accumulators: n-tile j, element e is row g + 8 (e / 2), column 8 j + 2 t
// + e % 2 (g = lane / 4, t = lane % 4). bf16 fragments come by ldmatrix,
// transposed where k is not the contiguous axis (A = P^T or dS^T; B = dO,
// Q or K read k-major); B two n-tiles at a time.
template <typename T, int K, int NT, int AM, int AK, int BK, int BN_>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* a,
                                          const T* b, int g, int t) {
  const int lane = 4 * g + t;
  const int r8 = lane & 7, hi = lane >> 4, odd = (lane >> 3) & 1;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    if constexpr (std::is_same<T, bf16>::value) {
      static_assert(NT % 2 == 0 && (AK == 1 || AM == 1) &&
                    (BK == 1 || BN_ == 1), "fragment layouts");
      uint32_t fa[4];
      if constexpr (AK == 1)   // rows m, k contiguous: a0..a3 in order
        ldmatrix_x4(fa, a + (lane & 15) * AM + k0 + hi * 8);
      else                     // rows k: matrices (k0, m0), (k0, m0 + 8),
        ldmatrix_x4_trans(     // (k0 + 8, m0), (k0 + 8, m0 + 8)
            fa, a + (k0 + r8 + hi * 8) * AK + odd * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t fb[4];  // b0, b1 of n-tile j, then of n-tile j + 1
        if constexpr (BK == 1)   // rows n, k contiguous
          ldmatrix_x4(fb, b + ((j + hi) * 8 + r8) * BN_ + k0 + odd * 8);
        else                     // rows k
          ldmatrix_x4_trans(fb, b + (k0 + odd * 8 + r8) * BK + (j + hi) * 8);
        mma_16816(c[j], fa, fb[0], fb[1]);
        mma_16816(c[j + 1], fa, fb[2], fb[3]);
      }
    } else {
#pragma unroll 4
      for (int k = k0; k < k0 + 16; ++k) {
        const float a0 = a[g * AM + k * AK];
        const float a1 = a[(g + 8) * AM + k * AK];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float b0 = b[k * BK + (8 * j + 2 * t) * BN_];
          const float b1 = b[k * BK + (8 * j + 2 * t + 1) * BN_];
          c[j][0] = fmaf(a0, b0, c[j][0]);
          c[j][1] = fmaf(a0, b1, c[j][1]);
          c[j][2] = fmaf(a1, b0, c[j][2]);
          c[j][3] = fmaf(a1, b1, c[j][3]);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// Start copying rows [r0, r0 + ROWS) of a (rows, D) matrix with row stride
// ld into shared memory (row stride LD), 16 bytes at a time; zeros past
// row n.
template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ld,
                                          int r0, int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    const bool valid = r0 + r < n;
    cp_async<16>(dst + r * LD + c, src + (valid ? (r0 + r) * ld + c : 0),
                 valid);
  }
}

// The query rows [lo, hi) that can see some key of [n0, n_end): causal
// rows from the first key's position on, window rows up to the last key's
// position + window - 1.
__device__ __forceinline__ void q_range(const Params& p, int n0, int n_end,
                                        int& lo, int& hi) {
  const int offset = p.Sk - p.Sq;
  lo = p.causal ? max(0, n0 - offset) : 0;
  hi = p.window > 0 ? min(p.Sq, n_end - 1 + p.window - offset) : p.Sq;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Tile<T, D>::MIN_BLOCKS)
flash_bwd_dkdv(const Params p) {
  using TL = Tile<T, D>;
  constexpr int BM = TL::BM, BN = TL::BN, LD = TL::LD, LP = TL::LP;
  constexpr int WS = TL::WS, WKV = TL::WKV, WQ = TL::WQ;
  constexpr int QN = WQ < 32 ? WQ : 32;  // dQ's columns per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BN * LD;
  T* Qs = Vs + BN * LD;      // two tiles
  T* dOs = Qs + 2 * BM * LD;  // two tiles
  T* Ps = dOs + 2 * BM * LD;
  T* dSs = Ps + BM * LP;
  float* lse_s = reinterpret_cast<float*>(dSs + BM * LP);  // two tiles
  float* delta_s = lse_s + 2 * BM;                          // two tiles

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;
  const int group = p.H / p.KV;
  const int n_end = min(n0 + BN, p.Sk);
  const int offset = p.Sk - p.Sq;

  // this warp's tiles: S / dP rows sr.. (16) x columns sc.. (WS); dK / dV
  // keys kr.. (16) x head dims kc.. (WKV); dQ rows qr.. x head dims qc..
  const int sr = 16 * (warp % (BM / 16)), sc = WS * (warp / (BM / 16));
  const int kr = 16 * (warp % (BN / 16)), kc = WKV * (warp / (BN / 16));
  const int qr = 16 * (warp % (BM / 16)), qc = WQ * (warp / (BM / 16));
  float dk[WKV / 8][4], dv[WKV / 8][4];
  zero(dk);
  zero(dv);

  // the (head of the group, query tile) pairs this block walks, a query
  // tile's Q, dO, lse and delta copied in while the previous one is used
  int q_lo, q_hi;
  q_range(p, n0, n_end, q_lo, q_hi);
  const int m_first = (q_lo / BM) * BM;
  const int per_head = q_hi > m_first ? (q_hi - m_first + BM - 1) / BM : 0;
  const int n_tiles = group * per_head;
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int h = kvh * group + it / per_head;
    const int m0 = m_first + (it % per_head) * BM;
    const long long bh = static_cast<long long>(b) * p.H + h;
    load_rows<T, BM, D, LD>(Qs + buf * BM * LD, static_cast<const T*>(p.q) +
                            b * p.q_sb + h * p.q_sh, p.q_ss, m0, p.Sq);
    load_rows<T, BM, D, LD>(dOs + buf * BM * LD,
                            static_cast<const T*>(p.dout) + b * p.do_sb +
                            h * p.do_sh, p.do_ss, m0, p.Sq);
    if (threadIdx.x < BM) {
      const int i = m0 + threadIdx.x;
      const bool valid = i < p.Sq;
      const long long at = bh * p.Sq + (valid ? i : 0);
      cp_async<4>(lse_s + buf * BM + threadIdx.x, p.lse + at, valid);
      cp_async<4>(delta_s + buf * BM + threadIdx.x, p.delta + at, valid);
    }
    cp_async_commit();
  };

  load_rows<T, BN, D, LD>(Ks, static_cast<const T*>(p.k) + b * p.k_sb +
                                  kvh * p.k_sh, p.k_ss, n0, p.Sk);
  load_rows<T, BN, D, LD>(Vs, static_cast<const T*>(p.v) + b * p.v_sb +
                                  kvh * p.v_sh, p.v_ss, n0, p.Sk);
  cp_async_commit();
  if (n_tiles > 0) prefetch(0);
  const bool has_softcap = p.softcap > 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int m0 = m_first + (it % per_head) * BM;
    const long long bh =
        static_cast<long long>(b) * p.H + kvh * group + it / per_head;
    if (it + 1 < n_tiles) {
      prefetch(it + 1);  // into the other buffer, free since the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and K, V) landed for every thread
    const T* Qb = Qs + buf * BM * LD;
    const T* dOb = dOs + buf * BM * LD;
    const float* lse_b = lse_s + buf * BM;
    const float* delta_b = delta_s + buf * BM;

    // S = Q K^T and dP = dO V^T of this warp's tile
    float s[WS / 8][4], dp[WS / 8][4];
    zero(s);
    zero(dp);
    warp_gemm<T, D, WS / 8, LD, 1, 1, LD>(s, Qb + sr * LD, Ks + sc * LD, g,
                                          t);
    warp_gemm<T, D, WS / 8, LD, 1, 1, LD>(dp, dOb + sr * LD, Vs + sc * LD,
                                          g, t);
    // P and dS, into shared memory
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = sr + g + 8 * (e >> 1);
        const int c = sc + 8 * j + 2 * t + (e & 1);
        const int i = m0 + r, key = n0 + c;
        const int qpos = i + offset;
        bool ok = i < p.Sq && key < p.Sk;
        if (p.causal) ok = ok && key <= qpos;
        if (p.window > 0) ok = ok && qpos - key < p.window;
        float x = s[j][e] * p.scale, th = 0.f;
        if (has_softcap) {
          th = tanhf(x / p.softcap);
          x = p.softcap * th;
        }
        const float pr = ok ? expf(x - lse_b[r]) : 0.f;
        float ds = pr * (dp[j][e] - delta_b[r]);
        if (has_softcap) ds *= 1.f - th * th;
        Ps[r * LP + c] = from_f32<T>(pr);
        dSs[r * LP + c] = from_f32<T>(ds * p.scale);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: A (key, row) = P[row][key]
    warp_gemm<T, BM, WKV / 8, 1, LP, LD, 1>(dv, Ps + kr, dOb + kc, g, t);
    warp_gemm<T, BM, WKV / 8, 1, LP, LD, 1>(dk, dSs + kr, Qb + kc, g, t);
    // dQ += dS K, QN head dims at a time, summed over key tiles by atomics
#pragma unroll 1
    for (int c0 = qc; c0 < qc + WQ; c0 += QN) {
      float dq[QN / 8][4];
      zero(dq);
      warp_gemm<T, BN, QN / 8, LP, 1, LD, 1>(dq, dSs + qr * LP, Ks + c0, g,
                                             t);
      float* acc = p.dq_acc + (bh * p.Sq + m0) * D;
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {  // two neighbouring head dims
          const int r = qr + g + 8 * (e >> 1);
          const int c = c0 + 8 * j + 2 * t;
          if (m0 + r < p.Sq)
            atomicAdd(reinterpret_cast<float2*>(acc + r * D + c),
                      make_float2(dq[j][e], dq[j][e + 1]));
        }
      }
    }
    __syncthreads();  // P, dS and this tile's buffer are free again
  }
  cp_async_wait<0>();  // K and V, when no query tile sees these keys

  // dK and dV of this block's keys, summed over the group's heads
  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int j = 0; j < WKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + kr + g + 8 * (e >> 1);
      const int c = kc + 8 * j + 2 * t + (e & 1);
      if (key < p.Sk) {
        dkp[key * p.dk_ss + c] = from_f32<T>(dk[j][e]);
        dvp[key * p.dv_ss + c] = from_f32<T>(dv[j][e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  using TL = Tile<T, D>;
  const dim3 rows((p.Sq + WARPS - 1) / WARPS, p.B * p.H);
  flash_bwd_delta<T, D><<<rows, THREADS, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TL::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 tiles((p.Sk + TL::BN - 1) / TL::BN, p.B * p.KV);
  flash_bwd_dkdv<T, D><<<tiles, THREADS, TL::SMEM, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq<T, D><<<rows, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0) return launch<float, D>(p, stream);
  if (dtype == 1) return launch<bf16, D>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The version of this C interface.
int flash_attention_bwd_abi(void) { return 1; }

// dtype: 0 = float32, 1 = bfloat16. q, o, do, dq: (B, H, Sq, D); k, v, dk,
// dv: (B, KV, Sk, D); each with unit stride over D, the given element
// strides over the other axes, 16-byte aligned rows and strides. lse: the
// forward's fp32 (B, H, Sq), contiguous. workspace: B H Sq (D + 1) fp32.
// Returns 0 or a CUDA error code.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* workspace,
                        int dtype, int B, int H, int KV, int Sq, int Sk, int D,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        long long do_sb, long long do_sh, long long do_ss,
                        long long dq_sb, long long dq_sh, long long dq_ss,
                        long long dk_sb, long long dk_sh, long long dk_ss,
                        long long dv_sb, long long dv_sh, long long dv_ss,
                        int causal, int window, float softcap, float scale,
                        void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      B * H > 65535 || B * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* delta = workspace;
  float* dq_acc = workspace + static_cast<long long>(B) * H * Sq;
  const Params p{q, k, v, o, dout, lse, dq, dk, dv, delta, dq_acc,
                 B, H, KV, Sq, Sk,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, do_sb, do_sh, do_ss,
                 dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
                 causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dtype<32>(dtype, p, s);
    case 64: return launch_dtype<64>(dtype, p, s);
    case 128: return launch_dtype<128>(dtype, p, s);
    case 256: return launch_dtype<256>(dtype, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
