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
// bound by operations (~0.1 ms at the dense bf16 rate), which only the
// tensor cores reach, and only through wgmma.
//
// Three kernels a call (four at D 256 with splits), on the caller's stream:
//  1. delta: per 64-row query tile, delta = rowsum(do * o) and the rows'
//     lse into one 512-byte record (64 lse, then 64 delta; rows past Sq get
//     lse = +inf, so exp(s - lse) is 0 there), and zeros into the tile's
//     fp32 dQ sums. 16-byte loads and stores.
//  2. dK / dV (and dQ's sums): one block per (batch, KV head, tile of
//     keys) keeps its K and V in shared memory and dK, dV in registers and
//     walks every query head of the KV head's group and every query tile
//     the masks let through, so dK and dV are summed over the group without
//     atomics and written once. Causal key tiles near 0 see the most query
//     tiles: they start first.
//  3. dq: the fp32 sums rounded into dq through its strides, 16 bytes a
//     thread.
// dQ's sums live in the workspace by 64-row tile, each tile's 64 x D fp32 as
// column blocks of 32 head dims, a row's eight 16-byte chunks XOR-swizzled
// by the row (so the wgmma kernel's staging is free of bank conflicts and
// one bulk copy moves a tile); the records follow.
//
// Pass 2 has three designs, chosen at compile time by type and head_dim:
//  - bf16 at D 64 and 128 (smollm's training, and the head_dim of gemma2,
//    qwen3, phi3.5 and deepseek): wgmma fed by TMA (flash_bwd_wgmma). A
//    block has consumer warpgroups of 64 keys each: two at D 64 (128 keys,
//    256 threads), one at D 128, whose dK and dV alone take 128 registers a
//    thread. Its thread 0 issues every load by TMA: K and V once, then each
//    query tile's Q and dO (64 rows) and its record (a bulk copy) into a
//    ring of three stages, each signalled by an mbarrier; a stage takes its
//    next tile once both consumers are past a named barrier that follows
//    their last read of it. Every mbarrier wait traps after 4 s, so a broken
//    pipeline fails the launch instead of holding the card.
//    A consumer computes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16;
//    at D 64 its rows of K and V sit in registers as the A operands, loaded
//    once by ldmatrix; at D 128 both operands are K-major in shared
//    memory), so P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) sit in
//    the accumulator layout of its key rows; rounded to bf16 they are the
//    register A operands of dV += P^T dO and dK += dS^T Q (dO and Q read
//    transposed from shared memory): P never goes through shared memory.
//    dS^T alone does, double-buffered: once both consumers have stored
//    their rows (a named barrier), each computes dQ = dS K over the block's
//    keys for its share of the head dims, half at D 64 (A = dS^T and B = K
//    both read transposed; K is stored in 64-byte rows, 32 head dims, so a
//    half is whole rows), stages that 64-row fp32 tile in shared memory and one
//    thread adds it to dQ's sums by one bulk reduce-add
//    (cp.reduce.async.bulk .add.f32), with no per-element atomics. Tiles are
//    stored as TMA writes them: rows of 128 bytes (64 head dims, or 64
//    query columns of dS^T) with the 128-byte swizzle, or of 64 bytes (K)
//    with the 64-byte swizzle, one column block after another, and the
//    wgmma descriptors use the same swizzles. The softmax-like step runs as
//    straight-line code, its masks in a loop of their own for the tiles
//    that need them. ptxas allocates registers for a wgmma kernel as if its
//    block were a whole number of warpgroups: a producer warp beside two
//    consumers left 168 a thread (384 threads' share) and spilled, so the
//    consumers issue the loads themselves (at most 255 registers).
//  - bf16 at D 256 (recurrentgemma's local layers, paligemma): wgmma fed by
//    TMA (flash_bwd_wgmma256). dK and dV of 64 keys x 256 dims would take
//    256 registers a thread in one warpgroup, so a block's two consumer
//    warpgroups split the head dims: each holds dK and dV for 128 of them
//    (128 registers). S^T = K Q^T and dP^T = V dO^T contract over all 256
//    dims; each warpgroup computes them once, for its 32 of the tile's 64
//    query columns (m64n32k16, both operands K-major in shared memory), and
//    the halves of P^T and dS^T meet in shared memory (bf16, 128-byte
//    swizzle), where both warpgroups read them as A for dV += P^T dO, dK +=
//    dS^T Q and dQ = dS K over its own 128 dims (m64n128k16). Shared
//    memory: K, V (32 KB each), two stages of Q and dO (64 KB each), P^T and
//    dS^T inside a 32 KB area that, once every product of the tile is done,
//    stages each warpgroup's dQ 64 dims at a time for the bulk reduce-add
//    (225 KB in all, one block an SM). A key tile has few blocks at a batch
//    of one (64 at S 4096 with one KV head), so ``splits`` blocks share its
//    (head, query tile) items, each a contiguous range; they write fp32
//    partials of dK and dV, and a fourth kernel (flash_bwd_dkdv_sum) sums
//    them in split order into dk and dv. The wrapper picks splits so that
//    the grid has about three blocks per SM.
//  - bf16 at D 32, and fp32 at every D: a block of 8 warps runs the
//    products as mma.sync m16n8k16 (fp32 accumulate), fragments loaded by
//    ldmatrix (bf16), or on the CUDA cores (fp32: the tensor cores would
//    round to TF32), each thread computing the elements an mma.sync
//    accumulator would hold (flash_bwd_dkdv). P and dS go through shared
//    memory; each query tile's Q, dO and record are copied in by cp.async
//    while the previous tile is used (two buffers; no mbarrier, so no wait
//    can hang); dQ is added to its sums by sm_90's float2 atomics. Tiles of
//    32 at fp32 D >= 128 keep shared memory under the block's limit.
// P and dS are rounded to bf16 for their products (bf16 inputs), as
// FlashAttention-2 does. The kernels allocate nothing: the wrapper passes
// the workspace (dQ's sums, then the records).
#include <cuda.h>  // CUtensorMap and its enums (the encoder: at run time)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;            // flash_bwd_dkdv and the passes
constexpr int THREADS = 32 * WARPS;
constexpr int QTILE = 64;           // rows of a dQ tile and of a record
constexpr int REC = 2 * QTILE;      // floats of a record: lse, then delta
constexpr float LOG2E = 1.4426950408889634f;

// Errors of our own, beside CUDA's codes
constexpr int kErrNoEncoder = 2001;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 2002;     // a tensor map was refused

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
  float* dq_acc;  // workspace: (B, H, QT) tiles of 64 x D fp32, swizzled
  float* rec;     // workspace: (B, H, QT) records of 64 lse, 64 delta
  int B, H, KV, Sq, Sk;
  int QT;         // 64-row query tiles: ceil(Sq / 64)
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
  int splits;     // D 256 route: blocks that share a key tile's items
  float* part;    // workspace, splits > 1: fp32 dK, then dV, partials,
                  // (splits, B, KV, Sk, D) each
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Where element (r, c) of a 64 x D tile of dQ's sums sits in the tile:
// column block c / 32 (2048 floats), row r (32 floats), its 4-float chunk
// XOR-swizzled by r % 8. Two neighbouring columns 2i, 2i + 1 stay
// neighbours.
__device__ __forceinline__ int acc_offset(int r, int c) {
  return (c >> 5) * 2048 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) +
         (c & 3);
}

// The first float of query tile qt's dQ sums, and of its record
__device__ __forceinline__ float* acc_tile(const Params& p, long long bh,
                                           int qt, int D) {
  return p.dq_acc + (bh * p.QT + qt) * QTILE * D;
}
__device__ __forceinline__ float* rec_tile(const Params& p, long long bh,
                                           int qt) {
  return p.rec + (bh * p.QT + qt) * REC;
}

// sum over 16 bytes of x and y of x_i y_i
__device__ __forceinline__ float dot16(const float4& x, const float4& y,
                                       float) {
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}
__device__ __forceinline__ float dot16(const float4& x, const float4& y,
                                       bf16) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), w = __bfloat1622float2(b[i]);
    s = fmaf(u.x, w.x, fmaf(u.y, w.y, s));
  }
  return s;
}

// ---------------------------------------------------------------------------
// pass 1: per 64-row query tile, the record (lse, delta = rowsum(do * o))
// and zeros into dQ's sums
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta(const Params p) {
  constexpr int VEC = 16 / sizeof(T);      // elements per 16 bytes
  constexpr int CH = D / VEC;              // 16-byte chunks per row
  constexpr int LPR = CH < 32 ? CH : 32;   // lanes per row
  constexpr int RPP = THREADS / LPR;       // rows per pass
  static_assert(QTILE % RPP == 0, "rows");
  const long long bh = blockIdx.y;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int qt = blockIdx.x, m0 = qt * QTILE;
  const int part = threadIdx.x % LPR;
  float* rec = rec_tile(p, bh, qt);
  for (int r = threadIdx.x / LPR; r < QTILE; r += RPP) {
    const int i = m0 + r;
    float sum = 0.f;
    if (i < p.Sq) {
      const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh +
                   i * p.o_ss;
      const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb +
                      h * p.do_sh + i * p.do_ss;
      for (int c = part; c < CH; c += LPR)
        sum += dot16(*reinterpret_cast<const float4*>(o + c * VEC),
                     *reinterpret_cast<const float4*>(dout + c * VEC), T());
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) {
      rec[r] = i < p.Sq ? p.lse[bh * p.Sq + i] : INFINITY;
      rec[QTILE + r] = sum;
    }
  }
  float4* acc = reinterpret_cast<float4*>(acc_tile(p, bh, qt, D));
  for (int c = threadIdx.x; c < QTILE * D / 4; c += THREADS)
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// pass 3: dq = dQ's fp32 sums, in q's type, through dq's strides
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq(const Params p) {
  const long long bh = blockIdx.y;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int qt = blockIdx.x, m0 = qt * QTILE;
  const float4* acc = reinterpret_cast<const float4*>(acc_tile(p, bh, qt, D));
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  for (int c = threadIdx.x; c < QTILE * D / 4; c += THREADS) {
    // chunk c: column block c / 512, row (c / 8) % 64, stored chunk c % 8
    const int r = (c >> 3) & (QTILE - 1);
    const int col = (c >> 9) * 32 + (((c & 7) ^ (r & 7)) << 2);
    if (m0 + r >= p.Sq) continue;
    const float4 x = acc[c];
    T* dst = dq + (m0 + r) * p.dq_ss + col;
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(dst) = x;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst) = packed;
    }
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// pass 2, mma.sync / CUDA cores (bf16 at D 32, fp32): dK, dV and
// dQ's sums
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
  static_assert(QTILE % BM == 0, "query tiles within a dQ tile");
};

// Four 8x8 bf16 matrices; lane l gives the (shared) address of row l % 8
// of matrix l / 8 and receives row l / 4, columns 2 (l % 4) + {0, 1} of
// each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t at) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(at));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  ldmatrix_x4(r, smem_u32(p));
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
    if (threadIdx.x < BM) {  // the record covers every row of the tile
      const float* rec = rec_tile(p, bh, m0 / QTILE) + m0 % QTILE;
      cp_async<4>(lse_s + buf * BM + threadIdx.x, rec + threadIdx.x, true);
      cp_async<4>(delta_s + buf * BM + threadIdx.x,
                  rec + QTILE + threadIdx.x, true);
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
    float* acc = acc_tile(p, bh, m0 / QTILE, D);
    const int ar = m0 % QTILE;  // this tile's first row in the dQ tile
#pragma unroll 1
    for (int c0 = qc; c0 < qc + WQ; c0 += QN) {
      float dq[QN / 8][4];
      zero(dq);
      warp_gemm<T, BN, QN / 8, LP, 1, LD, 1>(dq, dSs + qr * LP, Ks + c0, g,
                                             t);
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {  // two neighbouring head dims
          const int r = qr + g + 8 * (e >> 1);
          const int c = c0 + 8 * j + 2 * t;
          if (m0 + r < p.Sq)
            atomicAdd(reinterpret_cast<float2*>(acc + acc_offset(ar + r, c)),
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
// pass 2, wgmma + TMA, warp-specialised (bf16 at D 64 and 128): dK, dV and
// dQ's sums
// ---------------------------------------------------------------------------

constexpr int STAGES = 3;  // query tiles in flight
constexpr int ROWB = 128;  // bytes of a shared-memory row: 64 bf16
constexpr int KROWB = 64;  // K's rows: 32 bf16, so dQ's products split D
// named barriers: 0 is __syncthreads, DS_READY the consumers' dS^T of a
// query tile in shared memory, STAGED + wg consumer wg's dQ tile staged
constexpr int DS_READY = 1;
constexpr int STAGED = 2;

// A block: NWG consumer warpgroups of 64 keys; thread 0 also issues the
// loads (at most 255 registers a thread). At D 64 (two consumers) a thread
// holds dK and dV (64 fp32 registers), S^T and dP^T (64), and its rows of K
// and V as the A operands of S^T and dP^T (32); at D 128 (one consumer) dK
// and dV alone take 128, and K and V stay in shared memory.
template <int D>
struct Wg {
  static constexpr int NWG = D == 64 ? 2 : 1;
  static constexpr int NK = 64 * NWG;             // keys per block
  static constexpr int THREADS = 128 * NWG;
  static constexpr bool KV_REGS = D == 64;        // K, V as register A
  static constexpr int CB = D / 64;               // column blocks of 64
  static constexpr int QT_BYTES = QTILE * D * 2;  // one Q or dO tile
  static constexpr int KV_BYTES = NK * D * 2;     // K or V
  static constexpr int DS_BYTES = NK * QTILE * 2; // dS^T of one query tile
  static constexpr int DQ = D / NWG;              // dQ's columns a consumer
  static constexpr int ACC_BYTES = QTILE * DQ * 4;  // its staged dQ tile
  static constexpr int REC_BYTES = REC * 4;
  // byte offsets from the 1024-byte aligned base (swizzled tiles need it)
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_BYTES;
  static constexpr int OFF_Q = OFF_V + KV_BYTES;              // STAGES
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;    // STAGES
  static constexpr int OFF_DS = OFF_DO + STAGES * QT_BYTES;   // 2
  static constexpr int OFF_ACC = OFF_DS + 2 * DS_BYTES;       // NWG
  static constexpr int OFF_REC = OFF_ACC + NWG * ACC_BYTES;   // STAGES
  static constexpr int OFF_BAR = OFF_REC + STAGES * REC_BYTES;
  // K and V loaded; per stage, its query tile loaded
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + STAGES);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
// A wait that never ends is a bug in the pipeline: after 4 s, trap, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  for (uint32_t polls = 1;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls % 4096 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > 4000000000ull) __trap();
    }
  }
}

// TMA: the box of ``map`` at coordinates (c0, c1, c2, c3) into shared
// memory at dst; its bytes complete a transaction of the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// bytes (a multiple of 16) global -> shared at dst, both 16-byte aligned;
// they complete a transaction of the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// global[dst + i] += shared[src + i] for bytes / 4 floats, as one
// asynchronous bulk operation (a bulk group of this thread).
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Make this thread's writes to shared memory visible to the async proxy
// (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle (SW128: rows of 128 bytes, 64
// bf16; SW64: rows of 64 bytes, 32 bf16). K-major (rows along m or n, k
// contiguous): the leading offset is unused, the stride is 8 rows.
// MN-major (rows along k, m or n contiguous): the leading offset is the
// stride of the next row's worth of m or n, the stride 8 rows.
constexpr uint64_t SW128 = 1, SW64 = 2;
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo,
                                               uint64_t layout = SW128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x (the hardware's approximation, relative error 2^-22; 0 for -inf)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 32, fp32) (+)= A (64 x 16) B (16 x 32), both in shared memory:
// K-major when TA / TB is 0, MN-major (read transposed) when 1; d is
// overwritten when accumulate is 0.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both in shared memory:
// K-major when TA / TB is 0, MN-major (read transposed) when 1; d is
// overwritten when accumulate is 0.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128), both in shared memory:
// K-major when TA / TB is 0, MN-major (read transposed) when 1; d is
// overwritten when accumulate is 0.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 64, fp32) (+)= A (64 x 16, registers) B (16 x 64, in shared
// memory: K-major when TB is 0, MN-major (read transposed) when 1); d is
// overwritten when accumulate is 0.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// d (64 x 128, fp32) (+)= A (64 x 16, registers) B (16 x 128, in shared
// memory: K-major when TB is 0, MN-major (read transposed) when 1); d is
// overwritten when accumulate is 0.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// An accumulator of 64 x 64 (n8 block j: a[4 j .. 4 j + 3]: rows r0, r0 +
// 8, columns 8 j + 2 t + {0, 1}), rounded to bf16, as the register A
// operands of a product over its columns: 16 at a time.
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4][4],
                                       const float (&a)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(a[8 * kk], a[8 * kk + 1]);
    pa[kk][1] = pack_bf16(a[8 * kk + 2], a[8 * kk + 3]);
    pa[kk][2] = pack_bf16(a[8 * kk + 4], a[8 * kk + 5]);
    pa[kk][3] = pack_bf16(a[8 * kk + 6], a[8 * kk + 7]);
  }
}

struct Maps {
  CUtensorMap q, k, v, dout;  // 4-d over (D, S, heads, B)
};

template <int D>
__global__ void __launch_bounds__(Wg<D>::THREADS, 1)
flash_bwd_wgmma(const __grid_constant__ Maps maps, const Params p) {
  using W = Wg<D>;
  constexpr int NWG = W::NWG, NK = W::NK, CB = W::CB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + W::OFF_K, sV = base + W::OFF_V;
  auto sQ = [&](int s) { return base + W::OFF_Q + s * W::QT_BYTES; };
  auto sdO = [&](int s) { return base + W::OFF_DO + s * W::QT_BYTES; };
  auto sDS = [&](int i) { return base + W::OFF_DS + i * W::DS_BYTES; };
  auto sRec = [&](int s) { return base + W::OFF_REC + s * W::REC_BYTES; };
  const uint32_t kv_full = base + W::OFF_BAR;
  auto q_full = [&](int s) { return kv_full + 8u * (1 + s); };

  // key tile blockIdx.y: under a causal mask tile 0 sees the most query
  // tiles, and blocks start in order
  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int n0 = blockIdx.y * NK;
  const int group = p.H / p.KV;
  int q_lo, q_hi;
  q_range(p, n0, min(n0 + NK, p.Sk), q_lo, q_hi);
  const int m_first = (q_lo / QTILE) * QTILE;
  const int per_head =
      q_hi > m_first ? (q_hi - m_first + QTILE - 1) / QTILE : 0;
  const int n_tiles = group * per_head;

  // query tile it: Q, dO (TMA) and its record (a bulk copy) into stage
  // it % STAGES, completing that stage's barrier
  auto load_tile = [&](int it) {
    const int s = it % STAGES;
    const int h = kvh * group + it / per_head;
    const int m0 = m_first + (it % per_head) * QTILE;
    mbar_expect_tx(q_full(s), 2 * W::QT_BYTES + W::REC_BYTES);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      tma_load(sQ(s) + cb * QTILE * ROWB, &maps.q, q_full(s), cb * 64, m0,
               h, b);
      tma_load(sdO(s) + cb * QTILE * ROWB, &maps.dout, q_full(s), cb * 64,
               m0, h, b);
    }
    bulk_load(sRec(s),
              rec_tile(p, static_cast<long long>(b) * p.H + h, m0 / QTILE),
              W::REC_BYTES, q_full(s));
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(q_full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 issues every load: K and V once, the first STAGES query
  // tiles now, each later one as a stage frees up (below)
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(kv_full, 2 * W::KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      tma_load(sK + 2 * cb * NK * KROWB, &maps.k, kv_full, cb * 64, n0, kvh,
               b);
      tma_load(sK + (2 * cb + 1) * NK * KROWB, &maps.k, kv_full,
               cb * 64 + 32, n0, kvh, b);
      tma_load(sV + cb * NK * ROWB, &maps.v, kv_full, cb * 64, n0, kvh, b);
    }
    for (int it = 0; it < STAGES && it < n_tiles; ++it) load_tile(it);
  }

  // consumer warpgroup wg: keys [nw, nw + 64) of the block
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2;  // accumulator row group
  const int t = lane & 3;   // thread in group
  const int offset = p.Sk - p.Sq;
  const int nw = n0 + 64 * wg;
  const int kr0 = 64 * wg + 16 * warp + g;  // this thread's key rows in the
  const int key0 = n0 + kr0, key1 = key0 + 8;  // block: kr0, kr0 + 8
  const bool has_softcap = p.softcap > 0.f;
  const float scale2 = p.scale * LOG2E;
  const unsigned char* smem_gen = smem_raw + (base - raw);

  float dk[D / 2], dv[D / 2];  // n8 block j: [4 j .. 4 j + 3], as s below
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];  // S^T, dP^T: rows key0 (e < 2), key1; n8 block j:
                        // query columns m0 + 8 j + 2 t + (e & 1)
  uint32_t pa[4][4], da[4][4];
  // at D 64: this warp's 16 rows of K and V as wgmma A operands (the
  // layout of pa), head_dim 16 at a time, by ldmatrix from the swizzled
  // tiles
  uint32_t kf[W::KV_REGS ? 4 : 1][4], vf[W::KV_REGS ? 4 : 1][4];

  if (n_tiles > 0) {
    mbar_wait(kv_full, 0);
    if constexpr (W::KV_REGS) {
      // 16-byte chunk c of row r: K's in column block c / 4 of 64-byte
      // rows (64-byte swizzle), V's in 128-byte rows (128-byte swizzle)
      const uint32_t r = 64 * wg + 16 * warp + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t c = 2 * kk + (lane >> 4);
        ldmatrix_x4(kf[kk], sK + (c / 4) * NK * KROWB + r * KROWB +
                                (((c % 4) ^ ((r >> 1) & 3)) << 4));
        ldmatrix_x4(vf[kk], sV + r * ROWB + ((c ^ (r & 7)) << 4));
      }
    }
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int h = kvh * group + it / per_head;
    const int m0 = m_first + (it % per_head) * QTILE;
    mbar_wait(q_full(st), (it / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, over head_dim 16 at a time: A the
    // warpgroup's 64 key rows, B the query tile (K-major)
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t cb = kk / 4, off = (kk % 4) * 32;
      const uint32_t q_at = cb * QTILE * ROWB + off;
      if constexpr (W::KV_REGS) {
        wgmma_rs<0>(s, kf[kk], wgmma_desc(sQ(st) + q_at, 16, 8 * ROWB),
                    kk > 0);
        wgmma_rs<0>(dp, vf[kk], wgmma_desc(sdO(st) + q_at, 16, 8 * ROWB),
                    kk > 0);
      } else {
        const uint32_t k_at =
            (kk / 2) * NK * KROWB + wg * 64 * KROWB + (kk % 2) * 32;
        const uint32_t v_at = cb * NK * ROWB + wg * 64 * ROWB + off;
        wgmma_ss<0, 0>(s, wgmma_desc(sK + k_at, 16, 8 * KROWB, SW64),
                       wgmma_desc(sQ(st) + q_at, 16, 8 * ROWB), kk > 0);
        wgmma_ss<0, 0>(dp, wgmma_desc(sV + v_at, 16, 8 * ROWB),
                       wgmma_desc(sdO(st) + q_at, 16, 8 * ROWB), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) scale, in place,
    // then zeros where the mask bites: three loops, each free of branches
    // per element (rows past Sq have lse = +inf: P is 0 there)
    const float* rec =
        reinterpret_cast<const float*>(smem_gen + (sRec(st) - base));
    if (has_softcap) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 lse = *reinterpret_cast<const float2*>(rec + c);
        const float2 delta = *reinterpret_cast<const float2*>(rec + QTILE + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float th = tanhf(s[i] * p.scale / p.softcap);
          const float pr = fast_exp2(
              (p.softcap * th - ((e & 1) ? lse.y : lse.x)) * LOG2E);
          s[i] = pr;
          dp[i] = pr * (dp[i] - ((e & 1) ? delta.y : delta.x)) *
                  (1.f - th * th) * p.scale;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 lse = *reinterpret_cast<const float2*>(rec + c);
        const float2 delta = *reinterpret_cast<const float2*>(rec + QTILE + c);
        const float nl0 = -lse.x * LOG2E, nl1 = -lse.y * LOG2E;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float pr = fast_exp2(fmaf(s[i], scale2, (e & 1) ? nl1 : nl0));
          s[i] = pr;
          dp[i] = pr * (dp[i] - ((e & 1) ? delta.y : delta.x)) * p.scale;
        }
      }
    }
    const bool whole =
        nw + 64 <= p.Sk && (!p.causal || nw + 63 <= m0 + offset) &&
        (p.window <= 0 || min(m0 + QTILE, p.Sq) - 1 + offset - nw < p.window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qpos = m0 + 8 * (i / 4) + 2 * t + (i & 1) + offset;
        const int key = (i & 2) ? key1 : key0;
        bool ok = key < p.Sk;
        if (p.causal) ok = ok && key <= qpos;
        if (p.window > 0) ok = ok && qpos - key < p.window;
        s[i] = ok ? s[i] : 0.f;
        dp[i] = ok ? dp[i] : 0.f;
      }
    }
    pack_a(pa, s);
    pack_a(da, dp);

    // dS^T into shared memory, rows of 64 query columns, swizzled as the
    // descriptors read it
    const uint32_t ds_buf = sDS(it & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t off0 = kr0 * ROWB + (16 * kk + 8 * half + 2 * t) * 2;
        const uint32_t off1 = off0 + 8 * ROWB;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         ds_buf + (off0 ^ (((off0 >> 7) & 7) << 4))),
                     "r"(da[kk][2 * half])
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         ds_buf + (off1 ^ (((off1 >> 7) & 7) << 4))),
                     "r"(da[kk][2 * half + 1])
                     : "memory");
      }
    }
    fence_async_shared();

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries, 16 at a
    // time; dO and Q (queries x D) read transposed
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<1>(dv, pa[kk], wgmma_desc(sdO(st) + kk * 16 * ROWB,
                                         QTILE * ROWB, 8 * ROWB), 1);
      wgmma_rs<1>(dk, da[kk], wgmma_desc(sQ(st) + kk * 16 * ROWB,
                                         QTILE * ROWB, 8 * ROWB), 1);
    }
    wgmma_commit();

    // the block's dS^T is complete. Every product of tile it - 1 has
    // completed and its record was read, so its stage takes tile it - 1 +
    // STAGES; this consumer's last staged dQ tile was read by its bulk copy
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync(DS_READY, NWG * 128);
    if (threadIdx.x == 0 && it >= 1 && it - 1 + STAGES < n_tiles)
      load_tile(it - 1 + STAGES);
    {
      // dQ = dS K over the block's keys, 16 at a time, for this consumer's
      // DQ head dims: A = dS^T (keys x queries) and B = K (keys x D), both
      // read transposed
      constexpr int DQ = W::DQ;
      float dq[DQ / 2];
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        wgmma_ss<1, 1>(dq, wgmma_desc(ds_buf + kk * 16 * ROWB, NK * ROWB,
                                      8 * ROWB),
                       wgmma_desc(sK + (wg * DQ / 32) * NK * KROWB +
                                      kk * 16 * KROWB, NK * KROWB,
                                  8 * KROWB, SW64),
                       kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dv);
      fence_regs(dk);
      // stage the tile as dQ's sums lay out its column blocks, then one
      // thread adds it
      const uint32_t acc_buf = base + W::OFF_ACC + wg * W::ACC_BYTES;
      const int r0 = 16 * warp + g;
#pragma unroll
      for (int j = 0; j < DQ / 8; ++j) {
        const int c = 8 * j + 2 * t;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         acc_buf + 4 * acc_offset(r0, c)),
                     "f"(dq[4 * j]), "f"(dq[4 * j + 1])
                     : "memory");
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         acc_buf + 4 * acc_offset(r0 + 8, c)),
                     "f"(dq[4 * j + 2]), "f"(dq[4 * j + 3])
                     : "memory");
      }
      fence_async_shared();
      named_sync(STAGED + wg, 128);
      if (tid == 0)
        bulk_reduce_add(acc_tile(p, static_cast<long long>(b) * p.H + h,
                                 m0 / QTILE, D) + wg * DQ * QTILE,
                        acc_buf, W::ACC_BYTES);
    }
  }
  // the last bulk reduce-add has completed
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // dK and dV of this warpgroup's keys, summed over the group's heads
  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (key0 < p.Sk) {
      *reinterpret_cast<uint32_t*>(dkp + key0 * p.dk_ss + c) =
          pack_bf16(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dvp + key0 * p.dv_ss + c) =
          pack_bf16(dv[4 * j], dv[4 * j + 1]);
    }
    if (key1 < p.Sk) {
      *reinterpret_cast<uint32_t*>(dkp + key1 * p.dk_ss + c) =
          pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dvp + key1 * p.dv_ss + c) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2, wgmma + TMA at D 256 (bf16): dK, dV (or their fp32 partials) and
// dQ's sums
// ---------------------------------------------------------------------------

// A block: 64 keys and two consumer warpgroups that split the head dims:
// warpgroup wg holds dK and dV of the 64 keys for dims [128 wg, 128 wg +
// 128) (128 fp32 registers a thread) and computes S^T and dP^T for query
// columns [32 wg, 32 wg + 32) of each 64-row tile (m64n32k16 over all 256
// dims); the halves of P^T and dS^T meet in shared memory. Shared memory:
// K and V (32 KB each), two stages of Q and dO (64 KB each), P^T and dS^T
// (8 KB each) inside a 32 KB area that also stages dQ, the records.
struct W256 {
  static constexpr int D = 256;
  static constexpr int NK = 64;                    // keys per block
  static constexpr int THREADS = 256;
  static constexpr int CB = D / 64;                // column blocks of 64 dims
  static constexpr int STAGES = 2;
  static constexpr int TILE_BYTES = 64 * D * 2;    // K, V, Q or dO: 32 KB
  static constexpr int PT_BYTES = NK * QTILE * 2;  // P^T or dS^T: 8 KB
  static constexpr int STAGED = QTILE * 64 * 4;    // 64 dims of dQ: 16 KB
  static constexpr int REC_BYTES = REC * 4;
  // byte offsets from the 1024-byte aligned base
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + TILE_BYTES;
  static constexpr int OFF_Q = OFF_V + TILE_BYTES;   // stage s: Q, then dO
  static constexpr int OFF_X = OFF_Q + STAGES * 2 * TILE_BYTES;
  static constexpr int OFF_REC = OFF_X + 2 * STAGED; // P^T, dS^T inside X
  static constexpr int OFF_BAR = OFF_REC + STAGES * REC_BYTES;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + STAGES);
  static_assert(2 * PT_BYTES <= 2 * STAGED, "P^T and dS^T inside X");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// named barriers of flash_bwd_wgmma256 (0 is __syncthreads)
constexpr int X_FREE = 1;      // the last tile's staged dQ was read
constexpr int PDS_READY = 2;   // both halves of P^T and dS^T stored
constexpr int PRODUCTS = 3;    // every product of the tile completed
constexpr int STAGED256 = 4;   // + wg: warpgroup wg's dQ staged

__global__ void __launch_bounds__(W256::THREADS, 1)
flash_bwd_wgmma256(const __grid_constant__ Maps maps, const Params p) {
  using W = W256;
  constexpr int D = W::D;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + W::OFF_K, sV = base + W::OFF_V;
  auto sQ = [&](int s) { return base + W::OFF_Q + s * 2 * W::TILE_BYTES; };
  auto sdO = [&](int s) { return sQ(s) + W::TILE_BYTES; };
  const uint32_t sP = base + W::OFF_X, sDS = sP + W::PT_BYTES;
  auto sRec = [&](int s) { return base + W::OFF_REC + s * W::REC_BYTES; };
  const uint32_t kv_full = base + W::OFF_BAR;
  auto q_full = [&](int s) { return kv_full + 8u * (1 + s); };

  // key tile blockIdx.y (causal: tile 0 sees the most query tiles, and
  // blocks start in order); blockIdx.x: (batch, KV head, split). The
  // (head of the group, query tile) items of the key tile are cut into
  // ``splits`` ranges of nearly equal length, one a block.
  const int split = blockIdx.x % p.splits;
  const int b = blockIdx.x / p.splits / p.KV;
  const int kvh = blockIdx.x / p.splits % p.KV;
  const int n0 = blockIdx.y * W::NK;
  const int group = p.H / p.KV;
  int q_lo, q_hi;
  q_range(p, n0, min(n0 + W::NK, p.Sk), q_lo, q_hi);
  const int m_first = (q_lo / QTILE) * QTILE;
  const int per_head =
      q_hi > m_first ? (q_hi - m_first + QTILE - 1) / QTILE : 0;
  const int n_items = group * per_head;
  const int it_lo = split * n_items / p.splits;
  const int n_tiles = (split + 1) * n_items / p.splits - it_lo;

  // the block's tile i: Q, dO (TMA) and its record (a bulk copy) into
  // stage i % STAGES, completing that stage's barrier
  auto load_tile = [&](int i) {
    const int s = i % W::STAGES, item = it_lo + i;
    const int h = kvh * group + item / per_head;
    const int m0 = m_first + (item % per_head) * QTILE;
    mbar_expect_tx(q_full(s), 2 * W::TILE_BYTES + W::REC_BYTES);
#pragma unroll
    for (int cb = 0; cb < W::CB; ++cb) {
      tma_load(sQ(s) + cb * QTILE * ROWB, &maps.q, q_full(s), cb * 64, m0, h,
               b);
      tma_load(sdO(s) + cb * QTILE * ROWB, &maps.dout, q_full(s), cb * 64,
               m0, h, b);
    }
    bulk_load(sRec(s),
              rec_tile(p, static_cast<long long>(b) * p.H + h, m0 / QTILE),
              W::REC_BYTES, q_full(s));
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < W::STAGES; ++s) mbar_init(q_full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 issues every load: K and V once, the first two tiles now,
  // each later one once every product of the tile two before it completed
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(kv_full, 2 * W::TILE_BYTES);
#pragma unroll
    for (int cb = 0; cb < W::CB; ++cb) {
      tma_load(sK + cb * W::NK * ROWB, &maps.k, kv_full, cb * 64, n0, kvh, b);
      tma_load(sV + cb * W::NK * ROWB, &maps.v, kv_full, cb * 64, n0, kvh, b);
    }
    for (int i = 0; i < W::STAGES && i < n_tiles; ++i) load_tile(i);
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2;  // accumulator row group
  const int t = lane & 3;   // thread in group
  const int offset = p.Sk - p.Sq;
  const int kr0 = 16 * warp + g;  // this thread's key rows: kr0, kr0 + 8
  const int key0 = n0 + kr0, key1 = key0 + 8;
  const int qc0 = 32 * wg;        // this warpgroup's query columns
  const bool has_softcap = p.softcap > 0.f;
  const float scale2 = p.scale * LOG2E;
  const unsigned char* smem_gen = smem_raw + (base - raw);

  float dk[64], dv[64];  // n8 block j: dims 128 wg + 8 j + 2 t + {0, 1}
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % W::STAGES, item = it_lo + i;
    const int h = kvh * group + item / per_head;
    const int m0 = m_first + (item % per_head) * QTILE;
    mbar_wait(q_full(st), (i / W::STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 32 query columns,
    // over the 256 dims 16 at a time, both operands K-major
    float s[16], dp[16];  // rows key0 (e < 2), key1; n8 block j: query
                          // column qc0 + 8 j + 2 t + (e & 1)
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t at = (kk / 4) * QTILE * ROWB + (kk % 4) * 32;
      const uint32_t q_at = at + qc0 * ROWB;
      wgmma_ss<0, 0>(s, wgmma_desc(sK + at, 16, 8 * ROWB),
                     wgmma_desc(sQ(st) + q_at, 16, 8 * ROWB), kk > 0);
      wgmma_ss<0, 0>(dp, wgmma_desc(sV + at, 16, 8 * ROWB),
                     wgmma_desc(sdO(st) + q_at, 16, 8 * ROWB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta) scale, in place, then
    // zeros where the mask bites (rows past Sq have lse = +inf: P is 0)
    const float* rec =
        reinterpret_cast<const float*>(smem_gen + (sRec(st) - base));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = qc0 + 8 * j + 2 * t;
      const float2 lse = *reinterpret_cast<const float2*>(rec + c);
      const float2 delta = *reinterpret_cast<const float2*>(rec + QTILE + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const float l = (e & 1) ? lse.y : lse.x;
        const float dl = (e & 1) ? delta.y : delta.x;
        if (has_softcap) {
          const float th = tanhf(s[x] * p.scale / p.softcap);
          const float pr = fast_exp2((p.softcap * th - l) * LOG2E);
          s[x] = pr;
          dp[x] = pr * (dp[x] - dl) * (1.f - th * th) * p.scale;
        } else {
          const float pr = fast_exp2(fmaf(s[x], scale2, -l * LOG2E));
          s[x] = pr;
          dp[x] = pr * (dp[x] - dl) * p.scale;
        }
      }
    }
    const int qa = m0 + qc0;  // this warpgroup's first query row
    const bool whole =
        n0 + W::NK <= p.Sk && (!p.causal || n0 + W::NK - 1 <= qa + offset) &&
        (p.window <= 0 || min(qa + 32, p.Sq) - 1 + offset - n0 < p.window);
    if (!whole) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int qpos = qa + 8 * (x / 4) + 2 * t + (x & 1) + offset;
        const int key = (x & 2) ? key1 : key0;
        bool ok = key < p.Sk;
        if (p.causal) ok = ok && key <= qpos;
        if (p.window > 0) ok = ok && qpos - key < p.window;
        s[x] = ok ? s[x] : 0.f;
        dp[x] = ok ? dp[x] : 0.f;
      }
    }

    // the area that holds P^T and dS^T also staged the last tile's dQ:
    // wait until its bulk copies have read it
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync(X_FREE, W::THREADS);
    // this warpgroup's columns of P^T and dS^T, in bf16: rows of 64 query
    // columns (128 bytes), swizzled as the descriptors read them
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t off0 = kr0 * ROWB + (qc0 + 8 * j + 2 * t) * 2;
      const uint32_t off1 = off0 + 8 * ROWB;
      const uint32_t sw0 = off0 ^ (((off0 >> 7) & 7) << 4);
      const uint32_t sw1 = off1 ^ (((off1 >> 7) & 7) << 4);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sP + sw0),
                   "r"(pack_bf16(s[4 * j], s[4 * j + 1]))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sP + sw1),
                   "r"(pack_bf16(s[4 * j + 2], s[4 * j + 3]))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sDS + sw0),
                   "r"(pack_bf16(dp[4 * j], dp[4 * j + 1]))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sDS + sw1),
                   "r"(pack_bf16(dp[4 * j + 2], dp[4 * j + 3]))
                   : "memory");
    }
    fence_async_shared();
    named_sync(PDS_READY, W::THREADS);

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries, 16 at a
    // time, for this warpgroup's 128 dims (dO and Q read transposed, the
    // next 64 dims one column block on); dQ = dS K for the same dims, over
    // the 64 keys 16 at a time (dS^T and K read transposed)
    const uint32_t dims = 2 * wg * QTILE * ROWB;  // column block 2 wg
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<0, 1>(dv, wgmma_desc(sP + kk * 32, 16, 8 * ROWB),
                     wgmma_desc(sdO(st) + dims + kk * 16 * ROWB,
                                QTILE * ROWB, 8 * ROWB), 1);
      wgmma_ss<0, 1>(dk, wgmma_desc(sDS + kk * 32, 16, 8 * ROWB),
                     wgmma_desc(sQ(st) + dims + kk * 16 * ROWB,
                                QTILE * ROWB, 8 * ROWB), 1);
    }
    wgmma_commit();
    float dq[64];
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W::NK / 16; ++kk)
      wgmma_ss<1, 1>(dq, wgmma_desc(sDS + kk * 16 * ROWB, W::NK * ROWB,
                                    8 * ROWB),
                     wgmma_desc(sK + dims + kk * 16 * ROWB, W::NK * ROWB,
                                8 * ROWB), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dv);
    fence_regs(dk);
    // every product of this tile completed in both warpgroups: its stage
    // takes the tile after next, and X may be overwritten
    named_sync(PRODUCTS, W::THREADS);
    if (threadIdx.x == 0 && i + W::STAGES < n_tiles) load_tile(i + W::STAGES);

    // dQ of this warpgroup's dims into dQ's sums, 64 dims at a time: staged
    // in this warpgroup's half of X as the sums lay out two column blocks,
    // then added by one bulk reduce-add
    float* acc = acc_tile(p, static_cast<long long>(b) * p.H + h,
                          m0 / QTILE, D);
    const uint32_t stage = sP + wg * W::STAGED;
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1) {
        if (tid == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_sync(STAGED256 + wg, 128);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * r + jj, c = 8 * jj + 2 * t;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         stage + 4 * acc_offset(r0, c)),
                     "f"(dq[4 * j]), "f"(dq[4 * j + 1])
                     : "memory");
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         stage + 4 * acc_offset(r0 + 8, c)),
                     "f"(dq[4 * j + 2]), "f"(dq[4 * j + 3])
                     : "memory");
      }
      fence_async_shared();
      named_sync(STAGED256 + wg, 128);
      if (tid == 0)
        bulk_reduce_add(acc + (4 * wg + 2 * r) * 2048, stage, W::STAGED);
    }
  }
  // the last bulk reduce-add has completed
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // dK and dV of these keys: summed over the block's items; in bf16 when
  // one block has the key tile, else as this split's fp32 partials
  if (p.splits == 1) {
    bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
    bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 128 * wg + 8 * j + 2 * t;
      if (key0 < p.Sk) {
        *reinterpret_cast<uint32_t*>(dkp + key0 * p.dk_ss + c) =
            pack_bf16(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dvp + key0 * p.dv_ss + c) =
            pack_bf16(dv[4 * j], dv[4 * j + 1]);
      }
      if (key1 < p.Sk) {
        *reinterpret_cast<uint32_t*>(dkp + key1 * p.dk_ss + c) =
            pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dvp + key1 * p.dv_ss + c) =
            pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  } else {
    const long long rows = static_cast<long long>(p.B) * p.KV * p.Sk;
    float* pk = p.part + ((static_cast<long long>(split) * p.B + b) * p.KV +
                          kvh) * p.Sk * D;
    float* pv = pk + p.splits * rows * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 128 * wg + 8 * j + 2 * t;
      if (key0 < p.Sk) {
        *reinterpret_cast<float2*>(pk + key0 * D + c) =
            make_float2(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<float2*>(pv + key0 * D + c) =
            make_float2(dv[4 * j], dv[4 * j + 1]);
      }
      if (key1 < p.Sk) {
        *reinterpret_cast<float2*>(pk + key1 * D + c) =
            make_float2(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<float2*>(pv + key1 * D + c) =
            make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// The D 256 route's last pass when splits > 1: dk and dv = the splits'
// fp32 partials summed in split order (the same bits every call), in bf16
// through their strides, 4 dims a thread.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_sum(const Params p) {
  constexpr int D = 256;
  const long long rows = static_cast<long long>(p.B) * p.KV * p.Sk;
  const long long n = rows * (D / 4);
  for (long long x = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       x < n; x += static_cast<long long>(gridDim.x) * THREADS) {
    const long long row = x / (D / 4);  // (batch, KV head, key)
    const int c = static_cast<int>(x % (D / 4)) * 4;
    const int key = static_cast<int>(row % p.Sk);
    const int b = static_cast<int>(row / p.Sk / p.KV);
    const int kvh = static_cast<int>(row / p.Sk % p.KV);
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* src = p.part + (which * p.splits * rows + row) * D + c;
      float4 sum = *reinterpret_cast<const float4*>(src);
      for (int sp = 1; sp < p.splits; ++sp) {
        const float4 v =
            *reinterpret_cast<const float4*>(src + sp * rows * D);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      bf16* dst = which == 0
                      ? static_cast<bf16*>(p.dk) + b * p.dk_sb +
                            kvh * p.dk_sh + key * p.dk_ss + c
                      : static_cast<bf16*>(p.dv) + b * p.dv_sb +
                            kvh * p.dv_sh + key * p.dv_ss + c;
      uint2 packed;
      packed.x = pack_bf16(sum.x, sum.y);
      packed.y = pack_bf16(sum.z, sum.w);
      *reinterpret_cast<uint2*>(dst) = packed;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime, so the library links
// against the runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 (B, heads, S, D) tensor with the given element strides (unit
// stride over D) as a 4-d map over (D, S, heads, B), boxes of ``cols`` head
// dims (64: 128 bytes, 128-byte swizzle; 32: 64 bytes, 64-byte swizzle) by
// ``rows``; rows past S read as zeros.
int encode(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B,
           long long ss, long long sh, long long sb, int cols, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using W = Wg<D>;
  Maps maps;
  int err = encode(&maps.q, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                   64, QTILE);
  if (!err)
    err = encode(&maps.dout, p.dout, D, p.Sq, p.H, p.B, p.do_ss, p.do_sh,
                 p.do_sb, 64, QTILE);
  if (!err)
    err = encode(&maps.k, p.k, D, p.Sk, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb,
                 32, W::NK);
  if (!err)
    err = encode(&maps.v, p.v, D, p.Sk, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb,
                 64, W::NK);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.B * p.KV, (p.Sk + W::NK - 1) / W::NK);
  flash_bwd_wgmma<D><<<grid, W::THREADS, W::SMEM, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma256(const Params& p, cudaStream_t stream) {
  using W = W256;
  Maps maps;
  int err = encode(&maps.q, p.q, W::D, p.Sq, p.H, p.B, p.q_ss, p.q_sh,
                   p.q_sb, 64, QTILE);
  if (!err)
    err = encode(&maps.dout, p.dout, W::D, p.Sq, p.H, p.B, p.do_ss, p.do_sh,
                 p.do_sb, 64, QTILE);
  if (!err)
    err = encode(&maps.k, p.k, W::D, p.Sk, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb,
                 64, W::NK);
  if (!err)
    err = encode(&maps.v, p.v, W::D, p.Sk, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb,
                 64, W::NK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_wgmma256, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.B * p.KV * p.splits, (p.Sk + W::NK - 1) / W::NK);
  flash_bwd_wgmma256<<<grid, W::THREADS, W::SMEM, stream>>>(maps, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(p.B) * p.KV * p.Sk * (W::D / 4);
  const int blocks = static_cast<int>(
      (n + THREADS - 1) / THREADS < 65536 ? (n + THREADS - 1) / THREADS
                                          : 65536);
  flash_bwd_dkdv_sum<<<blocks, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkdv(const Params& p, cudaStream_t stream) {
  using TL = Tile<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TL::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 tiles((p.Sk + TL::BN - 1) / TL::BN, p.B * p.KV);
  flash_bwd_dkdv<T, D><<<tiles, THREADS, TL::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at D 64 and 128 take the wgmma kernel, bf16 at D 256 the wgmma
// kernel that splits the head dims between its warpgroups, every other
// (type, head_dim) the mma.sync / CUDA-core one: by shape, at compile time
template <typename T, int D>
constexpr bool uses_wgmma() {
  return std::is_same<T, bf16>::value && (D == 64 || D == 128);
}
template <typename T, int D>
constexpr bool uses_wgmma256() {
  return std::is_same<T, bf16>::value && D == 256;
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 tiles(p.QT, p.B * p.H);
  flash_bwd_delta<T, D><<<tiles, THREADS, 0, stream>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if constexpr (uses_wgmma<T, D>())
    err = launch_wgmma<D>(p, stream);
  else if constexpr (uses_wgmma256<T, D>())
    err = launch_wgmma256(p, stream);
  else
    err = launch_dkdv<T, D>(p, stream);
  if (err) return err;
  flash_bwd_dq<T, D><<<tiles, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const Params& p, cudaStream_t stream) {
  // only the D 256 route takes splits
  if (p.splits != 1 && !(dtype == 1 && D == 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float, D>(p, stream);
  if (dtype == 1) return launch<bf16, D>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The version of this C interface: 2 changed the workspace (dQ's sums by
// 64-row tile, then the records of lse and delta); 3 added ``splits`` and
// the D 256 route's partials after the records.
int flash_attention_bwd_abi(void) { return 3; }

// dtype: 0 = float32, 1 = bfloat16. q, o, do, dq: (B, H, Sq, D); k, v, dk,
// dv: (B, KV, Sk, D); each with unit stride over D, the given element
// strides over the other axes, 16-byte aligned rows and strides. lse: the
// forward's fp32 (B, H, Sq), contiguous. splits: 1, or for bf16 at D 256
// the number of blocks that share a key tile's (head, query tile) items.
// workspace: 16-byte aligned fp32, B H ceil(Sq / 64) 64 (D + 2) of them,
// then for splits > 1 2 splits B KV Sk D more. Returns 0, a CUDA error
// code, or one of this file's own codes (see
// flash_attention_bwd_error_string).
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
                        int splits, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      B * H > 65535 || B * KV > 65535 || splits < 1 ||
      static_cast<long long>(B) * KV * splits > 0x7fffffffLL ||
      (Sk + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int QT = (Sq + QTILE - 1) / QTILE;
  float* dq_acc = workspace;
  float* rec = workspace + static_cast<long long>(B) * H * QT * QTILE * D;
  float* part = rec + static_cast<long long>(B) * H * QT * REC;
  const Params p{q, k, v, o, dout, lse, dq, dk, dv, dq_acc, rec,
                 B, H, KV, Sq, Sk, QT,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, do_sb, do_sh, do_ss,
                 dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
                 causal, window, softcap, scale, splits, part};
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
  if (err == kErrNoEncoder)
    return "cuTensorMapEncodeTiled was not found";
  if (err == kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (alignment, strides)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
