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
// H100's ~295 operations per byte, so at S 2048 it is bound by operations:
// the two products of each tile, which only the tensor cores run at speed,
// and only through wgmma. At S 512 the bound is the bytes of q, k, v and o.
//
// What the design does about it:
//  - The TPU kernel walks the KV blocks as a sequential grid axis and skips
//    masked ones with pl.when; here the KV loop runs inside the block and is
//    bounded to the causal / window range, so masked tiles cost nothing,
//    and causal q tiles start heaviest first.
//  - bf16 (the model's type), one kernel for every head_dim: a block of
//    one (batch, head) has consumer warpgroups of 64 query rows (two; one
//    at D 256) and a producer warpgroup, one thread of which issues TMA
//    loads: Q once, K and V into a ring of two stages, each signalled by an
//    mbarrier per tensor. K and V are freed by mbarriers of their own, so K
//    runs two tiles ahead of the softmax. A consumer runs S = Q K^T as wgmma
//    m64nBNk16 with both operands in shared memory, the base-2 online
//    softmax in registers (masking only the tiles some (row, key) pair
//    cannot see), and O += P V as wgmma m64nDk16 with P (rounded to bf16, as
//    the reference's chunked path does) from registers and V read
//    transposed from shared memory. Tile i's softmax runs while the tensor
//    cores run tile i's Q K^T and tile i - 1's P V, and the two consumers
//    take turns to issue (ping-pong), so one's softmax overlaps the other's
//    products. setmaxnreg moves registers from the producer (40) to the
//    consumers (232), but ptxas allocates for the block's thread count
//    (168 at three warpgroups): at D 256, where the output alone is 128
//    fp32 registers a thread, one consumer (two warpgroups) avoids spills.
//  - Tiles are stored as TMA writes them: rows of 128 bytes (64 bytes at
//    D 32) with the 128-byte (64-byte) swizzle, one column block of 64
//    (32) head dims after another, and the wgmma descriptors use the same
//    swizzle. TMA zero-fills rows past Sq / Sk; keys past Sk are masked.
//  - The tensor maps are 4-d over (D, S, heads, B), built on the host per
//    call from the strides the wrapper passes, so (B, S, H, D) views need
//    no copy. The output goes back the same way: each consumer writes its
//    64 x D tile, swizzled, over its own rows of Q in shared memory, and
//    one TMA store per column block writes it through the output's strides
//    (the model passes a (B, S, H, D) buffer), clipping rows past Sq.
//  - fp32: the tensor cores would round to TF32, so fp32 runs on the CUDA
//    cores (67 TFLOP/s): tiles staged in shared memory, each thread keeping
//    a 4x4 block of scores and a 4 x D/16 block of the output.
//  - For training, the caller may pass an fp32 (B, H, Sq) buffer for the
//    row log-sum-exp, log sum_j exp(s_ij) of the scaled, capped, masked
//    scores s: m + log(l) of the online softmax, written once per row after
//    the last tile. flash_attention_bwd.cu recomputes P = exp(s - lse) from
//    it. A null pointer writes nothing (serving).
//  - The kernel launches on the caller's stream and allocates nothing.
#include <cuda.h>  // CUtensorMap and its enums (the encoder: at run time)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // fp32: query rows per block
constexpr int BK = 64;  // fp32: keys per KV tile

// Errors of our own, beside CUDA's codes
constexpr int kErrNoEncoder = 2001;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 2002;     // a tensor map was refused

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) contiguous, or null: not written
  int B, H, KV, Sq, Sk;
  long long q_sb, q_sh, q_ss;  // element strides of q over (batch, head, seq)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
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

// The KV tiles (of KT keys) a q tile of QT rows starting at q0 can see: up
// to its last row's position (causal), from its first row's window start
// (sliding window).
template <int QT, int KT>
__device__ __forceinline__ void kv_range(const Params& p, int q0, int& lo,
                                         int& hi) {
  const int offset = p.Sk - p.Sq;
  const int q_first = q0 + offset;
  const int q_last = min(q0 + QT, p.Sq) - 1 + offset;
  lo = 0;
  hi = p.Sk;
  if (p.causal) hi = min(p.Sk, q_last + 1);
  if (p.window > 0) lo = max(0, q_first - p.window + 1);
  lo = (lo / KT) * KT;
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

// The natural log-sum-exp of a row from its running max m and sum l (both
// in natural units). A row that saw no key (l = 0) gets +inf, so that the
// backward's exp(s - lse) is 0 there, as this kernel's output is.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : INFINITY;
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
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

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
  kv_range<BQ, BK>(p, q0, kv_lo, kv_hi);

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

  if (p.lse != nullptr && tid < BQ && q0 + tid < p.Sq)
    p.lse[static_cast<long long>(bh) * p.Sq + q0 + tid] = row_lse(
        m_s[tid], l_s[tid]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[(q0 + r) * p.o_ss + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int STAGES = 2;        // K / V ring
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// named barriers: 0 is __syncthreads, 1 + wg a consumer's epilogue, and
// TURN + wg the turn of consumer wg to issue its products
constexpr int TURN = 3;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A block: NWG consumer warpgroups of 64 query rows, then a producer
// warpgroup. ptxas allocates registers for __launch_bounds__'s thread count
// in groups of four warps, whatever setmaxnreg asks: 168 a thread at 384
// threads, 255 at 256. At D 256 the output alone takes 128, so there one
// consumer with the whole register file beats two that spill.
template <int D>
struct Tile {
  static constexpr int NWG = D == 256 ? 1 : 2;
  static constexpr int BM = 64 * NWG;             // query rows per block
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int BN = D == 256 ? 64 : 128;  // keys per KV tile
  static constexpr int SW = D < 64 ? D : 64;      // head dims per smem row
  static constexpr int ROWB = 2 * SW;             // bytes per smem row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K or one V tile
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : 2;
  // the swizzle XORs the 16-byte chunk index with address bits 7..
  static constexpr uint32_t SWZ_MASK = ROWB == 128 ? 7 : 3;
  // 1024 bytes of alignment slack, Q, the ring, 9 mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 80;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// TMA: shared memory at src into the box of ``map`` at (c0, c1, c2, c3);
// rows outside the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t layout) {
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

// d (64 x 64, fp32) (+)= A (64 x 16) B^T, A and B (64 x 16) K-major in
// shared memory; d is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) (+)= A (64 x 16) B^T, A and B (128 x 16) K-major in
// shared memory; d is overwritten when accumulate is 0.
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, fp32) += A (64 x 16, registers) B (16 x 32, MN-major in shared
// memory, read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64, MN-major in shared
// memory, read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128, MN-major in shared
// memory, read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 256, fp32) += A (64 x 16, registers) B (16 x 256, MN-major in shared
// memory, read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// The online softmax of one tile's scores s (n8 block j: s[4 j .. 4 j + 3],
// rows r0 (e < 2) and r0 + 8, keys k0 + 8 j + 2 t + (e & 1)), in place:
// mask where some (row, key) pair of the warpgroup's positions [w_first,
// w_last] cannot see the tile, move the running maxima m (in base-2 units,
// y = x log2(e)) and sums l on, leave p = 2^(y - m) in s and the factors the
// output rows must be rescaled by in corr. Without a softcap the scale goes
// into one multiply-add with the max: p = 2^(s scale log2(e) - m).
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             const Params& p, int k0,
                                             int w_first, int w_last,
                                             int qpos0, int qpos1, int t,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  float mul = p.scale * LOG2E;
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s[i] = p.softcap * tanhf(s[i] * p.scale / p.softcap) * LOG2E;
    mul = 1.f;
  }
  const bool whole = k0 + BN <= p.Sk &&
                     (!p.causal || k0 + BN - 1 <= w_first) &&
                     (p.window <= 0 || w_last - k0 < p.window);
  if (!whole) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int kpos = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      const int qpos = (i & 2) ? qpos1 : qpos0;
      bool ok = kpos < p.Sk;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && qpos - kpos < p.window;
      if (!ok) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float nbase[2];  // minus the exp base, in base-2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * mul);
    const float base = exp_base(mn);
    corr[r] = fast_exp2(m[r] - base);
    m[r] = mn;
    nbase[r] = -base;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    s[i] = fast_exp2(fmaf(s[i], mul, nbase[(i >> 1) & 1]));
    ps[(i >> 1) & 1] += s[i];
  }
  l[0] = l[0] * corr[0] + ps[0];
  l[1] = l[1] * corr[1] + ps[1];
}

// The score accumulators of n8 blocks 2 kk, 2 kk + 1, rounded to bf16, are
// the A operand (registers) of P V for keys [16 kk, 16 kk + 16).
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4],
                                       const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

struct Maps {
  CUtensorMap q, k, v, o;  // 4-d over (D, S, heads, B)
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
flash_fwd_bf16(const __grid_constant__ Maps maps, const Params p) {
  using T = Tile<D>;
  constexpr int NWG = T::NWG, BM = T::BM, BN = T::BN, SW = T::SW;
  constexpr int ROWB = T::ROWB;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte aligned shared memory
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;            // STAGES K tiles
  const uint32_t sV = sK + STAGES * T::KV_BYTES;  // STAGES V tiles
  // mbarriers: Q loaded; per stage K loaded, V loaded, K free, V free
  const uint32_t bars = sV + STAGES * T::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto k_free = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto v_free = [&](int s) { return bars + 8u * (1 + 3 * STAGES + s); };

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = q_tile(p) * BM;
  int kv_lo, kv_hi;
  kv_range<BM, BN>(p, q0, kv_lo, kv_hi);
  const int n_tiles = (kv_hi - kv_lo + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_free(s), NWG * 128);  // every consumer thread releases
      mbar_init(v_free(s), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // producer: one thread keeps the ring full. K of tile i + STAGES needs
    // only Q K^T of tile i done, V only P V of tile i: the consumers free
    // them apart, so K runs ahead of the softmax
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / SW; ++cb)
        tma_load(sQ + cb * BM * ROWB, &maps.q, q_full, cb * SW, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, use = it / STAGES;
        const int k0 = kv_lo + it * BN;
        if (use > 0) mbar_wait(k_free(s), (use - 1) & 1);
        mbar_expect_tx(k_full(s), T::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / SW; ++cb)
          tma_load(sK + s * T::KV_BYTES + cb * BN * ROWB, &maps.k, k_full(s),
                   cb * SW, k0, kvh, b);
        if (use > 0) mbar_wait(v_free(s), (use - 1) & 1);
        mbar_expect_tx(v_full(s), T::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / SW; ++cb)
          tma_load(sV + s * T::KV_BYTES + cb * BN * ROWB, &maps.v, v_full(s),
                   cb * SW, k0, kvh, b);
      }
    }
  } else {
    // consumer warpgroup wg: block rows [64 wg, 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int offset = p.Sk - p.Sq;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    const int qpos0 = q0 + r0 + offset, qpos1 = qpos0 + 8;
    const int w_first = q0 + wg * 64 + offset;  // this warpgroup's positions
    const int w_last = min(q0 + wg * 64 + 64, p.Sq) - 1 + offset;

    // scores in base-2 units: y = x log2(e), p = 2^(y - m)
    float m[2] = {-INFINITY, -INFINITY};  // running max of rows r0, r0 + 8
    float l[2] = {0.f, 0.f};              // this thread's part of the sums
    float corr[2];
    float o[D / 2];                       // n8 block j: o[4 j .. 4 j + 3]
    float s[BN / 2];
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    // S = Q K^T of the tile in stage st, over head_dim 16 at a time
    auto issue_qk = [&](int st) {
      const uint32_t kb = sK + st * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t cb = kk * 16 / SW, off = (kk * 16 % SW) * 2;
        const uint64_t da = wgmma_desc(
            sQ + cb * BM * ROWB + wg * 64 * ROWB + off, 16, 8 * ROWB,
            T::LAYOUT);
        const uint64_t db =
            wgmma_desc(kb + cb * BN * ROWB + off, 16, 8 * ROWB, T::LAYOUT);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage st: V (keys x D) is MN-major for this
    // product; the next 16 keys are 16 rows on, the next 64 (32) head dims
    // one column block (BN rows) on
    auto issue_pv = [&](int st) {
      const uint32_t vb = sV + st * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o, pa[kk], wgmma_desc(vb + kk * 16 * ROWB, BN * ROWB,
                                       8 * ROWB, T::LAYOUT));
      wgmma_commit();
    };

    // Two consumers take turns to issue their products (ping-pong), so
    // one's softmax runs while the other's products keep the tensor cores
    // busy: consumer wg waits for its turn (barrier TURN + wg, completed by
    // the other's arrival) and hands the turn on after issuing. Consumer 1
    // gives consumer 0 the first turn; each has n_tiles + 1 turns, and
    // consumer 1 hands on none after its last.
    auto my_turn = [&]() {
      if constexpr (NWG == 2)
        asm volatile("bar.sync %0, 256;\n" ::"r"(TURN + wg) : "memory");
    };
    auto hand_on = [&]() {
      if constexpr (NWG == 2)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(TURN + 1 - wg)
                     : "memory");
    };
    if (wg == 1) hand_on();

    mbar_wait(q_full, 0);
    // tile 0: its scores and probabilities (o is 0: nothing to rescale)
    mbar_wait(k_full(0), 0);
    my_turn();
    fence_regs(s);
    wgmma_fence();
    issue_qk(0);
    hand_on();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(k_free(0));
    softmax_tile<BN>(s, p, kv_lo, w_first, w_last, qpos0, qpos1, t, m, l,
                     corr);
    pack_p<BN>(pa, s);
    // tile it: its Q K^T and tile it - 1's P V run on the tensor cores
    // while this warpgroup waits for the first and then runs the softmax
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % STAGES, prev = (it - 1) % STAGES;
      mbar_wait(k_full(st), (it / STAGES) & 1);
      mbar_wait(v_full(prev), ((it - 1) / STAGES) & 1);
      my_turn();
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      issue_qk(st);
      issue_pv(prev);
      hand_on();
      wgmma_wait<1>();  // Q K^T is done, P V may still run
      fence_regs(s);
      mbar_arrive(k_free(st));
      softmax_tile<BN>(s, p, kv_lo + it * BN, w_first, w_last, qpos0, qpos1,
                       t, m, l, corr);
      wgmma_wait<0>();  // P V is done: o and pa may change
      fence_regs(o);
      mbar_arrive(v_free(prev));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      pack_p<BN>(pa, s);
    }
    {
      const int last = (n_tiles - 1) % STAGES;
      mbar_wait(v_full(last), ((n_tiles - 1) / STAGES) & 1);
      my_turn();
      fence_regs(o);
      wgmma_fence();
      issue_pv(last);
      if (wg == 0) hand_on();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_free(last));
    }
    float l0 = l[0], l1 = l[1];

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    // the rows' log-sum-exp: m is in base-2 units, so m ln 2 is the
    // natural max
    if (p.lse != nullptr && t == 0) {
      float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
      if (q0 + r0 < p.Sq) lse[q0 + r0] = row_lse(m[0] * LN2, l0);
      if (q0 + r0 + 8 < p.Sq) lse[q0 + r0 + 8] = row_lse(m[1] * LN2, l1);
    }
    // O in bf16 over this warpgroup's rows of Q (no product reads them
    // any more), swizzled as the output map's box expects
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const uint32_t region = sQ + (c / SW) * BM * ROWB;
      const uint32_t off0 = r0 * ROWB + (c % SW) * 2;
      const uint32_t off1 = off0 + 8 * ROWB;
      const uint32_t sw0 = off0 ^ (((off0 >> 7) & T::SWZ_MASK) << 4);
      const uint32_t sw1 = off1 ^ (((off1 >> 7) & T::SWZ_MASK) << 4);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(region + sw0),
                   "r"(pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(region + sw1),
                   "r"(pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1))
                   : "memory");
    }
    // make the writes visible to TMA, then one thread stores the tile
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0 && q0 + wg * 64 < p.Sq) {
#pragma unroll
      for (int cb = 0; cb < D / SW; ++cb)
        tma_store(&maps.o, sQ + cb * BM * ROWB + wg * 64 * ROWB, cb * SW,
                  q0 + wg * 64, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

// The driver's tensor-map encoder, found through the runtime, so the
// library links against the runtime alone.
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
// stride over D) as a 4-d map over (D, S, heads, B), boxes of (cols, rows).
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
      cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Tile<D>;
  Maps maps;
  int err = encode(&maps.q, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                   T::SW, T::BM);
  if (!err)
    err = encode(&maps.k, p.k, D, p.Sk, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb,
                 T::SW, T::BN);
  if (!err)
    err = encode(&maps.v, p.v, D, p.Sk, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb,
                 T::SW, T::BN);
  if (!err)
    err = encode(&maps.o, p.o, D, p.Sq, p.H, p.B, p.o_ss, p.o_sh, p.o_sb,
                 T::SW, 64);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.B * p.H, (p.Sq + T::BM - 1) / T::BM);
  flash_fwd_bf16<D><<<grid, T::THREADS, T::SMEM, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  const int bytes = simt_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_f32<D><<<grid, SIMT_THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, stream);
  if (dtype == 1) return launch_bf16<D>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The version of this C interface: 2 added the output strides (o_*), 3
// the row log-sum-exp (lse).
int flash_attention_abi(void) { return 3; }

// dtype: 0 = float32, 1 = bfloat16. q, o: (B, H, Sq, D), k/v: (B, KV, Sk,
// D), each with unit stride over D and the given element strides over the
// other axes (bf16: 16-byte aligned rows and strides, as TMA needs). lse:
// null, or a contiguous fp32 (B, H, Sq) buffer for the rows' log-sum-exp.
// Returns 0, a CUDA error code, or one of this file's own codes (see
// flash_attention_error_string).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int dtype, int B, int H, int KV, int Sq, int Sk, int D,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        int causal, int window, float softcap, float scale,
                        void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, lse, B, H, KV, Sq, Sk,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dtype<32>(dtype, p, s);
    case 64: return launch_dtype<64>(dtype, p, s);
    case 128: return launch_dtype<128>(dtype, p, s);
    case 256: return launch_dtype<256>(dtype, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  if (err == kErrNoEncoder)
    return "the driver's cuTensorMapEncodeTiled was not found";
  if (err == kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (alignment, strides)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
