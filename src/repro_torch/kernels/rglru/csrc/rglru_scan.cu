// RG-LRU linear recurrence, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru/kernel.py
// (rglru_scan_pallas, body _rglru_kernel). It computes the same function:
// h_t = a_t * h_{t-1} + b_t over a, b of shape (B, S, W), with an fp32
// state, here from an optional initial state h0 (B, W) (zeros without
// one), as ref.py's rglru_ref takes it. a, b and h are fp32, the type the
// model passes (its gates are fp32).
//
// What bounds it on this card: two reads and one write of 4 bytes per
// element against one multiply-add, so bytes: 3 x 4 B x B S W. At the
// model's prefill (B 4, S 512, W 4096) that is 100.7 MB, 0.030 ms at
// 3.35 TB/s.
//
// What the design does about it (chunk-parallel, in one pass):
//  - The TPU kernel walks S as a sequential grid axis with the state in
//    VMEM scratch. One thread per (batch, channel) walking S would be
//    16,384 threads at B 4, W 4096, a few warps an SM: too few loads in
//    flight to reach the memory rate.
//  - Here a block takes 32 channels (the lanes: every load and store is a
//    128-byte row) and 8 warps, each warp a segment of L steps of a window
//    of 8 L steps. Per window each thread loads its L steps of a and b into
//    registers, scans them from 0 (the segment's product of a and local
//    state) and publishes the pair in shared memory. After one barrier each
//    thread combines the segments before its own with the carry of the
//    previous window (at most 8 multiply-adds), rescans its L steps from
//    that carry (the recurrence's own sequential multiply-adds) and writes
//    h. The pairs are double-buffered by window, so one barrier a window
//    suffices. The next window's loads go out before this window's
//    arithmetic. At B 4, W 4096 that is 512 blocks of 256 threads, all
//    resident at once (at most 64 registers a thread), each with 2 L loads
//    in flight. Each element is still read and written once.
//  - The carry into a segment is a_last...a_first h + local state instead
//    of the step-by-step sum, so h rounds differently from the sequential
//    recurrence by a few ulps of its magnitude (|a| < 1 damps them).
//  - Any S >= 1 and any W: steps past S act as a = 1, b = 0 and are not
//    written; channels past W are neither read nor written (the Pallas
//    kernel asserts that its chunk divides S and its block divides W).
//  - a and b are read through element strides over batch and sequence
//    (unit stride over W); h and h0 are contiguous. The kernel launches on
//    the caller's stream and allocates nothing.
//
// The backward (rglru_scan_bwd; the Pallas kernel has none, the reference
// differentiates its associative scan with XLA) reverses the recurrence:
// g_t = dh_t + a_{t+1} g_{t+1} from the last step, then db_t = g_t,
// da_t = g_t h_{t-1} (h_{-1} = h0, or 0) and dh0 = a_0 g_0, reading the
// forward's saved h. It reads a, dh and h and writes da and db once: 5 x 4 B
// per element, bound by bytes (335.5 MB, 0.100 ms at B1 S4096 W4096, the
// train step's call). Its design splits S as well as W, so that a batch of
// one fills the card:
//  - A block takes 32 channels (the lanes) and a chunk of 128 steps (8
//    warps, 16 steps each): 4096 blocks at B 1, S 4096, W 4096. Each thread
//    copies its 48 values (a_{t+1}, dh_t, h_{t-1}) into the block's shared
//    memory by cp.async, which holds no register while the copies are in
//    flight: four blocks an SM, 192 KB of copies in flight (held in
//    registers, the same loads made the kernel half as fast: too few bytes
//    in flight).
//  - Chunks pass their carry right to left in one pass (a chained scan with
//    decoupled look-back): block x takes the chunk NCH - 1 - x / (B NCG) of
//    one (batch, channel group), so it waits only for blocks of lower
//    index, which the card starts first. A block composes its segments'
//    (product of a, local g) pairs into the chunk's, publishes that
//    aggregate, then walks right until it finds a chunk whose inclusive
//    carry is out, and evaluates the carry from there back through the
//    aggregates it passed, one multiply-add each, the same operations in
//    the same order as the chain itself: the carry has the same bits
//    however far the walk went, so two calls give the same bits. It
//    publishes its own inclusive carry, then rescans its steps from the
//    carry and writes da and db.
//  - Publishing: each value beside its flag in one 64-bit word, so one
//    store makes both visible and neither side needs a fence. A wait that
//    never ends would be a bug: after 4 s it traps, so the launch fails
//    instead of holding the card.
//  - The C function zeroes the flags (a memset of 24 B per (batch, chunk,
//    channel), on the same stream) before the launch; the wrapper passes
//    the workspace.
// Any S >= 1 and any W: steps past S act as a = 0, dh = 0 and are not
// written; channels past W are neither read nor written nor published.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;            // channels per block
constexpr int SEGS = 8;              // warps per block: segments of a window
constexpr int THREADS = LANES * SEGS;
constexpr int L = 8;                 // steps per segment
constexpr int WINDOW = SEGS * L;     // steps per window

struct Params {
  const float* a;
  const float* b;
  const float* h0;  // nullptr: zeros
  float* h;
  int B, S, W;
  long long a_sb, a_ss;  // element strides of a over (batch, seq)
  long long b_sb, b_ss;
};

// The L steps of this thread's segment from t0: a and b of its channel, or
// the identity (a = 1, b = 0) past S or W.
__device__ __forceinline__ void load_segment(const Params& p, const float* a,
                                             const float* b, bool live,
                                             int t0, float (&ra)[L],
                                             float (&rb)[L]) {
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const int t = t0 + u;
    const bool in = live && t < p.S;
    ra[u] = in ? __ldg(a + t * p.a_ss) : 1.f;
    rb[u] = in ? __ldg(b + t * p.b_ss) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 4) rglru_scan_f32(const Params p) {
  __shared__ float2 seg[2][SEGS][LANES];  // (product of a, local state)
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int w = blockIdx.x * LANES + lane;
  const int bi = blockIdx.y;
  const bool live = w < p.W;
  const float* a = p.a + bi * p.a_sb + (live ? w : 0);
  const float* b = p.b + bi * p.b_sb + (live ? w : 0);
  float* h = p.h + static_cast<long long>(bi) * p.S * p.W + w;
  // the state entering the current window, the same in every warp
  float carry = p.h0 != nullptr && live
                    ? p.h0[static_cast<long long>(bi) * p.W + w] : 0.f;

  float ra[L], rb[L], na[L], nb[L];
  load_segment(p, a, b, live, warp * L, ra, rb);
  for (int t0 = 0, win = 0; t0 < p.S; t0 += WINDOW, ++win) {
    // the next window's loads go out before this window's arithmetic
    if (t0 + WINDOW < p.S)
      load_segment(p, a, b, live, t0 + WINDOW + warp * L, na, nb);
    float prod = 1.f, local = 0.f;
#pragma unroll
    for (int u = 0; u < L; ++u) {
      prod *= ra[u];
      local = fmaf(ra[u], local, rb[u]);
    }
    float2 (*pairs)[LANES] = seg[win & 1];
    pairs[warp][lane] = make_float2(prod, local);
    __syncthreads();
    // the carry into this segment, and into the next window
    float state = carry;
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      if (s == warp) state = carry;
      const float2 q = pairs[s][lane];
      carry = fmaf(q.x, carry, q.y);
    }
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int t = t0 + warp * L + u;
      state = fmaf(ra[u], state, rb[u]);
      if (live && t < p.S) h[static_cast<long long>(t) * p.W] = state;
    }
#pragma unroll
    for (int u = 0; u < L; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
    }
  }
}

constexpr int BL = 16;               // backward: steps per thread
constexpr int CHUNK = SEGS * BL;     // backward: steps per block
// backward: shared memory of a block, a_{t+1}, dh_t and h_{t-1} of its
// chunk (3 x 16 KB): up to four blocks an SM, 192 KB of copies in flight
constexpr int BWD_SMEM = 3 * CHUNK * LANES * 4;

struct BwdParams {
  const float* a;
  const float* h;   // the forward's output, contiguous (B, S, W)
  const float* h0;  // nullptr: zeros
  const float* dh;  // gradient of h
  float* da;        // contiguous (B, S, W)
  float* db;        // contiguous (B, S, W)
  float* dh0;       // contiguous (B, W), or nullptr
  int B, S, W;
  long long a_sb, a_ss;
  long long dh_sb, dh_ss;
  int NCH, NCG;     // chunks of CHUNK steps; groups of LANES channels
  // workspace, per (batch, chunk, channel): the chunk's aggregate (product
  // of a, local g) and its inclusive carry (g at its first step), each a
  // 64-bit word of the value and a flag (1 once published; zeroed before
  // the launch)
  unsigned long long* agg_prod;
  unsigned long long* agg_local;
  unsigned long long* incl;
};

// 4 bytes global -> shared without passing through registers; zeros when
// !valid (src must still be a mapped address).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Start copying this thread's segment, the BL steps from t0, into its rows
// of the block's shared memory (row t - chunk start, column lane): the
// coefficient a_{t+1} of g_{t+1} (0 at the last step, and past S or W,
// where dh is 0 too), dh_t and h_{t-1} (h0, or 0, at t = 0). The copies
// hold no registers while they are in flight.
__device__ __forceinline__ void load_segment_bwd(
    const BwdParams& p, const float* a, const float* dh, const float* h,
    const float* h0, bool live, int t0, int r0, float* sc, float* sd,
    float* sh) {
  const int lane = threadIdx.x % LANES;
#pragma unroll
  for (int u = 0; u < BL; ++u) {
    const int t = t0 + u, at = (r0 + u) * LANES + lane;
    const bool in = live && t < p.S;
    copy4(sc + at, in && t + 1 < p.S ? a + (t + 1) * p.a_ss : a,
          in && t + 1 < p.S);
    copy4(sd + at, in ? dh + t * p.dh_ss : dh, in);
    if (t > 0)
      copy4(sh + at, in ? h + static_cast<long long>(t - 1) * p.W : h, in);
    else
      copy4(sh + at, h0 != nullptr ? h0 : h, in && h0 != nullptr);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A value and its flag as one 64-bit word: one store publishes both, so
// neither side needs a fence.
__device__ __forceinline__ void publish(unsigned long long* at, float v) {
  const unsigned long long word =
      (1ull << 32) | static_cast<unsigned long long>(__float_as_uint(v));
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(at), "l"(word)
               : "memory");
}

// The word at ``at``, read at the device's coherence point.
__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* at) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(at)
               : "memory");
  return v;
}

__device__ __forceinline__ bool published(unsigned long long word) {
  return (word >> 32) != 0;
}

__device__ __forceinline__ float value_of(unsigned long long word) {
  return __uint_as_float(static_cast<unsigned>(word));
}

// g entering chunk ``chunk`` from its right (g at the first step of chunk +
// 1), for channel w of batch bi: walk right past chunks whose aggregate is
// out to the nearest one whose inclusive carry is out, then evaluate back
// through the aggregates passed, as the chain computes it. A wait that
// never ends is a bug: after 4 s, trap, so the launch fails instead of
// holding the card.
__device__ __forceinline__ float look_back(const BwdParams& p, int bi,
                                           int chunk, int w) {
  const long long row = static_cast<long long>(bi) * p.NCH;
  int j = chunk + 1;
  unsigned long long inc = 0;
  uint64_t start = 0;
  for (uint32_t polls = 1;; ++polls) {
    const long long at = (row + j) * p.W + w;
    inc = peek(p.incl + at);
    if (published(inc)) break;
    if (published(peek(p.agg_prod + at)) &&
        published(peek(p.agg_local + at))) {
      ++j;
      continue;
    }
    if (polls % 1024 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > 4000000000ull) __trap();
    }
  }
  float g = value_of(inc);
  for (int i = j - 1; i > chunk; --i) {
    const long long at = (row + i) * p.W + w;
    g = fmaf(value_of(peek(p.agg_prod + at)), g,
             value_of(peek(p.agg_local + at)));
  }
  return g;
}

// Block x takes chunk NCH - 1 - x / (B NCG) of one (batch, channel group):
// the rightmost chunks first, so the chunks a block waits for belong to
// blocks of lower index, which the card starts first (as CUDA's own
// single-pass scans assume).
__global__ void __launch_bounds__(THREADS, 4) rglru_scan_bwd_f32(
    const BwdParams p) {
  extern __shared__ float rows[];  // a_{t+1}, dh_t, h_{t-1}: CHUNK x LANES
  __shared__ float2 seg[SEGS][LANES];  // (product of a, local g)
  __shared__ float carry[LANES];       // g entering the chunk from its right
  const int per = p.B * p.NCG;
  const int chunk = p.NCH - 1 - static_cast<int>(blockIdx.x / per);
  const int bi = static_cast<int>(blockIdx.x % per) / p.NCG;
  const int cg = static_cast<int>(blockIdx.x % per) % p.NCG;

  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int w = cg * LANES + lane;
  const bool live = w < p.W;
  const float* a = p.a + bi * p.a_sb + (live ? w : 0);
  const float* dh = p.dh + bi * p.dh_sb + (live ? w : 0);
  const long long row = static_cast<long long>(bi) * p.S * p.W + w;
  const float* h = p.h + (live ? row : 0);
  const float* h0 = p.h0 != nullptr
                        ? p.h0 + static_cast<long long>(bi) * p.W +
                              (live ? w : 0)
                        : nullptr;
  float* sc = rows;
  float* sd = sc + CHUNK * LANES;
  float* sh = sd + CHUNK * LANES;
  const int r0 = warp * BL;  // this thread's rows: its segment's steps
  const int t0 = chunk * CHUNK + r0;
  load_segment_bwd(p, a, dh, h, h0, live, t0, r0, sc, sd, sh);
  // each thread reads back only what it copied: no barrier for the rows
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // this segment's pair: g at its first step = local + prod g_right
  float prod = 1.f, local = 0.f;
#pragma unroll
  for (int u = BL - 1; u >= 0; --u) {
    const float c = sc[(r0 + u) * LANES + lane];
    prod *= c;
    local = fmaf(c, local, sd[(r0 + u) * LANES + lane]);
  }
  seg[warp][lane] = make_float2(prod, local);
  __syncthreads();

  if (warp == 0) {
    // the chunk's aggregate: its segments composed right to left
    float cp = 1.f, cl = 0.f;
#pragma unroll
    for (int s = SEGS - 1; s >= 0; --s) {
      const float2 q = seg[s][lane];
      cl = fmaf(q.x, cl, q.y);
      cp *= q.x;
    }
    float g = 0.f;  // g entering from the right: 0 past the last chunk
    if (live) {
      const long long at =
          (static_cast<long long>(bi) * p.NCH + chunk) * p.W + w;
      if (chunk < p.NCH - 1) {
        publish(p.agg_prod + at, cp);
        publish(p.agg_local + at, cl);
        g = look_back(p, bi, chunk, w);
      }
      publish(p.incl + at, fmaf(cp, g, cl));
    }
    carry[lane] = g;
  }
  __syncthreads();

  // g entering this segment from its right, then its steps, last first
  float state = carry[lane];
#pragma unroll
  for (int s = SEGS - 1; s > 0; --s) {
    if (s > warp) {
      const float2 q = seg[s][lane];
      state = fmaf(q.x, state, q.y);
    }
  }
#pragma unroll
  for (int u = BL - 1; u >= 0; --u) {
    const int t = t0 + u, at_s = (r0 + u) * LANES + lane;
    state = fmaf(sc[at_s], state, sd[at_s]);  // g_t
    if (live && t < p.S) {
      const long long at = row + static_cast<long long>(t) * p.W;
      p.db[at] = state;
      p.da[at] = state * sh[at_s];
      if (t == 0 && p.dh0 != nullptr)
        p.dh0[static_cast<long long>(bi) * p.W + w] = __ldg(a) * state;
    }
  }
}

}  // namespace

extern "C" {

// a, b: fp32 (B, S, W) with unit stride over W and the given element
// strides over batch and sequence; h0: contiguous fp32 (B, W) or null
// (zeros); h: contiguous fp32 (B, S, W). Returns the CUDA error code
// (0 = ok).
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h,
                   int B, int S, int W, long long a_sb, long long a_ss,
                   long long b_sb, long long b_ss, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(a), static_cast<const float*>(b),
                 static_cast<const float*>(h0), static_cast<float*>(h),
                 B, S, W, a_sb, a_ss, b_sb, b_ss};
  const dim3 grid((W + LANES - 1) / LANES, B);
  rglru_scan_f32<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The version of the backward's C interface: 2 added the workspace.
int rglru_scan_bwd_abi(void) { return 2; }

// The backward: a and dh fp32 (B, S, W) with unit stride over W and the
// given element strides; h: the forward's contiguous fp32 output; h0:
// contiguous fp32 (B, W) or null; da, db: contiguous fp32 (B, S, W); dh0:
// contiguous fp32 (B, W), or null (not written); workspace: 8-byte aligned,
// 6 B ceil(S / 128) W fp32 of it, zeroed here before the launch. Returns
// the CUDA error code (0 = ok).
int rglru_scan_bwd(const void* a, const void* h, const void* h0,
                   const void* dh, void* da, void* db, void* dh0,
                   void* workspace, int B, int S, int W, long long a_sb,
                   long long a_ss, long long dh_sb, long long dh_ss,
                   void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NCH = (S + CHUNK - 1) / CHUNK, NCG = (W + LANES - 1) / LANES;
  const long long slots = static_cast<long long>(B) * NCH * W;
  const long long blocks = static_cast<long long>(B) * NCH * NCG;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* ws = static_cast<unsigned long long*>(workspace);
  const BwdParams p{static_cast<const float*>(a), static_cast<const float*>(h),
                    static_cast<const float*>(h0),
                    static_cast<const float*>(dh), static_cast<float*>(da),
                    static_cast<float*>(db), static_cast<float*>(dh0),
                    B, S, W, a_sb, a_ss, dh_sb, dh_ss, NCH, NCG,
                    ws, ws + slots, ws + 2 * slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      rglru_scan_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BWD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  // every flag to 0
  e = cudaMemsetAsync(workspace, 0, 3 * slots * 8, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  rglru_scan_bwd_f32<<<static_cast<unsigned>(blocks), THREADS, BWD_SMEM,
                       s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
