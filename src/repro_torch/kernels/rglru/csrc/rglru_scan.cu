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
// forward's saved h. The same design in reverse: windows from the end of the
// sequence, each warp a segment of L steps scanned from its right end with
// the coefficients a_{t+1}, the segments' pairs combined right to left, the
// next (earlier) window's loads in flight. It reads a, dh and h and writes
// da and db once: 5 x 4 B per element, bound by bytes.
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
};

// The L steps of this thread's segment from t0: the coefficient a_{t+1} of
// g_{t+1} (0 at the last step, and past S or W, where dh is 0 too), dh_t and
// h_{t-1} (h0 or 0 at t = 0).
__device__ __forceinline__ void load_segment_bwd(
    const BwdParams& p, const float* a, const float* dh, const float* h,
    float hprev0, bool live, int t0, float (&rc)[L], float (&rd)[L],
    float (&rh)[L]) {
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const int t = t0 + u;
    const bool in = live && t < p.S;
    rc[u] = in && t + 1 < p.S ? __ldg(a + (t + 1) * p.a_ss) : 0.f;
    rd[u] = in ? __ldg(dh + t * p.dh_ss) : 0.f;
    rh[u] = !in ? 0.f : t > 0 ? __ldg(h + static_cast<long long>(t - 1) * p.W)
                              : hprev0;
  }
}

__global__ void __launch_bounds__(THREADS, 4) rglru_scan_bwd_f32(
    const BwdParams p) {
  __shared__ float2 seg[2][SEGS][LANES];  // (product of a, local g)
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int w = blockIdx.x * LANES + lane;
  const int bi = blockIdx.y;
  const bool live = w < p.W;
  const float* a = p.a + bi * p.a_sb + (live ? w : 0);
  const float* dh = p.dh + bi * p.dh_sb + (live ? w : 0);
  const long long row = static_cast<long long>(bi) * p.S * p.W + w;
  const float* h = p.h + (live ? row : 0);
  const float hprev0 = p.h0 != nullptr && live
                           ? p.h0[static_cast<long long>(bi) * p.W + w] : 0.f;
  // the gradient entering the current window from its right, the same in
  // every warp
  float carry = 0.f;

  float rc[L], rd[L], rh[L], nc[L], nd[L], nh[L];
  const int last = (p.S - 1) / WINDOW;
  load_segment_bwd(p, a, dh, h, hprev0, live, last * WINDOW + warp * L, rc,
                   rd, rh);
  for (int win = last; win >= 0; --win) {
    const int t0 = win * WINDOW;
    // the earlier window's loads go out before this window's arithmetic
    if (win > 0)
      load_segment_bwd(p, a, dh, h, hprev0, live, t0 - WINDOW + warp * L,
                       nc, nd, nh);
    float prod = 1.f, local = 0.f;
#pragma unroll
    for (int u = L - 1; u >= 0; --u) {
      prod *= rc[u];
      local = fmaf(rc[u], local, rd[u]);
    }
    float2 (*pairs)[LANES] = seg[win & 1];
    pairs[warp][lane] = make_float2(prod, local);
    __syncthreads();
    // the gradient entering this segment from its right, and this window's
    float state = carry;
#pragma unroll
    for (int s = SEGS - 1; s >= 0; --s) {
      if (s == warp) state = carry;
      const float2 q = pairs[s][lane];
      carry = fmaf(q.x, carry, q.y);
    }
#pragma unroll
    for (int u = L - 1; u >= 0; --u) {
      const int t = t0 + warp * L + u;
      state = fmaf(rc[u], state, rd[u]);  // g_t
      if (live && t < p.S) {
        const long long at = row + static_cast<long long>(t) * p.W;
        p.db[at] = state;
        p.da[at] = state * rh[u];
        if (t == 0 && p.dh0 != nullptr)
          p.dh0[static_cast<long long>(bi) * p.W + w] = __ldg(a) * state;
      }
    }
#pragma unroll
    for (int u = 0; u < L; ++u) {
      rc[u] = nc[u];
      rd[u] = nd[u];
      rh[u] = nh[u];
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

// The backward: a and dh fp32 (B, S, W) with unit stride over W and the
// given element strides; h: the forward's contiguous fp32 output; h0:
// contiguous fp32 (B, W) or null; da, db: contiguous fp32 (B, S, W); dh0:
// contiguous fp32 (B, W), or null (not written). Returns the CUDA error code
// (0 = ok).
int rglru_scan_bwd(const void* a, const void* h, const void* h0,
                   const void* dh, void* da, void* db, void* dh0, int B,
                   int S, int W, long long a_sb, long long a_ss,
                   long long dh_sb, long long dh_ss, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{static_cast<const float*>(a), static_cast<const float*>(h),
                    static_cast<const float*>(h0),
                    static_cast<const float*>(dh), static_cast<float*>(da),
                    static_cast<float*>(db), static_cast<float*>(dh0),
                    B, S, W, a_sb, a_ss, dh_sb, dh_ss};
  const dim3 grid((W + LANES - 1) / LANES, B);
  rglru_scan_bwd_f32<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
