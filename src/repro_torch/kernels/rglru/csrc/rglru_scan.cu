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
// What the design does about it:
//  - The TPU kernel walks S as a sequential grid axis with the state in
//    VMEM scratch. Here one thread owns one (batch, channel) and walks S in
//    a loop with the state in a register: nothing is carried between
//    blocks, and neighbouring threads read neighbouring channels, so every
//    load and store is coalesced along W.
//  - At B 4, W 4096 that is only 16,384 threads, a few warps an SM, so
//    occupancy cannot hide the memory latency; loads in flight must. The
//    time loop runs in steps of U = 8, and the loads of a and b for the
//    next step are issued before the dependent multiply-adds of this one
//    (they do not depend on h), so each thread keeps 2 x 8 loads in flight
//    while it computes.
//  - Any S >= 1 and any W: the ragged tail of S and the last block's
//    channels past W are masked (the Pallas kernel asserts that its chunk
//    divides S and its block divides W).
//  - a and b are read through element strides over batch and sequence
//    (unit stride over W); h and h0 are contiguous. The kernel launches on
//    the caller's stream and allocates nothing.
// A chunk-parallel design (a scan within chunks, then a carry pass) would
// put more threads on the card; it is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int U = 8;          // time steps per register batch

struct Params {
  const float* a;
  const float* b;
  const float* h0;  // nullptr: zeros
  float* h;
  int B, S, W;
  long long a_sb, a_ss;  // element strides of a over (batch, seq)
  long long b_sb, b_ss;
};

// The U steps from t0: a and b of channel w, or nothing past S.
__device__ __forceinline__ void load_steps(const Params& p, const float* a,
                                           const float* b, int t0,
                                           float (&ra)[U], float (&rb)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (t < p.S) {
      ra[u] = __ldg(a + t * p.a_ss);
      rb[u] = __ldg(b + t * p.b_ss);
    }
  }
}

__global__ void __launch_bounds__(THREADS) rglru_scan_f32(const Params p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= p.W) return;
  const float* a = p.a + bi * p.a_sb + w;
  const float* b = p.b + bi * p.b_sb + w;
  float* h = p.h + static_cast<long long>(bi) * p.S * p.W + w;
  float state =
      p.h0 != nullptr ? p.h0[static_cast<long long>(bi) * p.W + w] : 0.f;

  float ra[U] = {}, rb[U] = {}, na[U] = {}, nb[U] = {};
  load_steps(p, a, b, 0, ra, rb);
  for (int t0 = 0; t0 < p.S; t0 += U) {
    // the next step's loads go out before this step's multiply-adds
    if (t0 + U < p.S) load_steps(p, a, b, t0 + U, na, nb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < p.S) {
        state = fmaf(ra[u], state, rb[u]);
        h[static_cast<long long>(t) * p.W] = state;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
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
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_f32<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
