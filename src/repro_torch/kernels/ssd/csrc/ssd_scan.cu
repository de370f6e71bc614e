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
// B and C are shared by all heads (one group). Inputs are upcast to fp32 and
// the arithmetic is fp32, as the Pallas kernel's is, except seg (fp64, see
// below); y is written in x's type.
// Unlike the Pallas kernel, it also writes the final state h (B, H, P, N) in
// fp32, which the model's prefill cache needs.
//
// What bounds it on this card: at mamba2-130m's prefill (B 4, S 512, H 24,
// P 64, N 128, chunk 128) the function moves about 17 MB (x and y, B and C
// once, dt, the final state), 5 us at 3.35 TB/s, and needs about 2.5 GFLOP
// (C B^T once per (batch, chunk), the three head products, the triangle
// only), 2.5 us at the bf16 tensor-core rate: bound by bytes. This kernel
// runs fp32 on the CUDA cores (67 TFLOP/s) and forms C B^T once per head,
// about 2.7 GFLOP there, on 96 blocks for 132 SMs, so it is bound by its
// own operations, tens of microseconds: tensor cores and a chunk-parallel
// two-pass design are later work.
//
// What the design does about it:
//  - The TPU kernel walks the chunks as its innermost, sequential grid axis
//    and keeps the state in VMEM. Blocks on Hopper run in no order, so one
//    block of 256 threads owns one (batch, head), walks the chunks in a loop
//    and keeps the state in shared memory.
//  - Every product runs from shared memory into register tiles: the output
//    (4 rows x P/8 columns a thread), C B^T (8 x 8 a thread, the lower
//    triangle of 16 x 16 tiles only) and the state update (P/16 x N/16 a
//    thread). Rows are padded by one float, so the threads of a warp read
//    distinct banks.
//  - The intra-chunk decay is taken only on j <= i, where seg_i - seg_j <= 0;
//    the reference masks inside the exp because the upper triangle overflows.
//    seg is summed in fp64: over a chunk of 128 rows it reaches -100 on
//    random inputs and -1000 at mamba2-130m's init, where an fp32 ulp is
//    1e-5 and 6e-5, and every decay exp(seg_i - seg_j) inherits that error,
//    which the sequential recurrence never makes. Each dt * a is rounded to
//    fp32 first, as in the recurrence.
//  - Ragged sequences (S not a multiple of the chunk, S < chunk, S = 1) are
//    masked: rows past S load as zeros. The Pallas kernel asserts that the
//    chunk divides S and the reference model halves its chunk until it does;
//    the function is the same at any blocking.
//  - x, B, C and dt are read through element strides, so the model passes
//    its views of the conv output without a copy.
//
// Shared memory, in floats, with Qp the chunk rounded up to 16 rows: seg
//   Qp doubles, B Qp (N+1), C and then the decayed C B^T Qp max(N+1, Qp+1),
//   x * dt Qp (P+1), h P (N+1), and three vectors of Qp.
// At chunk 128, N 128, P 64 that is 200,960 bytes, which needs dynamic shared
// memory above 48 KB (cudaFuncSetAttribute) and leaves one block per SM.
//
// The kernel launches on the caller's stream and allocates nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 128;  // rows per chunk at most

struct Params {
  const void* x;        // (B, S, H, P), unit stride over P
  const float* dt;      // (B, S, H)
  const float* a_log;   // (H,), contiguous
  const void* b;        // (B, S, N), unit stride over N
  const void* c;        // (B, S, N), unit stride over N
  void* y;              // (B, S, H, P), contiguous
  float* h_final;       // (B, H, P, N), contiguous
  int B, S, H, Q;       // Q: rows per chunk, 1 <= Q <= QMAX
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ constexpr int round16(int q) { return (q + 15) & ~15; }

__host__ __device__ inline int g_stride(int Qp, int N) {
  return N + 1 > Qp + 1 ? N + 1 : Qp + 1;
}

template <int P, int N>
__host__ __device__ inline long long smem_floats(int Qp) {
  return static_cast<long long>(Qp) * (N + 1) +
         static_cast<long long>(Qp) * g_stride(Qp, N) +
         static_cast<long long>(Qp) * (P + 1) +
         static_cast<long long>(P) * (N + 1) + 5LL * Qp;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(Params p) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N are multiples of 16");
  constexpr int LN = N + 1, LP = P + 1;
  constexpr int MP = P / 8;               // output columns a thread
  constexpr int UP = P / 16, VN = N / 16;  // state tile a thread
  extern __shared__ double smem[];
  const int Q = p.Q;
  const int Qp = round16(Q);
  const int U = Qp / 16;                  // 16-row tiles in a chunk
  const int LG = g_stride(Qp, N);
  double* seg = smem;                     // cumsum(dt * a), fp64
  float* bs = reinterpret_cast<float*>(seg + Qp);  // B, Qp x LN
  float* cg = bs + Qp * LN;               // C, then G, Qp x LG
  float* xs = cg + Qp * LG;               // x * dt, Qp x LP
  float* hs = xs + Qp * LP;               // h, P x LN
  float* eseg = hs + P * LN;              // exp(seg)
  float* rem = eseg + Qp;                 // exp(seg_last - seg)
  float* dts = rem + Qp;                  // dt

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / p.H, hi = blockIdx.x % p.H;
  const float a = -expf(p.a_log[hi]);
  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb + hi * p.x_sh;
  const float* dt = p.dt + bi * p.dt_sb + hi * p.dt_sh;
  const T* bg = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cgl = static_cast<const T*>(p.c) + bi * p.c_sb;
  T* y = static_cast<T*>(p.y) +
         (static_cast<long long>(bi) * p.S * p.H + hi) * P;
  const long long y_ss = static_cast<long long>(p.H) * P;

  // output tile: rows 4 ry + k, columns py + 8 m
  const int ry = tid >> 3, py = tid & 7;
  const bool rows_live = 4 * ry < Qp;
  // C B^T tile: rows gi + 16 u, columns gj + 16 v
  const int gi = tid >> 4, gj = tid & 15;
  // state tile: h[sp + 16 u][sn + 16 v]
  const int sp = tid >> 4, sn = tid & 15;

  for (int e = tid; e < P * LN; e += THREADS) hs[e] = 0.f;

  const int nchunks = (p.S + Q - 1) / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int s0 = ch * Q;
    const int cq = min(Q, p.S - s0);  // live rows; the rest load as zeros

    // 1. load the chunk
    for (int j = tid; j < Qp; j += THREADS)
      dts[j] = j < cq ? dt[static_cast<long long>(s0 + j) * p.dt_ss] : 0.f;
    for (int e = tid; e < Qp * P; e += THREADS) {
      const int j = e / P, c = e % P;
      xs[j * LP + c] =
          j < cq ? to_f32(x[static_cast<long long>(s0 + j) * p.x_ss + c]) : 0.f;
    }
    for (int e = tid; e < Qp * N; e += THREADS) {
      const int j = e / N, n = e % N;
      const bool live = j < cq;
      bs[j * LN + n] =
          live ? to_f32(bg[static_cast<long long>(s0 + j) * p.b_ss + n]) : 0.f;
      cg[j * LG + n] =
          live ? to_f32(cgl[static_cast<long long>(s0 + j) * p.c_ss + n]) : 0.f;
    }
    __syncthreads();

    // 2. seg = cumsum(dt * a) in fp64: warp 0 scans, four rows a lane
    //    (Qp <= 128); rows past cq add 0, so seg[Qp - 1] is the total
    if (tid < 32) {
      double v[4];
      double run = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = tid * 4 + k;
        run += j < Qp ? static_cast<double>(dts[j] * a) : 0.0;
        v[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const double before = incl - run;
      const double total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = tid * 4 + k;
        if (j < Qp) {
          const double s = before + v[k];
          seg[j] = s;
          eseg[j] = expf(static_cast<float>(s));
          rem[j] = expf(static_cast<float>(total - s));
        }
      }
    }
    for (int e = tid; e < Qp * P; e += THREADS) {
      const int j = e / P, c = e % P;
      xs[j * LP + c] *= dts[j];
    }
    __syncthreads();

    // 3. carried state: acc = exp(seg_i) (C h)[i][p] (h is 0 in chunk 0)
    float acc[4][MP];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < MP; ++m) acc[k][m] = 0.f;
    if (ch > 0 && rows_live) {
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[MP];
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[k] = cg[(4 * ry + k) * LG + n];
#pragma unroll
        for (int m = 0; m < MP; ++m) hv[m] = hs[(py + 8 * m) * LN + n];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < MP; ++m) acc[k][m] += cv[k] * hv[m];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float e = eseg[4 * ry + k];
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[k][m] *= e;
      }
    }

    // 4. G = (C B^T) exp(seg_i - seg_j) on j <= i, 0 above; overwrites C.
    //    Tiles (u, v) with v > u lie wholly above the diagonal: skipped.
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

    // 5. intra-chunk term: acc += sum_{j <= i} G[i][j] (x dt)[j][p]; store y
    if (rows_live) {
      const int jmax = 4 * ry + 3;
      for (int j = 0; j <= jmax; ++j) {
        float gv[4], xv[MP];
#pragma unroll
        for (int k = 0; k < 4; ++k) gv[k] = cg[(4 * ry + k) * LG + j];
#pragma unroll
        for (int m = 0; m < MP; ++m) xv[m] = xs[j * LP + py + 8 * m];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < MP; ++m) acc[k][m] += gv[k] * xv[m];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * ry + k;
        if (i < cq) {
          T* row = y + static_cast<long long>(s0 + i) * y_ss;
#pragma unroll
          for (int m = 0; m < MP; ++m) store(row + py + 8 * m, acc[k][m]);
        }
      }
    }

    // 6. state update: h = exp(total) h + sum_j ((x dt)[j] rem[j]) B[j]^T
    {
      float hv[UP][VN];
#pragma unroll
      for (int u = 0; u < UP; ++u)
#pragma unroll
        for (int v = 0; v < VN; ++v) hv[u][v] = 0.f;
      for (int j = 0; j < cq; ++j) {
        const float r = rem[j];
        float xv[UP], bv[VN];
#pragma unroll
        for (int u = 0; u < UP; ++u) xv[u] = xs[j * LP + sp + 16 * u] * r;
#pragma unroll
        for (int v = 0; v < VN; ++v) bv[v] = bs[j * LN + sn + 16 * v];
#pragma unroll
        for (int u = 0; u < UP; ++u)
#pragma unroll
          for (int v = 0; v < VN; ++v) hv[u][v] += xv[u] * bv[v];
      }
      const float et = expf(static_cast<float>(seg[Qp - 1]));
#pragma unroll
      for (int u = 0; u < UP; ++u)
#pragma unroll
        for (int v = 0; v < VN; ++v) {
          float* h = hs + (sp + 16 * u) * LN + sn + 16 * v;
          *h = *h * et + hv[u][v];
        }
    }
    __syncthreads();  // before the next chunk overwrites the tiles
  }

  float* hf = p.h_final + static_cast<long long>(blockIdx.x) * P * N;
  for (int e = tid; e < P * N; e += THREADS) hf[e] = hs[(e / N) * LN + e % N];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long bytes = smem_floats<P, N>(round16(p.Q)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, P, N>
      <<<p.B * p.H, THREADS, static_cast<size_t>(bytes), stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(int N, const Params& p, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, P, 16>(p, stream);
    case 32: return launch<T, P, 32>(p, stream);
    case 64: return launch<T, P, 64>(p, stream);
    case 128: return launch<T, P, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_p(int P, int N, const Params& p, cudaStream_t stream) {
  switch (P) {
    case 16: return launch_n<T, 16>(N, p, stream);
    case 32: return launch_n<T, 32>(N, p, stream);
    case 64: return launch_n<T, 64>(N, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. x: (B, S, H, P) with
// unit stride over P; dt: (B, S, H) float32; a_log: (H,) float32,
// contiguous; b, c: (B, S, N) with unit stride over N; all with the given
// element strides over the other axes. y: contiguous (B, S, H, P) in x's
// type; h_final: contiguous (B, H, P, N) float32. chunk: rows per chunk,
// 1..128. P in {16, 32, 64}, N in {16, 32, 64, 128}. Returns the CUDA error
// code (0 = ok).
int ssd_scan_fwd(const void* x, const float* dt, const float* a_log,
                 const void* b, const void* c, void* y, float* h_final,
                 int dtype, int B, int S, int H, int P, int N, int chunk,
                 long long x_sb, long long x_ss, long long x_sh,
                 long long dt_sb, long long dt_ss, long long dt_sh,
                 long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > QMAX ||
      static_cast<long long>(B) * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, dt, a_log, b, c, y, h_final, B, S, H, chunk,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb,
                 c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_p<float>(P, N, p, s);
  else if (dtype == 1)
    err = launch_p<__nv_bfloat16>(P, N, p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
