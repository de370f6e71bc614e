// The reshard's transfer engine: one resize's on-card copies in one launch,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's reshard is one jax.device_put
// (src/repro/core/reshard.py), whose runtime carries out the Listing-3
// exchange with its own transfer engine. The port's reshard
// (src/repro_torch/core/reshard.py) compiles each leaf's walk once per
// geometry into a table of pieces and hands every piece whose source and
// destination lie on one card to this kernel, in one launch.
//
// What it computes: for each piece, a box of bytes from a source block to a
// destination block, bit for bit, whatever the dtype. A piece is up to 4
// dims after the wrapper merged the dims that are contiguous in both
// blocks: up to 3 outer dims (extents and byte strides on each side) and an
// innermost run of bytes that is contiguous in both. ref.py's
// box_copy_ref executes the same table with one torch.as_strided copy_ a
// piece.
//
// What bounds it on this card: bytes. It reads each copied byte once and
// writes it once, and computes nothing: 2 x the copied bytes at 3.35 TB/s.
// A resize of 512 MiB is bound at 0.32 ms.
//
// What the design does about it:
//  - The grid runs over (piece, tile). A tile is 16 KB of one row (rows
//    longer than a tile take several), or whole rows packed up to 16 KB
//    where the run is shorter. A block walks the launch's tiles with a
//    grid stride and finds each tile's piece by a binary search over the
//    pieces' first tiles (a few cached loads a 16 KB tile).
//  - Each thread loads 4 vectors of the piece's widest common alignment
//    before it stores them: 16-byte accesses where both pointers, the
//    strides and the run allow it (the blocks the caching allocator hands
//    out are 512-byte aligned, so whole blocks always do), down to single
//    bytes where they do not. 256 threads x 4 x 16 B is one 16 KB tile in
//    one pass, with 64 bytes a thread in flight.
//  - Four blocks (1024 threads, 64 KB of loads in flight) share an SM: the
//    launch bound holds a thread to 64 registers (ptxas spills 12 bytes).
//    Unbounded, the kernel took 96 registers, two blocks fitted, and the
//    copies ran slower (PERF.md). At most 8 blocks an SM are launched, few
//    enough that the binary search stays cheap.
//  - The host side is one C call: it checks the table (each piece's blocks
//    within their lists, no empty extent, each piece's tiles right after
//    the previous piece's), copies it and the blocks' pointers into a
//    pinned host buffer of its own, copies that to the caller's device
//    buffer on the caller's stream, records an event after the copy (the
//    buffer is reused once the event has completed) and launches. The
//    kernel allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long TILE = 16384;      // bytes of one tile (TILE_BYTES)
constexpr int BLOCKS_PER_SM = 8;      // launched; RESIDENT run at once
constexpr int RESIDENT = 4;            // at most 64 registers a thread
constexpr int MAX_DEVICES = 64;
constexpr int SLOTS = 8;               // pinned staging buffers a device
constexpr int INVALID_TABLE = -1;      // box_copy_launch's own error code

// One piece, as ref.py's TABLE_DTYPE lays it out (17 x int64).
struct Piece {
  long long src, dst;          // indices into the pointer lists
  long long src_off, dst_off;  // bytes from the block's data pointer
  long long run;               // bytes of each row, contiguous in both
  long long rows_per_tile;     // rows a tile covers (1 when run >= TILE)
  long long chunks;            // tiles across one row (1 when run < TILE)
  long long tile0;             // the piece's first tile in the launch
  long long ext[3];            // outer extents, outermost first
  long long src_stride[3];     // bytes (0 where the extent is 1)
  long long dst_stride[3];
};
static_assert(sizeof(Piece) == 17 * 8, "Piece must match PIECE_DTYPE");

// byte offsets of outer row `row` of a piece in its source and destination
__device__ __forceinline__ void row_offsets(const Piece& p, long long row,
                                            long long& s, long long& d) {
  const long long i2 = row % p.ext[2];
  row /= p.ext[2];
  const long long i1 = row % p.ext[1];
  const long long i0 = row / p.ext[1];
  s = i0 * p.src_stride[0] + i1 * p.src_stride[1] + i2 * p.src_stride[2];
  d = i0 * p.dst_stride[0] + i1 * p.dst_stride[1] + i2 * p.dst_stride[2];
}

// One tile of a piece in vectors of V: rows [row0, row0 + nrows), bytes
// [col0, col0 + width) of each. V divides every address it touches.
template <typename V>
__device__ __forceinline__ void copy_tile(const Piece& p, const char* src,
                                          char* dst, long long row0,
                                          long long nrows, long long col0,
                                          long long width) {
  const unsigned per_row = static_cast<unsigned>(width / sizeof(V));
  if (nrows == 1) {
    long long so, dso;
    row_offsets(p, row0, so, dso);
    const V* s = reinterpret_cast<const V*>(src + so + col0);
    V* d = reinterpret_cast<V*>(dst + dso + col0);
    for (unsigned i = threadIdx.x; i < per_row; i += THREADS * UNROLL) {
      V r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned j = i + u * THREADS;
        if (j < per_row) r[u] = __ldg(s + j);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned j = i + u * THREADS;
        if (j < per_row) d[j] = r[u];
      }
    }
    return;
  }
  // several short rows in one tile: at most TILE / sizeof(V) vectors
  const unsigned total = static_cast<unsigned>(nrows) * per_row;
  for (unsigned i = threadIdx.x; i < total; i += THREADS) {
    const unsigned r = i / per_row, c = i - r * per_row;
    long long so, dso;
    row_offsets(p, row0 + r, so, dso);
    const V* s = reinterpret_cast<const V*>(src + so + col0);
    V* d = reinterpret_cast<V*>(dst + dso + col0);
    d[c] = __ldg(s + c);
  }
}

__global__ void __launch_bounds__(THREADS, RESIDENT)
box_copy(const Piece* __restrict__ pieces, int n_pieces,
         const char* const* __restrict__ srcs, char* const* __restrict__ dsts,
         long long n_tiles) {
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // the last piece whose first tile is at or before t (no piece is empty)
    int lo = 0, hi = n_pieces - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pieces[mid].tile0 <= t) lo = mid; else hi = mid - 1;
    }
    const Piece& p = pieces[lo];
    const long long local = t - p.tile0;
    const long long group = local / p.chunks, chunk = local - group * p.chunks;
    const long long rows = p.ext[0] * p.ext[1] * p.ext[2];
    const long long row0 = group * p.rows_per_tile;
    const long long nrows = min(p.rows_per_tile, rows - row0);
    const long long col0 = chunk * TILE;
    const long long width = min(TILE, p.run - col0);
    const char* src = srcs[p.src] + p.src_off;
    char* dst = dsts[p.dst] + p.dst_off;
    const unsigned long long align =
        reinterpret_cast<unsigned long long>(src) |
        reinterpret_cast<unsigned long long>(dst) | p.run |
        p.src_stride[0] | p.src_stride[1] | p.src_stride[2] |
        p.dst_stride[0] | p.dst_stride[1] | p.dst_stride[2];
    if ((align & 15) == 0)
      copy_tile<uint4>(p, src, dst, row0, nrows, col0, width);
    else if ((align & 7) == 0)
      copy_tile<uint2>(p, src, dst, row0, nrows, col0, width);
    else if ((align & 3) == 0)
      copy_tile<unsigned>(p, src, dst, row0, nrows, col0, width);
    else if ((align & 1) == 0)
      copy_tile<unsigned short>(p, src, dst, row0, nrows, col0, width);
    else
      copy_tile<unsigned char>(p, src, dst, row0, nrows, col0, width);
  }
}

int sm_count(int dev) {
  static int cached[MAX_DEVICES] = {0};
  if (cached[dev]) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  cached[dev] = n;
  return n;
}

// tiles of one piece, as the kernel walks them
long long piece_tiles(const Piece& p) {
  const long long rows = p.ext[0] * p.ext[1] * p.ext[2];
  return (rows + p.rows_per_tile - 1) / p.rows_per_tile * p.chunks;
}

// The launch's tile count, or -1 where the table is not one the kernel
// takes: a block index past its list, an empty extent, or tiles other than
// these (ref.py's tiles() places them the same way).
long long check_table(const Piece* pieces, int n_pieces, int n_src,
                      int n_dst) {
  long long tiles = 0;
  for (int i = 0; i < n_pieces; ++i) {
    const Piece& p = pieces[i];
    if (p.src < 0 || p.src >= n_src || p.dst < 0 || p.dst >= n_dst ||
        p.run <= 0 || p.ext[0] <= 0 || p.ext[1] <= 0 || p.ext[2] <= 0)
      return -1;
    const bool short_run = p.run < TILE;
    if (p.rows_per_tile != (short_run ? TILE / p.run : 1) ||
        p.chunks != (short_run ? 1 : (p.run + TILE - 1) / TILE) ||
        p.tile0 != tiles)
      return -1;
    tiles += piece_tiles(p);
  }
  return tiles;
}

// A device's pinned staging buffers, each reused once the event recorded
// after its copy to the device has completed.
struct Slot {
  char* host = nullptr;
  size_t cap = 0;
  cudaEvent_t done = nullptr;
};
Slot slots[MAX_DEVICES][SLOTS];
std::mutex slots_lock;

cudaError_t take_slot(int dev, size_t bytes, Slot** out) {
  Slot* ring = slots[dev];
  Slot* free_small = nullptr;
  for (int i = 0; i < SLOTS; ++i) {
    Slot& s = ring[i];
    if (s.done != nullptr) {
      const cudaError_t q = cudaEventQuery(s.done);
      if (q == cudaErrorNotReady) {
        (void)cudaGetLastError();   // not an error: the copy is in flight
        continue;
      }
      if (q != cudaSuccess) return q;
    }
    if (s.cap >= bytes) {
      *out = &s;
      return cudaSuccess;
    }
    if (free_small == nullptr) free_small = &s;
  }
  if (free_small == nullptr) {          // every buffer in flight: wait
    free_small = &ring[0];
    cudaError_t err = cudaEventSynchronize(free_small->done);
    if (err != cudaSuccess) return err;
  }
  Slot& s = *free_small;
  if (s.cap < bytes) {
    if (s.host != nullptr) cudaFreeHost(s.host);
    s.host = nullptr;
    s.cap = 0;
    size_t cap = 4096;
    while (cap < bytes) cap *= 2;
    cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&s.host), cap,
                                    cudaHostAllocDefault);
    if (err != cudaSuccess) return err;
    s.cap = cap;
  }
  if (s.done == nullptr) {
    cudaError_t err = cudaEventCreateWithFlags(&s.done,
                                               cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  *out = &s;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The version of this C interface.
int box_copy_abi(void) { return 2; }

// table: n_pieces Pieces in host memory; ptrs: n_src source then n_dst
// destination data pointers. On `device`: checks the table, stages it and
// the pointers in pinned memory, copies them to dev_table (8-byte aligned,
// n_pieces * 136 + (n_src + n_dst) * 8 bytes) on `stream` and launches
// the copies. Returns the CUDA error code (0 = ok), or INVALID_TABLE.
int box_copy_launch(const void* table, const void* ptrs, void* dev_table,
                    int n_pieces, int n_src, int n_dst, int device,
                    void* stream) {
  if (n_pieces <= 0 || n_src <= 0 || n_dst <= 0 || device < 0 ||
      device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  const Piece* host_pieces = static_cast<const Piece*>(table);
  const long long n_tiles = check_table(host_pieces, n_pieces, n_src, n_dst);
  if (n_tiles <= 0) return INVALID_TABLE;
  const size_t table_bytes = static_cast<size_t>(n_pieces) * sizeof(Piece);
  const size_t ptr_bytes = static_cast<size_t>(n_src + n_dst) * sizeof(void*);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  {
    std::lock_guard<std::mutex> hold(slots_lock);
    Slot* slot = nullptr;
    err = take_slot(device, table_bytes + ptr_bytes, &slot);
    if (err == cudaSuccess) {
      std::memcpy(slot->host, table, table_bytes);
      std::memcpy(slot->host + table_bytes, ptrs, ptr_bytes);
      err = cudaMemcpyAsync(dev_table, slot->host, table_bytes + ptr_bytes,
                            cudaMemcpyHostToDevice, s);
    }
    if (err == cudaSuccess) err = cudaEventRecord(slot->done, s);
  }
  const int sms = err == cudaSuccess ? sm_count(device) : 0;
  if (err == cudaSuccess && sms <= 0) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) {
    const long long most = static_cast<long long>(sms) * BLOCKS_PER_SM;
    const unsigned grid =
        static_cast<unsigned>(n_tiles < most ? n_tiles : most);
    char* base = static_cast<char*>(dev_table);
    const Piece* pieces = reinterpret_cast<const Piece*>(base);
    const char* const* srcs =
        reinterpret_cast<const char* const*>(base + table_bytes);
    char* const* dsts = reinterpret_cast<char* const*>(base + table_bytes) +
                        n_src;
    box_copy<<<grid, THREADS, 0, s>>>(pieces, n_pieces, srcs, dsts, n_tiles);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

const char* box_copy_error_string(int code) {
  if (code == INVALID_TABLE)
    return "the table is not one the kernel takes (a block index past its "
           "list, an empty extent, or tiles out of place)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
