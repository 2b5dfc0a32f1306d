// Kernel B8 (radix pass): one least-significant-digit pass of the fused
// executor's radix sort (rdst_tpu_torch/ops/radix_sort.py): every row moves
// to its place in the stable order by one 8-bit digit of its key.
//
// B8 replaces no Pallas kernel.  The JAX package sorts large inputs with
// bitonic compare-exchange networks (rdst_tpu/ops/pallas_sort.py) because a
// TPU has no fast scatter; Hopper scatters at close to its copy rate, so a
// key of at most 64 bits sorts in one pass per byte, O(n) work a pass,
// where the network takes O(n log^2 n).  The design is Onesweep (Adinets
// and Merrill, "Onesweep: A Faster Least Significant Digit Radix Sort for
// GPUs", 2022): one launch a pass, the digit bases of all passes from one
// histogram launch (B1) before them, and a decoupled look-back between the
// tiles of a pass in place of a separate scan launch.
//
// What bounds it: every plane read once and written once, 2 * n * (bytes
// of a row) a pass over HBM bandwidth (0.239 ms for 50M rows of two u32
// planes at 3.35 TB/s).  A tile's work is a chain of latencies (its loads,
// the ranking, the look-back's round trips to L2, its stores) with few
// operations between them, so the design shortens the chain and keeps
// loads in flight across it:
//
//   - a block takes the next tile of kTile = kThreads * kItems rows from an
//     atomic counter (zeroed with the flags before each launch), so every
//     tile it waits on in the look-back belongs to a block that is already
//     running;
//   - each warp loads its 32 * kItems rows of the digit's plane
//     warp-striped (row i * 32 + lane of its stretch): the 32 lanes of one
//     load read 32 neighbouring words, so the load is one coalesced 128-byte
//     line for u32 (u8/u16 planes are read narrow).  These loads are 4-byte
//     loads, not 16-byte ones, because the ranking needs each item's 32
//     lanes on 32 consecutive rows; 16 loads in flight a thread keep enough
//     bytes moving;
//   - the next u32 plane (a u64 key's other word) is copied into shared
//     memory with cp.async as the block starts, so its loads fly through
//     the counting, the ranking and the look-back;
//   - early counts: the warps count their digits with shared atomics, and
//     the tile's counts go out at once as its aggregate flags, before the
//     ranking, so later tiles wait on this one as little as may be;
//   - ranking: item by item, eight ballots (one a digit bit) give each lane
//     the lanes of its digit (a warp-level multisplit; __match_any_sync
//     measured slower); a row's position in the tile is its warp's next
//     position for the digit (the digit's start in the tile plus the
//     earlier warps' counts plus this warp's earlier items) plus the lanes
//     below it in its group.  Item order is row order, so equal digits keep
//     their order: the pass is stable;
//   - then one thread a digit looks back over the earlier tiles' flags
//     (status and count in one 32-bit word: aggregate, or inclusive prefix,
//     which ends the walk) and publishes its own inclusive prefix.  The
//     digit's global base is the exclusive scan of its level's counts
//     (B1's output), scanned in each block with the tile's starts;
//   - partial coalescing of the scatter: the positions map back to tile rows
//     (src_of), and consecutive threads write consecutive positions, so a
//     digit's run within the tile (kTile / 256 = 16 rows on uniform digits)
//     goes out as one contiguous stretch and a warp's 32 stores touch two or
//     three stretches instead of 32 lines.  The destination of position p is
//     s_off[digit] + p for every plane; a plane beyond the first two is
//     loaded into shared memory in row order and written the same way.
//
// Limits: n < 2^30 (a flag's count has 30 bits); the wrapper keeps larger
// sorts on the network.
#include "bitonic.cuh"

namespace {

constexpr int kThreads = 256;  // = the radix: one thread a digit
constexpr int kItems = 16;     // rows a thread
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr int kRadix = 256;
constexpr uint32_t kCountMask = (1u << 30) - 1u;
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;

static_assert(kThreads == kRadix, "one thread a digit");

struct PassPlanes {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  int width[kMaxPlanes];
  int n_planes;
};

__device__ __forceinline__ uint32_t load_flag(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

template <int W>
__device__ __forceinline__ uint32_t load_w(const void* p, long long i) {
  if (W == 4) return static_cast<const uint32_t*>(p)[i];
  if (W == 2) return static_cast<const uint16_t*>(p)[i];
  return static_cast<const uint8_t*>(p)[i];
}

// A 4-byte copy from global into shared memory that completes in the
// background (cp.async); cp_wait() waits for this thread's copies.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Exclusive prefix sums of two ints a thread over the block (*ea of a, *eb
// of b).  scratch: 2 * kWarps ints of shared memory; ends with a barrier.
__device__ __forceinline__ void block_exclusive2(int a, int b, int* scratch,
                                                 int* ea, int* eb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = a;
  int y = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xo = __shfl_up_sync(0xffffffffu, x, o);
    const int yo = __shfl_up_sync(0xffffffffu, y, o);
    if (lane >= o) {
      x += xo;
      y += yo;
    }
  }
  if (lane == 31) {
    scratch[warp] = x;
    scratch[kWarps + warp] = y;
  }
  __syncthreads();
  int xw = 0;
  int yw = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      xw += scratch[w];
      yw += scratch[kWarps + w];
    }
  }
  *ea = xw + x - a;
  *eb = yw + y - b;
  __syncthreads();
}

// Shared memory of a block, in 4-byte words: the rows of two planes, the
// source row of each staged position (u16), the warps' digit counters, the
// destinations, the scan's scratch and the tile id.
constexpr int kSmemWords = 2 * kTile + kTile / 2 + kWarps * kRadix + kRadix + 2 * kWarps + 1;

// One pass: rows [0, n) of P.in, by the digit (in[digit_plane] >> shift) &
// 0xFF, into P.out in the stable order.  W: the digit plane's width.
// counts: the level's 256 digit counts (int64, B1's); flags: tiles * 256
// words, zero; counter: one word, zero (the words after the flags).
template <int W>
__global__ void __launch_bounds__(kThreads, 3)
radix_pass_kernel(PassPlanes P, int digit_plane, int shift, int n,
                  const long long* __restrict__ counts, uint32_t* flags,
                  unsigned int* counter) {
  extern __shared__ __align__(16) uint32_t smem[];
  // rows of the tile in row order: [0] the digit plane, [1] another plane
  uint32_t* rows0 = smem;
  uint32_t* rows1 = smem + kTile;
  uint16_t* src_of = reinterpret_cast<uint16_t*>(smem + 2 * kTile);  // row at position p
  uint32_t* warp_cnt = smem + 2 * kTile + kTile / 2;  // [kWarps][kRadix]
  int* s_off = reinterpret_cast<int*>(warp_cnt + kWarps * kRadix);  // dest of p: s_off[d] + p
  int* scratch = s_off + kRadix;
  int* s_tile = scratch + 2 * kWarps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) *s_tile = static_cast<int>(atomicAdd(counter, 1u));
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_cnt[w * kRadix + tid] = 0;
  const long long level_count = counts[tid];
  __syncthreads();
  const int tile = *s_tile;
  const long long row0 = static_cast<long long>(tile) * kTile;
  const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - row0));

  // the first other u32 plane goes to shared memory in the background, so
  // its loads fly through the counting, the ranking and the look-back
  const int q1 = digit_plane == 0 ? 1 : 0;
  const bool early = q1 < P.n_planes && P.width[q1] == 4;
  if (early) {
    const uint32_t* src = static_cast<const uint32_t*>(P.in[q1]) + row0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + tid;
      if (k < tile_n) cp_async4(&rows1[k], src + k);
    }
  }

  // the digit plane, warp-striped: tile row k = warp * 32 * kItems + i * 32
  // + lane; each warp counts its digits
  const int wk = warp * (32 * kItems) + lane;
  uint32_t v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = wk + i * 32;
    v[i] = k < tile_n ? load_w<W>(P.in[digit_plane], row0 + k) : 0u;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (wk + i * 32 < tile_n) atomicAdd(&warp_cnt[warp * kRadix + ((v[i] >> shift) & 0xFFu)], 1u);
  }
  __syncthreads();

  // the tile's count of digit tid goes out at once, as its aggregate, so
  // the tiles after it wait on it as little as may be
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = static_cast<int>(warp_cnt[w * kRadix + tid]);
    warp_cnt[w * kRadix + tid] = static_cast<uint32_t>(count);
    count += c;
  }
  uint32_t* my_flags = flags + static_cast<long long>(tile) * kRadix;
  store_flag(my_flags + tid, (tile == 0 ? kInclusive : kAggregate) |
                                 static_cast<uint32_t>(count));

  // the digit's global base and its start within the tile; each warp's
  // counter row becomes its digits' first positions in the tile
  int base;
  int start;
  block_exclusive2(static_cast<int>(level_count), count, scratch, &base, &start);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_cnt[w * kRadix + tid] += static_cast<uint32_t>(start);
  __syncthreads();

  // rank within the warp, item by item (row order): the lanes of a digit
  // are found by eight ballots, one a digit bit (a warp-level multisplit);
  // each row's position is its warp's next position for the digit plus the
  // lanes below it in its group.  The digit plane is kept in row order.
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = wk + i * 32;
    const bool valid = k < tile_n;
    const uint32_t d = (v[i] >> shift) & 0xFFu;
    unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned bits = __ballot_sync(0xffffffffu, (d >> b) & 1u);
      peers &= ((d >> b) & 1u) ? bits : ~bits;
    }
    const uint32_t next = warp_cnt[warp * kRadix + d];
    __syncwarp();
    if (valid) {
      if ((peers & lt) == 0) warp_cnt[warp * kRadix + d] = next + __popc(peers);
      src_of[next + __popc(peers & lt)] = static_cast<uint16_t>(k);
      rows0[k] = v[i];
    }
    __syncwarp();
  }

  // decoupled look-back over the earlier tiles
  int before = 0;
  if (tile > 0) {
    for (int j = tile - 1; j >= 0; --j) {
      const uint32_t* f = flags + static_cast<long long>(j) * kRadix + tid;
      uint32_t x;
      do {
        x = load_flag(f);
      } while (x == 0u);
      before += static_cast<int>(x & kCountMask);
      if ((x & ~kCountMask) == kInclusive) break;
    }
    store_flag(my_flags + tid, kInclusive | static_cast<uint32_t>(before + count));
  }
  s_off[tid] = base + before - start;
  if (early) cp_wait();
  __syncthreads();

  // the staged rows out in digit order, consecutive positions by
  // consecutive threads: the digit plane, then the early plane
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = i * kThreads + tid;
    if (p < tile_n) {
      const int k = src_of[p];
      const uint32_t x = rows0[k];
      const int dest = s_off[(x >> shift) & 0xFFu] + p;
      store_plane(P.out[digit_plane], W, dest, x);
      if (early) store_plane(P.out[q1], 4, dest, rows1[k]);
    }
  }

  // every further plane the same way, by the same destinations
  for (int q = 0; q < P.n_planes; ++q) {
    if (q == digit_plane || (early && q == q1)) continue;
    const int wq = P.width[q];
    uint32_t u[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + tid;
      u[i] = k < tile_n ? load_plane(P.in[q], wq, row0 + k) : 0u;
    }
    __syncthreads();  // the previous plane's rows are read
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + tid;
      if (k < tile_n) rows1[k] = u[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = i * kThreads + tid;
      if (p < tile_n) {
        const int k = src_of[p];
        store_plane(P.out[q], wq, s_off[(rows0[k] >> shift) & 0xFFu] + p, rows1[k]);
      }
    }
  }
}

template <int W>
cudaError_t launch_pass(const PassPlanes& P, int digit_plane, int shift, int n,
                        const long long* counts, unsigned int* flags,
                        unsigned int* counter, cudaStream_t s) {
  constexpr int bytes = 4 * kSmemWords;
  cudaError_t err = cudaFuncSetAttribute(
      radix_pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const unsigned int tiles = static_cast<unsigned int>((n + kTile - 1) / kTile);
  radix_pass_kernel<W><<<tiles, kThreads, bytes, s>>>(P, digit_plane, shift, n, counts,
                                                      flags, counter);
  return cudaGetLastError();
}

}  // namespace

// Rows of one tile (radix_sort.TILE mirrors it).
extern "C" int rdst_radix_tile() { return kTile; }

// ins, outs: n_planes device planes of n rows (u8/u16/u32, widths in
// bytes); the digit is (ins[digit_plane] >> shift) & 0xFF.  counts: the
// level's 256 int64 digit counts; scratch: ceil(n / tile) * 256 + 1 u32 of
// any contents, zeroed here before the launch (the look-back flags, then
// the tile counter), so every pass of a sort reuses one buffer.  Outputs
// must not overlap inputs.
extern "C" int rdst_radix_pass(void* const* ins, void* const* outs,
                               const int* widths, int n_planes,
                               int digit_plane, int shift, long long n,
                               const long long* counts, unsigned int* scratch,
                               void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || digit_plane < 0 ||
      digit_plane >= n_planes || n < 1 || n > static_cast<long long>(kCountMask) ||
      shift < 0 || shift > 24 || (shift & 7)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PassPlanes P{};
  for (int p = 0; p < n_planes; ++p) {
    if (widths[p] != 1 && widths[p] != 2 && widths[p] != 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.in[p] = ins[p];
    P.out[p] = outs[p];
    P.width[p] = widths[p];
  }
  P.n_planes = n_planes;
  if (shift >= 8 * widths[digit_plane]) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long flag_words = (n + kTile - 1) / kTile * kRadix;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (flag_words + 1) * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned int* counter = scratch + flag_words;
  const int ni = static_cast<int>(n);
  switch (widths[digit_plane]) {
    case 4:
      return static_cast<int>(launch_pass<4>(P, digit_plane, shift, ni, counts, scratch, counter, s));
    case 2:
      return static_cast<int>(launch_pass<2>(P, digit_plane, shift, ni, counts, scratch, counter, s));
    default:
      return static_cast<int>(launch_pass<1>(P, digit_plane, shift, ni, counts, scratch, counter, s));
  }
}
