// Kernel B6 (remote_exchange): the all-to-all exchange of the distributed
// shuffle, rdst_tpu_torch/parallel/remote_dma.py.
//
// Replaces the Pallas _exchange_kernel (rdst_tpu/parallel/remote_dma.py:125,
// launched by remote_dma_exchange at :225).  There every sender starts
// chunked remote DMAs of its per-destination segments into every peer's
// receive buffer, after a barrier, and each receiver drains its expected
// number of equal-size arrivals.  The 128-lane leads, the fixed 16 x 128
// chunks and the chunk-rounded receiver slots come from the TPU's DMA engine;
// a CUDA copy addresses elements, so this kernel keeps only the exact ragged
// layout of ragged_all_to_all: sender s's segment for destination d lands at
// offset sum_{s' < s} size[s', d] of d's buffer.
//
// One launch does the whole exchange, every sender and every plane, and
// writes every receive word exactly once.  Senders and receivers may differ
// in number (S x R): on a mesh that spans processes the receivers are this
// process's shards and the senders every shard of the group, a remote
// sender's plane being its block of the transport buffer that
// torch.distributed filled.  The segments of receiver d tile
// [0, min(demand_d, capacity)) of its buffer in sender order (the offsets are
// a cumsum), and the pad word fills the rest, so the kernel walks the
// receive buffers, not the senders: block (c, d, j) owns receive words
// [c * kChunk, (c + 1) * kChunk) of receiver d's buffer of plane j.  It copies
// the part of each sender's segment that falls there, writes the pad word
// over the part at or past min(demand_d, capacity), and adds the words that
// landed to arrived[j, d] with one atomicAdd (the counterpart of the drain).
// Stores past the capacity never happen: a segment keeps its part below it,
// and the caller still reports the demand (the reference's truncate-and-
// signal rule).  Sizes and offsets are read on the device, so the host never
// waits for them; each block sums the sizes of the senders before s to find
// where s's segment lands, so the layout needs no table of its own.  Sender
// planes and receiver buffers come as a table of pointers, so the same kernel
// serves buffers on the sender's own card and, later, peer-mapped buffers of
// other cards.
//
// Copies are 16 bytes wide at any alignment: a piece peels scalar words
// until its destination is 16-byte aligned, then stores aligned uint4s; where
// the source's word offset differs mod 4 each store takes its four words
// from two aligned uint4 loads (the second is the next store's first, so it
// comes from L1), and a scalar tail ends the piece.  The pad is the same
// split with no source.
//
// Bound: bytes.  Each landed word is read once and each receive word written
// once: 4 * (landed + planes * R * capacity) bytes over the H100's 3.35 TB/s.
// The first design (one launch per sender and plane, one u32 a thread, the
// receive buffers filled with the pad word beforehand) wrote every landed
// word twice and ran its launches at 43% of HBM bandwidth on the shuffle's
// unaligned segments.
//
// Ordering, the counterpart of the barrier: receivers read only after the
// launch, which stream order gives with all shards on one card.  A remote
// sender's block was written by a collective that the current stream has
// waited for before this launch.  Shards on several cards of one process
// need events around it: not done here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;  // receive words per block
constexpr int kUnroll = 4;    // 16-byte stores in flight per thread
constexpr uint32_t kPad = 0xFFFFFFFFu;

struct Exchange {
  // [j * n_send + s]: sender s's plane j; [n_planes * n_send + j * n_recv +
  // d]: receiver d's buffer of plane j (capacity words)
  const long long* ptrs;
  const long long* src_off;  // (n_send, n_recv) [s, d]: segment start in the sender
  const long long* sizes;    // (n_send, n_recv) [s, d]: rows s sends d
  unsigned long long* arrived;  // (n_planes, n_recv)
  long long capacity;
  int n_send;
  int n_recv;
  int n_planes;
};

template <int R>
__device__ __forceinline__ uint4 shifted(const uint4& x, const uint4& y) {
  if constexpr (R == 1) return make_uint4(x.y, x.z, x.w, y.x);
  if constexpr (R == 2) return make_uint4(x.z, x.w, y.x, y.y);
  return make_uint4(x.w, y.x, y.y, y.z);
}

// nvec aligned 16-byte stores at dst from the words at src, whose word
// offset mod 4 is R: store v takes words 4v .. 4v+3 of src, which lie in the
// aligned uint4s v and v + 1 counted from src - R.  Either uint4 holds a word
// of the segment, so no load leaves the source's 16-byte blocks.
template <int R>
__device__ __forceinline__ void copy_body(uint4* __restrict__ dst,
                                          const uint32_t* __restrict__ src,
                                          long long nvec) {
  const uint4* a = reinterpret_cast<const uint4*>(src - R);
  for (long long v0 = threadIdx.x; v0 < nvec; v0 += kThreads * kUnroll) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nvec) {
        if constexpr (R == 0) {
          x[u] = __ldg(a + v);
        } else {
          x[u] = shifted<R>(__ldg(a + v), __ldg(a + v + 1));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nvec) dst[v] = x[u];
    }
  }
}

// Words until p is 16-byte aligned, at most len.
__device__ __forceinline__ long long head_of(const uint32_t* p, long long len) {
  const long long h = (4 - ((reinterpret_cast<uintptr_t>(p) >> 2) & 3)) & 3;
  return h < len ? h : len;
}

// len words from src to dst (both 4-byte aligned), by the whole block.
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src,
                                           long long len) {
  const int t = threadIdx.x;
  const long long head = head_of(dst, len);
  if (t < head) dst[t] = src[t];
  dst += head;
  src += head;
  len -= head;
  const long long nvec = len >> 2;
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  switch ((reinterpret_cast<uintptr_t>(src) >> 2) & 3) {
    case 0: copy_body<0>(d4, src, nvec); break;
    case 1: copy_body<1>(d4, src, nvec); break;
    case 2: copy_body<2>(d4, src, nvec); break;
    default: copy_body<3>(d4, src, nvec); break;
  }
  const long long i = (nvec << 2) + t;
  if (i < len) dst[i] = src[i];
}

// len pad words at dst, by the whole block.
__device__ __forceinline__ void pad_words(uint32_t* dst, long long len) {
  const int t = threadIdx.x;
  const long long head = head_of(dst, len);
  if (t < head) dst[t] = kPad;
  dst += head;
  len -= head;
  const long long nvec = len >> 2;
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (long long v = t; v < nvec; v += kThreads) {
    d4[v] = make_uint4(kPad, kPad, kPad, kPad);
  }
  const long long i = (nvec << 2) + t;
  if (i < len) dst[i] = kPad;
}

__global__ void __launch_bounds__(kThreads)
exchange_kernel(const __grid_constant__ Exchange X) {
  const int d = blockIdx.y;
  const int j = blockIdx.z;
  const int ns = X.n_send;
  const int nr = X.n_recv;
  const long long cap = X.capacity;
  const long long p0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long p1 = p0 + kChunk < cap ? p0 + kChunk : cap;
  uint32_t* out = reinterpret_cast<uint32_t*>(
      X.ptrs[static_cast<long long>(X.n_planes) * ns + static_cast<long long>(j) * nr + d]);
  long long landed = 0;  // words of [p0, p1) that landed; uniform
  long long fill = 0;    // min(demand_d, capacity): where the pad begins
  long long lo = 0;      // where sender s's segment lands: sum of sizes[< s, d]
  for (int s = 0; s < ns; ++s) {
    const long long i = static_cast<long long>(s) * nr + d;
    const long long size = X.sizes[i];
    long long fit = cap - lo;  // the part of the segment below the capacity
    if (fit > size) fit = size;
    if (fit < 0) fit = 0;
    fill += fit;
    const long long a = p0 > lo ? p0 : lo;
    const long long b = p1 < lo + fit ? p1 : lo + fit;
    if (a < b) {
      const uint32_t* in = reinterpret_cast<const uint32_t*>(
                               X.ptrs[static_cast<long long>(j) * ns + s]) +
                           X.src_off[i] + (a - lo);
      copy_words(out + a, in, b - a);
      landed += b - a;
    }
    lo += size;
  }
  const long long a = p0 > fill ? p0 : fill;
  if (a < p1) pad_words(out + a, p1 - a);
  if (threadIdx.x == 0 && landed > 0) {
    atomicAdd(&X.arrived[static_cast<long long>(j) * nr + d],
              static_cast<unsigned long long>(landed));
  }
}

}  // namespace

// ptrs: device table of n_planes * (n_send + n_recv) int64 addresses (sender
// planes, then receiver buffers, as in Exchange).  src_off, sizes: device
// (n_send, n_recv) int64 [sender, receiver].  arrived: device (n_planes,
// n_recv) int64, added to.  Every receive word is written: no fill
// beforehand.
extern "C" int rdst_remote_exchange(const void* ptrs, const void* src_off,
                                    const void* sizes, int n_send, int n_recv,
                                    int n_planes, long long capacity,
                                    void* arrived, void* stream) {
  if (n_send < 1 || n_recv < 1 || n_recv > 65535 || n_planes < 1 ||
      n_planes > 65535 || capacity < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (capacity + kChunk - 1) / kChunk;
  if (chunks == 0) return static_cast<int>(cudaGetLastError());
  if (chunks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  Exchange X;
  X.ptrs = static_cast<const long long*>(ptrs);
  X.src_off = static_cast<const long long*>(src_off);
  X.sizes = static_cast<const long long*>(sizes);
  X.arrived = static_cast<unsigned long long*>(arrived);
  X.capacity = capacity;
  X.n_send = n_send;
  X.n_recv = n_recv;
  X.n_planes = n_planes;
  const dim3 grid(static_cast<unsigned int>(chunks), static_cast<unsigned int>(n_recv),
                  static_cast<unsigned int>(n_planes));
  exchange_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(X);
  return static_cast<int>(cudaGetLastError());
}
