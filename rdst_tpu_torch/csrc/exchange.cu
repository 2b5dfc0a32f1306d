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
// One launch copies one sender's plane: grid (blocks, destinations), a
// grid-stride loop over the segment, one u32 per thread, so loads and stores
// coalesce.  Sizes and offsets are read on the device (the host never waits
// for them); destination buffers come as a table of base pointers, so the
// same kernel serves buffers on the sender's own card and, later, peer-mapped
// buffers of other cards.  A store past the receiver's capacity is dropped
// element by element; the caller still reports the demand, which is the
// reference's truncate-and-signal rule.  Each block adds the elements it
// wrote to the receiver's arrival counter with one atomicAdd: the counterpart
// of the drain.
//
// Ordering, the counterpart of the barrier: every receive buffer is allocated
// and filled with the pad word before the first launch, and receivers read
// only after every sender's launch.  With all shards on one card, stream
// order gives both.  Shards on several cards need events between the fill,
// the launches and the reads: not done here.
//
// Bound: bytes.  Every element is read once and written once (8 bytes), so a
// launch should approach the 3.35 TB/s of the H100's HBM; chip_smoke.py
// prints the kernel's device time and rate at the shuffle's exchange.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
exchange_kernel(const uint32_t* __restrict__ src,
                const long long* __restrict__ src_off,
                const long long* __restrict__ sizes,
                const long long* __restrict__ dst_ptr,
                const long long* __restrict__ dst_off, long long capacity,
                unsigned long long* __restrict__ arrived) {
  const int d = blockIdx.y;
  const long long off = dst_off[d];
  long long fit = capacity - off;  // stores at or past capacity are dropped
  if (fit > sizes[d]) fit = sizes[d];
  if (fit <= 0) return;  // uniform across the block
  const uint32_t* in = src + src_off[d];
  uint32_t* out = reinterpret_cast<uint32_t*>(dst_ptr[d]) + off;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long wrote = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < fit; i += step) {
    out[i] = in[i];
    ++wrote;
  }
  // one atomicAdd per block: warp sums, then the first warp sums the warps
  __shared__ long long warp_sum[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) wrote += __shfl_down_sync(~0u, wrote, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = wrote;
  __syncthreads();
  if (threadIdx.x < 32) {
    wrote = threadIdx.x < kThreads / 32 ? warp_sum[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) wrote += __shfl_down_sync(~0u, wrote, o);
    if (threadIdx.x == 0 && wrote > 0) {
      atomicAdd(&arrived[d], static_cast<unsigned long long>(wrote));
    }
  }
}

}  // namespace

// src: the sender's u32 plane.  src_off, sizes, dst_ptr, dst_off, arrived:
// device arrays of n_dest int64 (dst_ptr holds each receiver's buffer base
// address).  max_seg bounds every segment's stored length (the sender's plane
// length or the capacity, whichever is smaller) and sizes the grid.
extern "C" int rdst_remote_exchange(const void* src, const void* src_off,
                                    const void* sizes, const void* dst_ptr,
                                    const void* dst_off, int n_dest,
                                    long long max_seg, long long capacity,
                                    void* arrived, void* stream) {
  if (n_dest < 1 || n_dest > 65535 || max_seg < 0 || capacity < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (max_seg == 0) return static_cast<int>(cudaGetLastError());
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (max_seg + kThreads - 1) / kThreads;
  long long cap = (static_cast<long long>(sms) * kBlocksPerSm + n_dest - 1) /
                  n_dest;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(n_dest));
  exchange_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const long long*>(src_off),
      static_cast<const long long*>(sizes),
      static_cast<const long long*>(dst_ptr),
      static_cast<const long long*>(dst_off), capacity,
      static_cast<unsigned long long*>(arrived));
  return static_cast<int>(cudaGetLastError());
}
