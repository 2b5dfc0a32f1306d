// Kernel B4 (merge stage): the stride kernel of the fused bitonic merge,
// rdst_tpu_torch/ops/fused_merge.py.
//
// It runs the merge phase of a bitonic network, whose direction is uniform:
// every pair swaps when keys[lo] > keys[hi], strictly and lexicographically
// over the first n_keys planes, and every plane follows.  Planes are u8, u16
// or u32 and widen to u32 in registers (bitonic.cuh).
//
// B4, merge_stage_kernel, replaces the Pallas _stage_kernel (rdst_tpu/ops/
// pallas_merge.py:148, launched by _pallas_stage at :208): one stride s over
// the whole sequence; pair i in [0, n/2) is (lo, lo + s) with
// lo = (i / s) * 2s + i % s.  The TPU version tiles partner chunks through
// VMEM with BlockSpecs (CHUNK elements); here s >= 128 on the merge path, so
// both partners of a warp's 32 pairs are contiguous runs and a grid-stride
// loop of one pair per thread reads and writes coalesced with no shared
// memory.  Each thread loads every plane of both partners before it
// compares, so up to 16 loads are in flight per thread.  Bound: one read and
// one write of every plane per stride (bandwidth); in place (ins == outs) a
// pair that does not swap is not written back.  Each pair belongs to one
// thread, so the kernel may run in place.
//
// B5, the strides below the block (the Pallas _tail_kernel, pallas_merge.py:
// 166, launched by _pallas_tail at :232), is no kernel of its own: it is B2's
// rdst_bitonic_tail (bitonic.cu) on a plan of one level with no direction,
// its tile held in registers.
#include "bitonic.cuh"

namespace {

constexpr int kStageThreads = 256;
constexpr int kStageBlocksPerSm = 8;

__global__ void __launch_bounds__(kStageThreads)
merge_stage_kernel(Planes P, long long half, long long s, bool in_place) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < half; i += step) {
    const long long lo = ((i & ~(s - 1)) << 1) | (i & (s - 1));
    const long long hi = lo + s;
    uint32_t a[kMaxPlanes];
    uint32_t b[kMaxPlanes];
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) {
      if (p < P.n_planes) {
        a[p] = load_plane(P.in[p], P.width[p], lo);
        b[p] = load_plane(P.in[p], P.width[p], hi);
      }
    }
    bool swap = false;
    bool decided = false;
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k) {
      if (k < P.n_keys && !decided && a[k] != b[k]) {
        swap = a[k] > b[k];
        decided = true;
      }
    }
    if (swap || !in_place) {
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) {
        if (p < P.n_planes) {
          store_plane(P.out[p], P.width[p], lo, swap ? b[p] : a[p]);
          store_plane(P.out[p], P.width[p], hi, swap ? a[p] : b[p]);
        }
      }
    }
  }
}

}  // namespace

// ins/outs: n_planes device pointers (planes of length n, widths in bytes),
// keys first; ins[p] == outs[p] for every plane runs in place.
extern "C" int rdst_merge_stage(void* const* ins, void* const* outs,
                                const int* widths, int n_planes, int n_keys,
                                long long n, long long s, void* stream) {
  Planes P;
  if (!make_planes(&P, ins, outs, widths, n_planes, n_keys) || !pow2(n) ||
      n < 2 || !pow2(s) || 2 * s > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool in_place = true;
  for (int p = 0; p < n_planes; ++p) in_place &= ins[p] == outs[p];
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long half = n / 2;
  long long blocks = (half + kStageThreads - 1) / kStageThreads;
  const long long cap = static_cast<long long>(sms) * kStageBlocksPerSm;
  if (blocks > cap) blocks = cap;
  merge_stage_kernel<<<static_cast<unsigned int>(blocks), kStageThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(P, half, s,
                                                            in_place);
  return static_cast<int>(cudaGetLastError());
}
