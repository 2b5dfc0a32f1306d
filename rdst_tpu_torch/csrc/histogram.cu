// Kernel B1: multi-level byte histograms with sortedness detection.
//
// Replaces the Pallas kernel rdst_tpu/ops/histogram.py _hist_kernel, launched
// by _multi_level_device (histogram.py:180) and by level_histogram with one
// level (histogram.py:258), together with the XLA epilogue that sums its
// tiles, removes the pads and merges tile boundaries (histogram.py:200-224).
//
// One pass over n keys held as n_words uint32 planes (most significant
// first) yields, for byte levels level0 .. level0 + n_levels - 1:
//   counts[l][d]  keys whose digit at that level is d
//   sorted[l]     1 iff that level's digits are nondecreasing in array order
//   prefix        length of the longest lexicographically nondecreasing
//                 prefix of the full key (n when sorted)
// packed into one int64 buffer [counts | sorted | prefix], so the planning
// step costs one device-to-host copy.
//
// Bound: bytes read, n * n_words * 4.  The design keeps it at one read of
// each word:
//   - blocks walk the array grid-stride with consecutive threads on
//     consecutive keys; a thread's predecessor arrives from the neighbouring
//     lane by warp shuffle, and only lane 0 reads its predecessor again;
//   - each block counts into shared-memory histograms [L][256] and flushes
//     them once with 64-bit atomics, so counts stay exact above 2^32;
//   - a digit below its predecessor's clears that level's flag, so no tile
//     boundaries need merging; the first strict lexicographic descent goes
//     through atomicMin;
//   - the ragged edge is masked here: no pad copy and no pad correction.
// Known weakness: a hot bin (all-equal or skewed keys) serialises a warp's
// 32 shared atomics.  Warp-aggregated counting is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadix = 256;
constexpr int kMaxWords = 8;
constexpr int kMaxLevels = 32;
constexpr int kThreads = 512;

struct Words {
  const uint32_t* w[kMaxWords];
};

__global__ void hist_init(unsigned long long* out, int n_levels, long long n) {
  const int nc = n_levels * kRadix;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i <= nc + n_levels;
       i += gridDim.x * blockDim.x) {
    out[i] = i < nc ? 0ull
                    : (i < nc + n_levels ? 1ull
                                         : static_cast<unsigned long long>(n));
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
hist_kernel(Words words, int level0, int n_levels, long long n,
            unsigned long long* out) {
  __shared__ unsigned int hist[kMaxLevels * kRadix];
  __shared__ unsigned int desc_bits;
  __shared__ unsigned long long first_desc;
  for (int j = threadIdx.x; j < n_levels * kRadix; j += blockDim.x) {
    hist[j] = 0u;
  }
  if (threadIdx.x == 0) {
    desc_bits = 0u;
    first_desc = static_cast<unsigned long long>(n);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  unsigned int my_desc = 0u;
  long long my_first = n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // base is uniform across the block, so every lane runs every iteration
  // and reaches each shuffle.
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    uint32_t cur[NW], prev[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      cur[k] = valid ? words.w[k][i] : 0u;
      const uint32_t up = __shfl_up_sync(0xffffffffu, cur[k], 1);
      prev[k] = (lane == 0) ? ((valid && i > 0) ? words.w[k][i - 1] : 0u) : up;
    }
    if (!valid) continue;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= n_levels) break;
      const int lv = level0 + l;
      const int widx = NW - 1 - (lv >> 2);
      const unsigned int shift = (lv & 3) * 8;
      uint32_t wc = 0u, wp = 0u;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (k == widx) {
          wc = cur[k];
          wp = prev[k];
        }
      }
      const unsigned int d = (wc >> shift) & 0xFFu;
      atomicAdd(&hist[l * kRadix + d], 1u);
      if (i > 0 && ((wp >> shift) & 0xFFu) > d) my_desc |= 1u << l;
    }
    if (i > 0 && i < my_first) {
      bool gt = false;
      bool decided = false;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (!decided && prev[k] != cur[k]) {
          gt = prev[k] > cur[k];
          decided = true;
        }
      }
      if (gt) my_first = i;  // keys [0, i) are nondecreasing
    }
  }

  if (my_desc) atomicOr(&desc_bits, my_desc);
  if (my_first < n) {
    atomicMin(&first_desc, static_cast<unsigned long long>(my_first));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_levels * kRadix; j += blockDim.x) {
    const unsigned int c = hist[j];
    if (c) atomicAdd(&out[j], static_cast<unsigned long long>(c));
  }
  if (threadIdx.x == 0) {
    const unsigned int bits = desc_bits;
    for (int l = 0; l < n_levels; ++l) {
      if (bits & (1u << l)) out[n_levels * kRadix + l] = 0ull;
    }
    if (first_desc < static_cast<unsigned long long>(n)) {
      atomicMin(&out[n_levels * kRadix + n_levels], first_desc);
    }
  }
}

}  // namespace

// words: n_words device pointers to uint32 planes of length n.
// out: int64 buffer of n_levels * 256 + n_levels + 1 elements.
extern "C" int rdst_histogram(void* const* words, int n_words, int level0,
                              int n_levels, long long n, void* out, int grid,
                              void* stream) {
  if (n_words < 1 || n_words > kMaxWords || n_levels < 1 ||
      n_levels > kMaxLevels || level0 < 0 ||
      level0 + n_levels > 4 * n_words || n < 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Words w{};
  for (int k = 0; k < n_words; ++k) {
    w.w[k] = static_cast<const uint32_t*>(words[k]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const int total = n_levels * kRadix + n_levels + 1;
  hist_init<<<(total + 255) / 256, 256, 0, s>>>(o, n_levels, n);
  switch (n_words) {
    case 1:
      hist_kernel<1><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
      break;
    case 2:
      hist_kernel<2><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
      break;
    case 3:
      hist_kernel<3><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
      break;
    case 4:
      hist_kernel<4><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
      break;
    case 5:
      hist_kernel<5><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
      break;
    case 6:
      hist_kernel<6><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
      break;
    case 7:
      hist_kernel<7><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
      break;
    default:
      hist_kernel<8><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
