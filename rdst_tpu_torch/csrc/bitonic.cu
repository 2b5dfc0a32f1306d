// Kernels B2 (tail) and B3 (span): the compare-exchange kernels of the
// fused bitonic sort, rdst_tpu_torch/ops/fused_sort.py.
//
// B2, tail_kernel, replaces the Pallas _tail_kernel (rdst_tpu/ops/
// pallas_sort.py:211, launched by _tail_call at :267).  One CTA holds one
// aligned block of `block` elements of every plane in shared memory and runs
// one or more merge levels there: for each (log_2r, start) level, ascending
// compare-exchange stages at strides start, start/2, ..., 1, where a pair in
// an odd run of length 2^log_2r (a descending run) swaps the other way.  On
// load it can un-flip the keys of odd phase-0 rows (XOR with the plane's own
// all-ones where bit `unflip_shift` of the global index is set).
//
// B3, span_kernel, replaces the Pallas _span_kernel (pallas_sort.py:286,
// launched by _span_call at :327).  One CTA gathers the P = 2*s_hi/s_lo
// strided pieces of w = block/P contiguous elements that one cell of the
// flat array viewed as (n/(2*s_hi), P, s_lo/w, w) covers, and retires the
// log2(P) stages at element strides s_hi .. s_lo (piece distances P/2 .. 1)
// in one trip through memory.  Direction is one per cell: (a >> log_ratio) & 1.
//
// Shared by both:
//   - planes are u8, u16 or u32 in device memory and widen to u32 in shared
//     memory; they narrow again on store (exact: every value is back in its
//     own domain once the un-flip is done);
//   - compares are strict lexicographic over the first n_keys planes, so ties
//     never swap and all planes move together; a descending pair swaps when
//     hi > lo, which is bit for bit the Pallas kernels' complement-around-an-
//     ascending-stage (gt over complements is lt, ties included);
//   - one thread per compare pair, __syncthreads() between stages.
// Bound: each trip reads and writes every plane once (n * bytes per element
// * 2); the stages in between run on shared memory.  The block is sized in
// rdst_tpu_torch/config.py (bitonic_smem_bytes) so that two CTAs fit an SM;
// span pieces stay at least 128 elements (one warp's worth of 16-byte loads
// of u32) so the gathered loads coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kMaxLevels = 32;
constexpr int kThreads = 512;

struct Planes {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  int width[kMaxPlanes];  // bytes: 1, 2 or 4
  int n_planes;
  int n_keys;
};

struct Levels {
  int log_2r[kMaxLevels];
  int start[kMaxLevels];
  int count;
};

__device__ __forceinline__ uint32_t load_plane(const void* p, int width,
                                               long long i) {
  if (width == 4) return static_cast<const uint32_t*>(p)[i];
  if (width == 2) return static_cast<const uint16_t*>(p)[i];
  return static_cast<const uint8_t*>(p)[i];
}

__device__ __forceinline__ void store_plane(void* p, int width, long long i,
                                            uint32_t v) {
  if (width == 4) {
    static_cast<uint32_t*>(p)[i] = v;
  } else if (width == 2) {
    static_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(v);
  } else {
    static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(v);
  }
}

__device__ __forceinline__ uint32_t ones_of(int width) {
  return width >= 4 ? 0xFFFFFFFFu : ((1u << (8 * width)) - 1u);
}

// sm holds n_planes rows of len u32: element e of plane p is sm[p * len + e].
__device__ __forceinline__ bool lex_gt(const uint32_t* sm, int len, int n_keys,
                                       int a, int b) {
  for (int k = 0; k < n_keys; ++k) {
    const uint32_t x = sm[k * len + a];
    const uint32_t y = sm[k * len + b];
    if (x != y) return x > y;
  }
  return false;
}

// One compare-exchange stage at distance s (a power of two) over the len
// shared elements: pair t is (lo, lo + s), lo = 2s * (t / s) + t % s.
template <typename DescOf>
__device__ __forceinline__ void stage(uint32_t* sm, int len, const Planes& P,
                                      int s, DescOf desc_of) {
  for (int t = threadIdx.x; t < len / 2; t += blockDim.x) {
    const int lo = ((t & ~(s - 1)) << 1) | (t & (s - 1));
    const int hi = lo + s;
    const bool swap = desc_of(lo) ? lex_gt(sm, len, P.n_keys, hi, lo)
                                  : lex_gt(sm, len, P.n_keys, lo, hi);
    if (swap) {
      for (int p = 0; p < P.n_planes; ++p) {
        const uint32_t a = sm[p * len + lo];
        sm[p * len + lo] = sm[p * len + hi];
        sm[p * len + hi] = a;
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
tail_kernel(Planes P, Levels L, int block, int unflip_shift) {
  extern __shared__ uint32_t sm[];
  const long long g0 = static_cast<long long>(blockIdx.x) * block;
  for (int p = 0; p < P.n_planes; ++p) {
    const uint32_t flip =
        (p < P.n_keys && unflip_shift >= 0) ? ones_of(P.width[p]) : 0u;
    for (int e = threadIdx.x; e < block; e += blockDim.x) {
      uint32_t v = load_plane(P.in[p], P.width[p], g0 + e);
      if (flip && (((g0 + e) >> unflip_shift) & 1)) v ^= flip;
      sm[p * block + e] = v;
    }
  }
  __syncthreads();
  for (int li = 0; li < L.count; ++li) {
    const int log_2r = L.log_2r[li];
    auto desc_of = [&](int e) { return (((g0 + e) >> log_2r) & 1) != 0; };
    for (int s = L.start[li]; s >= 1; s >>= 1) stage(sm, block, P, s, desc_of);
  }
  for (int p = 0; p < P.n_planes; ++p) {
    for (int e = threadIdx.x; e < block; e += blockDim.x) {
      store_plane(P.out[p], P.width[p], g0 + e, sm[p * block + e]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
span_kernel(Planes P, int p_dim, int w, long long s_lo, long long span,
            int w_cells, int log_ratio) {
  extern __shared__ uint32_t sm[];
  const long long a = blockIdx.x / w_cells;
  const long long b = blockIdx.x - a * w_cells;
  const long long base = a * span + b * w;
  const int len = p_dim * w;
  for (int p = 0; p < P.n_planes; ++p) {
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const long long g = base + (e / w) * s_lo + (e % w);
      sm[p * len + e] = load_plane(P.in[p], P.width[p], g);
    }
  }
  __syncthreads();
  const bool desc = ((a >> log_ratio) & 1) != 0;
  auto desc_of = [desc](int) { return desc; };
  for (int k = (p_dim / 2) * w; k >= w; k >>= 1) stage(sm, len, P, k, desc_of);
  for (int p = 0; p < P.n_planes; ++p) {
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const long long g = base + (e / w) * s_lo + (e % w);
      store_plane(P.out[p], P.width[p], g, sm[p * len + e]);
    }
  }
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// Fills P from the caller's arrays; false when they are out of range.
bool make_planes(Planes* P, void* const* ins, void* const* outs,
                 const int* widths, int n_planes, int n_keys) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n_keys < 1 ||
      n_keys > n_planes) {
    return false;
  }
  *P = Planes{};
  for (int p = 0; p < n_planes; ++p) {
    if (widths[p] != 1 && widths[p] != 2 && widths[p] != 4) return false;
    P->in[p] = ins[p];
    P->out[p] = outs[p];
    P->width[p] = widths[p];
  }
  P->n_planes = n_planes;
  P->n_keys = n_keys;
  return true;
}

}  // namespace

// ins/outs: n_planes device pointers (planes of length n, widths in bytes),
// keys first.  levels: n_levels pairs (log_2r[i], starts[i]).
// unflip_shift < 0 means no un-flip.
extern "C" int rdst_bitonic_tail(void* const* ins, void* const* outs,
                                 const int* widths, int n_planes, int n_keys,
                                 long long n, int block, const int* log_2r,
                                 const int* starts, int n_levels,
                                 int unflip_shift, void* stream) {
  Planes P;
  if (!make_planes(&P, ins, outs, widths, n_planes, n_keys) || !pow2(block) ||
      block < 2 || n % block != 0 || n_levels < 0 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels L{};
  for (int i = 0; i < n_levels; ++i) {
    if (!pow2(starts[i]) || starts[i] > block / 2 || log_2r[i] < 1 ||
        log_2r[i] > 62) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.log_2r[i] = log_2r[i];
    L.start[i] = starts[i];
  }
  L.count = n_levels;
  const size_t smem = static_cast<size_t>(block) * n_planes * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block / 2 < kThreads ? block / 2 : kThreads;
  if (n > 0) {
    tail_kernel<<<static_cast<unsigned int>(n / block), threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(P, L, block,
                                                       unflip_shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// The flat planes viewed as (n / (2 * s_hi), P, s_lo / w, w) with
// P = 2 * s_hi / s_lo and w = block / P; one CTA per (a, b) cell.
extern "C" int rdst_bitonic_span(void* const* ins, void* const* outs,
                                 const int* widths, int n_planes, int n_keys,
                                 long long n, long long s_hi, long long s_lo,
                                 int block, int log_ratio, void* stream) {
  Planes P;
  if (!make_planes(&P, ins, outs, widths, n_planes, n_keys) || !pow2(block) ||
      !pow2(s_hi) || !pow2(s_lo) || s_lo > s_hi || n % (2 * s_hi) != 0 ||
      log_ratio < 0 || log_ratio > 62) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long p_dim = 2 * s_hi / s_lo;
  if (p_dim > block || block / p_dim > s_lo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int w = static_cast<int>(block / p_dim);
  const int w_cells = static_cast<int>(s_lo / w);
  const long long cells = (n / (2 * s_hi)) * w_cells;
  const size_t smem = static_cast<size_t>(block) * n_planes * 4;
  cudaError_t err = cudaFuncSetAttribute(
      span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block / 2 < kThreads ? block / 2 : kThreads;
  if (cells > 0) {
    span_kernel<<<static_cast<unsigned int>(cells), threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        P, static_cast<int>(p_dim), w, s_lo, 2 * s_hi, w_cells, log_ratio);
  }
  return static_cast<int>(cudaGetLastError());
}
