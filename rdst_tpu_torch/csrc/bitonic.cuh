// Device helpers of the compare-exchange kernels.
//
// Planes, make_planes, load_plane, store_plane and ones_of serve B2 and B3
// (bitonic.cu: the Pallas _tail_call and _span_call, rdst_tpu/ops/
// pallas_sort.py:267 and :327) and B5 (merge.cu: the Pallas _pallas_tail,
// pallas_merge.py:232).  lex_gt, stage, load_block and store_block are B5's
// shared-memory stage loop: one pass over a block held in shared memory per
// stride, a barrier after each.  B5 is bound by that loop (shared memory and
// barriers), not by its one read and one write of every plane; B2 and B3 left
// it for tiles held in registers (bitonic.cu says how).
//
//   - planes are u8, u16 or u32 in device memory and widen to u32 in registers
//     and shared memory; they narrow again on store (exact: every value is
//     back in its own domain once a kernel is done);
//   - compares are strict lexicographic over the first n_keys planes, so ties
//     never swap and all planes move together.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kThreads = 512;

struct Planes {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  int width[kMaxPlanes];  // bytes: 1, 2 or 4
  int n_planes;
  int n_keys;
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

__host__ __device__ __forceinline__ uint32_t ones_of(int width) {
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
// shared elements: pair t is (lo, lo + s), lo = 2s * (t / s) + t % s.  A pair
// where desc_of(lo) holds swaps when hi > lo (a descending run).
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

// Loads one aligned block of every plane into shared memory (widened).
__device__ __forceinline__ void load_block(uint32_t* sm, const Planes& P,
                                           long long g0, int block) {
  for (int p = 0; p < P.n_planes; ++p) {
    for (int e = threadIdx.x; e < block; e += blockDim.x) {
      sm[p * block + e] = load_plane(P.in[p], P.width[p], g0 + e);
    }
  }
}

__device__ __forceinline__ void store_block(const uint32_t* sm,
                                            const Planes& P, long long g0,
                                            int block) {
  for (int p = 0; p < P.n_planes; ++p) {
    for (int e = threadIdx.x; e < block; e += blockDim.x) {
      store_plane(P.out[p], P.width[p], g0 + e, sm[p * block + e]);
    }
  }
}

inline bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// Fills P from the caller's arrays; false when they are out of range.
inline bool make_planes(Planes* P, void* const* ins, void* const* outs,
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
