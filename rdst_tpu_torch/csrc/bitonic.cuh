// Device helpers of the compare-exchange kernels.
//
// Planes, make_planes, load_plane, store_plane and ones_of serve B2, B3 and
// B5 (bitonic.cu: the Pallas _tail_call and _span_call, rdst_tpu/ops/
// pallas_sort.py:267 and :327, and _pallas_tail, pallas_merge.py:232, which
// runs as B2's kernel on a plan with no direction) and B4 (merge.cu: the
// Pallas _pallas_stage, pallas_merge.py:208).
//
//   - planes are u8, u16 or u32 in device memory and widen to u32 in
//     registers; they narrow again on store (exact: every value is back in
//     its own domain once a kernel is done);
//   - compares are strict lexicographic over the first n_keys planes, so ties
//     never swap and all planes move together.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 8;

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
