// rdst_tpu_torch native host runtime.
//
// A copy of rdst_tpu/native/rdst_host.cpp: only this header differs, so
// `diff` shows that the two have not drifted. rdst_tpu_torch/native/host.py
// builds it with g++ into build/rdst_tpu_torch_host/ and binds it through
// ctypes. Two services:
//
//   1. host_radix_sort_u32 / u64[_pairs]: multi-threaded stable LSD radix
//      sort of host-resident data, the builder's path for small numpy
//      inputs (config.host_sort_max). Same algorithmic structure as the
//      reference's MtLsb (per-tile histograms, bucket-major/tile-minor
//      offsets, private scatter ranges, no atomics —
//      mt_lsb_sort.rs:40-133).
//
//   2. histogram_u32: multi-threaded byte-plane histograms for host data
//      (get_counts equivalent, sort_utils.rs:109-180).
//
// Exposed with C linkage for ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kRadix = 256;

int hw_threads() {
  unsigned t = std::thread::hardware_concurrency();
  return t == 0 ? 4 : static_cast<int>(t);
}

template <typename F>
void parallel_for_tiles(int n_tiles, F&& fn) {
  int nt = std::min(hw_threads(), n_tiles);
  std::vector<std::thread> ts;
  ts.reserve(nt);
  std::atomic<int> next(0);
  for (int w = 0; w < nt; ++w) {
    ts.emplace_back([&]() {
      int t;
      while ((t = next.fetch_add(1)) < n_tiles) fn(t);
    });
  }
  for (auto& th : ts) th.join();
}

// One stable counting-sort pass over `level`-th byte, tiled.
// src/dst are n elements of W-byte keys + optional u32 payload arrays.
template <typename K>
void lsd_pass(const K* src, K* dst, const uint32_t* src_pay,
              uint32_t* dst_pay, int64_t n, int shift) {
  const int64_t kMinTile = 1 << 16;
  int n_tiles = std::max<int64_t>(
      1, std::min<int64_t>(hw_threads() * 4, n / kMinTile));
  int64_t tile = (n + n_tiles - 1) / n_tiles;

  // per-tile histograms (sort_utils.rs:193-244 get_tile_counts)
  std::vector<std::vector<int64_t>> hist(n_tiles,
                                         std::vector<int64_t>(kRadix, 0));
  parallel_for_tiles(n_tiles, [&](int t) {
    int64_t lo = t * tile, hi = std::min<int64_t>(n, lo + tile);
    auto& h = hist[t];
    for (int64_t i = lo; i < hi; ++i) ++h[(src[i] >> shift) & 0xFF];
  });

  // bucket-major tile-minor offsets (mt_lsb_sort.rs:51-63)
  std::vector<std::vector<int64_t>> off(n_tiles,
                                        std::vector<int64_t>(kRadix, 0));
  int64_t run = 0;
  for (int d = 0; d < kRadix; ++d)
    for (int t = 0; t < n_tiles; ++t) {
      off[t][d] = run;
      run += hist[t][d];
    }

  // private-range scatter, embarrassingly parallel (mt_lsb_sort.rs:65-132)
  parallel_for_tiles(n_tiles, [&](int t) {
    int64_t lo = t * tile, hi = std::min<int64_t>(n, lo + tile);
    auto o = off[t];  // copy: per-tile cursors
    for (int64_t i = lo; i < hi; ++i) {
      int64_t p = o[(src[i] >> shift) & 0xFF]++;
      dst[p] = src[i];
      if (src_pay) dst_pay[p] = src_pay[i];
    }
  });
}

template <typename K>
void host_radix_sort(K* data, uint32_t* payload, int64_t n) {
  if (n <= 1) return;
  std::vector<K> tmp(n);
  std::vector<uint32_t> tmp_pay(payload ? n : 0);
  K* a = data;
  K* b = tmp.data();
  uint32_t* pa = payload;
  uint32_t* pb = payload ? tmp_pay.data() : nullptr;
  const int levels = static_cast<int>(sizeof(K));
  for (int l = 0; l < levels; ++l) {
    // level skipping: nondecreasing digit plane => identity pass
    // (lsb_sort.rs:62-83)
    int shift = l * 8;
    bool sorted = true;
    for (int64_t i = 1; i < n && sorted; ++i)
      sorted = ((a[i] >> shift) & 0xFF) >= ((a[i - 1] >> shift) & 0xFF);
    if (sorted) continue;
    lsd_pass<K>(a, b, pa, pb, n, shift);
    std::swap(a, b);
    std::swap(pa, pb);
  }
  if (a != data) {
    std::memcpy(data, a, n * sizeof(K));
    if (payload) std::memcpy(payload, pa, n * sizeof(uint32_t));
  }
}

}  // namespace

extern "C" {

void host_radix_sort_u32(uint32_t* data, int64_t n) {
  host_radix_sort<uint32_t>(data, nullptr, n);
}

void host_radix_sort_u64(uint64_t* data, int64_t n) {
  host_radix_sort<uint64_t>(data, nullptr, n);
}

void host_radix_sort_u32_pairs(uint32_t* keys, uint32_t* payload, int64_t n) {
  host_radix_sort<uint32_t>(keys, payload, n);
}

void host_radix_sort_u64_pairs(uint64_t* keys, uint32_t* payload, int64_t n) {
  host_radix_sort<uint64_t>(keys, payload, n);
}

void histogram_u32(const uint32_t* data, int64_t n, int level,
                   int64_t* out256) {
  int shift = level * 8;
  std::vector<int64_t> h(kRadix, 0);
  for (int64_t i = 0; i < n; ++i) ++h[(data[i] >> shift) & 0xFF];
  std::memcpy(out256, h.data(), kRadix * sizeof(int64_t));
}

}  // extern "C"
