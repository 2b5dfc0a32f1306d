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
//   prefix        the first i with key(i-1) > key(i) in lexicographic order,
//                 or n when there is none
// packed into one int64 buffer [counts | sorted | prefix], so the planning
// step costs one device-to-host copy.
//
// Bound: bytes read, n * n_words * 4.  Beside the reads the card spends one
// shared-memory increment per key and level and a few instructions to find
// its address; everything else is kept off the per-key path.  The design:
//   - each thread takes 4 consecutive keys of every plane with one 16-byte
//     load (a warp: 128 keys); the head up to plane 0's 16-byte boundary and
//     the ragged tail (at most 6 keys) go through scalar loads in block 0,
//     and a plane whose alignment differs from plane 0's loads its 4 words
//     one by one.  A thread's first predecessor arrives from the previous
//     lane by warp shuffle; lane 0 reads it once per chunk;
//   - the levels counted are fixed at compile time for the full key (level0
//     0, all 4 * n_words levels) and for one level of one word; a general
//     instance per word count serves any other (level0, n_levels);
//   - a SIMD byte compare of neighbouring words (gt_msb) gives the descents
//     of four levels at once, so a level's flag is one OR per word, and is
//     no longer computed once every level of the word has descended; the
//     first lexicographic descent is looked for only until a thread has
//     found one;
//   - counting: one red.shared.add of 1 per key and level; the hardware
//     merges the lanes that hit one address, so keys that share a digit
//     (a constant byte, presorted high bytes) cost no more than others.
//     The histograms are kParts copies [level][digit][part], part = lane %
//     kParts, as many as the shared budget holds (16 at 8 levels): lanes of
//     different parts never touch one word, and at most 32 / kParts lanes
//     share a bank;
//   - one block an SM (1024 threads for keys of 1-4 words), so the flush is
//     one add per bin and SM: each block adds its nonzero bins to a
//     workspace with 64-bit atomics, and the last block to arrive (a counter
//     behind __threadfence) moves the workspace into the output and leaves
//     it zero for the next launch on the stream.  One launch; integer sums,
//     so the output does not depend on the order in which blocks finish.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadix = 256;
constexpr int kMaxWords = 8;
constexpr int kMaxLevels = 32;
constexpr int kMaxDevices = 64;
// Keys of 1-4 words take blocks of kBlockThreads threads (64 registers a
// thread) whose histograms may fill kSmemBudget bytes of shared memory: one
// block an SM.  Wider keys take half of each (128 registers).
constexpr int kBlockThreads = 1024;
constexpr int kSmemBudget = 128 * 1024;
constexpr int kGroupUnroll = 2;  // 4-key groups a thread loads at once (1-2 words)
constexpr unsigned kAll32 = 0xffffffffu;
constexpr unsigned kMsb = 0x80808080u;

// kAll: level0 = 0 and every level of the key; kOne: one level of one
// word; kSome: any other (level0, n_levels).
enum Mode { kAll = 0, kOne = 1, kSome = 2 };

struct Words {
  const uint32_t* w[kMaxWords];
};

// Lives across launches, zero between them (the host zeroes it once).
struct Work {
  unsigned long long counts[kMaxLevels * kRadix];
  unsigned long long first_inv;  // ~(first descent), 0 for none: atomicMax
  unsigned int desc;             // bit l: level l has a descent
  unsigned int arrived;          // blocks done
};

constexpr int floor_log2(int x) { return x <= 1 ? 0 : 1 + floor_log2(x / 2); }

template <int NW, int MODE>
struct Cfg {
  static constexpr int kThreads = NW <= 4 ? kBlockThreads : kBlockThreads / 2;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSmem = NW <= 4 ? kSmemBudget : kSmemBudget / 2;
  static constexpr int kRows = MODE == kOne ? 1 : 4 * NW;  // at most
  static constexpr int kFit = kSmem / (kRows * kRadix * 4);
  static constexpr int kLogParts = floor_log2(kFit < 1 ? 1 : (kFit > 32 ? 32 : kFit));
  static constexpr int kParts = 1 << kLogParts;
  static constexpr int kUnroll = NW <= 2 ? kGroupUnroll : 1;
};

__device__ __forceinline__ uint4 load4(const uint32_t* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ uint32_t key_at(const uint4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// Byte b of w, zero-extended (sh = 8 * b).
__device__ __forceinline__ uint32_t digit(uint32_t w, int sh) {
  return __byte_perm(w, 0u, 0x4440u | static_cast<unsigned>(sh >> 3));
}

// Bit 7 of each byte: that byte of a > that byte of b (unsigned): the carry
// out of a + ~b, the majority of a's and ~b's top bits and the carry of
// their low seven bits.
__device__ __forceinline__ uint32_t gt_msb(uint32_t a, uint32_t b) {
  const uint32_t s = (a & 0x7F7F7F7Fu) + (~b & 0x7F7F7F7Fu);
  return ((a & ~b) | ((a ^ ~b) & s)) & kMsb;
}

// Keys a (the predecessor) and b of NW words: a > b lexicographically,
// compared two words at a time.
template <int NW>
__device__ __forceinline__ bool lex_gt(const uint32_t (&a)[NW],
                                       const uint32_t (&b)[NW]) {
  bool gt = false, eq = true;
#pragma unroll
  for (int k = 0; k < NW; k += 2) {
    const uint64_t x = k + 1 < NW ? (uint64_t{a[k]} << 32 | a[k + 1]) : a[k];
    const uint64_t y = k + 1 < NW ? (uint64_t{b[k]} << 32 | b[k + 1]) : b[k];
    gt = gt || (eq && x > y);
    eq = eq && x == y;
  }
  return gt;
}

// Add 1 at shared byte address addr (the hardware adds the lanes that
// share an address at once); the _if form only where p holds.
__device__ __forceinline__ void red_inc(uint32_t addr) {
  asm volatile("red.shared.add.u32 [%0], 1;" :: "r"(addr) : "memory");
}

__device__ __forceinline__ void red_inc_if(uint32_t addr, bool p) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %1, 0;\n\t"
      "@q red.shared.add.u32 [%0], 1;\n\t}"
      :: "r"(addr), "r"(static_cast<uint32_t>(p)) : "memory");
}

template <int NW, int MODE>
__global__ void __launch_bounds__(Cfg<NW, MODE>::kThreads)
hist_kernel(Words words, unsigned vec_mask, long long head, long long groups,
            long long n, int level0, int n_levels, unsigned long long* out,
            Work* work) {
  using C = Cfg<NW, MODE>;
  constexpr int LP = C::kLogParts;
  constexpr int U = C::kUnroll;
  constexpr int kThreads = C::kThreads;
  constexpr int kWarps = C::kWarps;
  extern __shared__ uint4 smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  __shared__ unsigned s_desc;
  __shared__ unsigned long long s_first;
  __shared__ bool s_last;

  const int lo = MODE == kAll ? 0 : level0;
  const int rows = MODE == kAll ? 4 * NW : (MODE == kOne ? 1 : n_levels);
  const int one_sh = 8 * level0;  // kOne: the level's byte in the word
  const int lane = threadIdx.x & 31;
  const int part = lane & (C::kParts - 1);
  // shared byte address of this thread's part of bin 0 of row 0
  uint32_t hist_s = static_cast<uint32_t>(__cvta_generic_to_shared(hist)) + 4u * part;
  asm volatile("mov.u32 %0, %0;" : "+r"(hist_s));  // computed once, kept in a register

  for (int j = threadIdx.x; j < (rows * kRadix << LP) / 4; j += kThreads) {
    smem[j] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    s_desc = 0u;
    s_first = static_cast<unsigned long long>(n);
  }
  __syncthreads();

  // Level (word k, byte b) -> row of the histogram, or -1 when not counted;
  // folds to a constant for kAll and kOne.
  auto row_of = [&](int k, int b) -> int {
    if (MODE == kOne) return b == 0 ? 0 : -1;
    const int l = 4 * (NW - 1 - k) + b - lo;
    return (MODE == kSome && (l < 0 || l >= n_levels)) ? -1 : l;
  };
  auto shift_of = [&](int b) { return MODE == kOne ? one_sh : 8 * b; };
  // byte address of digit d's counter in row l, this thread's part
  auto bin = [&](int l, uint32_t d) {
    return hist_s + (static_cast<uint32_t>(l) << (10 + LP)) + (d << (2 + LP));
  };

  uint32_t desc[NW];  // bit 7 of byte b of word k: that level has a descent
#pragma unroll
  for (int k = 0; k < NW; ++k) desc[k] = 0u;
  long long first = n;

  // The head (keys before plane 0's first 16-byte boundary) and the tail
  // (keys after the last whole group): at most 6 keys, one per thread.
  const long long body_end = head + 4 * groups;
  if (blockIdx.x == 0 && threadIdx.x < head + (n - body_end)) {
    const long long i = threadIdx.x < head ? threadIdx.x
                                           : body_end + (threadIdx.x - head);
    uint32_t cur[NW], prev[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      cur[k] = __ldg(words.w[k] + i);
      prev[k] = i > 0 ? __ldg(words.w[k] + i - 1) : cur[k];
      desc[k] |= gt_msb(prev[k], cur[k]);
    }
    // straight into the block's minimum: a tail key comes after the body
    // keys this thread goes on to search
    if (lex_gt<NW>(prev, cur)) atomicMin(&s_first, static_cast<unsigned long long>(i));
#pragma unroll
    for (int k = 0; k < NW; ++k) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int l = row_of(k, b);
        if (l >= 0) red_inc(bin(l, digit(cur[k], shift_of(b))));
      }
    }
  }

  // The body: warp w takes chunks w, w + W, ... of 32 * U groups of 4 keys;
  // lane t of step u holds group chunk * 32 * U + u * 32 + t.  Every lane
  // runs every step (the bounds are uniform over the warp), so each reaches
  // every shuffle.
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long chunk = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       chunk * 32 * U < groups; chunk += n_warps) {
    const long long g0 = chunk * 32 * U;
    uint4 cur[U][NW];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long g = g0 + u * 32 + lane;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        cur[u][k] = g < groups ? load4(words.w[k] + head + 4 * g, (vec_mask >> k) & 1u)
                               : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // the key before the chunk, for lane 0 of step 0
    const long long i_first = head + 4 * g0;
    uint32_t carry[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      carry[k] = (lane == 0 && i_first > 0) ? __ldg(words.w[k] + i_first - 1) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long g = g0 + u * 32 + lane;
      const bool valid = g < groups;
      const long long i0 = head + 4 * g;
      const bool whole = __all_sync(kAll32, valid);
      uint32_t pred[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const uint32_t up = __shfl_sync(kAll32, cur[u][k].w, (lane + 31) & 31);
        pred[k] = lane ? up : (i0 > 0 ? carry[k] : cur[u][k].x);
        carry[k] = up;  // lane 0's predecessor at step u + 1
      }
      if (valid) {
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          if (desc[k] != kMsb) {
            const uint4& c = cur[u][k];
            desc[k] |= gt_msb(pred[k], c.x) | gt_msb(c.x, c.y) |
                       gt_msb(c.y, c.z) | gt_msb(c.z, c.w);
          }
        }
        if (first == n) {
          unsigned gts = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t a[NW], b[NW];
#pragma unroll
            for (int k = 0; k < NW; ++k) {
              a[k] = j ? key_at(cur[u][k], j - 1) : pred[k];
              b[k] = key_at(cur[u][k], j);
            }
            gts |= static_cast<unsigned>(lex_gt<NW>(a, b)) << j;
          }
          if (gts) first = i0 + (__ffs(gts) - 1);
        }
      }
      if (!whole) {  // the last chunk: each valid lane adds its keys
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const uint4& c = cur[u][k];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int l = row_of(k, b);
            if (l < 0) continue;
            const int sh = shift_of(b);
            red_inc_if(bin(l, digit(c.x, sh)), valid);
            red_inc_if(bin(l, digit(c.y, sh)), valid);
            red_inc_if(bin(l, digit(c.z, sh)), valid);
            red_inc_if(bin(l, digit(c.w, sh)), valid);
          }
        }
        continue;
      }
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const uint4& c = cur[u][k];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int l = row_of(k, b);
          if (l < 0) continue;
          const int sh = shift_of(b);
          red_inc(bin(l, digit(c.x, sh)));
          red_inc(bin(l, digit(c.y, sh)));
          red_inc(bin(l, digit(c.z, sh)));
          red_inc(bin(l, digit(c.w, sh)));
        }
      }
    }
  }

  // the block's flags and first descent
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int l = row_of(k, b);
      if (l >= 0 && ((desc[k] >> (shift_of(b) + 7)) & 1u)) bits |= 1u << l;
    }
  }
  bits = __reduce_or_sync(kAll32, bits);
  if (lane == 0 && bits) atomicOr(&s_desc, bits);
  if (first < n) atomicMin(&s_first, static_cast<unsigned long long>(first));
  __syncthreads();

  // Each sub-counter counted at most the block's keys, which the host
  // keeps below 2^31: sum the parts and add the nonzero bins.
  for (int j = threadIdx.x; j < rows * kRadix; j += kThreads) {
    unsigned s = 0u;
#pragma unroll
    for (int p = 0; p < C::kParts; ++p) s += hist[(j << LP) + p];
    if (s) atomicAdd(&work->counts[j], static_cast<unsigned long long>(s));
  }
  if (threadIdx.x == 0) {
    if (s_desc) atomicOr(&work->desc, s_desc);
    if (s_first < static_cast<unsigned long long>(n)) atomicMax(&work->first_inv, ~s_first);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&work->arrived, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: every other block's adds are visible; move the
  // workspace into the output and leave it zero
  __threadfence();
  for (int j = threadIdx.x; j < rows * kRadix; j += kThreads) {
    out[j] = atomicExch(&work->counts[j], 0ull);
  }
  if (threadIdx.x == 0) {
    const unsigned d = atomicExch(&work->desc, 0u);
    for (int l = 0; l < rows; ++l) out[rows * kRadix + l] = (d >> l) & 1u ? 0ull : 1ull;
    const unsigned long long fi = atomicExch(&work->first_inv, 0ull);
    out[rows * kRadix + rows] = fi ? ~fi : static_cast<unsigned long long>(n);
    atomicExch(&work->arrived, 0u);
  }
}

template <int NW, int MODE>
cudaError_t launch(const Words& w, unsigned vec_mask, long long head,
                   long long groups, long long n, int level0, int n_levels,
                   unsigned long long* out, Work* work, int sms,
                   cudaStream_t s) {
  using C = Cfg<NW, MODE>;
  constexpr int kThreads = C::kThreads;
  constexpr int kWarps = C::kWarps;
  const int rows = MODE == kAll ? 4 * NW : (MODE == kOne ? 1 : n_levels);
  const size_t smem = static_cast<size_t>(rows) * kRadix * C::kParts * sizeof(unsigned);
  auto kern = hist_kernel<NW, MODE>;
  // per device, found on the first launch: the shared-memory limit for the
  // widest row count, then the blocks an SM holds at each row count
  static bool ready[kMaxDevices];
  static int per_sm_of[kMaxDevices][kMaxLevels + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kRows * kRadix * C::kParts * 4);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  int& per_sm = per_sm_of[dev][rows];
  if (per_sm == 0) {
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern, kThreads, smem);
    if (err != cudaSuccess) return err;
    per_sm = fit > 0 ? fit : 1;
  }
  const long long chunks = (groups + 32LL * C::kUnroll - 1) / (32LL * C::kUnroll);
  long long grid = static_cast<long long>(sms) * per_sm;
  grid = grid < (chunks + kWarps - 1) / kWarps ? grid : (chunks + kWarps - 1) / kWarps;
  // a block counts fewer than 2^31 keys, so its 32-bit counters are exact
  const long long need = (n >> 31) + 1;
  grid = grid > need ? grid : need;
  kern<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      w, vec_mask, head, groups, n, level0, n_levels, out, work);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_nw(int n_words, const Words& w, unsigned vec_mask,
                      long long head, long long groups, long long n, int level0,
                      int n_levels, unsigned long long* out, Work* work,
                      int sms, cudaStream_t s) {
#define RDST_HIST_CASE(NW)                                                    \
  case NW:                                                                    \
    return launch<NW, MODE>(w, vec_mask, head, groups, n, level0, n_levels, \
                            out, work, sms, s);
  switch (n_words) {
    RDST_HIST_CASE(1)
    RDST_HIST_CASE(2)
    RDST_HIST_CASE(3)
    RDST_HIST_CASE(4)
    RDST_HIST_CASE(5)
    RDST_HIST_CASE(6)
    RDST_HIST_CASE(7)
    RDST_HIST_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RDST_HIST_CASE
}

}  // namespace

// words: n_words device pointers to uint32 planes of length n, any 4-byte
// alignment.  out: int64 buffer of n_levels * 256 + n_levels + 1 elements.
// work: the stream's workspace (sizeof(Work) bytes, zero before the first
// launch; every launch leaves it zero).  sms: the card's SM count.
extern "C" int rdst_histogram(void* const* words, int n_words, int level0,
                              int n_levels, long long n, void* out, void* work,
                              int sms, void* stream) {
  if (n_words < 1 || n_words > kMaxWords || n_levels < 1 ||
      n_levels > kMaxLevels || level0 < 0 ||
      level0 + n_levels > 4 * n_words || n < 0 || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Words w{};
  for (int k = 0; k < n_words; ++k) {
    w.w[k] = static_cast<const uint32_t*>(words[k]);
  }
  // head: keys before plane 0's first 16-byte boundary; a plane that is
  // 16-byte aligned at the same key gets vector loads
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(w.w[0]);
  long long head = static_cast<long long>(((16 - (a0 & 15)) & 15) / 4);
  head = head < n ? head : n;
  const long long groups = (n - head) / 4;
  unsigned vec_mask = 0u;
  for (int k = 0; k < n_words; ++k) {
    if (((reinterpret_cast<uintptr_t>(w.w[k]) + 4 * head) & 15) == 0) vec_mask |= 1u << k;
  }
  auto* o = static_cast<unsigned long long*>(out);
  auto* wk = static_cast<Work*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (level0 == 0 && n_levels == 4 * n_words) {
    return static_cast<int>(launch_nw<kAll>(n_words, w, vec_mask, head, groups, n,
                                            level0, n_levels, o, wk, sms, s));
  }
  if (n_words == 1 && n_levels == 1) {
    return static_cast<int>(launch<1, kOne>(w, vec_mask, head, groups, n, level0,
                                            n_levels, o, wk, sms, s));
  }
  return static_cast<int>(launch_nw<kSome>(n_words, w, vec_mask, head, groups, n,
                                           level0, n_levels, o, wk, sms, s));
}

// Bytes of the workspace rdst_histogram takes.
extern "C" long long rdst_histogram_work_bytes() {
  return static_cast<long long>(sizeof(Work));
}
