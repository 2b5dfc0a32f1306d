// Kernels B2 (tail) and B3 (span): the compare-exchange kernels of the
// fused bitonic sort, rdst_tpu_torch/ops/fused_sort.py.
//
// B2, tail_kernel, replaces the Pallas _tail_kernel (rdst_tpu/ops/
// pallas_sort.py:211, launched by _tail_call at :267): on every aligned tile
// of `block` elements, one or more merge levels, each a run of ascending
// compare-exchange stages at strides start .. 1, a pair in an odd run of
// length 2^log_2r (a descending run) swapping the other way; on load it can
// un-flip the keys of odd phase-0 rows (XOR with the plane's all-ones where
// bit `unflip_shift` of the global index is set).
//
// B3, span_kernel, replaces the Pallas _span_kernel (pallas_sort.py:286,
// launched by _span_call at :327): a tile is one cell, the P = 2*s_hi/s_lo
// pieces of w = block/P contiguous elements at distance s_lo, and the
// log2(P) stages at element strides s_hi .. s_lo run on it in one trip.
// Direction is one per cell: (a >> log_ratio) & 1 for cell a of the
// (n/(2*s_hi), P, s_lo/w, w) view.
//
// What bounds them: each trip reads and writes every plane once, so the
// bound is n * (bytes per element) * 2 over HBM bandwidth, and everything in
// between has to hide under those copies.  The first version kept a tile in
// shared memory and ran one pass over it per stride with a barrier after
// each: some 40 shared-memory accesses per element of a 2-plane trip, 2-way
// bank conflicts at strides below 32, and scalar copies that no compute
// overlapped.  This design:
//
//   - keeps a tile in registers: each of T = block/E threads holds E
//     elements of every plane, E = 32, 16, 8, 4 at 1-2, 3-4, 5-7, 8 planes
//     (at most 64 registers of data, so nothing spills).  Where a thread's
//     elements sit is a layout a: reg i of thread tid holds element
//     ((tid >> a) << (a + R)) | (i << a) | (tid & (2^a - 1)), R = log2 E.
//     A stride on one of the register bits [a, a+R) compares two registers
//     of a thread; one on a lane bit between R and 4 is a __shfl_xor_sync
//     with the partner lane; any other first moves the tile to a layout
//     that holds it: a transpose, plane by plane, through a u32 buffer in
//     shared memory with two barriers.  The host plans the steps
//     (fused_sort._net_plan): a level of 12-14 stages needs two or three
//     moves.  Every stage is ascending: a FLIP complements the keys of a
//     level's descending runs before and after it, as the Pallas kernels do;
//     the compare takes the first 1-4 key planes as 64-bit words (one
//     ISETP and one ISETP.EX each).
//   - resolves each plane's width once, on the way from the staging buffer
//     into registers (u8/u16 widen to u32) and on the way out;
//   - copies in 16-byte units: tiles arrive with cp.async (16 bytes a
//     thread, consecutive threads on consecutive chunks) and leave with
//     16-byte stores; every offset into a piece is a shift and a mask;
//   - overlaps copies and compute inside each CTA: persistent CTAs walk the
//     tiles, and the next tile's cp.async is in flight while the current one
//     is compared and stored.  Shared memory holds that one staging tile (raw
//     widths) and the one-plane transpose buffer, so a 2-plane block of 2^14
//     needs 192 KB: one CTA per SM, 512 threads.
//   - swizzles both buffers at 16-byte granularity (chunk ^= row & 7 within
//     each 128-byte row), so that neither the 16-byte vector accesses of
//     layout 0 nor the scalar ones of layouts 5 and up conflict on a bank;
//     with a known at compile time a scalar access is one instruction.
//
// Both kernels run the same body on a plan of steps (FLIP, REG, LANE, MOVE);
// a compare is strict lexicographic over the first n_keys planes, so ties
// never swap, all planes move together and the output is bit for bit that
// of tail_plain / span_plain.
//
// B5, the merge tail of the fused merge (the Pallas _pallas_tail, rdst_tpu/
// ops/pallas_merge.py:232), is tail_kernel on a plan of one level with no
// FLIP: strides block/2 .. 1, ascending on every tile (fused_merge.
// merge_tail_cuda).  It runs in place (outs == ins): a tile is read and
// written by one CTA, the next tile's copies never touch the current one,
// and no plane pointer is __restrict__.  Nothing here changed for it.
#include "bitonic.cuh"

namespace {

constexpr int kNetThreads = 512;  // most threads of a B2/B3 CTA
constexpr int kMaxSteps = 768;  // the Net fits the 4 KB of kernel parameters
constexpr int kSmemMax = 227 * 1024;  // dynamic shared memory of one CTA

// Elements per thread and plane for K planes: E * K <= 64 registers of
// data, the most that leaves the rest of a thread's 128 without spills.
template <int K>
constexpr int kElems = K <= 2 ? 32 : (K <= 4 ? 16 : (K <= 7 ? 8 : 4));
// Blocks below 32 * kElems<K> elements run with 2 elements per thread.
constexpr int kSmallElems = 2;

enum : int { kFlip = 0, kReg = 1, kLane = 2, kMove = 3 };
constexpr int kNoDir = 127;  // a FLIP's unused second direction

// The plan.  bit: the element bit of a stage (REG, LANE), the target
// layout of a MOVE, or a FLIP's second direction.  dir: a FLIP's direction,
// >= 0 an element bit, < 0 the tile-uniform bit -dir-1 of the tile's run
// index u (B2: the tile index, B3: the cell's a).  FLIP XORs the key planes
// where exactly one of its directions' bits is set; stages are ascending.
struct Net {
  uint32_t step[kMaxSteps];  // op | bit << 8 | dir << 16, one load a step
  int n_steps;
  int a0;
};

// Tile t covers pieces q in [0, 2^(log_block - log_w)) of 2^log_w elements:
// element e sits at base(t) + (e >> log_w) * s_lo + (e & (2^log_w - 1)),
// base(t) = (t >> log_wc) * span + (t & (2^log_wc - 1)) << log_w.  B2 is
// one piece per tile, span = block.  The per-plane staging offsets and
// flip masks ride here too, in the constant bank rather than in registers.
struct Tiles {
  int count;  // tiles (< 2^31)
  long long span;
  long long s_lo;
  int log_w;
  int log_wc;
  int log_block;
  int vec;  // every plane pointer 16-byte aligned, every piece >= 16 bytes
  int soff[kMaxPlanes];       // staging tile of plane p (bytes)
  uint32_t ones[kMaxPlanes];  // all-ones of key plane p, 0 for the others
  int tbuf;                   // the u32 transpose buffer (bytes)
};

__device__ __forceinline__ int swz(int b) { return b ^ ((b >> 3) & 0x70); }
__device__ __forceinline__ int swz_w(int e) { return e ^ ((e >> 3) & 0x1C); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ int layout_base(int tid, int a) {
  return ((tid >> a) << (a + R)) | (tid & ((1 << a) - 1));
}

// kSpan: B3's cells of pieces; else B2's tiles, one contiguous piece each.
template <bool kSpan>
__device__ __forceinline__ long long tile_base(const Tiles& G, int t) {
  if constexpr (!kSpan) return static_cast<long long>(t) << G.log_block;
  const long long b = t & ((1 << G.log_wc) - 1);
  return static_cast<long long>(t >> G.log_wc) * G.span + (b << G.log_w);
}

template <bool kSpan>
__device__ __forceinline__ long long gidx(const Tiles& G, long long base,
                                          int e) {
  if constexpr (!kSpan) return base + e;
  return base + static_cast<long long>(e >> G.log_w) * G.s_lo +
         (e & ((1 << G.log_w) - 1));
}

template <int W>
__device__ __forceinline__ uint32_t sld(const unsigned char* s, int b) {
  if constexpr (W == 4) return *reinterpret_cast<const uint32_t*>(s + b);
  if constexpr (W == 2) return *reinterpret_cast<const uint16_t*>(s + b);
  return s[b];
}

__device__ __forceinline__ void sst(unsigned char* s, int b, int width,
                                    uint32_t v) {
  if (width == 4) {
    *reinterpret_cast<uint32_t*>(s + b) = v;
  } else if (width == 2) {
    *reinterpret_cast<uint16_t*>(s + b) = static_cast<uint16_t>(v);
  } else {
    s[b] = static_cast<uint8_t>(v);
  }
}

// Element k of a run of width-W elements packed in words w[].
template <int W, int k>
__device__ __forceinline__ uint32_t unpack(const uint32_t (&w)[4]) {
  constexpr int byte = k * W;
  const uint32_t x = w[byte / 4] >> (8 * (byte % 4));
  if constexpr (W == 4) return x;
  if constexpr (W == 2) return x & 0xFFFFu;
  return x & 0xFFu;
}

template <int W, int E, int C, int k>
__device__ __forceinline__ void unpack_run(uint32_t (&v)[E],
                                           const uint32_t (&w)[4]) {
  constexpr int per = (E * W >= 16 ? 16 : E * W) / W;
  if constexpr (k < per) {
    v[C * per + k] = unpack<W, k>(w);
    unpack_run<W, E, C, k + 1>(v, w);
  }
}

template <int W, int E, int C>
__device__ __forceinline__ void read_run(uint32_t (&v)[E],
                                         const unsigned char* s, int b0) {
  constexpr int U = E * W >= 16 ? 16 : E * W;
  if constexpr (C < E * W / U) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const unsigned char* p = s + swz(b0 + C * U);
    if constexpr (U == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (U == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x; w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    unpack_run<W, E, C, 0>(v, w);
    read_run<W, E, C + 1>(v, s, b0);
  }
}

// Where a thread's elements sit in a layout a with a known at compile time:
// the swizzles are linear and base, i << a share no bit, so element i of
// width W is at byte (sb ^ S_i) + (i << a) * W, sb the thread's part and S_i
// a constant in the bits the swizzle moves (4-6) -- when (i << a) * W stays
// clear of them.  One XOR per distinct S_i, then immediate offsets.
//
// The staging tile (raw width W, swizzled bytes) -> registers in layout A:
template <int W, int E, int A>
__device__ __forceinline__ void read_at(uint32_t (&v)[E],
                                        const unsigned char* s, int base) {
  const int sb = swz(base * W);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = (i << A) * W;
    v[i] = sld<W>(s, (sb ^ ((c >> 3) & 0x70)) + c);
  }
}

template <int W, int E>
__device__ __forceinline__ void read_stage(uint32_t (&v)[E],
                                           const unsigned char* s, int a,
                                           int base, int tid) {
  if constexpr (E * W >= 4) {
    if (a == 0) {  // E consecutive elements: vector reads
      read_run<W, E, 0>(v, s, tid * E * W);
      return;
    }
  }
  constexpr int lw = W >> 1;  // log2 W
  switch (a) {  // a register stride of at least 128 bytes splits
    case 5: if constexpr (lw == 2) { read_at<W, E, 5>(v, s, base); return; } break;
    case 6: if constexpr (lw >= 1) { read_at<W, E, 6>(v, s, base); return; } break;
    case 7: read_at<W, E, 7>(v, s, base); return;
    case 8: read_at<W, E, 8>(v, s, base); return;
    case 9: read_at<W, E, 9>(v, s, base); return;
    case 10: read_at<W, E, 10>(v, s, base); return;
    default: break;
  }
  // swz is linear and base, i << a share no bit
  const int sb = swz(base * W);
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = sld<W>(s, sb ^ swz((i << a) * W));
}

// Registers in layout a <-> the u32 transpose buffer (word swizzle: bits
// 2-4 take bits 5-7, so every layout a >= 5 splits as above).
template <int E, int A, bool kPut>
__device__ __forceinline__ void tmove_at(uint32_t* tb, uint32_t (&v)[E],
                                         int base) {
  const int sb = swz_w(base);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = i << A;
    const int w = (sb ^ ((c >> 3) & 0x1C)) + c;
    if constexpr (kPut) {
      tb[w] = v[i];
    } else {
      v[i] = tb[w];
    }
  }
}

template <int E, bool kPut>
__device__ __forceinline__ void tmove(uint32_t* tb, uint32_t (&v)[E], int a,
                                      int base, int tid) {
  if (a == 0) {
    const int e0 = tid * E;
    if constexpr (E >= 4) {
#pragma unroll
      for (int c = 0; c < E / 4; ++c) {
        uint4* q = reinterpret_cast<uint4*>(tb + swz_w(e0 + 4 * c));
        if constexpr (kPut) {
          *q = make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
        } else {
          const uint4 x = *q;
          v[4 * c] = x.x; v[4 * c + 1] = x.y; v[4 * c + 2] = x.z; v[4 * c + 3] = x.w;
        }
      }
    } else {
      uint2* q = reinterpret_cast<uint2*>(tb + swz_w(e0));
      if constexpr (kPut) {
        *q = make_uint2(v[0], v[1]);
      } else {
        const uint2 x = *q;
        v[0] = x.x; v[1] = x.y;
      }
    }
    return;
  }
  switch (a) {
    case 5: tmove_at<E, 5, kPut>(tb, v, base); return;
    case 6: tmove_at<E, 6, kPut>(tb, v, base); return;
    case 7: tmove_at<E, 7, kPut>(tb, v, base); return;
    case 8: tmove_at<E, 8, kPut>(tb, v, base); return;
    case 9: tmove_at<E, 9, kPut>(tb, v, base); return;
    case 10: tmove_at<E, 10, kPut>(tb, v, base); return;
    default: break;
  }
  const int sb = swz_w(base);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if constexpr (kPut) {
      tb[sb ^ swz_w(i << a)] = v[i];
    } else {
      v[i] = tb[sb ^ swz_w(i << a)];
    }
  }
}

// One plane of the tile from the transpose buffer to device memory.
template <int W, bool kSpan>
__device__ __forceinline__ void tstore(const uint32_t* tb, void* out,
                                       const Tiles& G, long long base, int B,
                                       int tid, int T) {
  unsigned char* o = static_cast<unsigned char*>(out);
  if (G.vec) {
    constexpr int per = 16 / W;
    for (int c = tid; c < B / per; c += T) {
      const int e0 = c * per;
      uint32_t w[4];
      if constexpr (W == 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(tb + swz_w(e0));
        w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
      } else {
        uint32_t x[per];
#pragma unroll
        for (int q = 0; q < per / 4; ++q) {
          const uint4 y = *reinterpret_cast<const uint4*>(tb + swz_w(e0 + 4 * q));
          x[4 * q] = y.x; x[4 * q + 1] = y.y; x[4 * q + 2] = y.z; x[4 * q + 3] = y.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (W == 2) {
            w[q] = (x[2 * q] & 0xFFFFu) | (x[2 * q + 1] << 16);
          } else {
            w[q] = (x[4 * q] & 0xFFu) | ((x[4 * q + 1] & 0xFFu) << 8) |
                   ((x[4 * q + 2] & 0xFFu) << 16) | (x[4 * q + 3] << 24);
          }
        }
      }
      *reinterpret_cast<uint4*>(o + gidx<kSpan>(G, base, e0) * W) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int e = tid; e < B; e += T) {
      store_plane(out, W, gidx<kSpan>(G, base, e), tb[swz_w(e)]);
    }
  }
}

// Start the copies of tile t into the staging buffer (one cp.async group).
template <int K, bool kSpan>
__device__ __forceinline__ void fill(unsigned char* smem, const Planes& P,
                                     const Tiles& G, int t, int B,
                                     int tid, int T) {
  const long long base = tile_base<kSpan>(G, t);
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const int W = P.width[p];
    unsigned char* s = smem + G.soff[p];
    if (G.vec) {
      const unsigned char* in = static_cast<const unsigned char*>(P.in[p]);
      const int log_per = 4 - (W >> 1);  // log2(16 / W)
      for (int c = tid; c < (B * W) >> 4; c += T) {
        cp_async16(s + swz(c << 4), in + gidx<kSpan>(G, base, c << log_per) * W);
      }
    } else {
      for (int e = tid; e < B; e += T) {
        sst(s, swz(e * W), W, load_plane(P.in[p], W, gidx<kSpan>(G, base, e)));
      }
    }
  }
  cp_async_commit();
}

template <int E>
constexpr int kLog = E == 32 ? 5 : E == 16 ? 4 : E == 8 ? 3 : E == 4 ? 2 : 1;

// A FLIP's predicate as a mask over a thread's registers: bit i set where
// register i flips.  dir is an element bit (a register bit gives a pattern
// over i, a thread bit one value for the thread) or, < 0, the tile's flag.
template <int E>
__device__ __forceinline__ uint32_t dir_mask(int dir, int a, int tid, int u) {
  if (dir < 0) return (u >> (-dir - 1)) & 1 ? ~0u : 0u;
  if (dir >= a && dir < a + kLog<E>) {
    switch (dir - a) {
      case 0: return 0xAAAAAAAAu;
      case 1: return 0xCCCCCCCCu;
      case 2: return 0xF0F0F0F0u;
      case 3: return 0xFF00FF00u;
      default: return 0xFFFF0000u;
    }
  }
  return ((tid >> (dir < a ? dir : dir - kLog<E>)) & 1) ? ~0u : 0u;
}

// x > y, strictly and lexicographically over the first NK planes (NK = 0:
// the first nk).  Key planes pair into 64-bit words, which the compiler
// compares with one ISETP and one ISETP.EX.
__device__ __forceinline__ uint64_t w64(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

template <int K, int NK>
__device__ __forceinline__ bool lex_gt(const uint32_t (&x)[K],
                                       const uint32_t (&y)[K], int nk) {
  if constexpr (NK == 1) {
    return x[0] > y[0];
  } else if constexpr (NK == 2) {
    return w64(x[0], x[1]) > w64(y[0], y[1]);
  } else if constexpr (NK == 3) {
    const uint64_t a = w64(x[0], x[1]);
    const uint64_t b = w64(y[0], y[1]);
    return a > b || (a == b && x[2] > y[2]);
  } else if constexpr (NK == 4) {
    const uint64_t a = w64(x[0], x[1]);
    const uint64_t b = w64(y[0], y[1]);
    return a > b || (a == b && w64(x[2], x[3]) > w64(y[2], y[3]));
  } else {
    bool gt = false;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      if (k < nk) gt = x[k] != y[k] ? x[k] > y[k] : gt;
    }
    return gt;
  }
}

// Registers i < j with j = i | 2^RB, an ascending pair: swap when lo > hi
// (the plan complements the keys of descending runs around their level).
template <int K, int E, int RB, int NK>
__device__ __forceinline__ void ce_reg(uint32_t (&v)[K][E], int nk) {
  if constexpr (RB < kLog<E>) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (i & (1 << RB)) continue;
      const int j = i | (1 << RB);
      uint32_t x[K];
      uint32_t y[K];
#pragma unroll
      for (int p = 0; p < K; ++p) {
        x[p] = v[p][i];
        y[p] = v[p][j];
      }
      const bool swap = lex_gt<K, NK>(x, y, nk);
#pragma unroll
      for (int p = 0; p < K; ++p) {
        v[p][i] = swap ? y[p] : x[p];
        v[p][j] = swap ? x[p] : y[p];
      }
    }
  }
}

template <int K, int E, int NK>
__device__ __forceinline__ void ce_reg_at(uint32_t (&v)[K][E], int rb, int nk) {
  switch (rb) {
    case 0: ce_reg<K, E, 0, NK>(v, nk); break;
    case 1: ce_reg<K, E, 1, NK>(v, nk); break;
    case 2: ce_reg<K, E, 2, NK>(v, nk); break;
    case 3: ce_reg<K, E, 3, NK>(v, nk); break;
    default: ce_reg<K, E, 4, NK>(v, nk); break;
  }
}

// The register stage at register bit rb, compiled for the key counts 1-4.
template <int K, int E>
__device__ __forceinline__ void stage_reg(uint32_t (&v)[K][E], int rb, int nk) {
  if (nk == 1) {
    ce_reg_at<K, E, 1>(v, rb, nk);
  } else if constexpr (K >= 2) {
    if (nk == 2) {
      ce_reg_at<K, E, 2>(v, rb, nk);
    } else if constexpr (K >= 3) {
      if (nk == 3) {
        ce_reg_at<K, E, 3>(v, rb, nk);
      } else if constexpr (K >= 4) {
        if (nk == 4) {
          ce_reg_at<K, E, 4>(v, rb, nk);
        } else if constexpr (K >= 5) {
          ce_reg_at<K, E, 0>(v, rb, nk);
        }
      }
    }
  }
}

// Element bit j on lane bit tb, an ascending pair: each thread compares its
// register with the partner lane's and keeps the one its side gets.
template <int K, int E>
__device__ __forceinline__ void ce_lane(uint32_t (&v)[K][E], int j, int a,
                                        int nk, unsigned mask, int tid) {
  const int tb = j < a ? j : j - kLog<E>;
  const bool is_hi = (tid >> tb) & 1;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    uint32_t x[K];
    uint32_t y[K];
    uint32_t lo[K];
    uint32_t hi[K];
#pragma unroll
    for (int p = 0; p < K; ++p) {
      x[p] = v[p][i];
      y[p] = __shfl_xor_sync(mask, x[p], 1 << tb);
      lo[p] = is_hi ? y[p] : x[p];
      hi[p] = is_hi ? x[p] : y[p];
    }
    const bool swap = lex_gt<K, 0>(lo, hi, nk);
#pragma unroll
    for (int p = 0; p < K; ++p) v[p][i] = swap ? y[p] : x[p];
  }
}

template <int K, int E, bool kSpan>
__device__ __forceinline__ void run_tiles(const Planes& P, const Net& N,
                                          const Tiles& G) {
  constexpr int R = kLog<E>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = 1 << G.log_block;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int nk = P.n_keys;
  uint32_t* tb = reinterpret_cast<uint32_t*>(smem + G.tbuf);
  uint32_t v[K][E];

  int t = blockIdx.x;
  fill<K, kSpan>(smem, P, G, t, B, tid, T);
  for (; t < G.count; t += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    int a = N.a0;
    int base = layout_base<R>(tid, a);
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const int W = P.width[p];
      if (W == 4) {
        read_stage<4, E>(v[p], smem + G.soff[p], a, base, tid);
      } else if (W == 2) {
        read_stage<2, E>(v[p], smem + G.soff[p], a, base, tid);
      } else {
        read_stage<1, E>(v[p], smem + G.soff[p], a, base, tid);
      }
    }
    __syncthreads();
    if (t + static_cast<int>(gridDim.x) < G.count) {
      fill<K, kSpan>(smem, P, G, t + gridDim.x, B, tid, T);
    }
    for (int s = 0; s < N.n_steps; ++s) {
      const uint32_t w = N.step[s];
      const int op = w & 0xFF;
      const int bit = static_cast<int8_t>(w >> 8);
      const int dir = static_cast<int8_t>(w >> 16);
      if (op == kReg) {
        stage_reg<K, E>(v, bit - a, nk);
      } else if (op == kLane) {
        ce_lane<K, E>(v, bit, a, nk, T >= 32 ? ~0u : (1u << T) - 1u, tid);
      } else if (op == kMove) {
        const int nbase = layout_base<R>(tid, bit);
#pragma unroll
        for (int p = 0; p < K; ++p) {
          tmove<E, true>(tb, v[p], a, base, tid);
          __syncthreads();
          tmove<E, false>(tb, v[p], bit, nbase, tid);
          __syncthreads();
        }
        a = bit;
        base = nbase;
      } else {  // kFlip: complement the key planes where dir's bit (or
                // bit's, a second direction, unless kNoDir) is set
        const int u = t >> G.log_wc;
        uint32_t dm = dir_mask<E>(dir, a, tid, u);
        if (bit != kNoDir) dm ^= dir_mask<E>(bit, a, tid, u);
        if (dm != 0u) {
#pragma unroll
          for (int p = 0; p < K; ++p) {
            if (p < nk) {
#pragma unroll
              for (int i = 0; i < E; ++i) v[p][i] ^= ((dm >> i) & 1) ? G.ones[p] : 0u;
            }
          }
        }
      }
    }
    const long long gbase = tile_base<kSpan>(G, t);
#pragma unroll
    for (int p = 0; p < K; ++p) {
      tmove<E, true>(tb, v[p], a, base, tid);
      __syncthreads();
      const int W = P.width[p];
      if (W == 4) {
        tstore<4, kSpan>(tb, P.out[p], G, gbase, B, tid, T);
      } else if (W == 2) {
        tstore<2, kSpan>(tb, P.out[p], G, gbase, B, tid, T);
      } else {
        tstore<1, kSpan>(tb, P.out[p], G, gbase, B, tid, T);
      }
      __syncthreads();
    }
  }
}

template <int K, int E>
__global__ void __launch_bounds__(kNetThreads, 1)
tail_kernel(const Planes P, const __grid_constant__ Net N,
            const __grid_constant__ Tiles G) {
  run_tiles<K, E, false>(P, N, G);
}

template <int K, int E>
__global__ void __launch_bounds__(kNetThreads, 1)
span_kernel(const Planes P, const __grid_constant__ Net N,
            const __grid_constant__ Tiles G) {
  run_tiles<K, E, true>(P, N, G);
}

using KernelFn = void (*)(const Planes, const Net, const Tiles);

template <int K>
KernelFn pick_k(bool span, int elems) {
  if (elems == kElems<K>) {
    return span ? span_kernel<K, kElems<K>> : tail_kernel<K, kElems<K>>;
  }
  if (elems == kSmallElems) {
    return span ? span_kernel<K, kSmallElems> : tail_kernel<K, kSmallElems>;
  }
  return nullptr;
}

KernelFn pick_kernel(bool span, int n_planes, int elems) {
  switch (n_planes) {
    case 1: return pick_k<1>(span, elems);
    case 2: return pick_k<2>(span, elems);
    case 3: return pick_k<3>(span, elems);
    case 4: return pick_k<4>(span, elems);
    case 5: return pick_k<5>(span, elems);
    case 6: return pick_k<6>(span, elems);
    case 7: return pick_k<7>(span, elems);
    case 8: return pick_k<8>(span, elems);
    default: return nullptr;
  }
}

int log2_of(long long x) {
  int l = 0;
  while ((1LL << l) < x) ++l;
  return l;
}

// Fills N from the caller's plan and checks that every stage is local in the
// layout it runs in (register or lane bit), so the kernel never guesses.
bool make_net(Net* N, const int8_t* ops, const int8_t* bits,
              const int8_t* dirs, int n_steps, int a0, int log_block,
              int log_e) {
  if (n_steps < 0 || n_steps > kMaxSteps || a0 < 0 ||
      a0 > log_block - log_e) {
    return false;
  }
  const int lanes = log_block - log_e < 5 ? log_block - log_e : 5;
  int a = a0;
  for (int s = 0; s < n_steps; ++s) {
    const int op = ops[s];
    const int bit = bits[s];
    const int dir = dirs[s];
    if (dir >= log_block) return false;
    if (op == kFlip) {
      if (bit != kNoDir && bit >= log_block) return false;
    } else if (op == kMove) {
      if (bit < 0 || bit > log_block - log_e) return false;
      a = bit;
    } else if (op == kReg) {
      if (bit < a || bit >= a + log_e) return false;
    } else if (op == kLane) {
      if (bit < 0 || bit >= log_block || (bit >= a && bit < a + log_e)) {
        return false;
      }
      const int tb = bit < a ? bit : bit - log_e;
      if (tb >= lanes) return false;
    } else {
      return false;
    }
    N->step[s] = static_cast<uint32_t>(op) |
                 (static_cast<uint32_t>(bit & 0xFF) << 8) |
                 (static_cast<uint32_t>(dir & 0xFF) << 16);
  }
  N->n_steps = n_steps;
  N->a0 = a0;
  return true;
}

int launch(bool span, const Planes& P, int elems, const Net& N, Tiles G,
           void* stream) {
  KernelFn fn = pick_kernel(span, P.n_planes, elems);
  const int block = 1 << G.log_block;
  if (fn == nullptr || block % elems != 0 || block / elems > kNetThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = block / elems;
  long long smem = 0;
  for (int p = 0; p < P.n_planes; ++p) {
    G.soff[p] = static_cast<int>(smem);
    G.ones[p] = p < P.n_keys ? ones_of(P.width[p]) : 0u;
    smem += (static_cast<long long>(block) * P.width[p] + 15) & ~15LL;
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  }
  G.tbuf = static_cast<int>(smem);
  smem += 4LL * block;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (G.count <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, threads, static_cast<size_t>(smem));
  }
  int device = 0;
  int sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long grid = static_cast<long long>(sms) * per_sm;
  if (grid > G.count) grid = G.count;
  fn<<<static_cast<unsigned int>(grid), threads, static_cast<size_t>(smem),
       static_cast<cudaStream_t>(stream)>>>(P, N, G);
  return static_cast<int>(cudaGetLastError());
}

bool vec_ok(const Planes& P, long long piece) {
  for (int p = 0; p < P.n_planes; ++p) {
    if (reinterpret_cast<uintptr_t>(P.in[p]) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(P.out[p]) % 16 != 0 ||
        piece * P.width[p] % 16 != 0) {
      return false;
    }
  }
  return true;
}

}  // namespace

// ins/outs: n_planes device pointers (planes of length n, widths in bytes),
// keys first.  elems: elements per thread (fused_sort.elems_per_thread).
// ops/bits/dirs: the n_steps steps of the plan (fused_sort._net_plan), a0 its
// first layout; they encode the levels and the un-flip.
extern "C" int rdst_bitonic_tail(void* const* ins, void* const* outs,
                                 const int* widths, int n_planes, int n_keys,
                                 long long n, int block, int elems,
                                 const int8_t* ops, const int8_t* bits,
                                 const int8_t* dirs, int n_steps, int a0,
                                 void* stream) {
  Planes P;
  if (!make_planes(&P, ins, outs, widths, n_planes, n_keys) || !pow2(block) ||
      block < 2 || n % block != 0 || !pow2(elems) || elems > block) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Net N;
  const int log_block = log2_of(block);
  if (!make_net(&N, ops, bits, dirs, n_steps, a0, log_block, log2_of(elems))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tiles G{};
  if (n / block >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  G.count = static_cast<int>(n / block);
  G.span = block;
  G.s_lo = block;
  G.log_w = log_block;
  G.log_wc = 0;
  G.log_block = log_block;
  G.vec = vec_ok(P, block);
  return launch(false, P, elems, N, G, stream);
}

// The flat planes viewed as (n / (2 * s_hi), P, s_lo / w, w) with
// P = 2 * s_hi / s_lo and w = block / P; one tile per (a, b) cell.  The plan
// holds the stages at element bits log2(w) + log2(P) - 1 .. log2(w) of the
// cell, descending where bit log_ratio of a is set.
extern "C" int rdst_bitonic_span(void* const* ins, void* const* outs,
                                 const int* widths, int n_planes, int n_keys,
                                 long long n, long long s_hi, long long s_lo,
                                 int block, int elems, const int8_t* ops,
                                 const int8_t* bits, const int8_t* dirs,
                                 int n_steps, int a0, void* stream) {
  Planes P;
  if (!make_planes(&P, ins, outs, widths, n_planes, n_keys) || !pow2(block) ||
      !pow2(s_hi) || !pow2(s_lo) || s_lo > s_hi || n % (2 * s_hi) != 0 ||
      !pow2(elems) || elems > block) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long p_dim = 2 * s_hi / s_lo;
  if (p_dim > block || block / p_dim > s_lo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long w = block / p_dim;
  Net N;
  const int log_block = log2_of(block);
  if (!make_net(&N, ops, bits, dirs, n_steps, a0, log_block, log2_of(elems))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tiles G{};
  G.log_wc = log2_of(s_lo / w);
  if ((n / (2 * s_hi)) << G.log_wc >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  G.count = static_cast<int>((n / (2 * s_hi)) << G.log_wc);
  G.span = 2 * s_hi;
  G.s_lo = s_lo;
  G.log_w = log2_of(w);
  G.log_block = log_block;
  G.vec = vec_ok(P, w);
  return launch(true, P, elems, N, G, stream);
}
