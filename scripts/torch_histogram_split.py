#!/usr/bin/env python3
"""Where the time of the histogram kernel B1 goes, on one CUDA card.

    python3 scripts/torch_histogram_split.py [--reps 5] [--no-ablation]
                                             [--no-variants]

Two parts, each kernel built with nvcc into ``build/histogram_split/``
(git-ignored), all builds started together:

  ablation  the one-thread-per-key kernel of the first port (its source is
            below, ``ABLATION_SRC``), cut back in four cumulative stages:
              a  the loads only (each key and its predecessor: a warp
                 shuffle, lane 0 reading its own), folded into a sink;
              b  + the level flags and the sorted prefix (the per-level
                 word select, shift and mask, the compare);
              c  + one shared-memory atomicAdd per key and level;
              d  + the 64-bit global flush of every block's bins and the
                 separate init launch: the whole kernel;
            each at 2^25 keys x 2 words (8 levels) on uniform and all-equal
            keys, at that kernel's own grid (4 blocks of 512 threads per SM).
  variants  this tree's ``csrc/histogram.cu`` with a few of its lines
            replaced (``VARIANTS``: each replaced text must occur once): the
            vote for digits a warp shares taken out; other shared budgets
            (hence sub-histogram counts), block sizes and unrolls; at 2^25 x
            2 words on uniform, presorted, all-equal and Zipf keys and at
            2^25 x 1 word, one level (B1'); every output must equal
            ``histogram_plain``.  The "split" variants cut the kernel back
            to split its time (their output is not checked): the loads
            alone, + flags and prefix, + every add at a bank-conflict-free
            address.

Times: CUDA events around one launch (the host's enqueue included, as a
caller meets it), median of REPS after a warm-up; for the variants also
the mean of 20 launches back to back (the device's time per launch) and
2^10 keys (the fixed cost of a launch).  Bound: the planes read once and
the buffer written once at the HBM rate of ``benchmark/peaks.json`` (3.35 TB/s).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "histogram_split"
HBM = json.loads((ROOT / "benchmark" / "peaks.json").read_text())["hbm_bytes_per_s"]
SEED = 20261016

# The first port's B1 (one key per thread, runtime level range), with STAGE
# guards: 1 = loads, 2 = + flags and prefix, 3 = + shared atomics, 4 = all.
ABLATION_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kRadix = 256, kMaxWords = 8, kMaxLevels = 32, kThreads = 512;
struct Words { const uint32_t* w[kMaxWords]; };

__global__ void hist_init(unsigned long long* out, int n_levels, long long n) {
  const int nc = n_levels * kRadix;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i <= nc + n_levels;
       i += gridDim.x * blockDim.x) {
    out[i] = i < nc ? 0ull : (i < nc + n_levels ? 1ull : (unsigned long long)n);
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
hist_kernel(Words words, int level0, int n_levels, long long n,
            unsigned long long* out) {
  __shared__ unsigned int hist[kMaxLevels * kRadix];
  __shared__ unsigned int desc_bits;
  __shared__ unsigned long long first_desc;
  for (int j = threadIdx.x; j < n_levels * kRadix; j += blockDim.x) hist[j] = 0u;
  if (threadIdx.x == 0) { desc_bits = 0u; first_desc = (unsigned long long)n; }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned int my_desc = 0u;
  long long my_first = n;
  uint32_t sink = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
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
#if STAGE == 1
#pragma unroll
    for (int k = 0; k < NW; ++k) sink ^= cur[k] + 3u * prev[k];
#else
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= n_levels) break;
      const int lv = level0 + l;
      const int widx = NW - 1 - (lv >> 2);
      const unsigned int shift = (lv & 3) * 8;
      uint32_t wc = 0u, wp = 0u;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (k == widx) { wc = cur[k]; wp = prev[k]; }
      }
      const unsigned int d = (wc >> shift) & 0xFFu;
#if STAGE >= 3
      atomicAdd(&hist[l * kRadix + d], 1u);
#endif
      if (i > 0 && ((wp >> shift) & 0xFFu) > d) my_desc |= 1u << l;
    }
    if (i > 0 && i < my_first) {
      bool gt = false, decided = false;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (!decided && prev[k] != cur[k]) { gt = prev[k] > cur[k]; decided = true; }
      }
      if (gt) my_first = i;
    }
#endif
  }
  if (sink == 0x9E3779B9u) out[0] = sink;  // keeps stage a's loads
  if (my_desc) atomicOr(&desc_bits, my_desc);
  if (my_first < n) atomicMin(&first_desc, (unsigned long long)my_first);
  __syncthreads();
#if STAGE == 3
  if (threadIdx.x == 0 && hist[0] == 0xFFFFFFFFu) out[0] = hist[1];  // keeps the atomics
#endif
#if STAGE >= 4
  for (int j = threadIdx.x; j < n_levels * kRadix; j += blockDim.x) {
    const unsigned int c = hist[j];
    if (c) atomicAdd(&out[j], (unsigned long long)c);
  }
#endif
  if (threadIdx.x == 0) {
    const unsigned int bits = desc_bits;
    for (int l = 0; l < n_levels; ++l) {
      if (bits & (1u << l)) out[n_levels * kRadix + l] = 0ull;
    }
    if (first_desc < (unsigned long long)n) atomicMin(&out[n_levels * kRadix + n_levels], first_desc);
  }
}
}  // namespace

extern "C" int rdst_histogram(void* const* words, int n_words, int level0, int n_levels,
                              long long n, void* out, int grid, void* stream) {
  if (n_words != 2) return (int)cudaErrorInvalidValue;
  Words w{};
  for (int k = 0; k < n_words; ++k) w.w[k] = (const uint32_t*)words[k];
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* o = (unsigned long long*)out;
#if STAGE >= 4
  const int total = n_levels * kRadix + n_levels + 1;
  hist_init<<<(total + 255) / 256, 256, 0, s>>>(o, n_levels, n);
#endif
  hist_kernel<2><<<grid, kThreads, 0, s>>>(w, level0, n_levels, n, o);
  return (int)cudaGetLastError();
}
"""

STAGES = {"a": "loads only", "b": "+ flags and prefix", "c": "+ shared atomics",
          "d": "+ global flush and init launch (the whole kernel)"}
# Text in csrc/histogram.cu that the variants replace.
_CARRY = "        carry[k] = up;  // lane 0's predecessor at step u + 1\n      }\n"
_FIRST = "  long long first = n;\n"
_FLAGS = "  // the block's flags and first descent\n"
_WHOLE = "      if (!whole) {"
_ADD4 = "".join(f"          red_inc(bin(l, digit(c.{x}, sh)));\n" for x in "xyzw")
_SMEM = ("kSmemBudget = 128 * 1024;", "kSmemBudget = 64 * 1024;")
_INC_IF = "__device__ __forceinline__ void red_inc_if("
# A vote for the digits a whole warp shares: where its 128 keys share a
# level's digit with lane 0's first key, lane 0 adds 128 once.
_VOTE = [
    (_INC_IF, """__device__ __forceinline__ void red_add(uint32_t addr, uint32_t v, bool p) {
  asm volatile(
      "{\\n\\t.reg .pred q;\\n\\tsetp.ne.b32 q, %2, 0;\\n\\t"
      "@q red.shared.add.u32 [%0], %1;\\n\\t}"
      :: "r"(addr), "r"(v), "r"(static_cast<uint32_t>(p)) : "memory");
}

""" + _INC_IF),
    ("""        const uint4& c = cur[u][k];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int l = row_of(k, b);
          if (l < 0) continue;
          const int sh = shift_of(b);
""" + _ADD4, """        const uint4& c = cur[u][k];
        const uint32_t lead = __shfl_sync(kAll32, c.x, 0);
        const uint32_t differ = __reduce_or_sync(
            kAll32, (c.x ^ lead) | (c.y ^ lead) | (c.z ^ lead) | (c.w ^ lead));
        const bool common = ((differ - 0x01010101u) & ~differ & kMsb) != 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int l = row_of(k, b);
          if (l < 0) continue;
          const int sh = shift_of(b);
          if (common && digit(differ, sh) == 0u) {
            red_add(bin(l, digit(lead, sh)), 4u * 32u, lane == 0);
            continue;
          }
""" + _ADD4),
]
# the loads into a sink that the kernel keeps, and nothing else
_LOADS_ONLY = [
    (_FIRST, _FIRST + "  uint32_t sink = 0u;\n"),
    (_CARRY, _CARRY + "#pragma unroll\n      for (int k = 0; k < NW; ++k) {\n"
     "        const uint4& c = cur[u][k];\n"
     "        sink ^= pred[k] + c.x + c.y + c.z + c.w;\n      }\n      continue;\n"),
    (_FLAGS, "  if (sink == 0x9E3779B9u) out[0] = sink;\n" + _FLAGS),
]
# name -> (replacements (old, new) in this tree's csrc/histogram.cu, output exact)
VARIANTS = {
    "kept": ([], True),
    "vote": (_VOTE, True),
    "smem 64K": ([_SMEM], True),
    "512 threads, smem 64K": ([("kBlockThreads = 1024;", "kBlockThreads = 512;"), _SMEM],
                              True),
    "unroll 1": ([("kGroupUnroll = 2;", "kGroupUnroll = 1;")], True),
    "split 1: loads alone": (_LOADS_ONLY, False),
    "split 2: + flags and prefix": ([(_WHOLE, "      continue;\n" + _WHOLE)], False),
    "split 3: + adds, conflict-free": ([(_ADD4, (
        "          const uint32_t at = hist_s - 4u * part +\n"
        "              (static_cast<uint32_t>(l) << (10 + LP)) + 4u * lane;\n"
        + "          red_inc(at);\n" * 4))], False),
}


def patched(src: str, edits) -> str:
    """src with each (old, new) applied; old must occur exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant text found {src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)
    return src

def cuda_ms(torch, fn, reps):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def build_all(ablation: bool, variants: bool) -> dict[str, ctypes.CDLL]:
    """Every library at once, one nvcc each."""
    from rdst_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    if ablation:
        src = OUT / "ablation.cu"
        src.write_text(ABLATION_SRC)
        for i, stage in enumerate(STAGES, 1):
            jobs[f"stage {stage}"] = (src, [f"-DSTAGE={i}"])
    if variants:
        kernel = (ROOT / "rdst_tpu_torch" / "csrc" / "histogram.cu").read_text()
        for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
            src = OUT / f"variant{i}.cu"
            src.write_text(patched(kernel, edits))
            jobs[name] = (src, [])
    procs = {}
    for i, (name, (src, opts)) in enumerate(jobs.items()):
        lib = OUT / f"lib{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, *opts, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc [{name}] failed:\n{out}\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def keys_of(torch, P, kind, n, nw, gen, dev):
    """(nw) u32 planes of n keys: uniform, presorted (uniform keys sorted),
    all equal, or Zipf (2^20 distinct random keys at Zipf(1.1) rank
    frequencies, drawn on the card)."""
    def u32(m):
        return P.narrow(torch.randint(0, 1 << 32, (m,), generator=gen, device=dev,
                                      dtype=torch.int64), torch.uint32)

    if kind == "uniform":
        return [u32(n) for _ in range(nw)]
    if kind == "equal":
        return [P.full(n, 0x01020304 + k, torch.uint32, dev) for k in range(nw)]
    if kind == "zipf":
        pool = [u32(1 << 20) for _ in range(nw)]
        p = torch.arange(1, (1 << 20) + 1, device=dev, dtype=torch.float64) ** -1.1
        pick = torch.multinomial(p, n, replacement=True, generator=gen)
        return [P.take(q, pick) for q in pool]
    w = [P.widen(p) for p in (u32(n) for _ in range(nw))]
    key = w[0]
    for x in w[1:]:  # nw <= 2 here: a 64-bit key
        key = (key << 32) | x
    key = torch.sort(key ^ (-(1 << 63) if nw == 2 else 0)).values ^ (
        -(1 << 63) if nw == 2 else 0)
    if nw == 1:
        return [P.narrow(key, torch.uint32)]
    return [P.narrow((key >> 32) & 0xFFFFFFFF, torch.uint32),
            P.narrow(key & 0xFFFFFFFF, torch.uint32)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-ablation", action="store_true")
    ap.add_argument("--no-variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_histogram_split: CUDA is not available", file=sys.stderr)
        return 2
    from rdst_tpu_torch import _build
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch.ops import histogram as H

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    libs = build_all(not args.no_ablation, not args.no_variants)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sms = _build.sm_count(dev)
    n = 1 << 25
    vp, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def ptrs(words):
        return (ctypes.c_void_p * H.MAX_WORDS)(*[w.data_ptr() for w in words])

    if not args.no_ablation:
        grid = max(1, min(-(-n // 512), sms * 4))
        for kind in ("uniform", "equal"):
            w = keys_of(torch, P, kind, n, 2, gen, dev)
            out = torch.zeros(8 * 256 + 9, dtype=torch.int64, device=dev)
            bound = (8 * n + 8 * out.numel()) / HBM * 1e3
            row = []
            for stage in STAGES:
                fn = libs[f"stage {stage}"].rdst_histogram
                fn.argtypes = [vp, i32, i32, i32, ll, vp, i32, vp]

                def call():
                    err = fn(ptrs(w), 2, 0, 8, n, out.data_ptr(), grid,
                             _build.stream_of(out))
                    if err:
                        raise RuntimeError(f"stage {stage}: CUDA error {err}")
                ms = cuda_ms(torch, call, args.reps)
                row.append(ms)
                print(f"ablation [{kind}, 2^25 x 2, 8 levels, grid {grid}] stage "
                      f"{stage} ({STAGES[stage]}): {ms:.4f} ms; bound {bound:.4f} ms")
            if kind == "uniform":
                torch.cuda.synchronize()
                if not torch.equal(out, H.histogram_plain(w, 8)):
                    raise AssertionError("the whole ablation kernel differs from the plain version")
            steps = [row[0]] + [b - a for a, b in zip(row, row[1:])]
            print(f"ablation split [{kind}]: " + "; ".join(
                f"{s} {x:+.4f} ms" for s, x in zip(STAGES, steps)))
            del w
    if not args.no_variants:
        # yardsticks: a PyTorch reduction reading the bytes of 2^25 x 2
        # words, and a one-element PyTorch op (a launch and nothing else),
        # each 20 times back to back
        both = torch.rand(2 * n, device=dev, generator=gen)
        one = torch.zeros(1, device=dev)
        for label, op, moved in (("torch.sum over 2^26 float32", both.sum, 8 * n),
                                 ("a one-element add_", lambda: one.add_(1), 0)):
            def twenty():
                for _ in range(20):
                    op()
            ms = cuda_ms(torch, twenty, args.reps) / 20
            print(f"yardstick: {label}, back to back: {ms:.4f} ms"
                  + (f" ({moved / ms / 1e9:.3f} TB/s)" if moved else ""))
        del both, one
        cases = [(kind, 2, 8, 0, n) for kind in ("uniform", "presorted", "equal", "zipf")]
        cases += [("uniform", 1, 1, 2, n), ("uniform", 2, 8, 0, 1 << 10)]
        for kind, nw, nl, l0, n in cases:
            w = keys_of(torch, P, kind, n, nw, gen, dev)
            want = H.histogram_plain(w, nl, l0)
            bound = (4 * nw * n + 8 * want.numel()) / HBM * 1e3
            for name, (_, exact) in VARIANTS.items():
                fn = libs[name].rdst_histogram
                fn.argtypes = [vp, i32, i32, i32, ll, vp, vp, i32, vp]
                work = torch.zeros(H._WORK_WORDS, dtype=torch.int64, device=dev)
                out = torch.empty_like(want)

                def call():
                    err = fn(ptrs(w), nw, l0, nl, n, out.data_ptr(), work.data_ptr(),
                             sms, _build.stream_of(out))
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                ms = cuda_ms(torch, call, args.reps)
                if exact and not torch.equal(out, want):
                    raise AssertionError(f"variant {name} [{kind}] differs from the plain version")

                def twenty():
                    for _ in range(20):
                        call()
                dev_ms = cuda_ms(torch, twenty, args.reps) / 20
                print(f"variant [{kind}, 2^{n.bit_length() - 1} x {nw}, {nl} level(s)] "
                      f"{name}: {ms:.4f} ms, back to back {dev_ms:.4f} ms "
                      f"({bound / dev_ms:.1%} of the bound {bound:.4f} ms)")
            del w, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
