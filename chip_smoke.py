#!/usr/bin/env python3
"""Drive the PyTorch port (rdst_tpu_torch) on one CUDA card and check it.

Run from the checkout root:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card as nvidia-smi names it, and the kernel build;
  2. every kernel of the sort path against its plain PyTorch version on the
     card, at the shapes the path gives it, bit for bit, with times from
     CUDA events (median of a few runs);
  3. the sort path end to end through the public API: 2^25 uniform u64
     keys, a 10,000,000-pair stable u32 key-value sort (a length that takes
     the piece path) and 2^22 f64 keys with +-NaN, +-0 and +-Inf, each
     bit-equal to numpy, with every kernel's launch count from that run;
  4. one JSON line of the kernels, then the result line.

Exits non-zero, printing no result, when CUDA is absent, when the package is
not importable, or when any check fails.  Needs one card; uses no JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
REPS = 5

# (kernel name, source, the Pallas call it replaces)
KERNEL_INFO = {
    "multi_level_histogram": (
        "rdst_tpu_torch/csrc/histogram.cu", "rdst_tpu/ops/histogram.py:180"),
    "bitonic_tail": (
        "rdst_tpu_torch/csrc/bitonic.cu", "rdst_tpu/ops/pallas_sort.py:267"),
    "bitonic_span": (
        "rdst_tpu_torch/csrc/bitonic.cu", "rdst_tpu/ops/pallas_sort.py:327"),
}


def cuda_ms(torch, fn) -> float:
    """Median of REPS timed runs (CUDA events) after one warm-up run."""
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import rdst_tpu_torch as rt
        from rdst_tpu_torch import _build
        from rdst_tpu_torch import _planes as P
        from rdst_tpu_torch import config
        from rdst_tpu_torch.ops import fused_sort as fs
        from rdst_tpu_torch.ops import histogram as H
    except ImportError as e:
        print(f"chip_smoke: rdst_tpu_torch is not importable: {e}",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    _build.library()
    print(f"kernels built and loaded in {_build.build_seconds:.2f} s")

    def planes_u32(n, k, high=1 << 32):
        return [
            P.narrow(torch.randint(0, high, (n,), generator=gen, device=dev,
                                   dtype=torch.int64), torch.uint32)
            for _ in range(k)
        ]

    def planes_of(n, dtypes, high=None):
        out = []
        for dt in dtypes:
            top = P.all_ones(dt) + 1 if high is None else high
            v = torch.randint(0, top, (n,), generator=gen, device=dev,
                              dtype=torch.int64)
            out.append(P.narrow(v, dt))
        return out

    def max_err(a, b) -> int:
        if isinstance(a, torch.Tensor):
            a, b = [a], [b]
        err = 0
        for x, y in zip(a, b):
            if x.dtype != y.dtype or x.shape != y.shape:
                raise AssertionError(f"dtype/shape {x.dtype}{tuple(x.shape)} "
                                     f"vs {y.dtype}{tuple(y.shape)}")
            d = (P.widen(x) if x.dtype != torch.int64 else x) - (
                P.widen(y) if y.dtype != torch.int64 else y)
            err = max(err, int(d.abs().max().item()) if d.numel() else 0)
        return err

    # -- 2. kernels against their plain versions ------------------------------
    results = {name: {"max_abs_err": 0} for name in KERNEL_INFO}

    def check(name, label, kernel_fn, plain_fn, main_shape=False):
        got = kernel_fn()
        torch.cuda.synchronize()
        want = plain_fn()
        err = max_err(got, want)
        ms = cuda_ms(torch, kernel_fn)
        plain_ms = cuda_ms(torch, plain_fn)
        print(f"{name} [{label}]: max_abs_err={err} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if err != 0:
            raise AssertionError(f"{name} [{label}] disagrees with its plain "
                                 f"version (max_abs_err {err})")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main_shape:
            r["ms"], r["plain_ms"] = ms, plain_ms
        return got

    n = 1 << 25
    # B1: two u32 planes (a u64 key), all 8 byte levels
    w = planes_u32(n, 2)
    check("multi_level_histogram", "2^25 x 2 words, uniform",
          lambda: H.histogram_cuda(w, 8), lambda: H.histogram_plain(w, 8),
          main_shape=True)
    packed = torch.sort(torch.randint(0, 1 << 62, (n,), generator=gen,
                                      device=dev)).values
    ws = [P.narrow(packed >> 32, torch.uint32),
          P.narrow(packed & 0xFFFFFFFF, torch.uint32)]
    got = check("multi_level_histogram", "2^25 x 2 words, presorted",
                lambda: H.histogram_cuda(ws, 8),
                lambda: H.histogram_plain(ws, 8))
    res = H.unpack(got.cpu().numpy(), 8)
    if res.sorted_prefix != n or not res.level_sorted[7]:
        raise AssertionError("presorted input: prefix or top level unsorted")
    we = [P.full(n, 0x01020304, torch.uint32, dev)] * 2
    check("multi_level_histogram", "2^25 x 2 words, all equal",
          lambda: H.histogram_cuda(we, 8), lambda: H.histogram_plain(we, 8))
    wr = [p[: n - 12345] for p in w]
    check("multi_level_histogram", "2^25-12345 x 2 words, ragged",
          lambda: H.histogram_cuda(wr, 8), lambda: H.histogram_plain(wr, 8))
    check("multi_level_histogram", "level_histogram (one level)",
          lambda: H.histogram_cuda([w[1]], 1, 2),
          lambda: H.histogram_plain([w[1]], 1, 2))

    # B2: the u64 sort's trip 1 (block 8192, rows of 4096, un-flip), a
    # two-level trip 1, a single-level sweep, narrow planes, eight planes
    blk = fs.pick_blocks(2)[1]
    check("bitonic_tail", f"2^25 x 2, trip 1, block {blk}, un-flip",
          lambda: fs.tail_cuda(w, n, blk, 2, [(13, 4096)], 12),
          lambda: fs.tail_plain(w, n, blk, 2, [(13, 4096)], 12),
          main_shape=True)
    check("bitonic_tail", "2^25 x 2, two levels, un-flip",
          lambda: fs.tail_cuda(w, n, blk, 2, [(12, 2048), (13, 4096)], 11),
          lambda: fs.tail_plain(w, n, blk, 2, [(12, 2048), (13, 4096)], 11))
    check("bitonic_tail", "2^25 x 2, single level",
          lambda: fs.tail_cuda(w, n, blk, 2, [(21, blk // 2)], None),
          lambda: fs.tail_plain(w, n, blk, 2, [(21, blk // 2)], None))
    narrow = planes_of(1 << 24, [torch.uint16, torch.uint32, torch.uint8], 7)
    blk3 = fs.pick_blocks(3)[1]
    check("bitonic_tail", "2^24 u16+u32 keys, u8 rider",
          lambda: fs.tail_cuda(narrow, 1 << 24, blk3, 2,
                               [(12, 2048), (13, 4096)], 11),
          lambda: fs.tail_plain(narrow, 1 << 24, blk3, 2,
                                [(12, 2048), (13, 4096)], 11))
    eight = planes_of(1 << 22, [torch.uint32] * 8, 5)
    blk8 = fs.pick_blocks(8)[1]
    check("bitonic_tail", f"2^22 x 8 planes, block {blk8}",
          lambda: fs.tail_cuda(eight, 1 << 22, blk8, 3, [(20, blk8 // 2)], None),
          lambda: fs.tail_plain(eight, 1 << 22, blk8, 3,
                                [(20, blk8 // 2)], None))

    # B3: the u64 sort's span trips at P = 64, 8 and 2, narrow and 8 planes
    for s_hi, s_lo, two_r, main in [(1 << 24, 1 << 19, 1 << 25, True),
                                    (1 << 18, 1 << 13, 1 << 25, False),
                                    (1 << 15, 1 << 13, 1 << 16, False),
                                    (1 << 13, 1 << 13, 1 << 14, False)]:
        p_dim = 2 * s_hi // s_lo
        check("bitonic_span", f"2^25 x 2, P={p_dim}, s_hi=2^{s_hi.bit_length() - 1}",
              lambda: fs.span_cuda(w, n, s_hi, s_lo, two_r, blk, 2),
              lambda: fs.span_plain(w, n, s_hi, s_lo, two_r, blk, 2),
              main_shape=main)
    check("bitonic_span", "2^24 u16+u32 keys, u8 rider, P=16",
          lambda: fs.span_cuda(narrow, 1 << 24, 1 << 16, 1 << 13, 1 << 18,
                               blk3, 2),
          lambda: fs.span_plain(narrow, 1 << 24, 1 << 16, 1 << 13, 1 << 18,
                                blk3, 2))
    check("bitonic_span", "2^22 x 8 planes, P=16",
          lambda: fs.span_cuda(eight, 1 << 22, 1 << 14, 1 << 11, 1 << 16,
                               blk8, 3),
          lambda: fs.span_plain(eight, 1 << 22, 1 << 14, 1 << 11, 1 << 16,
                                blk8, 3))
    del w, ws, we, wr, narrow, eight, packed

    # -- 3. the sort path end to end -------------------------------------------
    rng = np.random.default_rng(SEED)
    x64 = rng.integers(0, 2**64, size=1 << 25, dtype=np.uint64)
    k32 = rng.integers(0, 2**32, size=10_000_000, dtype=np.uint32)
    v32 = rng.integers(0, 2**32, size=10_000_000, dtype=np.uint32)
    f64 = rng.standard_normal(1 << 22)
    specials = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf])
    at = rng.choice(f64.size, size=6 * 1000, replace=False)
    f64[at] = np.repeat(specials, 1000)
    f64_bits = f64.view(np.uint64).copy()
    f64_bits[at[:500]] |= np.uint64(0x3)  # NaN payload bits stay exact
    f64 = f64_bits.view(np.float64)

    for k in _build.KERNELS.values():
        k.launches = 0
    timings = {}

    def timed(label, n_keys, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        timings[label] = (dt, n_keys / dt)
        return out

    with config.work_profiles(True):  # prints each "(level) PLAN:" pick
        y64 = timed("u64 2^25", x64.size, lambda: rt.radix_sort_unstable(x64))
        ks, vs = timed("u32 key-value 10M stable", k32.size,
                       lambda: rt.sort_key_value(k32, v32, stable=True))
        yf = timed("f64 2^22 specials", f64.size,
                   lambda: rt.radix_sort_unstable(f64))
    launches = {name: _build.KERNELS[name].launches for name in KERNEL_INFO}

    if not np.array_equal(y64, np.sort(x64)):
        raise AssertionError("u64 2^25 sort differs from np.sort")
    order = np.argsort(k32, kind="stable")
    if not (np.array_equal(ks, k32[order]) and np.array_equal(vs, v32[order])):
        raise AssertionError("stable key-value sort differs from argsort")
    u = f64.view(np.uint64)
    folded = np.where(u >> np.uint64(63) == 1, ~u, u | np.uint64(1 << 63))
    want = f64[np.argsort(folded, kind="stable")]
    if not np.array_equal(yf.view(np.uint64), want.view(np.uint64)):
        raise AssertionError("f64 sort differs from the total-order oracle")
    for label, (dt, rate) in timings.items():
        print(f"sort {label}: bit-exact vs numpy, {dt:.4f} s, {rate:,.0f} keys/s "
              f"(host clock, numpy in and out)")
    dt = cuda_ms(torch, lambda: rt.radix_sort_unstable(x64))
    print(f"sort u64 2^25 warm: {dt:.2f} ms, {x64.size / dt * 1e3:,.0f} keys/s "
          f"(median of {REPS}, numpy in and out)")
    print(f"launches on the sort path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the sort path")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # -- 4. report -------------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
