#!/usr/bin/env python3
"""Drive the PyTorch port (rdst_tpu_torch) on one CUDA card and check it.

Run from the checkout root:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card as nvidia-smi names it, and the kernel build;
  2. every kernel of the sort path against its plain PyTorch version on the
     card, at the shapes the paths give it, bit for bit, with times from
     CUDA events (median of a few runs): B1-B3, and the merge kernels B4/B5
     at the chunked path's merge shape (2^25 x 4 planes) and others;
  3. the paths end to end through the public API, each driven with every
     launch count set to 0 just before it and read just after, each sorted
     bit-equal to numpy or to torch.sort, each printing its plan trace, time
     and rate:
       - 2^25 uniform u64 keys, a 10,000,000-pair stable u32 key-value sort
         (the piece path) and 2^22 f64 keys with +-NaN, +-0 and +-Inf;
       - the low-memory Regions path at the real gate: 2^30 int64 keys with
         int32 values on the card (12 GiB of planes, above the 10 GiB
         ``low_mem_threshold_bytes``), with its peak device memory;
       - 20M u64 keys with the low-memory tuner and the gate forced open;
       - a presorted merge of 2^25 u64 keys whose first 15/16 are sorted;
       - the bucketed MtOop plan on 16M u32 key-value pairs, uniform and
         with one key holding half the rows;
  4. one JSON line of the kernels, then the result line.

Exits non-zero, printing no result, when CUDA is absent, when the package is
not importable, or when any check fails.  Needs one card; uses no JAX.
"""
from __future__ import annotations

import contextlib
import io
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
    "merge_stage": (
        "rdst_tpu_torch/csrc/merge.cu", "rdst_tpu/ops/pallas_merge.py:208"),
    "merge_tail": (
        "rdst_tpu_torch/csrc/merge.cu", "rdst_tpu/ops/pallas_merge.py:232"),
}
GiB = 1 << 30


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


def plain_route(fm, fn):
    """Run ``fn`` with the merge wrappers routed to their plain versions:
    the same stage schedule on the same card, for a composite's check."""
    saved = fm.merge_stage_call, fm.merge_tail_call
    fm.merge_stage_call = lambda pl, n, s, k, in_place=False: \
        fm.merge_stage_plain(list(pl), n, s, k)
    fm.merge_tail_call = lambda pl, n, b, k, in_place=False: \
        fm.merge_tail_plain(list(pl), n, b, k)
    try:
        return fn()
    finally:
        fm.merge_stage_call, fm.merge_tail_call = saved


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
        from rdst_tpu_torch.ops import fused_merge as fm
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
        """``name``: a kernel, or a tuple of the kernels a composite runs."""
        got = kernel_fn()
        torch.cuda.synchronize()
        want = plain_fn()
        err = max_err(got, want)
        ms = cuda_ms(torch, kernel_fn)
        plain_ms = cuda_ms(torch, plain_fn)
        names = name if isinstance(name, tuple) else (name,)
        print(f"{'+'.join(names)} [{label}]: max_abs_err={err} kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if err != 0:
            raise AssertionError(f"{name} [{label}] disagrees with its plain "
                                 f"version (max_abs_err {err})")
        for nm in names:
            r = results[nm]
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

    # B4/B5 at the chunked path's merge shape: two u64 key words, the
    # stable tiebreak plane and a u32 rider; then narrow planes, a float32
    # rider (its bits), eight planes, and merge_level (many pairs per pass)
    z4 = planes_u32(n, 2, 1 << 20) + [P.arange(n, torch.uint32, dev)] + \
        planes_u32(n, 1)
    blk4 = fm.pick_block(4)
    for s_ in (1 << 24, 1 << 13):
        check("merge_stage", f"2^25 x 4, stride 2^{s_.bit_length() - 1}",
              lambda: fm.merge_stage_cuda(z4, n, s_, 3),
              lambda: fm.merge_stage_plain(z4, n, s_, 3),
              main_shape=s_ == 1 << 24)
    check("merge_tail", f"2^25 x 4, block {blk4}",
          lambda: fm.merge_tail_cuda(z4, n, blk4, 3),
          lambda: fm.merge_tail_plain(z4, n, blk4, 3), main_shape=True)
    del z4
    m24 = 1 << 24
    narrow = planes_of(m24, [torch.uint16, torch.uint32, torch.uint8], 7)
    blk3 = fm.pick_block(3)
    check("merge_stage", "2^24 u16+u32 keys, u8 rider, stride 2^20",
          lambda: fm.merge_stage_cuda(narrow, m24, 1 << 20, 2),
          lambda: fm.merge_stage_plain(narrow, m24, 1 << 20, 2))
    check("merge_tail", f"2^24 u16+u32 keys, u8 rider, block {blk3}",
          lambda: fm.merge_tail_cuda(narrow, m24, blk3, 2),
          lambda: fm.merge_tail_plain(narrow, m24, blk3, 2))
    f32 = [planes_u32(m24, 1, 1000)[0],
           torch.randn(m24, generator=gen, device=dev).view(torch.uint32)]
    check("merge_stage", "2^24 u32 key, float32 rider, stride 2^16",
          lambda: fm.merge_stage_cuda(f32, m24, 1 << 16, 1),
          lambda: fm.merge_stage_plain(f32, m24, 1 << 16, 1))
    check("merge_tail", "2^24 u32 key, float32 rider",
          lambda: fm.merge_tail_cuda(f32, m24, fm.pick_block(2), 1),
          lambda: fm.merge_tail_plain(f32, m24, fm.pick_block(2), 1))
    eight = planes_of(1 << 22, [torch.uint32] * 8, 5)
    blk8 = fm.pick_block(8)
    check("merge_stage", "2^22 x 8 planes, stride 2^21",
          lambda: fm.merge_stage_cuda(eight, 1 << 22, 1 << 21, 3),
          lambda: fm.merge_stage_plain(eight, 1 << 22, 1 << 21, 3))
    check("merge_tail", f"2^22 x 8 planes, block {blk8}",
          lambda: fm.merge_tail_cuda(eight, 1 << 22, blk8, 3),
          lambda: fm.merge_tail_plain(eight, 1 << 22, blk8, 3))
    del narrow, f32, eight
    # 32 sorted runs of 2^20: 16 pairs merge in every launch
    runs = torch.randint(0, 1 << 30, (n,), generator=gen, device=dev)
    runs = torch.sort(runs.view(-1, 1 << 20), dim=1).values.reshape(-1)
    lvl = [P.narrow(runs, torch.uint32), planes_u32(n, 1)[0]]
    del runs
    check(("merge_stage", "merge_tail"), "merge_level 2^25 x 2, runs of 2^20",
          lambda: fm.merge_level(lvl, 1 << 20, 1),
          lambda: plain_route(fm, lambda: fm.merge_level(lvl, 1 << 20, 1)))
    del lvl
    torch.cuda.empty_cache()

    # -- 3. the paths end to end ---------------------------------------------
    rng = np.random.default_rng(SEED)
    launches = {name: 0 for name in KERNEL_INFO}

    def drive(label, n_keys, fn, merges=False):
        """Run one path with every launch count set to 0 just before it and
        read just after; print its plan trace, time and rate."""
        for k in _build.KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        trace = io.StringIO()
        with config.work_profiles(True), contextlib.redirect_stdout(trace):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = {name: _build.KERNELS[name].launches for name in KERNEL_INFO}
        for name, c in counts.items():
            launches[name] += c
        plans = " | ".join(trace.getvalue().strip().splitlines())
        print(f"path {label}: {dt:.4f} s, {n_keys / dt:,.0f} keys/s; "
              f"plan: {plans}; launches {counts}")
        if merges and not (counts["merge_stage"] > 0 and counts["merge_tail"] > 0):
            raise AssertionError(f"path {label} merged without B4 and B5")
        return out, plans

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

    y64, _ = drive("u64 2^25 (numpy in and out)", x64.size,
                   lambda: rt.radix_sort_unstable(x64))
    (ks, vs), _ = drive("u32 key-value 10M stable", k32.size,
                        lambda: rt.sort_key_value(k32, v32, stable=True))
    yf, _ = drive("f64 2^22 specials", f64.size,
                  lambda: rt.radix_sort_unstable(f64))
    for name in ("multi_level_histogram", "bitonic_tail", "bitonic_span"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the sort path")
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
    print("sorts u64 2^25, u32 key-value 10M, f64 2^22: bit-exact vs numpy")
    dt = cuda_ms(torch, lambda: rt.radix_sort_unstable(x64))
    print(f"sort u64 2^25 warm: {dt:.2f} ms, {x64.size / dt * 1e3:,.0f} keys/s "
          f"(median of {REPS}, numpy in and out)")
    del y64, ks, vs, yf, k32, v32, f64, order, folded, want, u

    # the low-memory Regions path at the real gate: 2^30 int64 keys (39 bits
    # of entropy, so ~2^20 ties; the low bit set as the sign bit, so both
    # signs) and int32 values, made on the card
    n30 = 1 << 30
    keys = torch.empty(n30, dtype=torch.int64, device=dev).random_(generator=gen)
    keys >>= 24
    keys ^= keys << 63
    vals = torch.empty(n30, dtype=torch.int32, device=dev).random_(generator=gen)
    planes_gib = n30 * 12 / GiB
    print(f"regions 2^30: {planes_gib:.1f} GiB of planes, gate "
          f"{config.low_mem_threshold_bytes / GiB:.1f} GiB")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (ok_, (ov,)), plans = drive(
        "regions 2^30 int64 + int32, low-mem tuner, stable", n30,
        lambda: rt.radix_sort_builder(keys, [vals]).with_low_mem_tuner()
        .with_stable().sort(), merges=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"regions 2^30 peak device memory: {peak} B ({peak / GiB:.2f} GiB), "
          f"of which inputs {base} B ({base / GiB:.2f} GiB) held by the caller")
    if "PLAN: Regions" not in plans:
        raise AssertionError("the 2^30 low-memory sort did not pick Regions")
    ref_keys, ref_idx = torch.sort(keys, stable=True)
    if not torch.equal(ok_, ref_keys):
        raise AssertionError("regions 2^30 keys differ from torch.sort")
    del ref_keys
    if not torch.equal(ov, vals[ref_idx]):
        raise AssertionError("regions 2^30 values differ from the stable order")
    print("regions 2^30: bit-exact vs torch.sort(stable=True) and its gather")
    del keys, vals, ok_, ov, ref_idx
    torch.cuda.empty_cache()

    # the JAX package's acceptance shape: 20M u64, the gate forced open
    klm = rng.integers(0, 2**64, size=20_000_000, dtype=np.uint64)
    old_gate = config.low_mem_threshold_bytes
    config.low_mem_threshold_bytes = 1
    try:
        got, plans = drive(
            "lowmem 20M u64, gate forced", klm.size,
            lambda: rt.radix_sort_builder(klm).with_low_mem_tuner().sort(),
            merges=True)
    finally:
        config.low_mem_threshold_bytes = old_gate
    if "PLAN: Regions" not in plans or not np.array_equal(got, np.sort(klm)):
        raise AssertionError("lowmem 20M u64 differs from np.sort")
    print("lowmem 20M u64: bit-exact vs np.sort")
    del klm, got

    # a presorted merge: the first 15/16 sorted
    xp = rng.integers(0, 2**64, size=1 << 25, dtype=np.uint64)
    xp[: 15 * xp.size // 16] = np.sort(xp[: 15 * xp.size // 16])
    got, plans = drive("presorted 2^25 u64, 15/16 sorted", xp.size,
                       lambda: rt.radix_sort_unstable(xp), merges=True)
    if "PresortedMerge[" not in plans or not np.array_equal(got, np.sort(xp)):
        raise AssertionError("presorted 2^25 u64 differs from np.sort")
    print("presorted 2^25 u64: bit-exact vs np.sort")
    del xp, got

    # the bucketed MtOop plan, uniform and with one key on half the rows
    nb = 1 << 24
    for hot in (False, True):
        kb = rng.integers(0, 2**32, size=nb, dtype=np.uint32)
        if hot:
            kb[(kb >> 24) == 0x55] ^= np.uint32(1 << 24)  # top byte 0x55 pure
            kb[: nb // 2] = np.uint32(0x5555AAAA)
            rng.shuffle(kb)
        vb = rng.integers(0, 2**32, size=nb, dtype=np.uint32)
        (gk, (gv,)), plans = drive(
            f"bucketed MtOop 16M u32 key-value{' hot key' if hot else ''}",
            nb, lambda: rt.radix_sort_builder(kb, [vb])
            .with_algorithm(rt.Algorithm.MT_OOP).with_stable().sort())
        order = np.argsort(kb, kind="stable")
        if not (np.array_equal(gk, kb[order]) and np.array_equal(gv, vb[order])):
            raise AssertionError(f"bucketed (hot={hot}) differs from argsort")
        if "BatchedRows[" not in plans or hot != ("SingleKeySkip" in plans):
            raise AssertionError(f"bucketed (hot={hot}) plan: {plans}")
        print(f"bucketed 16M (hot={hot}): bit-exact vs numpy stable argsort")
    print(f"launches on the paths: {launches}")
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
