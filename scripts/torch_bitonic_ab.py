#!/usr/bin/env python3
"""Kernels of this checkout against another build of them, on one CUDA card.

    python3 scripts/torch_bitonic_ab.py --parent DIR [--reps 5] [--no-sorts]
                                        [--kernels B5,B6] [--sorter]
                                        [--stages shuffle,regions]
    python3 scripts/torch_bitonic_ab.py --sizing

DIR is an unpacked checkout of the commit to compare with (``git archive``
of the parent commit, in a directory that .gitignore lists).  Two parts:

  kernels  DIR's csrc sources build into a library of their own, called
           through DIR's C interfaces: B1 through ``rdst_histogram`` (DIR's
           grid of 4 blocks per SM; both trees' C interfaces called alike,
           one call per timing and 20 back to back, and this tree's Python
           wrapper beside them) at 2^25 x 2 words, 8 levels, on uniform,
           presorted, all-equal and Zipf keys, at 2^30 x 2 and at 10M x 1
           word, 4 levels, and B1' (2^25 x 1 word, one level) with
           ``torch.bincount`` of the byte plane timed after each turn (a
           yardstick neither tree calls); B2/B3 through the plan interface of
           ``rdst_bitonic_tail`` / ``rdst_bitonic_span`` (DIR from the
           B2/B3 redesign on), B5 through ``rdst_merge_tail`` (its
           shared-memory kernel, at DIR's two-CTA block and at this tree's
           block) and B6 through ``rdst_remote_exchange`` of one sender and
           plane (DIR's wrapper: a pad fill of the receive buffers, then one
           launch per sender and plane).  At each shape both builds take the
           same planes and arguments, in turns parent, this, this, parent
           (CUDA events, median of REPS per turn), and both outputs must
           equal the plain version's bit for bit (B6: buffers, pads, demand
           and arrivals).  B6 is timed as a wrapper and as its launches
           alone, at the sizes the stable 2^28 shuffle sends (recorded from
           one run of it), with one and three planes, and at even aligned
           sizes.  Bound: bytes read once and written once at the HBM rate
           of ``benchmark/peaks.json`` (3.35 TB/s).
  sorts    each tree in turn, parent, this, this, parent, the scripts
           ``--stages`` names: ``scripts/torch_shuffle_stages.py`` (the
           stable 2^28 shuffle over 8 shards, sequential and overlapped)
           and ``scripts/torch_regions_stages.py`` (the 2^30 Regions sort),
           each with its warm time and its split by the port's spans and
           kernels, both this tree's scripts run on DIR's package with
           ``--root``;
           with ``--sorter`` also ``Sorter.run`` on 2^25 uniform u64 keys
           already on the card (device time under torch.profiler, B2 and B3
           totals) and on sorted 2^25 u64 keys (keys whose every byte level
           is nondecreasing, which take the AlreadySorted short circuit, and
           uniform keys sorted), each tree in a process of its own.

``--sizing`` times this tree's ``fused_sort`` at the main paths' shapes
(2^25 u64 keys; 2^25 u64 keys + u32 payload, stable: 4 planes; the
shuffle's finish sort, 1.5 x 2^25 rows of validity + u64 key + payload,
stable: 5 planes on the piece path) under each B2/B3 block rule, in turns:
``config.bitonic_smem_bytes`` of 227 KB (one CTA per SM: blocks of 2^14,
2^13 and 2^12 elements at 2, 4 and 5 planes) and of half that less 1 KB
(two CTAs per SM: 2^13, 2^12 and 2^12).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM = json.loads((ROOT / "benchmark" / "peaks.json").read_text())["hbm_bytes_per_s"]
SEED = 20261016
PAD = 0xFFFFFFFF

# (kernel, label, n, plane count, n_keys, args): tail args (block, levels,
# unflip_shift), span args (s_hi, s_lo, two_r, block), merge tail args
# (DIR's block, this tree's block)
SHAPES = [
    ("B2", "2^25 x 2, trip 1, block 16384 (levels 13-14), un-flip", 1 << 25, 2, 2,
     (16384, [(13, 4096), (14, 8192)], 12)),
    ("B3", "2^25 x 2, P=128, block 16384", 1 << 25, 2, 2,
     (1 << 24, 1 << 18, 1 << 25, 16384)),
    ("B2", "2^25 x 5, trip 1, block 4096, un-flip", 1 << 25, 5, 4,
     (4096, [(12, 2048)], 11)),
    ("B3", "2^25 x 5, P=32, block 4096", 1 << 25, 5, 4,
     (1 << 24, 1 << 20, 1 << 25, 4096)),
    ("B5", "2^25 x 4 (3 keys), the chunked path's merge", 1 << 25, 4, 3,
     (4096, 8192)),
    ("B5", "2^27 x 5 (4 keys), the overlapped shuffle's merge", 1 << 27, 5, 4,
     (4096, 4096)),
    ("B5", "2^25 x 2 (1 key)", 1 << 25, 2, 1, (8192, 16384)),
]


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


def build_parent(parent: Path, which: set[str]) -> ctypes.CDLL:
    """DIR's sources of the kernels in ``which`` and util.cu as one library,
    with the C interfaces this script calls bound: B1 ``rdst_histogram``,
    B2/B3 the plan interface, B5 ``rdst_merge_tail`` and B6
    ``rdst_remote_exchange`` (the last two as they stood before the B5/B6
    redesign)."""
    from rdst_tpu_torch import _build

    csrc = parent / "rdst_tpu_torch" / "csrc"
    sources = {"B1": "histogram.cu", "B2": "bitonic.cu", "B3": "bitonic.cu",
               "B5": "merge.cu", "B6": "exchange.cu"}
    names = sorted({sources[k] for k in which}) + ["util.cu"]
    out = ROOT / "build" / "parent_kernels.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(out),
                    *[str(csrc / f) for f in names]], check=True)
    lib = ctypes.CDLL(str(out))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    binds = []
    if which & {"B2", "B3"}:
        from rdst_tpu_torch.ops import fused_sort as fs

        binds += [("rdst_bitonic_tail", fs.TAIL.argtypes),
                  ("rdst_bitonic_span", fs.SPAN.argtypes)]
    if "B1" in which:
        binds.append(("rdst_histogram", [vp, i, i, i, ll, vp, i, vp]))
    if "B5" in which:
        binds.append(("rdst_merge_tail", [vp, vp, vp, i, i, ll, i, vp]))
    if "B6" in which:
        binds.append(("rdst_remote_exchange", [vp, vp, vp, vp, vp, i, ll, ll, vp, vp]))
    for symbol, argtypes in binds:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = i
    return lib


def compare(torch, P, label, fns, want, bound, reps, batch=1):
    """``fns``: (name, fn) pairs, parents first; each output must equal
    ``want``; timed in turns, parents, these, these, parents; with
    ``batch``, the mean of that many calls back to back per timing."""
    for name, fn in fns:
        got = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(P.sview(a), P.sview(b)) for a, b in zip(got, want)):
            raise AssertionError(f"{name} [{label}] differs from the plain version")
    order = fns + fns[::-1]
    t = {}
    for name, fn in order:
        def many(fn=fn):
            for _ in range(batch):
                fn()
        t.setdefault(name, []).append(cuda_ms(torch, many, reps) / batch)
    print(f"{label}: " + "; ".join(
        f"{name} {' / '.join(f'{x:.4f}' for x in ts)} ms "
        f"({bound / statistics.mean(ts):.1%} of the bound)" for name, ts in t.items())
        + f"; bound {bound:.4f} ms")


def kernels(parent: Path, reps: int, which: set[str]) -> None:
    import torch
    from rdst_tpu_torch import _build
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch.ops import fused_merge as fm
    from rdst_tpu_torch.ops import fused_sort as fs

    lib = build_parent(parent, which)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def check(err, name):
        if err:
            raise RuntimeError(f"parent {name}: CUDA error {err}")

    def parent_call(kind, planes, n, nk, args):
        outs, ins_a, outs_a, widths = fs._plane_ptrs(planes)
        stream = _build.stream_of(planes[0])
        if kind == "B2":
            block, levels, unflip = args
            net, flip = fs._tail_net(levels, unflip, block)
            check(lib.rdst_bitonic_tail(
                ins_a, outs_a, widths, len(planes), nk, n, block,
                *fs._plan_args(block, len(planes), net, flip), stream), kind)
        elif kind == "B3":
            s_hi, s_lo, two_r, block = args
            L = fs._log2(block)
            net = [(-1 - fs._log2(two_r // (2 * s_hi)),
                    list(range(L - 1, L - 1 - fs._log2(2 * s_hi // s_lo), -1)))]
            check(lib.rdst_bitonic_span(
                ins_a, outs_a, widths, len(planes), nk, n, s_hi, s_lo, block,
                *fs._plan_args(block, len(planes), net), stream), kind)
        else:
            check(lib.rdst_merge_tail(ins_a, outs_a, widths, len(planes), nk, n,
                                      args, stream), kind)
        return outs

    for kind, label, n, k, nk, args in SHAPES:
        if kind not in which:
            continue
        planes = [P.narrow(torch.randint(0, 1 << 32, (n,), generator=gen, device=dev,
                                         dtype=torch.int64), torch.uint32)
                  for _ in range(k)]
        bound = 2 * 4 * k * n / HBM * 1e3
        if kind == "B2":
            fns = [("parent", lambda: parent_call(kind, planes, n, nk, args)),
                   ("this", lambda: fs.tail_cuda(planes, n, args[0], nk, *args[1:]))]
            want = fs.tail_plain(planes, n, args[0], nk, args[1], args[2])
            compare(torch, P, f"{kind} [{label}]", fns, want, bound, reps)
        elif kind == "B3":
            fns = [("parent", lambda: parent_call(kind, planes, n, nk, args)),
                   ("this", lambda: fs.span_cuda(planes, n, *args, nk))]
            want = fs.span_plain(planes, n, *args, nk)
            compare(torch, P, f"{kind} [{label}]", fns, want, bound, reps)
        else:  # B5 at DIR's block and this tree's, both builds at both
            blocks = sorted(set(args))
            for blk in blocks:
                want = fm.merge_tail_plain(planes, n, blk, nk)
                fns = [(f"parent (block {blk})",
                        lambda b=blk: parent_call(kind, planes, n, nk, b)),
                       (f"this (block {blk})",
                        lambda b=blk: fm.merge_tail_cuda(planes, n, b, nk))]
                compare(torch, P, f"{kind} [{label}], block {blk} (parent's own "
                        f"{args[0]}, this tree's {args[1]})", fns, want, bound, reps)
                del want
        del planes
        torch.cuda.empty_cache()
    if "B1" in which:
        histogram_ab(torch, P, lib, dev, gen, reps)
    if "B6" in which:
        exchange_ab(torch, P, lib, dev, gen, reps)


def histogram_ab(torch, P, lib, dev, gen, reps):
    """B1 and B1' of both builds on the same planes, in turns."""
    from rdst_tpu_torch import _build
    from rdst_tpu_torch.ops import histogram as H

    def u32(n):
        return P.narrow(torch.randint(0, 1 << 32, (n,), generator=gen, device=dev,
                                      dtype=torch.int64), torch.uint32)

    def planes(kind, n, nw):
        if kind == "uniform":
            return [u32(n) for _ in range(nw)]
        if kind == "equal":
            return [P.full(n, 0x01020304 + k, torch.uint32, dev) for k in range(nw)]
        if kind == "zipf":  # 2^20 distinct random keys at Zipf(1.1) frequencies
            rank = torch.arange(1, (1 << 20) + 1, device=dev, dtype=torch.float64) ** -1.1
            pick = torch.multinomial(rank, n, replacement=True, generator=gen)
            return [P.take(u32(1 << 20), pick) for _ in range(nw)]
        key = torch.sort(torch.randint(0, 1 << 62, (n,), generator=gen, device=dev)).values
        return [P.narrow(key >> 32, torch.uint32), P.narrow(key & 0xFFFFFFFF, torch.uint32)]

    # both builds through their C interfaces, each call as its wrapper makes
    # it (output buffer, pointer table; the parent's grid of 4 blocks of
    # 512 threads per SM, this tree's workspace), without the Python checks
    this_fn = _build.library().rdst_histogram
    this_fn.argtypes = H.HISTOGRAM.argtypes
    this_fn.restype = ctypes.c_int
    sms = _build.sm_count(dev)

    def parent(w, nl, l0):
        n = int(w[0].shape[0])
        out = torch.empty(nl * H.RADIX + nl + 1, dtype=torch.int64, device=dev)
        grid = max(1, min(-(-n // 512), sms * 4))
        ptrs = (ctypes.c_void_p * H.MAX_WORDS)(*[x.data_ptr() for x in w])
        err = lib.rdst_histogram(ptrs, len(w), l0, nl, n, out.data_ptr(), grid,
                                 _build.stream_of(out))
        if err:
            raise RuntimeError(f"parent B1: CUDA error {err}")
        return [out]

    def this(w, nl, l0):
        n = int(w[0].shape[0])
        out = torch.empty(nl * H.RADIX + nl + 1, dtype=torch.int64, device=dev)
        ptrs = (ctypes.c_void_p * H.MAX_WORDS)(*[x.data_ptr() for x in w])
        stream = _build.stream_of(out)
        err = this_fn(ptrs, len(w), l0, nl, n, out.data_ptr(),
                      H._workspace(dev, stream).data_ptr(), sms, stream)
        if err:
            raise RuntimeError(f"B1: CUDA error {err}")
        return [out]

    cases = [(f"2^25 x 2 words, 8 levels, {kind}", kind, 1 << 25, 2, 8, 0)
             for kind in ("uniform", "presorted", "equal", "zipf")]
    cases += [("B1' 2^25 x 1 word, level 2", "uniform", 1 << 25, 1, 1, 2),
              ("2^30 x 2 words, 8 levels, uniform", "uniform", 1 << 30, 2, 8, 0),
              ("10M x 1 word, 4 levels, uniform", "uniform", 10_000_000, 1, 4, 0)]
    for label, kind, n, nw, nl, l0 in cases:
        w = planes(kind, n, nw)
        want = [H.histogram_plain(w, nl, l0)]
        bound = (4 * nw * n + 8 * want[0].numel()) / HBM * 1e3
        fns = [("parent", lambda: parent(w, nl, l0)), ("this", lambda: this(w, nl, l0))]
        compare(torch, P, f"B1 [{label}], one call", fns, want, bound, reps)
        compare(torch, P, f"B1 [{label}], 20 calls back to back", fns, want, bound,
                reps, batch=20)
        wrap = cuda_ms(torch, lambda: H.histogram_cuda(w, nl, l0), reps)
        print(f"B1 [{label}]: this tree's wrapper histogram_cuda, one call {wrap:.4f} ms")
        if nl == 1:
            byte_plane = (P.widen(w[0]) >> (8 * l0)) & 0xFF
            lib_ms = cuda_ms(torch, lambda: torch.bincount(byte_plane, minlength=256), reps)
            print(f"B1 [{label}]: torch.bincount of the byte plane {lib_ms:.4f} ms "
                  "(library yardstick)")
            del byte_plane
        del w, want
        torch.cuda.empty_cache()


def exchange_ab(torch, P, lib, dev, gen, reps, D=8, nl=1 << 25):
    """B6 of both builds at the sizes the stable 2^28 shuffle sends (one
    recorded run of it), with one and three planes, and at even aligned
    sizes: as wrappers, and as launches alone on buffers made beforehand."""
    from rdst_tpu_torch import _build
    from rdst_tpu_torch import parallel as par
    from rdst_tpu_torch.parallel import remote_dma as rd

    def u32(n):
        return P.narrow(torch.randint(0, 1 << 32, (n,), generator=gen, device=dev,
                                      dtype=torch.int64), torch.uint32)

    recorded = []
    real = rd.remote_dma_exchange_cuda

    def recorder(planes, offs, sizes, capacity):
        if not recorded:
            recorded.append(([o.clone() for o in offs], [z.clone() for z in sizes],
                             capacity))
        return real(planes, offs, sizes, capacity)

    hi, lo = u32(D * nl), u32(D * nl)
    rd.remote_dma_exchange_cuda = recorder
    try:
        par.distributed_sort([hi, lo], [P.arange(D * nl, torch.uint32, dev)],
                             mesh=par.make_mesh(D, device=dev), stable=True)
    finally:
        rd.remote_dma_exchange_cuda = real
    del hi, lo
    torch.cuda.empty_cache()
    offs, sizes, cap = recorded[0]
    seg = nl // D
    cases = [("the 2^28 shuffle's sizes, 1 plane", offs, sizes, 1),
             ("the 2^28 shuffle's sizes, 3 planes", offs, sizes, 3),
             (f"even sizes of {seg} rows (aligned), 1 plane",
              [torch.arange(D, device=dev) * seg] * D,
              [torch.full((D,), seg, dtype=torch.int64, device=dev)] * D, 1)]

    def parent_launches(src, so, sz, ro, recv, arrived):
        step = torch.arange(D, dtype=torch.int64, device=dev) * (cap * 4)
        stream = _build.stream_of(recv[0])
        for j, out in enumerate(recv):
            dst_ptr = step + out.data_ptr()
            for s in range(D):
                err = lib.rdst_remote_exchange(
                    src[s][j].data_ptr(), so[s].data_ptr(), sz[s].data_ptr(),
                    dst_ptr.data_ptr(), ro[s].data_ptr(), D,
                    min(int(src[s][j].shape[0]), cap), cap,
                    arrived[j].data_ptr(), stream)
                if err:
                    raise RuntimeError(f"parent B6: CUDA error {err}")

    for label, co, cs, k in cases:
        src = [[u32(nl) for _ in range(k)] for _ in range(D)]
        so, sz = torch.stack(co), torch.stack(cs)
        lay = rd.exchange_layout(sz, cap)
        landed = int(lay.landed.sum())

        def parent_wrapper():
            l2 = rd.exchange_layout(sz, cap)
            recv = [P.full(D * cap, PAD, torch.uint32, dev) for _ in range(k)]
            arrived = torch.zeros((k, D), dtype=torch.int64, device=dev)
            parent_launches(src, so, sz, l2.recv_offsets, recv, arrived)
            return recv + [l2.demand, arrived]

        def this_wrapper():
            recv, demand, arrived = rd.remote_dma_exchange_cuda(src, co, cs, cap)
            return recv + [demand, arrived]

        recv, demand, arrived = rd.remote_dma_exchange_plain(src, co, cs, cap)
        want = recv + [demand, arrived]
        # the wrapper must write every receive word once and read each
        # landed word once
        bound = 4 * k * (landed + D * cap) / HBM * 1e3
        compare(torch, P, f"B6 wrapper [{label}]",
                [("parent", parent_wrapper), ("this", this_wrapper)], want, bound, reps)
        bufs = [P.full(D * cap, PAD, torch.uint32, dev) for _ in range(k)]
        arr = torch.zeros((k, D), dtype=torch.int64, device=dev)

        def parent_alone():
            parent_launches(src, so, sz, lay.recv_offsets, bufs, arr)
            return bufs

        def this_alone():
            rd.launch_all(src, so, sz, bufs, arr, cap)
            return bufs

        compare(torch, P, f"B6 launches alone [{label}] (parent: {D * k} launches "
                f"on pad-filled buffers; this: 1 launch, pads included)",
                [("parent", parent_alone), ("this", this_alone)], want[:k],
                bound, reps)
        del src, bufs, want, recv
        torch.cuda.empty_cache()


def sorter_run(reps: int) -> None:
    """In a tree's own process: Sorter.run on 2^25 u64 keys on the card,
    uniform, then sorted in two forms."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rdst_tpu_torch import keys
    from rdst_tpu_torch.ops import fused_sort as fs
    from rdst_tpu_torch.sorter import Sorter

    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 2**64, size=1 << 25, dtype=np.uint64)
    top = np.sort(rng.integers(0, 256, size=1 << 25, dtype=np.uint64))
    for label, xs in (("256 top-byte values, every level nondecreasing (AlreadySorted)",
                       (top << np.uint64(56)) | np.uint64(0x0001020304050607)),
                      ("uniform keys sorted", np.sort(x))):
        nks = keys.normalize(xs, device="cuda")
        Sorter().run(nks)
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda: Sorter().run(nks), reps)
        print(f"Sorter.run sorted 2^25 u64, {label} [{fs.__file__}]: {ms:.3f} ms "
              f"(CUDA events, median of {reps})")
        del nks
    nk = keys.normalize(x, device="cuda")
    sorter = Sorter()
    sorter.run(nk)
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: sorter.run(nk), reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sorter.run(nk)
        torch.cuda.synchronize()
    busy = tail = span = 0.0
    nt = ns = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        busy += e.self_device_time_total
        if "tail_kernel" in e.key:
            tail += e.self_device_time_total
            nt += e.count
        elif "span_kernel" in e.key:
            span += e.self_device_time_total
            ns += e.count
    print(f"Sorter.run 2^25 u64 [{fs.__file__}]: {ms:.3f} ms (CUDA events, median "
          f"of {reps}); device time over kernels {busy / 1e3:.3f} ms, B2 "
          f"{tail / 1e3:.3f} ms in {nt} launches, B3 {span / 1e3:.3f} ms in {ns}")


def sizing(reps: int) -> None:
    import torch
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch import config
    from rdst_tpu_torch.ops import fused_sort as fs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def u32(n):
        return P.narrow(torch.randint(0, 1 << 32, (n,), generator=gen, device=dev,
                                      dtype=torch.int64), torch.uint32)

    n, m = 1 << 25, 3 << 24
    valid = P.narrow((torch.arange(m, device=dev) >= m - m // 40).to(torch.int64),
                     torch.uint32)  # the finish sort's pads: 2.5% of the buffer
    cases = [
        ("2^25 u64 keys (2 planes)", [u32(n), u32(n)], [], False),
        ("2^25 u64 keys + u32 payload, stable (4 planes)", [u32(n), u32(n)], [u32(n)], True),
        ("1.5 x 2^25 validity + u64 key + payload, stable (5 planes, pieces)",
         [valid, u32(m), u32(m)], [u32(m)], True),
    ]
    rules = {"one CTA per SM": 227 * 1024, "two CTAs per SM": (227 * 1024) // 2 - 1024}
    old = config.bitonic_smem_bytes
    try:
        for label, words, pays, stable in cases:
            k = len(words) + len(pays) + stable
            t, blk = {}, {}
            for rule in list(rules) + list(rules)[::-1]:
                config.bitonic_smem_bytes = rules[rule]
                blk[rule] = fs.pick_blocks(k)[0]
                t.setdefault(rule, []).append(cuda_ms(
                    torch, lambda: fs.fused_sort(words, pays, stable=stable), reps))
            print(f"fused_sort [{label}]: " + "; ".join(
                f"{rule} (block {blk[rule]}) "
                f"{' / '.join(f'{x:.3f}' for x in t[rule])} ms" for rule in rules))
    finally:
        config.bitonic_smem_bytes = old


def sorts(parent: Path, reps: int, sorter: bool, stages: set[str]) -> None:
    env = dict(os.environ)
    if sorter:
        for tree in (parent, ROOT, ROOT, parent):
            env["PYTHONPATH"] = str(tree)
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--sorter-run", "--reps", str(reps)], cwd=tree, env=env,
                           check=True)
    for script in ("torch_shuffle_stages.py", "torch_regions_stages.py"):
        if script.split("_")[1] not in stages:
            continue
        for tree in (parent, ROOT, ROOT, parent):
            res = subprocess.run(
                [sys.executable, str(ROOT / "scripts" / script), "--root", str(tree)],
                cwd=tree, capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"{script} [{tree}] failed:\n{res.stderr[-4000:]}")
            print(f"{script} [{tree.name}]:\n{res.stdout}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="unpacked checkout to compare with")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-sorts", action="store_true", help="the kernels part only")
    ap.add_argument("--kernels", default="B5,B6",
                    help="kernels to compare, of B1, B2, B3, B5, B6")
    ap.add_argument("--stages", default="shuffle,regions",
                    help="stage scripts to run on both trees, of shuffle, regions")
    ap.add_argument("--sorter", action="store_true",
                    help="also Sorter.run of both trees")
    ap.add_argument("--sizing", action="store_true",
                    help="time fused_sort under each B2/B3 block rule")
    ap.add_argument("--sorter-run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_bitonic_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.sorter_run:
        sorter_run(args.reps)
        return 0
    sys.path.insert(0, str(ROOT))
    if args.sizing:
        sizing(args.reps)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    kernels(args.parent.resolve(), args.reps, set(args.kernels.split(",")))
    if not args.no_sorts:
        sorts(args.parent.resolve(), args.reps, args.sorter, set(args.stages.split(",")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
