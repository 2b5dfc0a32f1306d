#!/usr/bin/env python3
"""Kernels of this checkout against another build of them, on one CUDA card.

    python3 scripts/torch_bitonic_ab.py --parent DIR [--reps 5] [--no-sorts]
                                        [--kernels B5,B6] [--sorter]
    python3 scripts/torch_bitonic_ab.py --sizing

DIR is an unpacked checkout of the commit to compare with (``git archive``
of the parent commit, in a directory that .gitignore lists).  Two parts:

  kernels  DIR's csrc sources build into a library of their own, called
           through DIR's C interfaces: B2/B3 through the plan interface of
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
           sizes.  Bound: bytes read once and written once at 3.35 TB/s.
  sorts    each tree in turn, parent, this, this, parent:
           ``scripts/torch_shuffle_stages.py`` (the stable 2^28 shuffle over 8
           shards: warm time and stage split, and the overlapped run's B4/B5
           time) and ``scripts/torch_regions_stages.py`` (the 2^30 Regions
           sort: chunk sorts, each merge's B4/B5 launches and time, copies),
           both this tree's scripts run on DIR's package with ``--root``;
           with ``--sorter`` also ``Sorter.run`` on 2^25 uniform u64 keys
           already on the card (device time under torch.profiler, B2 and B3
           totals), each tree in a process of its own.

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
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM = 3.35e12  # bytes/s, NVIDIA H100 SXM data sheet
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


def build_parent(parent: Path, bitonic: bool) -> ctypes.CDLL:
    """DIR's merge.cu, exchange.cu and util.cu (and bitonic.cu when B2/B3
    are compared) as one library."""
    from rdst_tpu_torch import _build

    csrc = parent / "rdst_tpu_torch" / "csrc"
    names = ["merge.cu", "exchange.cu", "util.cu"] + (["bitonic.cu"] if bitonic else [])
    out = ROOT / "build" / "parent_kernels.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(out),
                    *[str(csrc / f) for f in names]], check=True)
    lib = ctypes.CDLL(str(out))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if bitonic:
        from rdst_tpu_torch.ops import fused_sort as fs

        lib.rdst_bitonic_tail.argtypes = fs.TAIL.argtypes
        lib.rdst_bitonic_span.argtypes = fs.SPAN.argtypes
        lib.rdst_bitonic_tail.restype = lib.rdst_bitonic_span.restype = i
    lib.rdst_merge_tail.argtypes = [vp, vp, vp, i, i, ll, i, vp]
    lib.rdst_remote_exchange.argtypes = [vp, vp, vp, vp, vp, i, ll, ll, vp, vp]
    lib.rdst_merge_tail.restype = lib.rdst_remote_exchange.restype = i
    return lib


def compare(torch, P, label, fns, want, bound, reps):
    """``fns``: (name, fn) pairs, parents first; each output must equal
    ``want``; timed in turns, parents, these, these, parents."""
    for name, fn in fns:
        got = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(P.sview(a), P.sview(b)) for a, b in zip(got, want)):
            raise AssertionError(f"{name} [{label}] differs from the plain version")
    order = fns + fns[::-1]
    t = {}
    for name, fn in order:
        t.setdefault(name, []).append(cuda_ms(torch, fn, reps))
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

    lib = build_parent(parent, bool(which & {"B2", "B3"}))
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
    if "B6" in which:
        exchange_ab(torch, P, lib, dev, gen, reps)


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
    """In a tree's own process: Sorter.run on 2^25 u64 keys on the card."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rdst_tpu_torch import keys
    from rdst_tpu_torch.ops import fused_sort as fs
    from rdst_tpu_torch.sorter import Sorter

    x = np.random.default_rng(SEED).integers(0, 2**64, size=1 << 25, dtype=np.uint64)
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


def sorts(parent: Path, reps: int, sorter: bool) -> None:
    env = dict(os.environ)
    if sorter:
        for tree in (parent, ROOT, ROOT, parent):
            env["PYTHONPATH"] = str(tree)
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--sorter-run", "--reps", str(reps)], cwd=tree, env=env,
                           check=True)
    for script, keep in (("torch_shuffle_stages.py", ("warm", "overlapped", "profiled")),
                         ("torch_regions_stages.py", ("call", "  ", "split"))):
        for tree in (parent, ROOT, ROOT, parent):
            res = subprocess.run(
                [sys.executable, str(ROOT / "scripts" / script), "--root", str(tree)],
                cwd=tree, capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"{script} [{tree}] failed:\n{res.stderr[-4000:]}")
            lines = [ln for ln in res.stdout.splitlines() if ln.startswith(keep)
                     or "tail_kernel" in ln or "span_kernel" in ln
                     or "merge_stage_kernel" in ln]
            print(f"{script} [{tree.name}]:\n  " + "\n  ".join(lines))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="unpacked checkout to compare with")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-sorts", action="store_true", help="the kernels part only")
    ap.add_argument("--kernels", default="B5,B6",
                    help="kernels to compare, of B2, B3, B5, B6")
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
        sorts(args.parent.resolve(), args.reps, args.sorter)
    return 0


if __name__ == "__main__":
    sys.exit(main())
