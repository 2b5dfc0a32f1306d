#!/usr/bin/env python3
"""B2/B3 of this checkout against another build of them, on one CUDA card.

    python3 scripts/torch_bitonic_ab.py --parent DIR [--reps 5] [--no-sorts]
    python3 scripts/torch_bitonic_ab.py --sizing

DIR is an unpacked checkout of the commit to compare with (``git archive``
of the parent commit, in a directory that .gitignore lists).  Two parts:

  kernels  DIR's csrc/bitonic.cu, bitonic.cuh and util.cu build into a
           library of their own, called through DIR's C interface (levels,
           starts and unflip_shift for the tail, log_ratio for the span, one
           CTA per tile).  At each shape both builds take the same planes and
           arguments, in turns parent, this, this, parent (CUDA events,
           median of REPS per turn), and both outputs must equal the plain
           version's bit for bit.  Bound: every plane read once and written
           once at 3.35 TB/s.
  sorts    each tree in a process of its own (the packages share a name), in
           turns parent, this, this, parent: ``Sorter.run`` on 2^25 uniform
           u64 keys already on the card (its kernels' device time under
           torch.profiler, with the B2 and B3 totals and launches), and then
           DIR's and this tree's ``scripts/torch_shuffle_stages.py`` (the
           stable 2^28 shuffle over 8 shards: warm time and stage split).

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

# (kernel, label, n, plane count, n_keys, args): tail args (block, levels,
# unflip_shift), span args (s_hi, s_lo, two_r, block)
SHAPES = [
    ("B2", "2^25 x 2, trip 1, block 8192, un-flip", 1 << 25, 2, 2,
     (8192, [(13, 4096)], 12)),
    ("B2", "2^25 x 2, trip 1, block 16384 (levels 13-14), un-flip", 1 << 25, 2, 2,
     (16384, [(13, 4096), (14, 8192)], 12)),
    ("B2", "2^25 x 2, single level, block 16384", 1 << 25, 2, 2,
     (16384, [(21, 8192)], None)),
    ("B3", "2^25 x 2, P=64, block 8192", 1 << 25, 2, 2,
     (1 << 24, 1 << 19, 1 << 25, 8192)),
    ("B3", "2^25 x 2, P=128, block 16384", 1 << 25, 2, 2,
     (1 << 24, 1 << 18, 1 << 25, 16384)),
    ("B2", "2^25 x 4, trip 1, block 4096, un-flip", 1 << 25, 4, 3,
     (4096, [(12, 2048)], 11)),
    ("B2", "2^25 x 4, trip 1, block 8192, un-flip", 1 << 25, 4, 3,
     (8192, [(13, 4096)], 12)),
    ("B3", "2^25 x 4, P=32, block 4096", 1 << 25, 4, 3,
     (1 << 24, 1 << 20, 1 << 25, 4096)),
    ("B3", "2^25 x 4, P=64, block 8192", 1 << 25, 4, 3,
     (1 << 24, 1 << 19, 1 << 25, 8192)),
    ("B2", "2^25 x 5, trip 1, block 4096, un-flip", 1 << 25, 5, 4,
     (4096, [(12, 2048)], 11)),
    ("B3", "2^25 x 5, P=32, block 4096", 1 << 25, 5, 4,
     (1 << 24, 1 << 20, 1 << 25, 4096)),
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


def build_parent(parent: Path) -> ctypes.CDLL:
    """DIR's bitonic.cu (with its header) and util.cu as one library."""
    from rdst_tpu_torch import _build

    csrc = parent / "rdst_tpu_torch" / "csrc"
    out = ROOT / "build" / "parent_bitonic.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(out),
                    str(csrc / "bitonic.cu"), str(csrc / "util.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rdst_bitonic_tail.argtypes = [vp, vp, vp, i, i, ll, i, vp, vp, i, i, vp]
    lib.rdst_bitonic_span.argtypes = [vp, vp, vp, i, i, ll, ll, ll, i, i, vp]
    lib.rdst_bitonic_tail.restype = lib.rdst_bitonic_span.restype = i
    return lib


def kernels(parent: Path, reps: int) -> None:
    import torch
    from rdst_tpu_torch import _build
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch.ops import fused_sort as fs

    lib = build_parent(parent)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def parent_call(kind, planes, n, nk, args):
        outs, ins_a, outs_a, widths = fs._plane_ptrs(planes)
        stream = _build.stream_of(planes[0])
        if kind == "B2":
            block, levels, unflip = args
            l2r = (ctypes.c_int * 32)(*[lv for lv, _ in levels])
            st = (ctypes.c_int * 32)(*[s for _, s in levels])
            err = lib.rdst_bitonic_tail(ins_a, outs_a, widths, len(planes), nk, n,
                                        block, l2r, st, len(levels),
                                        -1 if unflip is None else unflip, stream)
        else:
            s_hi, s_lo, two_r, block = args
            err = lib.rdst_bitonic_span(ins_a, outs_a, widths, len(planes), nk, n,
                                        s_hi, s_lo, block,
                                        fs._log2(two_r // (2 * s_hi)), stream)
        if err:
            raise RuntimeError(f"parent {kind}: CUDA error {err}")
        return outs

    for kind, label, n, k, nk, args in SHAPES:
        planes = [P.narrow(torch.randint(0, 1 << 32, (n,), generator=gen, device=dev,
                                         dtype=torch.int64), torch.uint32)
                  for _ in range(k)]
        if kind == "B2":
            this = lambda: fs.tail_cuda(planes, n, *args[:1], nk, *args[1:])  # noqa: E731
            want = fs.tail_plain(planes, n, args[0], nk, args[1], args[2])
        else:
            this = lambda: fs.span_cuda(planes, n, *args, nk)  # noqa: E731
            want = fs.span_plain(planes, n, *args, nk)
        old = lambda: parent_call(kind, planes, n, nk, args)  # noqa: E731
        for name, fn in (("parent", old), ("this", this)):
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(P.sview(a), P.sview(b)) for a, b in zip(got, want)):
                raise AssertionError(f"{name} {kind} [{label}] differs from the plain version")
        t = [cuda_ms(torch, f, reps) for f in (old, this, this, old)]
        par, new = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        bound = 2 * 4 * k * n / HBM * 1e3
        print(f"{kind} [{label}]: parent {t[0]:.4f} / {t[3]:.4f} ms, this "
              f"{t[1]:.4f} / {t[2]:.4f} ms; bound {bound:.4f} ms "
              f"({2 * 4 * k * n} B); share of bound parent {bound / par:.1%}, "
              f"this {bound / new:.1%}; parent / this {par / new:.3f}")
        del planes, want


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


def sorts(parent: Path, reps: int) -> None:
    env = dict(os.environ)
    for tree in (parent, ROOT, ROOT, parent):
        env["PYTHONPATH"] = str(tree)
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--sorter-run",
                        "--reps", str(reps)], cwd=tree, env=env, check=True)
    for tree in (parent, ROOT, ROOT, parent):
        env["PYTHONPATH"] = str(tree)
        out = subprocess.run([sys.executable, "scripts/torch_shuffle_stages.py"],
                             cwd=tree, env=env, check=True, capture_output=True,
                             text=True).stdout
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("warm", "profiled")) or "tail_kernel" in ln
                 or "span_kernel" in ln]
        print(f"shuffle stages [{tree.name}]:\n  " + "\n  ".join(lines))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="unpacked checkout to compare with")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-sorts", action="store_true", help="the kernels part only")
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
    kernels(args.parent.resolve(), args.reps)
    if not args.no_sorts:
        sorts(args.parent.resolve(), args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
