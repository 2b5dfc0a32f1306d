"""Floor table of the PyTorch port: ``scripts/floor_table.py`` on the card.

One row per operand shape (floor_table.py's five), each column in ns per
element:

* ``achieved``  -- the dispatcher on the shape: ``torch_bench_suite``'s
  chained dispatcher step (``Sorter.run`` with the histogram taken once) for
  c1, c2 and c3, and ``engine.sort_words`` for the headline, as bench.py
  runs it;
* ``fused raw`` -- the fused executor (``ops.fused_sort.fused_sort``: its
  radix passes, B1 and B8, on rows of at most 8 key bytes and one payload,
  which every shape here is; else phase 0, kernels B2 and B3) driven
  directly on the operand planes, with no normalization, histogram or
  dispatch;
* ``torch raw`` -- the library's sort of the same function: the key planes
  packed into one int64 (most significant plane first, the top bit
  flipped, so that signed order is the key's order), ``torch.sort`` and one
  gather of each payload plane by its indices, the keys unpacked again;
* ``bound``     -- the card's least time for the work: every operand plane,
  and the index plane a stable fused sort carries, read once and written
  once over the HBM rate of ``benchmark/peaks.json`` (3.35 TB/s); HBM bounds it;
* ``executor floor`` -- the trips through memory the fused plan makes (its
  B8 passes, or its B2 and B3 launches, its phase-0 row sorts and the piece
  path's merges, counted on one call), each reading and writing the planes
  it was given, over the same rate.

Every timed step first XORs each plane with 0xB5A93E6B cut to its width
(torch_bench_suite's rehash), so steps chain and no input arrives sorted.
Times are CUDA events over the chained steps (``torch_bench_suite.
bench_loop``).  Each column's last step is checked against ``torch.sort`` of
its input; a mismatch exits non-zero.  ``stage_count`` is floor_table.py's
bitonic stage count per element, without its TPU cost per stage.

    python scripts/torch_floor_table.py            # on the card
    python scripts/torch_floor_table.py --device cpu --iters 1   # SIZES cut down
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rdst_tpu_torch import _planes as P  # noqa: E402
from rdst_tpu_torch import keys as rkeys  # noqa: E402
from rdst_tpu_torch.engine import sort_words  # noqa: E402
from rdst_tpu_torch.ops import fused_sort as fs  # noqa: E402
from rdst_tpu_torch.ops import radix_sort as rs  # noqa: E402
from rdst_tpu_torch.sorter import Sorter  # noqa: E402
from scripts import torch_bench_suite as tbs  # noqa: E402
from scripts.torch_timings import device_name  # noqa: E402

_I64_MIN = -(1 << 63)

#: Rows of the shapes (floor_table.py's sizes).
SIZES = {"headline": 1 << 25, "n10": 10_000_000}


def stage_count(n: int) -> float:
    """Bitonic compare-exchange stages per element of a dense n-element sort
    as the fused executor runs it (floor_table.py ``vpu_bound_ns`` without
    its cost per stage): a power of two, or a length within 1.13 of one,
    runs the full L(L+1)/2 stages; another runs the piece decomposition,
    each piece its own stage count, then one virtually padded merge level
    per fold.  Depends on n alone, not on the card."""
    T = 1 << (n - 1).bit_length()
    if T <= 1.13 * n or T < (1 << 12):
        pieces, total = [T], T
    else:
        Q = T // 16
        total = -(-n // Q) * Q
        M = total // Q
        pieces = [
            (1 << b) * Q
            for b in range(M.bit_length() - 1, -1, -1)
            if M & (1 << b)
        ]
    stages = sum(
        (p.bit_length() - 1) * p.bit_length() / 2 * p for p in pieces
    ) / total
    la = pieces[0]
    for ln in pieces[1:]:
        la += ln
        stages += (la - 1).bit_length() * la / total  # log2(next_pow2(la))
    return stages


#: floor_table.py's shapes: (label, the SIZES entry of its rows, its planes'
#: dtypes (keys first), its payload planes, stable)
SHAPES = [
    ("headline 2^25 x 2key unstable", "headline", (np.uint32, np.uint32), 0, False),
    ("c1-shape 10M x 1key unstable", "n10", (np.uint32,), 0, False),
    ("c2-unstable 10M 2key+pay", "n10", (np.uint32,) * 3, 1, False),
    ("c2-stable 10M 2key+pay", "n10", (np.uint32,) * 3, 1, True),
    ("c3-stable 10M u16+u32key+pay", "n10", (np.uint16, np.uint32, np.uint32), 1, True),
]


def make_shapes(rng):
    """``SHAPES`` with floor_table.py's draws from ``rng``: (label, numpy
    planes, payload count, stable)."""
    def draw(dt, n):
        if dt == np.uint16:
            return rng.integers(0, 2**16, n).astype(np.uint16)
        return rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)

    return [(label, [draw(dt, SIZES[size]) for dt in dtypes], n_pay, stable)
            for label, size, dtypes, n_pay, stable in SHAPES]


def fused_step(n_keys, stable):
    def step(a):
        aw = tbs.xor_scramble(a)
        ow, op = fs.fused_sort(aw[:n_keys], aw[n_keys:], stable=stable)
        return tuple(ow) + tuple(op)
    return step


def pack(keys) -> torch.Tensor:
    """Key planes (most significant first, at most 64 bits together) as one
    int64 whose signed order is their unsigned lexicographic order."""
    acc = None
    for p in keys:
        v = P.widen(p)
        acc = v if acc is None else (acc << (8 * p.dtype.itemsize)) | v
    return acc ^ _I64_MIN


def unpack(packed, dtypes) -> list:
    """Invert :func:`pack` into planes of ``dtypes``."""
    v = packed ^ _I64_MIN
    out = []
    for dt in reversed(dtypes):
        out.insert(0, P.narrow(v & P.all_ones(dt), dt))
        v = v >> (8 * dt.itemsize)
    return out


def torch_step(n_keys, stable):
    """The library's sort of the fused step's function."""
    def step(a):
        aw = tbs.xor_scramble(a)
        vals, idx = torch.sort(pack(aw[:n_keys]), stable=stable)
        keys = unpack(vals, [w.dtype for w in aw[:n_keys]])
        return tuple(keys) + tuple(P.sview(p)[idx].view(p.dtype) for p in aw[n_keys:])
    return step


def bound_bytes(planes, stable) -> int:
    """Bytes every operand plane (and a stable sort's u32 index plane) takes
    to be read once and written once."""
    n = int(planes[0].shape[0])
    return 2 * n * (sum(p.dtype.itemsize for p in planes) + (4 if stable else 0))


def executor_trips(planes, n_keys, stable):
    """The trips through memory of one fused sort of ``planes``: {kind:
    (count, bytes read and written)}, kinds ``B8`` (a radix pass: every
    plane read once and written once; ``radix_sort.radix_pass`` on the card,
    ``radix_pass_plain`` on the CPU), ``B2``, ``B3``, ``phase 0`` (the
    ``lex_sort`` calls: the row sorts, and a piece too short for the
    network sorted whole) and ``merge`` (the piece path's merges, B7: both
    runs read once and the merged run written once)."""
    book = {}
    sites = [(fs, "tail_call", "B2"), (fs, "span_call", "B3"),
             (fs.P, "lex_sort", "phase 0"), (fs, "piece_merge", "merge"),
             (rs, "radix_pass", "B8"), (rs, "radix_pass_plain", "B8")]
    real = [getattr(mod, name) for mod, name, _ in sites]

    def counted(fn, kind):
        def wrapped(ps, *args, **kw):
            runs = list(ps) + (list(args[0]) if kind == "merge" else [])
            c, b = book.get(kind, (0, 0))
            book[kind] = (c + 1, b + 2 * sum(p.numel() * p.dtype.itemsize for p in runs))
            return fn(ps, *args, **kw)
        return wrapped

    for (mod, name, kind), fn in zip(sites, real):
        setattr(mod, name, counted(fn, kind))
    try:
        fs.fused_sort(planes[:n_keys], planes[n_keys:], stable=stable)
    finally:
        for (mod, name, _), fn in zip(sites, real):
            setattr(mod, name, fn)
    return book


def _check(label, column, args, out, n_keys, stable):
    """The last step's output against torch.sort of its input."""
    aw = tbs.xor_scramble(args)
    n_bytes = sum(w.dtype.itemsize for w in aw[:n_keys])
    tbs.check_sorted(f"{label} ({column})", aw[:n_keys], aw[n_keys:], n_bytes, stable,
                     list(out[:n_keys]), list(out[n_keys:]))


def achieved(label, planes, n_keys, stable, iters):
    """Seconds per dispatcher step on the shape (checked)."""
    keys, pays = planes[:n_keys], planes[n_keys:]
    # the dispatcher's keys are u32 words: a u16 plane widens, its top two
    # bytes outside the key's n_bytes
    words = [P.narrow(P.widen(w), torch.uint32) for w in keys]
    n_bytes = sum(w.dtype.itemsize for w in keys)
    if label.startswith("headline"):
        def step(a):
            return tuple(sort_words(tbs.xor_scramble(a))[0])
        t, last_in, out = tbs.bench_loop(step, tuple(words), iters)
        tbs.check_sorted(f"{label} (achieved)", tbs.xor_scramble(last_in), [],
                         n_bytes, False, list(out), [])
        return t
    t, _, _ = tbs.bench_config(f"{label} (achieved)", words, pays, n_bytes, stable,
                               Sorter(), iters=iters)
    return t


def hbm_bytes_per_s() -> float:
    """The card's HBM rate, the benchmark's figure (``benchmark/peaks.json``)."""
    with open(os.path.join(ROOT, "benchmark", "peaks.json")) as f:
        return json.load(f)["hbm_bytes_per_s"]


def row(label, planes, n_pay, stable, iters):
    """One row's columns in ns per element, and its trips."""
    n = int(planes[0].shape[0])
    k = len(planes) - n_pay
    args = tuple(planes)
    cols = {"achieved": achieved(label, planes, k, stable, iters)}
    for column, step in (("fused raw", fused_step(k, stable)),
                         ("torch raw", torch_step(k, stable))):
        t, last_in, out = tbs.bench_loop(step, args, iters)
        _check(label, column, last_in, out, k, stable)
        cols[column] = t
    trips = executor_trips(planes, k, stable)
    hbm = hbm_bytes_per_s()
    cols["bound"] = bound_bytes(planes, stable) / hbm
    cols["executor floor"] = sum(b for _, b in trips.values()) / hbm
    ns = {c: t * 1e9 / n for c, t in cols.items()}
    return ns, trips


COLUMNS = ("achieved", "fused raw", "torch raw", "bound", "executor floor")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed steps (default: bench_suite.py's rule)")
    args = ap.parse_args(argv)
    dev = rkeys.as_device(args.device)

    rng = np.random.default_rng(11)
    print(f"device: {device_name(dev)}")
    print("| shape | " + " | ".join(f"{c} ns/el" for c in COLUMNS)
          + " | fused/torch | fused/bound | stages/el | executor trips |")
    print("|" + "---|" * (len(COLUMNS) + 5))
    for label, ws, n_pay, stable in make_shapes(rng):
        planes = [torch.from_numpy(w).to(dev) for w in ws]
        ns, trips = row(label, planes, n_pay, stable, args.iters)
        trip_text = ", ".join(f"{kind} {c}" for kind, (c, _) in trips.items())
        print(f"| {label} | " + " | ".join(f"{ns[c]:.6g}" for c in COLUMNS)
              + f" | {ns['fused raw'] / ns['torch raw']:.3f}"
              f" | {ns['fused raw'] / ns['bound']:.2f}"
              f" | {stage_count(int(planes[0].shape[0])):.2f} | {trip_text} |",
              flush=True)
        del planes
    return 0


if __name__ == "__main__":
    main()
