"""Perf-regression harness of the PyTorch port: ``scripts/timings.py`` on
``rdst_tpu_torch`` (the reference's scripts/timings.rs:88-200).

A CSV of keys/s per (type, distribution, size): u32, u64 and u128 keys
(u128 as the composite (hi u64, lo u64), 16 levels), uniform and bimodal,
sizes 2^max-exp down to 2^min-exp, one row per size keyed by the git commit
and the device (``nvidia-smi``'s name and power limit on the card).  Each
size's time is the median of ``--reps`` windows around one
``engine.sort_words`` call on words already on the device (CUDA events on
the card, the host clock on the CPU), and its output is checked bit for bit
against the lexicographic order of its input (``torch.sort``).

Two faults of timings.py are not copied:

* the sizes are centred slices of the pool, ``start = (n - size) // 2``, as
  the reference's ``gen_exponential_input_set`` takes them, so every size
  of a bimodal pool holds both of its halves (timings.py:96-98 takes prefix
  slices: a size of at most half the pool holds only the ``>>`` half);
* the medley is timed as one loop over every size, as bench_utils.rs:134-166
  does, not summed from per-size medians that each carry their own
  dispatch overhead (timings.py:137-143).

    python scripts/torch_timings.py --out timings.csv --min-exp 16 --max-exp 28
    python scripts/torch_timings.py --device cpu --min-exp 8 --max-exp 10
"""
import argparse
import csv
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rdst_tpu_torch import _planes as P  # noqa: E402
from rdst_tpu_torch import keys as rkeys  # noqa: E402
from rdst_tpu_torch.engine import sort_words  # noqa: E402
from scripts.torch_bench_suite import Timer, check_sorted  # noqa: E402

TYPES = ("uint32", "uint64", "uint128")
DISTS = ("uniform", "bimodal")


def git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, check=True, cwd=ROOT,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def device_name(dev) -> str:
    """The card as ``nvidia-smi`` names it with its power limit, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[dev.index or 0]


def gen(rng, n, dtype, dist):
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, size=max(n, 1), endpoint=True,
                     dtype=dtype)
    if dist == "bimodal":
        # reference bimodal: half >>shift, half <<shift (bench_utils.rs:56-75)
        shift = np.dtype(dtype).itemsize * 4
        u = x.view(f"uint{np.dtype(dtype).itemsize * 8}")
        h = n // 2
        u[:h] >>= u.dtype.type(shift)
        u[h:] <<= u.dtype.type(shift)
    return x[:n]


def gen_u128(rng, n, dist):
    """u128 = composite (hi u64, lo u64), 16 levels (radix_key_impl.rs:39-46)."""
    hi = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    lo = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    if dist == "bimodal":
        # half >>64 (hi moves into lo), half <<64 (lo moves into hi)
        h = n // 2
        lo[:h], hi[:h] = hi[:h].copy(), np.uint64(0)
        hi[h:], lo[h:] = lo[h:].copy(), np.uint64(0)
    return hi, lo


def centred(pool, size):
    """The ``size`` rows at the middle of ``pool`` (a tensor or array)."""
    start = (len(pool) - size) // 2
    return pool[start:start + size]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="timings.csv")
    ap.add_argument("--max-exp", type=int, default=23)
    ap.add_argument("--min-exp", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--commit", default=None,
                    help="the commit column (default: git rev-parse of the checkout)")
    args = ap.parse_args()
    dev = rkeys.as_device(args.device)

    sha = args.commit or git_sha()
    card = device_name(dev)
    rng = np.random.default_rng(0)
    rows, medleys = [], []
    for dtype in TYPES:
        for dist in DISTS:
            n = 1 << args.max_exp
            if dtype == "uint128":
                pool = gen_u128(rng, n, dist)
            else:
                pool = gen(rng, n, np.dtype(dtype), dist)
            nk = rkeys.normalize(pool, device=dev)
            words = list(nk.words)
            del pool
            sizes = [1 << e for e in range(args.max_exp, args.min_exp - 1, -1)]
            for size in sizes:
                x = [centred(w, size) for w in words]
                held = [w.clone() for w in x]
                out = sort_words(x)[0]  # warm
                ts = []
                for _ in range(args.reps):
                    with Timer(dev) as t:
                        out = sort_words(x)[0]
                    ts.append(t.seconds)
                if not all(torch.equal(P.sview(a), P.sview(b)) for a, b in zip(held, x)):
                    raise SystemExit(f"{dtype} {dist} {size}: a sort wrote into its input")
                check_sorted(f"{dtype} {dist} {size}", x, [], nk.n_bytes, False, out, [])
                del held, out
                sec = float(np.median(ts))
                rows.append({
                    "commit": sha,
                    "type": dtype,
                    "dist": dist,
                    "n": size,
                    "seconds": f"{sec:.6f}",
                    "keys_per_sec": f"{size / sec:.0f}",
                    "device": card,
                })
                print(rows[-1], flush=True)
            # the medley (bench_utils.rs:78-100, 134-166): every size sorted
            # once in one timed loop; the median of --reps loops
            ts = []
            for _ in range(args.reps):
                with Timer(dev) as t:
                    for size in sizes:
                        sort_words([centred(w, size) for w in words])
                ts.append(t.seconds)
            medleys.append((dtype, dist, sum(sizes), float(np.median(ts)), len(sizes)))
            del words, nk

    with open(args.out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}")
    for dtype, dist, tot_n, tot_s, k in medleys:
        print(f"medley {dtype} {dist}: {tot_n / tot_s:.0f} keys/s over "
              f"{k} sizes in one loop ({tot_s:.6f} s a loop, median of "
              f"{args.reps}; {card})")


if __name__ == "__main__":
    main()
