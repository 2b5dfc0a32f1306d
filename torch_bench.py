"""Headline benchmark of the PyTorch port: u64 keys/s on one card
(``bench.py`` on ``rdst_tpu_torch``).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

vs_baseline is the ratio against the BASELINE.json north-star target of
1e9 u64 keys/s/chip.  The metric is bench.py's: the host clock around one
step (``once``) and around ``iters`` chained steps (``many``), each ended by
a synchronize, and ``n / ((t_many - t_once) / (iters - 1))``.  A step
re-randomizes every word as ``w * 2654435761 + (i + 1) mod 2^32`` and sorts
the words with ``engine.sort_words``.  bench.py chains its steps inside one
jit (``lax.fori_loop``); here they are a Python loop of eager calls, so the
time to enqueue each step's kernels is part of the number, as it is for
every caller of the port.  No CUDA graph: ``sort_words`` is eager.

After the timed calls each size's last step is run again from the same
input (the same words, or the same generator seed, and the same steps),
outside the timed window, and its output is held bit-equal to
``torch.sort`` of the step's rehashed input; a mismatch exits non-zero
with no result.  That and each ``--sweep-large`` size's peak device memory
(``torch.cuda.max_memory_allocated`` over its calls, the check left out)
go to standard error.

    python torch_bench.py                          # 2^25 u64, the card
    python torch_bench.py --sweep                  # 2^25..2^28
    python torch_bench.py --sweep-large --try-2e30 --planes 1
    python torch_bench.py --device cpu --n 65536   # the plain versions

Extra configs (BASELINE.md list): scripts/torch_timings.py
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.engine import sort_words
from rdst_tpu_torch.keys import as_device

#: bench.py's multiplier, as the int32 of the same bits
_MUL_I32 = 2654435761 - (1 << 32)
_I64_MIN = -(1 << 63)


def _rehash(w: torch.Tensor, i: int) -> torch.Tensor:
    """``w * 2654435761 + (i + 1) mod 2^32`` on a u32 plane.  torch's
    uint32 has no CUDA multiply; int32 products and sums wrap mod 2^32, so
    on the signed view they give the unsigned result's bits."""
    return torch.mul(P.sview(w), _MUL_I32).add_(i + 1).view(torch.uint32)


def _step(ws: list, plan: str) -> tuple:
    """One step: rehash and sort the words of ``ws``.  ``ws`` is emptied
    once its words are rehashed, so a caller that holds no other reference
    to them lets the allocator reuse their memory (bench.py's donation)."""
    hashed = [_rehash(w, i) for i, w in enumerate(ws)]
    ws.clear()
    return tuple(sort_words(hashed, plan=plan)[0])


def _many(ws: list, iters: int, plan: str) -> tuple:
    """``iters`` chained steps from the words of ``ws`` (emptied)."""
    for _ in range(iters):
        ws = list(_step(ws, plan))
    return tuple(ws)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _packed(ws) -> torch.Tensor:
    """One or two u32 words as int64 keys in the words' unsigned order."""
    k = P.widen(ws[0])
    if len(ws) == 2:
        k = (k << 32).bitwise_or_(P.widen(ws[1])).bitwise_xor_(_I64_MIN)
    return k


def _check_last_step(x: list, plan: str) -> None:
    """Run one step on ``x`` (emptied) and hold its output bit-equal to
    ``torch.sort`` of its rehashed input; exit non-zero on a mismatch."""
    n, k = int(x[0].shape[0]), len(x)
    out = _step(list(x), plan)
    keys = _packed([_rehash(w, i) for i, w in enumerate(x)])
    x.clear()
    want = torch.sort(keys).values
    del keys
    if not torch.equal(want, _packed(out)):
        raise SystemExit(f"torch_bench: n={n} words={k} plan={plan}: the last step's "
                         "output differs from torch.sort of its input")
    print(f"torch_bench: n={n} words={k} plan={plan}: the last step is bit-equal to "
          "torch.sort of its input", file=sys.stderr, flush=True)


def _bench_sort_words(n, n_words, iters=8, plan="auto", device="cuda"):
    dev = as_device(device)
    rng = np.random.default_rng(42)
    words = [
        torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32)).to(dev)
        for _ in range(n_words)
    ]

    def once(ws):
        return _step(list(ws), plan)

    def many(ws):
        return _many(list(ws), iters, plan)

    r = once(words)
    _sync(r[0])
    t0 = time.perf_counter()
    r1 = once(words)
    _sync(r1[0])
    t_once = time.perf_counter() - t0

    r = many(words)
    _sync(r[0])
    t0 = time.perf_counter()
    r = many(words)
    _sync(r[0])
    t_many = time.perf_counter() - t0
    per_iter = (t_many - t_once) / (iters - 1)
    del r, r1
    _check_last_step(list(_many(list(words), iters - 1, plan)), plan)
    return n / per_iter


def _bench_sort_words_donated(n, n_words, iters=3, plan="auto", device="cuda"):
    """Large-n harness: the input made on the device, and consumed by the
    timed call.

    Each timed call draws its words on the device from a generator seeded
    as bench.py seeds its keys (0 and 2 for the untimed calls, 1 and 3 for
    the timed ones), and the draw is inside the timed window, as there.
    The step releases its input words once it has rehashed them (bench.py
    donates them), so no copy of the input outlives them and the peak is
    the sort's own working set.  The peak device memory of the calls,
    from a reset before them to the end of the timed window, goes to
    standard error before the last step's check.
    """
    dev = as_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return [
            torch.randint(-(1 << 31), 1 << 31, (n,), generator=g, device=dev,
                          dtype=torch.int32).view(torch.uint32)
            for _ in range(n_words)
        ]

    def once(ws):
        return _step(ws, plan)

    def many(ws):
        return _many(ws, iters, plan)

    def timed(fn, seed):
        ws = gen(seed)
        _sync(ws[0])
        r = fn(ws)
        _sync(r[0])  # force sync
        return r

    timed(once, 0)  # warm
    t0 = time.perf_counter()
    timed(once, 1)
    t_once = time.perf_counter() - t0
    timed(many, 2)  # warm
    t0 = time.perf_counter()
    timed(many, 3)
    t_many = time.perf_counter() - t0
    per_iter = (t_many - t_once) / (iters - 1)
    _peak(dev, n, n_words)
    _check_last_step(list(_many(gen(3), iters - 1, plan)), plan)
    return n / per_iter


def _peak(dev, n, n_words):
    """Print the peak device memory since its last reset to stderr."""
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"torch_bench: peak device memory n={n} words={n_words}: {peak} B "
              f"({peak / (1 << 30):.2f} GiB)", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 25)
    ap.add_argument("--plan", default="auto")
    ap.add_argument("--all", action="store_true",
                    help="name the harness of all BASELINE configs (verbose, not "
                         "the one-line mode)")
    ap.add_argument("--sweep", action="store_true",
                    help="keys/s at 2^25..2^28 -- the large-n anchor for "
                         "the 1B-key north star (one JSON line per size)")
    ap.add_argument("--sweep-large", action="store_true",
                    help="device-generated, consumed-input sweep at "
                         "2^28..2^29 (and --try-2e30) -- measures AT the "
                         "north-star scale")
    ap.add_argument("--try-2e30", action="store_true",
                    help="attempt n=2^30 with the large-n harness (an out-"
                         "of-memory error is recorded as the size's line)")
    ap.add_argument("--planes", type=int, default=2,
                    help="key word planes for --sweep-large (1 = u32 keys)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu; cuda without a card raises")
    args = ap.parse_args()
    dev = as_device(args.device)

    if args.all:
        print("use scripts/torch_timings.py for the full matrix", file=sys.stderr)

    if args.sweep_large:
        logns = [28, 29] + ([30] if args.try_2e30 else [])
        planes = args.planes
        for logn in logns:
            try:
                kps = _bench_sort_words_donated(
                    1 << logn, n_words=planes, plan=args.plan, iters=3, device=dev,
                )
            except torch.cuda.OutOfMemoryError as e:  # the size's verdict
                _peak(dev, 1 << logn, planes)
                print(json.dumps({
                    "metric": f"u{32 * planes}_sort_keys_per_s_chip_n{1 << logn}",
                    "value": 0,
                    "unit": "keys/s",
                    "error": repr(e)[:300],
                }))
                continue
            print(json.dumps({
                "metric": f"u{32 * planes}_sort_keys_per_s_chip_n{1 << logn}",
                "value": round(kps),
                "unit": "keys/s",
                "vs_baseline": round(kps / 1e9, 4),
            }))
        return

    if args.sweep:
        for logn in (25, 26, 27, 28):
            kps = _bench_sort_words(1 << logn, n_words=2, plan=args.plan,
                                    iters=4 if logn >= 27 else 8, device=dev)
            print(json.dumps({
                "metric": f"u64_sort_keys_per_s_chip_n{1 << logn}",
                "value": round(kps),
                "unit": "keys/s",
                "vs_baseline": round(kps / 1e9, 4),
            }))
        return

    keys_per_s = _bench_sort_words(args.n, n_words=2, plan=args.plan, device=dev)
    target = 1e9  # BASELINE.json north star: 1B u64 keys/s/chip
    print(
        json.dumps(
            {
                "metric": f"u64_sort_keys_per_s_chip_n{args.n}",
                "value": round(keys_per_s),
                "unit": "keys/s",
                "vs_baseline": round(keys_per_s / target, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
