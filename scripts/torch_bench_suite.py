"""Benchmark suite of the PyTorch port: ``scripts/bench_suite.py`` on
``rdst_tpu_torch``, for the BASELINE.md configs.

  1. 10M uniform u32 (reference basic_sort)
  2. u64 and f64 keys + payload, stable and unstable
  3. composite struct keys (u16, f32, u32 payload: struct_sort)
  4. a Zipfian u32 distribution (the tuner's skew ladder)
  6. 90%-presorted inputs (struct_sort.rs:43-127)

Every config runs the dispatcher path: the multi-level histogram (kernel
B1) is computed once on the device, the tuner picks the plan from it, and
each timed step runs ``Sorter.run(..., hist=hist)`` on word planes already
on the device.  Steps are chained, each step's output the next one's input,
and each step first re-randomizes its keys with a plane-preserving XOR
rehash: a bijection that permutes each byte plane's buckets without
changing their shape, so the fixed histogram's shape (constant planes,
skew, the tuner's ladder) stays true while the sorted-input short circuit
never fires.  A plan that reads bucket VALUES from the histogram
(:func:`reads_absolute_counts`) would be wrong from the second step on; such
a config runs unchained instead, every step sorting the same input, and its
row says ``"mode": "unchained"`` (every other row ``"chained"``).

Times are CUDA events around the chained steps on the card (the host clock
on the CPU), after one warm step.  After the timed steps the last step's
output is held against the lexicographic order of that step's input,
computed with ``torch.sort``: keys bit-equal, payloads bit-equal when the
sort is stable, else the same (key, payload) multiset.  A mismatch exits
non-zero and prints no row for that config.

    python scripts/torch_bench_suite.py                # on the card
    python scripts/torch_bench_suite.py --device cpu --n 20000 --iters 2

Prints one JSON line per config: bench_suite.py's fields, plus ``mode`` and
``n`` (the rows sorted; ``--n`` cuts every config to at most that many, the
metric keeping its configuration's name).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rdst_tpu_torch import _planes as P  # noqa: E402
from rdst_tpu_torch import keys as rkeys  # noqa: E402
from rdst_tpu_torch.keys import NormalizedKeys  # noqa: E402
from rdst_tpu_torch.ops.histogram import multi_level_histogram  # noqa: E402
from rdst_tpu_torch.sorter import DEFAULT_THREADS, Sorter  # noqa: E402
from rdst_tpu_torch.sorts.lsb import compaction_plan  # noqa: E402
from rdst_tpu_torch.tuner import Algorithm, TuningParams  # noqa: E402

#: The rehash constant of bench_suite.py (odd, so XOR is a bijection).
SCRAMBLE = 0xB5A93E6B
_I64_MIN = -(1 << 63)


def _xor(w: torch.Tensor) -> torch.Tensor:
    """``w`` XOR the constant cut to its width (floor_table.py's u16 plane
    takes the low 16 bits).  torch's unsigned types have no XOR kernel, so
    the same-width signed view takes the same bits as a signed value."""
    bits = 8 * w.dtype.itemsize
    c = SCRAMBLE & ((1 << bits) - 1)
    if c >> (bits - 1):
        c -= 1 << bits
    return (P.sview(w) ^ c).view(w.dtype)


def xor_scramble(ws):
    """Plane-preserving rehash: XOR each word with a fixed odd constant.

    Bijective; permutes each byte plane's histogram buckets (constant
    planes stay constant, skew magnitudes unchanged) while scrambling sort
    order, so the already-sorted short circuit never fires between steps."""
    return [_xor(w) for w in ws]


def suffix_scramble(s):
    """Rehash only the tail beyond ``s``: the presorted-prefix plan's
    regime needs the prefix to stay sorted across steps, as in
    struct_sort.rs:43-127's fixed 90%-presorted inputs."""

    def scramble(ws):
        return [P.cat([w[:s], _xor(w[s:])]) for w in ws]

    return scramble


def dispatcher_step(n_words, n_bytes, stable, hist, sorter, scramble):
    """One step: rehash the keys, then ``Sorter.run`` with the fixed
    histogram (the tuner consults it on the host each step, as
    sorter.rs:67-76 does).  ``scramble=None`` sorts the input as it is."""
    meta = ("dtype", torch.uint32)

    def step(a):
        ws, ps = list(a[:n_words]), list(a[n_words:])
        if scramble is not None:
            ws = scramble(ws)
        nk = NormalizedKeys(tuple(ws), n_bytes, meta)
        out_nk, out_ps = sorter.run(nk, ps, stable=stable, hist=hist)
        return tuple(out_nk.words) + tuple(out_ps)

    return step


class Timer:
    """Seconds of a ``with`` region: CUDA events on the card, the device
    synchronized at both ends; the host clock on the CPU."""

    def __init__(self, dev):
        self.cuda = torch.device(dev).type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize()
            self.seconds = self.ev[0].elapsed_time(self.ev[1]) / 1e3
        else:
            self.seconds = time.perf_counter() - self.t0


def bench_loop(step, args, iters=None, chained=True):
    """Seconds per step, the last step's input and its output.

    One warm step, then ``iters`` steps timed together: chained (each
    step's output is the next one's input) or, with ``chained=False``, each
    on ``args``.  ``iters`` scales inversely with the input size, as
    bench_suite.py's does."""
    n = int(args[0].shape[0])
    if iters is None:
        iters = max(6, min(256, int(1e8 // max(n, 1))))
    step(args)
    a = prev = args
    with Timer(args[0].device) as t:
        for _ in range(iters):
            prev = a if chained else args
            a = step(prev)
    return max(t.seconds / iters, 1e-9), prev, a


def emit(metric, n, seconds, extra=None):
    rec = {
        "metric": metric,
        "value": round(n / seconds),
        "unit": "keys/s",
        "vs_baseline": round(n / seconds / 1e9, 4),
    }
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def plan_pick(sorter, hist, n_bytes, n):
    """The tuner's pick from the top level's counts, as bench_suite.py
    reports it: None for an input the histogram finds sorted."""
    if hist.fully_sorted():
        return None
    params = TuningParams(threads=DEFAULT_THREADS, level=n_bytes - 1,
                          total_levels=n_bytes, input_len=n)
    return sorter.tuner.pick_algorithm(params, hist.counts[n_bytes - 1].tolist())


def reads_absolute_counts(algo, hist) -> bool:
    """True when the plan run for ``algo`` reads more of the histogram than
    its shape, so that a rehash between steps would make a fixed histogram
    wrong: the short circuit of an input found sorted, the bucketed MtOop
    plan (``msb_plan`` -> ``bucketed_sort(..., counts)``: bucket bounds and
    sizes), and the level-compacted plans when a level is constant
    (``packed_sort`` writes the constant byte back from the counts).  The
    comparative plan reads no counts."""
    if algo is None or algo is Algorithm.MT_OOP:
        return True
    if algo is Algorithm.COMPARATIVE:
        return False
    return any(c is not None for c in compaction_plan(hist.counts)[1])


def _key_groups(words, n_bytes):
    """The key as int64 groups, most significant first, each ordered as the
    key is: the top word cut to the key's significant bytes (a rehash sets
    bits above them, which are no part of the key), pairs of words joined
    with the sign bit flipped."""
    ws = [P.widen(w) for w in words]
    top_bits = 8 * (n_bytes - 4 * (len(ws) - 1))
    if top_bits < 32:
        ws[0] = ws[0] & ((1 << top_bits) - 1)
    groups = []
    while ws:
        if len(ws) == 1:
            groups.insert(0, ws.pop())
        else:
            lo, hi = ws.pop(), ws.pop()
            groups.insert(0, ((hi << 32) | lo) ^ _I64_MIN)
    return groups


def lex_order(columns):
    """The stable permutation that sorts rows by ``columns`` (int64, most
    significant first): ``torch.sort`` from the least significant up."""
    idx = torch.arange(columns[0].shape[0], device=columns[0].device)
    for c in reversed(columns):
        idx = idx[torch.sort(c[idx], stable=True).indices]
    return idx


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(P.sview(x), P.sview(y)) for x, y in zip(a, b))


def check_sorted(metric, words, payloads, n_bytes, stable, out_words, out_payloads):
    """Hold a sort's output against the lexicographic order of its input;
    exit non-zero (no row printed) on a mismatch."""
    kin, kout = _key_groups(words, n_bytes), _key_groups(out_words, n_bytes)
    order = lex_order(kin)
    ok = _same([g[order] for g in kin], kout)
    if ok and payloads:
        if stable:
            ok = _same([P.sview(p)[order] for p in payloads], out_payloads)
        else:  # the same (key, payload) multiset
            cin = kin + [P.widen(p) for p in payloads]
            cout = kout + [P.widen(p) for p in out_payloads]
            ok = _same([c[lex_order(cin)] for c in cin],
                       [c[lex_order(cout)] for c in cout])
    if not ok:
        raise SystemExit(f"{metric}: the sorted output differs from torch.sort "
                         "of its input")


def bench_config(metric, words, payloads, n_bytes, stable, sorter, scramble=xor_scramble,
                 iters=None):
    """Time the tuner's plan on ``words`` + ``payloads`` (tensors on the
    device) and check the last step.  Returns (seconds per step, the pick,
    "chained" or "unchained")."""
    n = int(words[0].shape[0])
    hist = multi_level_histogram(words, n_bytes)
    algo = plan_pick(sorter, hist, n_bytes, n)
    chained = not reads_absolute_counts(algo, hist)
    step = dispatcher_step(len(words), n_bytes, stable, hist, sorter,
                           scramble if chained else None)
    args = tuple(words) + tuple(payloads)
    held = None if chained else [a.clone() for a in args]
    t, last_in, out = bench_loop(step, args, iters, chained)
    nw = len(words)
    if held is not None and not _same(held, args):
        raise SystemExit(f"{metric}: a step wrote into its input planes")
    in_words = list(last_in[:nw])
    if chained:
        in_words = scramble(in_words)
    check_sorted(metric, in_words, list(last_in[nw:]), n_bytes, stable,
                 list(out[:nw]), list(out[nw:]))
    return t, algo, "chained" if chained else "unchained"


def make_configs(rng, n, run):
    """bench_suite.py's configs in its order and with its draws from
    ``rng``: (metric, numpy words, numpy payloads, n_bytes, stable,
    scramble).  ``n`` is 10M there; the presorted struct config takes
    409,600 rows, or ``n`` where that is less."""
    out = []
    pay = [np.arange(n, dtype=np.uint32)]

    def words_of(nk):
        return [w.numpy() for w in nk.words]

    if "1" in run:
        w = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
        out.append(("c1_u32_10M_uniform", [w], [], 4, False, xor_scramble))

    if "2" in run:
        w2 = [rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
              for _ in range(2)]
        out.append(("c2_u64_payload_unstable_10M", w2, pay, 8, False, xor_scramble))
        out.append(("c2_u64_payload_stable_10M", w2, pay, 8, True, xor_scramble))
        f = rng.standard_normal(n)
        wf = words_of(rkeys.normalize(f, device="cpu"))
        out.append(("c2_f64_payload_stable_10M", wf, pay, 8, True, xor_scramble))

    if "3" in run:
        # composite struct key (u16, f32) + u32 payload: 6 bytes, 2 words
        a16 = rng.integers(0, 2**16, n).astype(np.uint16)
        b32 = rng.standard_normal(n).astype(np.float32)
        nk3 = rkeys.normalize((a16, b32), device="cpu")
        out.append(("c3_struct_key_payload_10M", words_of(nk3), pay, nk3.n_bytes,
                    True, xor_scramble))

    if "4" in run:
        # Zipfian u32 (the skew regime; the rehash keeps the skew)
        z = (rng.zipf(1.3, n) % (2**31)).astype(np.uint32)
        wz = words_of(rkeys.normalize(z, device="cpu"))
        out.append(("c4_zipf_u32_10M", wz, [], 4, False, xor_scramble))

    if "6" in run:
        # 90%-presorted inputs; only the tail beyond the cut is rehashed
        ns = min(409_600, n)
        cut = int(ns * 0.9)
        a16 = rng.integers(0, 2**16, ns).astype(np.uint16)
        b32 = rng.standard_normal(ns).astype(np.float32)
        nk6 = rkeys.normalize((a16, b32), device="cpu")
        w6 = [w.copy() for w in words_of(nk6)]
        # sort the prefix across word planes; a descent AT the cut keeps
        # the measured prefix out of the rehashed tail
        order = np.lexsort([w[:cut] for w in w6][::-1])
        for w in w6:
            w[:cut] = w[:cut][order]
        w6[0][cut] = 0
        out.append(("c6_struct_409k_90presorted", w6, [np.arange(ns, dtype=np.uint32)],
                    nk6.n_bytes, False, suffix_scramble(cut)))

        cut10 = int(n * 0.9)
        wp = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
        wp[:cut10] = np.sort(wp[:cut10])
        wp[cut10] = 0
        out.append(("c6_u32_10M_90presorted", [wp], [], 4, False,
                    suffix_scramble(cut10)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,6",
                    help="comma-separated subset of configs to run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=10_000_000,
                    help="rows of each config (bench_suite.py: 10M)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed steps (default: bench_suite.py's rule)")
    opts = ap.parse_args()
    dev = rkeys.as_device(opts.device)
    run = set(opts.configs.split(","))

    rng = np.random.default_rng(0)
    sorter = Sorter()
    for metric, words, payloads, n_bytes, stable, scramble in make_configs(
            rng, opts.n, run):
        ws = [torch.from_numpy(w).to(dev) for w in words]
        ps = [torch.from_numpy(p).to(dev) for p in payloads]
        t, algo, mode = bench_config(metric, ws, ps, n_bytes, stable, sorter,
                                     scramble, opts.iters)
        n = int(ws[0].shape[0])
        emit(metric, n, t, extra={"plan": algo and algo.value, "mode": mode, "n": n})


if __name__ == "__main__":
    main()
