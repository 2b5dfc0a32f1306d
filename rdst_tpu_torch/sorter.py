"""Sorter: the dispatch layer routing a sort to an execution plan.

Port of ``rdst_tpu/sorter.py``.  One histogram pass (kernel B1) gives every
level's counts and sortedness; a fully sorted input returns at once; the
tuner picks an Algorithm from the top level's counts; the Algorithm's plan
runs.  Inputs of at most 128 keys go straight to the comparative plan.  A
sorted prefix covering half the input is kept, and only the suffix is
sorted and then merged (``_presorted_merge``).

With ``config.work_profiles(True)`` each pick prints
``(level) PLAN: <Algo> len=N``, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch.keys import NormalizedKeys
from rdst_tpu_torch.ops.histogram import HistogramResult, multi_level_histogram
from rdst_tpu_torch.tuner import (
    SINGLE_PROGRAM_ALGORITHMS,
    Algorithm,
    StandardTuner,
    Tuner,
    TuningParams,
)
from rdst_tpu_torch.utils.trace import span, traced

__all__ = ["Sorter", "PlanContext", "register_plan", "get_plan"]

#: Small-input comparative cutoff (reference: src/sorter.rs:35-38).
COMPARATIVE_CUTOFF = 128

#: Nominal parallelism reported to tuners (reference sorter.rs:108).
DEFAULT_THREADS = 8


@dataclasses.dataclass
class PlanContext:
    """Everything an execution plan may need."""

    hist: HistogramResult | None
    stable: bool
    parallel: bool
    algorithm: Algorithm
    tuner: Tuner


# plan registry: Algorithm -> fn(words, payloads, ctx) -> (words, payloads)
_PLANS: dict[Algorithm, Callable] = {}


def register_plan(algo: Algorithm):
    def deco(fn):
        _PLANS[algo] = fn
        return fn

    return deco


def get_plan(algo: Algorithm) -> Callable:
    return _PLANS[algo]


class Sorter:
    """Routes one sort request to a plan (reference Sorter, sorter.rs:10-22)."""

    def __init__(self, parallel: bool = True, tuner: Tuner | None = None):
        self.parallel = parallel
        self.tuner = tuner if tuner is not None else StandardTuner()

    @traced("sorter.run")
    def run(
        self,
        nk: NormalizedKeys,
        payloads: Sequence[torch.Tensor] = (),
        *,
        stable: bool = False,
        hist: HistogramResult | None = None,
    ) -> tuple[NormalizedKeys, list[torch.Tensor]]:
        """Histogram -> tuner -> plan.  ``hist`` may be precomputed.  The
        call is the ``rdst.sorter.run`` span; the plan body is
        ``rdst.plan.<Algorithm value>``."""
        words = list(nk.words)
        payloads = list(payloads)
        n = int(words[0].shape[0])
        L = nk.n_bytes

        if n <= COMPARATIVE_CUTOFF:
            algo = Algorithm.COMPARATIVE
            hist = None
        else:
            if hist is None:
                hist = multi_level_histogram(words, L)
            if hist.fully_sorted():
                # already-sorted short circuit (sorter.rs:59-65)
                _trace_pick(L - 1, "AlreadySorted", n)
                return nk, payloads
            params = TuningParams(
                threads=DEFAULT_THREADS if self.parallel else 1,
                level=L - 1,
                total_levels=L,
                input_len=n,
                parent_len=None,
            )
            with span("tuner.pick"):
                algo = self.tuner.pick_algorithm(params, hist.counts[L - 1].tolist())
            if not self.parallel and algo not in SINGLE_PROGRAM_ALGORITHMS:
                algo = Algorithm.LSB

        _trace_pick(L - 1, algo, n)
        ctx = PlanContext(
            hist=hist,
            stable=stable,
            parallel=self.parallel,
            algorithm=algo,
            tuner=self.tuner,
        )
        plan = _PLANS[algo]
        split = _presorted_split(n, hist)
        if algo is Algorithm.MT_OOP:
            split = None
        with span("plan." + algo.value):
            if split is not None:
                _trace_pick(L - 1, f"PresortedMerge[{algo.value}]", n)
                out_words, out_payloads = _presorted_merge(
                    words, payloads, split, plan, ctx, stable
                )
            else:
                out_words, out_payloads = plan(words, payloads, ctx)
        return (
            NormalizedKeys(tuple(out_words), nk.n_bytes, nk.meta),
            list(out_payloads),
        )


def _trace_pick(level: int, algo, n: int) -> None:
    # work_profiles-equivalent pick trace (reference: sorter.rs:78-79).
    if config.work_profiles_enabled():
        name = algo.value if isinstance(algo, Algorithm) else str(algo)
        print(f"({level}) PLAN: {name} len={n}")


def _presorted_split(n: int, hist) -> tuple[int, int] | None:
    """(split, padded_total) when the presorted-prefix path should engage:
    the sorted prefix, quantized down to sixteenths of the power-of-two
    total, covers at least half the input."""
    if hist is None or n < config.presorted_merge_min:
        return None
    prefix = getattr(hist, "sorted_prefix", 0)
    T = 1 << (n - 1).bit_length()
    q = T // 16
    s = (min(prefix, n) // q) * q
    if s * 2 < n or s >= n or s <= 0:
        return None
    return s, T


def _presorted_merge(words, payloads, split, plan, ctx, stable):
    """Sort only the suffix, then bitonic-merge prefix and suffix.

    Pads (to the power-of-two total) carry all-ones keys plus a validity
    plane as the least significant key, so they sort after every real
    element and slice off the tail.  ``merge_sorted(stable=True)`` breaks
    key ties prefix-first, which keeps a stable plan stable."""
    from rdst_tpu_torch.ops.merge import merge_sorted

    s, T = split
    n = int(words[0].shape[0])
    nw = len(words)
    dev = words[0].device
    suf_w, suf_p = plan([w[s:] for w in words], [p[s:] for p in payloads], ctx)
    pad = T - n

    def b_side(p, fill):
        if pad == 0:
            return p
        return P.cat([p, P.full(pad, fill, p.dtype, dev)])

    a = (
        [w[:s] for w in words]
        + [P.full(s, 0, torch.uint32, dev)]
        + [p[:s] for p in payloads]
    )
    valid = P.cat([P.full(n - s, 0, torch.uint32, dev),
                   P.full(pad, 1, torch.uint32, dev)])
    b = (
        [b_side(w, P.all_ones(w.dtype)) for w in suf_w]
        + [valid]
        + [b_side(p, 0) for p in suf_p]
    )
    merged = merge_sorted(a, b, nw + 1, stable=stable)
    merged = [p[:n] for p in merged]
    return merged[:nw], merged[nw + 1:]


def _register_default_plans():
    """Populate the plan registry with the JAX package's mapping of the
    eight Algorithm names onto plans (rdst_tpu/sorter.py:249-325)."""
    from rdst_tpu_torch.sorts.comparative import comparative_sort
    from rdst_tpu_torch.sorts.lsb import packed_sort
    from rdst_tpu_torch.sorts.msb import bucketed_sort
    from rdst_tpu_torch.sorts.regions import regions_plan as _regions

    def counts_of(ctx: PlanContext) -> np.ndarray | None:
        return ctx.hist.counts if ctx.hist is not None else None

    def comparative_plan(words, payloads, ctx: PlanContext):
        return comparative_sort(words, payloads, stable=ctx.stable)

    def lsb_plan(words, payloads, ctx: PlanContext):
        # LSB family is stable by contract (reference lib.rs docs)
        return packed_sort(words, payloads, counts_of(ctx), stable=True)

    def ska_plan(words, payloads, ctx: PlanContext):
        return packed_sort(words, payloads, counts_of(ctx), stable=ctx.stable)

    def msb_plan(words, payloads, ctx: PlanContext):
        return bucketed_sort(
            words, payloads, counts_of(ctx), stable=ctx.stable,
            tuner=ctx.tuner, parallel=ctx.parallel,
        )

    def regions_plan(words, payloads, ctx: PlanContext):
        return _regions(words, payloads, counts_of(ctx), stable=ctx.stable)

    _PLANS[Algorithm.COMPARATIVE] = comparative_plan
    _PLANS[Algorithm.LSB] = lsb_plan
    _PLANS[Algorithm.LR_LSB] = lsb_plan
    _PLANS[Algorithm.MT_LSB] = lsb_plan
    _PLANS[Algorithm.SKA] = ska_plan
    _PLANS[Algorithm.MT_OOP] = msb_plan
    _PLANS[Algorithm.RECOMBINATING] = ska_plan
    _PLANS[Algorithm.SCANNING] = ska_plan
    _PLANS[Algorithm.REGIONS] = regions_plan


_register_default_plans()
