"""MtOop plan: bucketed MSB partition, then per-bucket sorts.

Port of ``rdst_tpu/sorts/msb.py`` ``bucketed_sort``, the plan that
``Algorithm.MT_OOP`` maps to (no built-in tuner picks it; a caller asks for
it with ``with_algorithm`` or ``engine.sort_words(plan="bucketed")``):

  1. stable partition by the top two bytes: one ``lex_sort`` on a u16 key;
  2. per-bucket depth-1 tuner picks from each top-byte bucket's histogram of
     the next byte, read off the sorted partition key by ``searchsorted``
     (the reference re-picks per bucket, sorter.rs:121-171);
  3. dominant buckets carved out as contiguous slices (``_carve_plan``, at
     most ``MAX_CARVED``): a bucket holding one key is left as the stable
     partition put it (SingleKeySkip), any other sorts with its own depth-1
     plan (``packed_sort`` for the LSB family, ``comparative_sort``
     otherwise);
  4. the other buckets gathered into (256, cap) rows, pads at each row's
     tail, and sorted in one batched stable ``lex_sort`` along the rows;
  5. the rows' valid prefixes written back densely
     (``ops/ragged_concat.py``), carved blocks spliced in bucket order.

The re-tuning edges and every carved bucket's single-key flag reach the host
in one copy.  The composition is stable: the partition, the row padding and
the batched sort are, and carved buckets sort stably.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch.ops.histogram import multi_level_histogram
from rdst_tpu_torch.ops.ragged_concat import ragged_concat_multi
from rdst_tpu_torch.sorts.comparative import comparative_sort
from rdst_tpu_torch.sorts.lsb import packed_sort
from rdst_tpu_torch.tuner import Algorithm, TuningParams
from rdst_tpu_torch.utils.trace import span

__all__ = ["bucketed_sort"]

RADIX = 256
MAX_CARVED = 8  # carved slices per sort (the JAX package's static-graph bound)

#: Algorithm names whose execution is the packed (level-compacted) plan
_PACKED_FAMILY = frozenset(
    {Algorithm.LSB, Algorithm.LR_LSB, Algorithm.MT_LSB, Algorithm.SKA}
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _trace(msg: str) -> None:
    if config.work_profiles_enabled():
        print(msg)


def _level_byte(words: Sequence[torch.Tensor], level: int) -> torch.Tensor:
    """The ``level``-th (LSB-first) byte of every key, as int64 in [0, 256)."""
    w = words[len(words) - 1 - level // 4]
    return (P.widen(w) >> ((level % 4) * 8)) & 0xFF


def _carve_plan(top: np.ndarray, n: int, max_expansion: float):
    """Buckets to carve out so that the padded rows stay within
    ``max_expansion`` times the input: greedy, largest first (the reference
    carves the one >50% bucket, ska_sort.rs:52-65; several can dominate
    under multi-hot skew).  Returns (carved bucket ids ascending, row cap
    for the rest), or None when MAX_CARVED carves are not enough."""
    order = np.argsort(top)[::-1]
    for k in range(MAX_CARVED + 1):
        rest_max = int(top[order[k]]) if k < RADIX else 0
        cap = _round_up(max(rest_max, 8), 8)
        if cap * (RADIX - k) <= max_expansion * max(n, 1):
            return sorted(int(b) for b in order[:k]), cap
    return None


def bucketed_sort(
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor],
    counts: np.ndarray | None,
    *,
    stable: bool = False,
    tuner=None,
    parallel: bool = True,
    max_expansion: float = 1.8,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Top-byte partition + per-bucket re-tuned plans + ragged writeback.

    ``counts`` is the (L, 256) host histogram of the input's byte levels."""
    words = list(words)
    payloads = list(payloads)
    n = int(words[0].shape[0])
    if counts is None:
        return comparative_sort(words, payloads, stable=stable)
    if n > config.max_bucketed_elements:
        _trace(
            f"(msb) FALLBACK: Comparative (n={n} > "
            f"max_bucketed_elements={config.max_bucketed_elements})"
        )
        return comparative_sort(words, payloads, stable=stable)
    top = counts[-1]  # the most significant level's histogram
    L = counts.shape[0]
    plan = _carve_plan(top, n, max_expansion)
    if plan is None:
        _trace("(msb) FALLBACK: Comparative (padding untameable)")
        return comparative_sort(words, payloads, stable=stable)
    carved, cap = plan
    dev = words[0].device
    n_words = len(words)

    # 1. stable partition by the top two bytes (a u16 key)
    combined = _level_byte(words, L - 1)
    if L >= 2:
        combined = (combined << 8) | _level_byte(words, L - 2)
    part = P.lex_sort([P.narrow(combined, torch.uint16)] + words + payloads,
                      num_keys=1, stable=True)
    del combined
    part_key, part_planes = part[0], part[1:]
    starts_np = (np.cumsum(top) - top).astype(np.int64)

    # 2. the re-tuning edges (hist2[b] = bucket b's level L-2 histogram) and
    # every carved bucket's single-key flag, in one device-to-host copy
    fetch = []
    retune = tuner is not None and L >= 2
    if retune:
        fetch.append(torch.searchsorted(
            P.widen(part_key), torch.arange(RADIX * RADIX + 1, device=dev),
            side="left"))
    flagged = []
    for b in carved:
        s, ln = int(starts_np[b]), int(top[b])
        if ln > 0:
            bw = [P.sview(p[s: s + ln]) for p in part_planes[:n_words]]
            fetch.append(torch.stack([w.min() == w.max() for w in bw]).all()
                         .to(torch.int64).reshape(1))
            flagged.append(b)
    del part_key
    if fetch:
        with span("sync.msb_fetch"):
            host = torch.cat(fetch).cpu().numpy()
    else:
        host = np.zeros(0, np.int64)
    n_edges = RADIX * RADIX + 1 if retune else 0
    single = dict(zip(flagged, host[n_edges:].astype(bool)))

    picks: dict[int, Algorithm] = {}
    if retune:
        edges = host[:n_edges]
        hist2 = (edges[1:] - edges[:-1]).reshape(RADIX, RADIX)
        for b in range(RADIX):
            ln = int(top[b])
            if ln == 0:
                continue
            picks[b] = tuner.pick_algorithm(
                TuningParams(
                    threads=8 if parallel else 1,
                    level=L - 2,
                    total_levels=L,
                    input_len=ln,
                    parent_len=n,
                ),
                hist2[b].tolist(),
            )
        if config.work_profiles_enabled():
            names: dict[str, int] = {}
            for b, a in picks.items():
                if b not in carved:
                    names[a.value] = names.get(a.value, 0) + 1
            summary = " ".join(f"{k}x{v}" for k, v in sorted(names.items()))
            _trace(f"({L - 2}) PLAN: BatchedRows[{summary}] cap={cap}")

    # 3. carved dominant buckets, each with its own depth-1 plan
    carved_out: dict[int, list[torch.Tensor]] = {}
    for b in carved:
        s, ln = int(starts_np[b]), int(top[b])
        if ln == 0:
            continue
        bw = [p[s: s + ln] for p in part_planes[:n_words]]
        bp = [p[s: s + ln] for p in part_planes[n_words:]]
        if single[b]:
            # hot-key fast path: nothing to sort, and the stable partition
            # already left the payloads in stable order
            _trace(f"({L - 2}) PLAN: SingleKeySkip len={ln} bucket={b}")
            carved_out[b] = bw + bp
            continue
        algo = picks.get(b, Algorithm.COMPARATIVE)
        _trace(f"({L - 2}) PLAN: {algo.value} len={ln} bucket={b} (carved)")
        if algo in _PACKED_FAMILY:
            bhist = multi_level_histogram(bw, L)
            sw, sp = packed_sort(
                bw, bp, bhist.counts,
                stable=True if algo is not Algorithm.SKA else stable,
            )
        else:
            sw, sp = comparative_sort(bw, bp, stable=stable)
        carved_out[b] = list(sw) + list(sp)

    # 4. the rest: (256, cap) rows gathered from the partition, pads (all-ones
    # keys, zero payloads) at each row's tail, and one batched stable sort
    lengths_np = top.astype(np.int64).copy()
    lengths_np[carved] = 0
    pos = torch.arange(cap, device=dev)
    starts = torch.from_numpy(starts_np).to(dev)
    valid = pos < torch.from_numpy(lengths_np).to(dev)[:, None]
    idx = torch.clamp(starts[:, None] + pos, max=max(n - 1, 0)).reshape(-1)

    def rows_of(plane, fill):
        rows = P.take(plane, idx, 0).reshape(RADIX, cap)
        return P.where(valid, rows, P.fill_like(1, fill, plane))

    bucket_rows = [rows_of(p, -1 if i < n_words else 0)
                   for i, p in enumerate(part_planes)]
    srt = P.lex_sort(bucket_rows, n_words, stable=True, dim=1)
    del bucket_rows

    # 5. writeback in bucket order, carved blocks between ragged ranges of
    # rows (every offset is known on the host from ``counts``)
    pieces: list[list[torch.Tensor]] = []
    b0 = 0
    for b in carved + [RADIX]:
        if b > b0:
            seg_total = int(top[b0:b].sum())
            if seg_total > 0:
                pieces.append(ragged_concat_multi(
                    [p[b0:b] for p in srt], lengths_np[b0:b], seg_total))
        if b in carved_out:
            pieces.append(carved_out[b])
        b0 = b + 1
    if not pieces:
        return words, payloads
    out = [P.cat([piece[i] for piece in pieces])
           for i in range(len(part_planes))]
    return out[:n_words], out[n_words:]
