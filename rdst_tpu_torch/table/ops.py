"""Relational operators over columnar tables, built on the sort engine.

Port of ``rdst_tpu/table/ops.py``: sort-based hash aggregate, filter and
sort-merge join.  The reference sorts with ``lax.sort``; here the key words
sort with ``_planes.lex_argsort`` (``torch.sort`` on packed int64 keys) and
every column follows by one gather of its own dtype, which gives the same
bits as carrying it through the sort as payload words.

Static-shape discipline, as in the reference: ``filter`` and
``group_aggregate`` keep length n with a valid ``count`` (a 0-dim int32
tensor, never read on the host); only the inner ``join`` reads one number
on the host, its total match count.  Segmented sums are cumsum differences
at group boundaries, accumulated in int64 for integer and bool columns and
in float64 for float columns (the reference's x64 branch).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import keys as _keys
from rdst_tpu_torch.table.table import Table

__all__ = ["sort_by", "filter", "group_aggregate", "join"]

_AGG_OPS = ("sum", "count", "mean", "min", "max", "first", "last")


def _take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]`` for any dtype (unsigned columns through their signed
    view)."""
    return P.sview(col)[idx].view(col.dtype)


def _to_acc(c: torch.Tensor) -> torch.Tensor:
    """A column as its sum accumulator: int64 for integers and bools (u64
    by its bit pattern, which wraps as the reference's int64 does), float64
    for floats."""
    if c.dtype in P.UNSIGNED:
        return P.widen(c)
    if c.dtype == torch.uint64:
        return c.view(torch.int64)
    return c.to(torch.float64 if c.dtype.is_floating_point else torch.int64)


def _sort_rows(table: Table, by, *, stable=True, extra_key=None):
    """Sort all columns by the composite key of ``by`` columns.

    Returns (sorted Table, sorted key words).  ``extra_key``: optional
    column name appended as the least significant key field (for min/max
    aggregates)."""
    by = [by] if isinstance(by, str) else list(by)
    fields = [table.column(c) for c in by]
    if extra_key is not None:
        fields.append(table.column(extra_key))
    nk = _keys.normalize(tuple(fields)) if len(fields) > 1 else _keys.normalize(fields[0])
    idx = P.lex_argsort(nk.words, stable)
    words = [P.take(w, idx) for w in nk.words]
    cols = {c: _take(table.column(c), idx) for c in table.column_names}
    return Table(cols), words


def sort_by(table: Table, by, *, stable: bool = True) -> Table:
    """ORDER BY over any composite column key (rdst order semantics)."""
    t, _ = _sort_rows(table, by, stable=stable)
    return t


def filter(table: Table, mask, *, return_count: bool = True):
    """Keep rows where ``mask`` is true, packed to the front (stable).

    The output keeps length n; rows past ``count`` are the filtered-out
    remainder, also in stable order (a stable sort on a 1-bit key)."""
    mask = _keys._to_tensor(mask, table.device).to(table.device)
    if mask.dtype != torch.bool:
        mask = mask != 0
    idx = torch.argsort((~mask).to(torch.uint8), stable=True)
    t = Table({c: _take(table.column(c), idx) for c in table.column_names})
    count = mask.sum(dtype=torch.int32)
    return (t, count) if return_count else t


def _segment_starts(key_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Boolean mask: row starts a new key group (rows already sorted)."""
    n = key_words[0].shape[0]
    neq = torch.zeros(n, dtype=torch.bool, device=key_words[0].device)
    for w in key_words:
        s = P.sview(w)
        neq |= s != s.roll(1)
    neq[0] = True
    return neq


def group_aggregate(
    table: Table,
    by,
    aggs: Mapping[str, tuple[str, str]],
    *,
    presorted: bool = False,
) -> tuple[Table, torch.Tensor]:
    """Sort-based GROUP BY: sort by the group key, find the segment
    boundaries, reduce each segment.

    ``aggs``: {out_name: (column, op)} with op in sum/count/mean/min/max/
    first/last.  The output has length n, one row per group packed to the
    front, ``count`` groups valid; slots past ``count`` are unspecified.
    Sums are cumsum differences at the boundaries; min/max take the ends of
    segments sorted by (key, value).  ``presorted`` is accepted, as in the
    reference, and has no effect."""
    del presorted
    by_list = [by] if isinstance(by, str) else list(by)
    for _, (_, op) in aggs.items():
        if op not in _AGG_OPS:
            raise ValueError(f"unsupported agg op {op!r}")
    minmax = {k: v for k, v in aggs.items() if v[1] in ("min", "max")}
    plain = {k: v for k, v in aggs.items() if v[1] not in ("min", "max")}

    srt, key_words = _sort_rows(table, by_list, stable=True)
    n = srt.n_rows
    dev = table.device
    if n == 0:
        out_cols = {name: srt.column(name) for name in by_list}
        for out_name in aggs:
            out_cols[out_name] = torch.zeros(0, dtype=torch.float32, device=dev)
        return Table(out_cols), torch.zeros((), dtype=torch.int32, device=dev)
    starts = _segment_starts(key_words)
    count = starts.sum(dtype=torch.int32)

    # group start positions packed first (a stable partition); the group
    # end is the next start - 1, the last valid group's n - 1.  Slots past
    # ``count`` hold garbage within [0, n).
    gstart = torch.argsort((~starts).to(torch.uint8), stable=True)
    gidx = torch.arange(n, device=dev)
    gend = torch.where(gidx == count - 1, n - 1, gstart.roll(-1) - 1).clamp(0, n - 1)

    out_cols = {name: _take(srt.column(name), gstart) for name in by_list}
    sizes = (gend - gstart + 1).to(torch.int32)
    for out_name, (col, op) in plain.items():
        c = srt.column(col) if col is not None else None
        if op == "count":
            out_cols[out_name] = sizes
        elif op == "sum":
            out_cols[out_name] = _segment_sum(c, gstart, gend)
        elif op == "mean":
            ssum = _segment_sum(c, gstart, gend)
            out_cols[out_name] = ssum.to(torch.float32) / sizes.clamp(min=1)
        elif op == "first":
            out_cols[out_name] = _take(c, gstart)
        elif op == "last":
            out_cols[out_name] = _take(c, gend)

    value_sorted: dict = {}  # one (key, value)-ordered sort per column
    for out_name, (col, op) in minmax.items():
        if col not in value_sorted:
            value_sorted[col], _ = _sort_rows(
                table.select(by_list + [col]), by_list, stable=True,
                extra_key=col,
            )
        idx = gstart if op == "min" else gend
        out_cols[out_name] = _take(value_sorted[col].column(col), idx)
    return Table(out_cols), count


def _segment_sum(c: torch.Tensor, gstart: torch.Tensor, gend: torch.Tensor):
    """Exact segmented sums via cumsum differences at boundaries: integer
    columns in int64 (exact while each group's sum fits), float columns in
    float64."""
    acc = torch.cumsum(_to_acc(c), 0)
    before = torch.where(gstart > 0, acc[(gstart - 1).clamp(min=0)], 0)
    return acc[gend] - before


def join(
    left: Table,
    right: Table,
    on,
    *,
    how: str = "inner",
    suffix: str = "_r",
) -> tuple[Table, torch.Tensor]:
    """Sort-merge equi-join over composite keys of any width; ``right``
    keys may repeat.

    The right side sorts by the key; each left key finds its range by a
    lexicographic binary search (:func:`_lex_searchsorted`).
    ``how="inner"``: one row per (left row, matching right row) pair,
    duplicate right keys expanding in left order then right sorted order;
    the length is the match count, the one number read on the host.
    ``how="left"``: left's length; a duplicate right key resolves to its
    first match in right's sorted order; unmatched rows carry zeros and
    ``_matched=False``, as the reference documents and its distributed join
    does (its single-chip code gathers the right row at the insertion point
    instead).
    """
    if how not in ("inner", "left"):
        raise ValueError("how must be 'inner' or 'left'")
    on_list = [on] if isinstance(on, str) else list(on)
    rs, r_words = _sort_rows(right, on_list, stable=True)
    lk = _keys.normalize(
        tuple(left.column(c) for c in on_list)
        if len(on_list) > 1
        else left.column(on_list[0])
    )
    lo, hi = _equal_range(r_words, list(lk.words))
    matched = hi > lo
    m = rs.n_rows
    right_cols = [(name, name + (suffix if name in left.column_names else ""))
                  for name in rs.column_names if name not in on_list]

    if how == "left":
        idx = lo.clamp(0, max(m - 1, 0))
        cols = {name: left.column(name) for name in left.column_names}
        for name, out_name in right_cols:
            c = rs.column(name)
            zero = torch.zeros(left.n_rows, dtype=c.dtype, device=c.device)
            cols[out_name] = P.where(matched, _take(c, idx), zero) if m else zero
        cols["_matched"] = matched
        return Table(cols), matched.sum(dtype=torch.int32)

    # inner: expand duplicate matches.  The output length is data-dependent:
    # one host read for the total, then a gather plan of that length.
    mult = hi - lo
    total = int(mult.sum())
    dev = lo.device
    if total == 0:
        cols = {name: left.column(name)[:0] for name in left.column_names}
        for name, out_name in right_cols:
            cols[out_name] = rs.column(name)[:0]
        return Table(cols), torch.zeros((), dtype=torch.int32, device=dev)
    offs = torch.cumsum(mult, 0)  # inclusive; offs - mult is the exclusive start
    j = torch.arange(total, device=dev)
    li = torch.searchsorted(offs, j, right=True).clamp(0, lo.shape[0] - 1)
    ri = (lo[li] + j - (offs - mult)[li]).clamp(0, m - 1)
    cols = {name: _take(left.column(name), li) for name in left.column_names}
    for name, out_name in right_cols:
        cols[out_name] = _take(rs.column(name), ri)
    return Table(cols), torch.tensor(total, dtype=torch.int32, device=dev)


def _lex_searchsorted(sorted_words, query_words, *, side="left", bound=None):
    """Vectorized lexicographic binary search over multi-word u32 keys.

    The reference's search (``table/ops.py`` ``_lex_searchsorted``), kept
    with its signature for parity with it; the joins call
    :func:`_equal_range`, which runs the same search once for both sides.

    ``sorted_words``: word planes of the lexicographically sorted haystack
    (most significant first); ``query_words``: same-width query planes.
    Returns int64 insertion positions in [0, m]: ``side="left"`` counts
    strictly smaller haystack keys, ``side="right"`` smaller-or-equal.

    ``bound``: optional 0-dim tensor limiting the search to the first
    ``bound`` haystack rows (capacity-padded buffers whose valid prefix
    length is data-dependent, the distributed join's case); it is never
    read on the host.

    Both sides pack into int64 groups of equal order (the sort's own
    ``_planes._packed_groups``).  A key of one group (at most 64 bits) is
    one ``torch.searchsorted``, the rows past ``bound`` read as the largest
    int64 and the result clamped to ``bound``.  Wider keys take a branchless
    power-of-two descent: log2(m) rounds, each a clamped gather of every
    candidate group and a lexicographic compare."""
    return _search_packed(P._packed_groups(sorted_words),
                          P._packed_groups(query_words), side == "right", bound)


def _equal_range(sorted_words, query_words, *, bound=None):
    """(left, right) insertion positions of every query, as the two sides
    of :func:`_lex_searchsorted`, with one search where the key is wider
    than one int64 group: ``right`` is then one past the end of the run of
    equal haystack keys that starts at ``left``, else ``left``."""
    hay = P._packed_groups(sorted_words)
    queries = P._packed_groups(query_words)
    lo = _search_packed(hay, queries, False, bound)
    m = int(hay[0].shape[0])
    if len(hay) == 1 or m == 0:
        return lo, _search_packed(hay, queries, True, bound)
    pos = torch.arange(m, device=lo.device)
    limit = m if bound is None else bound.to(torch.int64)
    new = (pos == 0) | (pos == limit)  # a run starts at the bound
    for h in hay:
        new |= h != h.roll(1)
    run = torch.cumsum(new, 0)  # nondecreasing run numbers
    at = lo.clamp(max=m - 1)
    eq = lo < limit
    for h, q in zip(hay, queries):
        eq &= h[at] == q
    return lo, torch.where(eq, torch.searchsorted(run, run[at], right=True), lo)


def _search_packed(hay, queries, want_leq: bool, bound):
    """:func:`_lex_searchsorted` on packed int64 groups."""
    m = int(hay[0].shape[0])
    nq = queries[0].shape[0]
    dev = queries[0].device
    pos = torch.zeros(nq, dtype=torch.int64, device=dev)
    if m == 0:
        return pos
    if len(hay) == 1:
        h = hay[0]
        if bound is not None:
            top = torch.iinfo(torch.int64).max
            h = torch.where(torch.arange(m, device=dev) < bound, h, top)
        pos = torch.searchsorted(h, queries[0], right=want_leq)
        return pos if bound is None else torch.minimum(pos, bound.to(torch.int64))
    limit = m if bound is None else bound.to(torch.int64)
    step = 1 << (m.bit_length() - 1)
    while step >= 1:
        cand = pos + step
        at = (cand - 1).clamp(0, m - 1)
        lt = torch.zeros(nq, dtype=torch.bool, device=dev)
        eq = torch.ones(nq, dtype=torch.bool, device=dev)
        for h, q in zip(hay, queries):
            s = h[at]
            lt |= eq & (s < q)
            eq &= s == q
        take = (cand <= limit) & ((lt | eq) if want_leq else lt)
        pos = torch.where(take, cand, pos)
        step //= 2
    return pos
