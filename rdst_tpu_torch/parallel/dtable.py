"""Distributed table pipeline: shuffle sort + aggregate + filter + join.

Port of ``rdst_tpu/parallel/dtable.py``.  Tables are sharded row-wise over
the mesh's shards (shard s holds rows ``[s * n / D, (s + 1) * n / D)``);
the operators compose:

  * ``distributed_sort_table``      - global ORDER BY via the MSB shuffle
    (the device-major concatenation of the valid rows is the sorted table);
  * ``distributed_filter``          - a local filter on every shard (no
    exchange), packed left with per-shard counts;
  * ``distributed_group_aggregate`` - shuffle rows by group key (range or
    hash partition: every group lands on one shard, or on a run of shards
    when the shuffle rank-splits one key), then a local sort-based
    aggregate and a combine of the groups that straddle shard boundaries;
  * ``distributed_join``            - co-partition both sides by the same
    partition, then a local sort-merge join on every shard.

The JAX package runs each body inside ``shard_map``.  Here each process
runs it in lockstep over the shards of a
:class:`~rdst_tpu_torch.parallel.mesh.Mesh` that it holds (all of them, or
one block after ``init_distributed``), with the mesh's collectives in place
of ``all_gather`` / ``psum`` and the flat shard index (``mesh.shards``) in
place of ``axis_index``, as ``parallel/shuffle.py`` does.  On a mesh over
processes each process passes its own rows (``L * n_local``, its L shards'
share) and gets back its shards' output with the global counts; the
outputs of the ranks, concatenated rank by rank, are the one-process
result.  Every rank issues the same collectives in the same order, and
every ``OverflowError`` is decided on global counts, so all ranks raise
it or none does.  Every operator runs on the mesh's cards: a table's rows
are split over them in order (card c's block copied to card c on its
stream where it lies elsewhere), each shard's work runs on its card's
stream, and the boundary combine's gathered rows and the counts on card 0,
each card reading its own copy.  On one card (``devices=None``) the
operator returns one ``Table``; on K > 1 cards, one per card, card c's on
card c: concatenated in card order they are the one-card result (the
static-length outputs of the sort and the filter, and the densified rows
of the aggregate and the join alike; nothing is gathered onto card 0).
The counts, the group count and the match count stay as on one card.  A
table in may also be such a list, one ``Table`` per card.  The aggregate
and the join densify on each card: its shards' valid prefixes,
concatenated, after one host read of the gathered per-shard counts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import keys as _keys
from rdst_tpu_torch.builder import _encode_payload
from rdst_tpu_torch.parallel.mesh import Mesh
from rdst_tpu_torch.parallel.shuffle import (
    _capacity, _check_axis, distributed_sort, partition_exchange,
)
from rdst_tpu_torch.table import ops as tops
from rdst_tpu_torch.table.table import Table

__all__ = [
    "distributed_sort_table",
    "distributed_filter",
    "distributed_group_aggregate",
    "distributed_join",
]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for u32 values held in int64, in 16-bit halves of
    ``c`` so no product passes 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_plane(words) -> torch.Tensor:
    """Deterministic 32-bit mix of the key word planes (dtable.py
    ``_hash_plane``): Fibonacci-multiplicative with an avalanche shift per
    word, bit-equal to the reference.  Equal keys always collide, which is
    all co-partitioning needs; distinct keys spread over all 32 bits, so
    the shuffle's window draws its 16 bucket bits from the hash."""
    h = None
    for w in words:
        w = P.widen(w)
        h = w if h is None else h ^ w
        h = _mul32(h, _GOLDEN)
        h = h ^ (h >> 15)
    return P.narrow(h, torch.uint32)


def _on_mesh(table, mesh: Mesh) -> list[Table]:
    """The table's rows split over the mesh's cards in order, card c's on
    card c (copied there on its stream where they lie elsewhere); a list
    of one table per card passes, each moved to its card."""
    K = len(mesh.devices)
    if isinstance(table, (list, tuple)):
        if len(table) != K:
            raise ValueError(f"{len(table)} tables for {K} cards")
        parts = list(table)
    else:
        n = table.n_rows
        if n % mesh.n_local:
            raise ValueError(f"length {n} not divisible by the {mesh.n_local} "
                             "shards of this process")
        b = n // K
        parts = [table if K == 1 else
                 Table({c: table.column(c)[i * b:(i + 1) * b] for c in table.column_names})
                 for i in range(K)]
    out = []
    for c, (t, dev) in enumerate(zip(parts, mesh.devices)):
        with mesh.on(c):
            out.append(t if t.device == dev else
                       Table({name: t.column(name).to(dev) for name in t.column_names}))
    return out


def _planes(per_card):
    """Each card's plane list -> the shuffle's planes: tensors on one card,
    per-card lists on several."""
    if len(per_card) == 1:
        return list(per_card[0])
    return [list(blocks) for blocks in zip(*per_card)]


def _block(plane, c):
    """Card c's block of a plane of the shuffle's output."""
    return plane[c] if isinstance(plane, list) else plane


def _per_card(tables):
    return tables[0] if len(tables) == 1 else tables


def _encode_table(table: Table, by):
    """Normalize the key columns and encode the rest as u32 payload words."""
    by = [by] if isinstance(by, str) else list(by)
    fields = tuple(table.column(c) for c in by)
    nk = _keys.normalize(fields if len(fields) > 1 else fields[0])
    other = [c for c in table.column_names if c not in by]
    enc = [(c, _encode_payload(table.column(c), table.device)) for c in other]
    payload_words = [w for _, (ws, _) in enc for w in ws]
    return by, nk, other, enc, payload_words


def _key_columns(by, nk, out_words) -> dict:
    out = _keys.denormalize(
        _keys.NormalizedKeys(tuple(out_words), nk.n_bytes, nk.meta))
    return dict(zip(by, (out,) if len(by) == 1 else out))


def _decode_columns(enc, planes, names=None) -> dict:
    """Decode consecutive payload planes per encoded column; ``names``
    renames them."""
    cols = {}
    i = 0
    for j, (name, (ws, decode)) in enumerate(enc):
        k = len(ws)
        cols[name if names is None else names[j]] = decode(list(planes[i:i + k]))
        i += k
    return cols


def _per_shard(planes, L: int):
    """(L * c,) planes of this process's L shards -> per shard, the list of
    its (c,) views."""
    c = int(planes[0].shape[0]) // L
    return [[p[i * c:(i + 1) * c] for p in planes] for i in range(L)]


def _dense(per_shard, counts) -> list[torch.Tensor]:
    """Each output plane: the shards' valid prefixes, concatenated on their
    device (``counts``: host ints)."""
    out = []
    for j, p in enumerate(per_shard[0]):
        parts = [P.sview(planes[j][:c]) for planes, c in zip(per_shard, counts)]
        out.append(torch.cat(parts).view(p.dtype))
    return out


def distributed_sort_table(
    table: Table,
    by,
    *,
    mesh: Mesh,
    axis: str = "shard",
    capacity_factor: float = 1.5,
    stable: bool = True,
    overlap_exchange: bool = False,
):
    """Global ORDER BY over the mesh.  Returns (Table of D * capacity rows
    in device-major order, (D,) per-shard valid counts).  On a mesh over
    processes each rank passes its own rows and gets its shards' L *
    capacity rows with the global (D,) counts.  On K > 1 cards, one Table
    a card."""
    with mesh.call():
        tables = _on_mesh(table, mesh)
        encs = []
        for c in mesh.cards:
            with mesh.on(c):
                encs.append(_encode_table(tables[c], by))
        words, payloads, counts = distributed_sort(
            _planes([e[1].words for e in encs]), _planes([e[4] for e in encs]),
            mesh=mesh, axis=axis, capacity_factor=capacity_factor, stable=stable,
            overlap_exchange=overlap_exchange,
        )
        out = []
        for c in mesh.cards:
            by_c, nk, _, enc, _ = encs[c]
            with mesh.on(c):
                cols = _key_columns(by_c, nk, [_block(w, c) for w in words])
                cols.update(_decode_columns(enc, [_block(p, c) for p in payloads]))
            out.append(Table({n: cols[n] for n in tables[c].column_names}))
    return _per_card(out), counts


def distributed_filter(table: Table, mask, *, mesh: Mesh, axis: str = "shard"):
    """A local filter on every shard (no exchange): each shard's kept rows
    packed left in stable order, its other rows after them, with (D,) int32
    per-shard counts.  On a mesh over processes the table and the mask are
    this rank's rows; the counts are global (one ``all_gather``).  On K > 1
    cards, one Table a card (the mask split as the rows, or one per card)."""
    _check_axis(mesh, axis)
    with mesh.call():
        tables = _on_mesh(table, mesh)
        K, L = len(mesh.devices), mesh.per_card
        if isinstance(mask, (list, tuple)):
            masks = list(mask)
        else:  # split first: each card's part reaches it on its stream
            b = int(mask.shape[0]) // K
            masks = [mask[c * b:(c + 1) * b] for c in range(K)]
        outs, kept = [], []
        for c, (t, dev) in enumerate(zip(tables, mesh.devices)):
            with mesh.on(c):
                m = _keys._to_tensor(masks[c], dev).to(dev)
                if m.dtype != torch.bool:
                    m = m != 0
                n = t.n_rows
                # every shard's stable 1-bit sort at once: rows of the
                # (L, n / L) view
                keep = m.view(L, n // L)
                idx = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
                idx += torch.arange(0, n, n // L, device=dev)[:, None]
                idx = idx.view(-1)
                outs.append(Table({name: tops._take(t.column(name), idx)
                                   for name in t.column_names}))
                kept.extend(keep.sum(1))  # int64: what collectives carry
        counts = mesh.all_gather(kept)
    return _per_card(outs), counts.to(torch.int32)


# ---------------------------------------------------------------------------
# The aggregate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _AggPlan:
    """Per-call aggregation plan: (out_name, op) per aggregate, the words
    of each min/max value's order normalization, and each value's (min
    identity, max identity) in :func:`_ordered` space."""

    val_specs: tuple
    norm_widths: tuple
    sentinels: tuple


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """Values whose order torch's min/max see as the column's own: unsigned
    columns as int64 (u64 with its sign bit flipped), bools as int64."""
    if x.dtype in P.UNSIGNED:
        return P.widen(x)
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ (-(1 << 63))
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    return x


def _unordered(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    if dt in P.UNSIGNED:
        return P.narrow(v, dt)
    if dt == torch.uint64:
        return (v ^ (-(1 << 63))).view(torch.uint64)
    if dt == torch.bool:
        return v != 0
    return v


def _sentinels(dt: torch.dtype) -> tuple:
    """(identity of min, identity of max) for a column of ``dt``, in
    :func:`_ordered` space (the reference's iinfo/finfo bounds)."""
    if dt == torch.bool:
        return (1, 0)
    if dt == torch.uint64:
        return ((1 << 63) - 1, -(1 << 63))
    if dt.is_floating_point:
        info = torch.finfo(dt)
        return (float(info.max), float(info.min))
    info = torch.iinfo(dt)
    return (int(info.max), int(info.min))


def _agg_local(plan: _AggPlan, kw, vals, norm_words, cnt):
    """One shard's segment reduction (the first half of dtable.py
    ``_agg_body``): ``kw`` its key word planes (locally sorted, valid rows
    first), ``vals`` one value plane per aggregate, ``norm_words`` the
    min/max values' order words, ``cnt`` its 0-dim valid count.  Returns
    the shard's state for the boundary combine."""
    n = kw[0].shape[0]
    dev = kw[0].device
    pos = torch.arange(n, device=dev)
    valid = pos < cnt
    starts = valid & tops._segment_starts(kw)
    G = starts.sum()
    # group start positions packed first (a stable partition)
    gstart = torch.argsort((~starts).to(torch.uint8), stable=True)
    gend = torch.where(pos == G - 1, cnt - 1, gstart.roll(-1) - 1).clamp(0, n - 1)
    sizes = (gend - gstart + 1).to(torch.int32)
    packed: dict = {}
    ni = 0
    for vi, (out_name, op) in enumerate(plan.val_specs):
        c = vals[vi]
        nw = plan.norm_widths[vi]
        if op == "count":
            packed[out_name] = sizes
        elif op in ("sum", "mean"):
            # prefix sums: the rows past ``cnt`` come after every valid
            # group, so they change no valid group's sum
            s = tops._segment_sum(c, gstart, gend)
            packed[out_name] = s
            if op == "mean":
                packed[out_name] = s.to(torch.float32) / sizes.clamp(min=1).to(torch.float32)
                packed[out_name + "\0sum"] = s
        elif op == "first":
            packed[out_name] = tops._take(c, gstart)
        elif op == "last":
            packed[out_name] = tops._take(c, gend)
        else:  # min / max: ends of segments sorted by (validity, key, value)
            validity = P.narrow((~valid).to(torch.int64), torch.uint32)
            planes = [validity] + list(kw) + list(norm_words[ni:ni + nw]) + [c]
            vs = P.lex_sort(planes, len(planes) - 1, stable=True)[-1]
            packed[out_name] = tops._take(vs, gstart if op == "min" else gend)
        ni += nw
    last = torch.clamp(cnt - 1, 0, n - 1).view(1)
    return dict(
        kw=kw, G=G, gstart=gstart, sizes=sizes, packed=packed,
        has=cnt > 0,
        first_key=torch.cat([P.widen(w[:1]) for w in kw]),
        last_key=torch.cat([P.widen(P.take(w, last)) for w in kw]),
    )


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits64(x: torch.Tensor) -> torch.Tensor:
    """int64 holding ``x``'s bits: each value's signed view of its own
    width, widened (sign-extended), so :func:`_from_bits64` restores it."""
    return x.view(_INT_OF_WIDTH[x.element_size()]).to(torch.int64)


def _from_bits64(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return v.to(_INT_OF_WIDTH[dt.itemsize]).view(dt)


def _boundary_rows(mesh: Mesh, local: list):
    """Every shard's boundary state, gathered in one ``all_gather``: each
    shard packs ``has``, its first and last key words, its first group's
    size and each first-group partial (bit for bit) into one int64 row.
    Returns (has (D,) bool, first keys (D, nk), last keys (D, nk), first
    sizes (D,) int32, {partial: (D,) of its signed view's dtype})."""
    nk = local[0]["first_key"].shape[0]
    names = list(local[0]["packed"])
    dts = [P.sview(local[0]["packed"][k]).dtype for k in names]
    rows = [None] * len(local)
    for i, _ in mesh.each():
        x = local[i]
        rows[i] = torch.cat([x["has"].to(torch.int64).view(1), x["first_key"],
                             x["last_key"], x["sizes"][:1].to(torch.int64)]
                            + [_bits64(P.sview(x["packed"][k][:1])) for k in names])
    g = mesh.all_gather(rows)  # (D, 2 nk + 2 + partials)
    partials = {k: _from_bits64(g[:, 2 * nk + 2 + j], dt)
                for j, (k, dt) in enumerate(zip(names, dts))}
    return (g[:, 0] != 0, g[:, 1:1 + nk], g[:, 1 + nk:1 + 2 * nk],
            g[:, 1 + 2 * nk].to(torch.int32), partials)


def _agg_combine(mesh: Mesh, plan: _AggPlan, local: list):
    """The boundary combine of dtable.py ``_agg_body``, in lockstep: a group
    that straddles shards (the shuffle rank-split its key, across a process
    boundary too) belongs to the first shard holding its rows, which adds
    the first-group partials of every later shard whose first key equals
    its last key; those shards drop their first group.  ``local[i]`` is
    shard ``mesh.shards[i]``'s state.  Returns per local shard (output
    planes: key words, then one per aggregate; its group count)."""
    D = mesh.size
    g_has, g_first, g_last, first_sizes, partials = _boundary_rows(mesh, local)
    names = list(partials)
    rep = mesh.replicas(g_has, g_first, g_last, first_sizes, *partials.values())
    outs, counts, iotas = [None] * len(local), [None] * len(local), {}
    for i, c in mesh.each():
        me, x, dev = mesh.shards[i], local[i], mesh.devices[c]
        g_has, g_first, g_last, first_sizes = rep[c][:4]
        first_partials = dict(zip(names, rep[c][4:]))
        if c not in iotas:
            iotas[c] = torch.arange(D, device=dev)
        d_iota = iotas[c]
        n = x["gstart"].shape[0]
        has = x["has"]
        suppressed = has & ((d_iota < me) & g_has
                            & (g_last == x["first_key"][None]).all(1)).any()
        contrib = ((d_iota > me) & g_has
                   & (g_first == x["last_key"][None]).all(1) & has)
        last_slot = torch.clamp(x["G"] - 1, 0, n - 1).view(1)
        packed = dict(x["packed"])

        def at_last(v):  # (1,) of v's own dtype
            return P.sview(v).index_select(0, last_slot).view(v.dtype)

        def put_last(v, new):  # v with new (1,) at the last slot
            return P.sview(v).index_copy(0, last_slot, P.sview(new)).view(v.dtype)

        for vi, (out_name, op) in enumerate(plan.val_specs):
            cur = packed[out_name]
            fp = first_partials[out_name].view(cur.dtype)
            if op in ("sum", "count"):
                add = torch.where(contrib, fp, 0).sum()
                packed[out_name] = cur.index_add(0, last_slot, add.view(1).to(cur.dtype))
            elif op == "mean":
                fs = first_partials[out_name + "\0sum"]
                s = at_last(packed[out_name + "\0sum"]) + torch.where(contrib, fs, 0).sum()
                c2 = at_last(x["sizes"]) + torch.where(contrib, first_sizes, 0).sum()
                new = s.to(torch.float32) / c2.clamp(min=1).to(torch.float32)
                packed[out_name] = put_last(cur, new)
            elif op in ("min", "max"):
                red = torch.amin if op == "min" else torch.amax
                ofp = _ordered(fp)
                ident = torch.full((), plan.sentinels[vi][op == "max"],
                                   dtype=ofp.dtype, device=dev)
                best = red(torch.where(contrib, ofp, ident)).view(1)
                new = red(torch.cat([_ordered(at_last(cur)), best])).view(1)
                packed[out_name] = put_last(cur, _unordered(new, cur.dtype))
            elif op == "last":
                e = torch.where(contrib, d_iota, -1).max()
                from_later = P.sview(fp).index_select(0, e.clamp(0, D - 1).view(1))
                new = torch.where(e >= 0, from_later, P.sview(at_last(cur)))
                packed[out_name] = put_last(cur, new.view(cur.dtype))
            # 'first': the owner's value is already right

        # drop a suppressed first group: shift every output left by one
        shift = suppressed.to(torch.int64)
        rot = (torch.arange(n, device=dev) + shift) % n
        keys = [P.take(P.take(w, x["gstart"]), rot) for w in x["kw"]]
        aggs = [tops._take(packed[name], rot) for name, _ in plan.val_specs]
        outs[i] = keys + aggs
        counts[i] = x["G"] - shift
    return outs, counts


def _check_partition(partition):
    if partition not in ("range", "hash"):
        raise ValueError("partition must be 'range' or 'hash'")


def distributed_group_aggregate(
    table: Table,
    by,
    aggs: Mapping[str, tuple[str, str]],
    *,
    mesh: Mesh,
    axis: str = "shard",
    capacity_factor: float = 1.5,
    overlap_exchange: bool = False,
    partition: str = "range",
):
    """Shuffle-then-local GROUP BY, finished on the mesh.

    The shuffle partitions rows by the group key; each shard then
    segment-reduces its resident rows (sum/count/mean by cumsum differences,
    min/max by a value-keyed local sort), and groups that straddle a shard
    boundary (possible when the shuffle rank-splits one key) are combined
    from gathered first-group partials (:func:`_agg_combine`).  Returns
    (Table of group rows, densified on the mesh's device, or on K > 1
    cards one Table a card, densified on it; a 0-dim int32 tensor of the
    group count).  On a mesh over processes each rank gets
    its own shards' group rows and the global group count.

    ``partition="hash"`` shuffles by a leading 32-bit key hash instead of
    the key range: distinct group keys spread uniformly whatever their range
    clustering, and the group rows arrive in hash order, not key order."""
    by_list = [by] if isinstance(by, str) else list(by)
    for _, (_, op) in aggs.items():
        if op not in tops._AGG_OPS:
            raise ValueError(f"unsupported agg op {op!r}")
    _check_partition(partition)
    with mesh.call():
        return _group_aggregate(mesh, _on_mesh(table, mesh), by_list, aggs, axis,
                                capacity_factor, overlap_exchange, partition)


def _group_aggregate(mesh, tables, by_list, aggs, axis, capacity_factor,
                     overlap_exchange, partition):
    D, L = mesh.size, mesh.per_card

    # 1. shuffle rows by group key; value columns ride as payload words.  A
    # value column that is also a group key rides under an alias.
    need_cols = sorted({c for c, _ in aggs.values() if c is not None})
    alias = {c: (c + "\0v" if c in by_list else c) for c in need_cols}
    encs, shuffle_words = [], []
    for c, t in enumerate(tables):
        sub_cols = {k: t.column(k) for k in by_list}
        for k in need_cols:
            sub_cols[alias[k]] = t.column(k)
        with mesh.on(c):
            encs.append(_encode_table(Table(sub_cols), by_list))
            words_c = list(encs[-1][1].words)
            if partition == "hash":
                words_c = [_hash_plane(words_c)] + words_c
        shuffle_words.append(words_c)
    nk = encs[0][1]
    words, payloads, counts = distributed_sort(
        _planes(shuffle_words), _planes([e[4] for e in encs]), mesh=mesh, axis=axis,
        capacity_factor=capacity_factor, stable=True,
        overlap_exchange=overlap_exchange,
    )
    cap = _capacity(words[0], mesh)
    if max(counts.tolist()) > cap:  # the global counts: every rank alike
        raise OverflowError("shuffle capacity exceeded; raise capacity_factor")

    # 2. decode the value planes, build the plan, and every shard's segment
    # reduction (on its card), then the boundary combine
    nkw = nk.n_words + (1 if partition == "hash" else 0)
    cnts = mesh.replicas(counts)
    local = [None] * mesh.n_local
    plan = None
    for c in mesh.cards:
        with mesh.on(c):
            dec_cols = _decode_columns(encs[c][3], [_block(p, c) for p in payloads])
            val_specs, val_arrays, norm_planes, norm_widths, sentinels = [], [], [], [], []
            for out_name, (col, op) in aggs.items():
                if col is None or op == "count":
                    v = torch.zeros(L * cap, dtype=torch.int32, device=mesh.devices[c])
                else:
                    v = dec_cols[alias[col]]
                val_specs.append((out_name, op))
                val_arrays.append(v)
                if op in ("min", "max"):
                    vnk = _keys.normalize(v)
                    norm_planes.extend(vnk.words)
                    norm_widths.append(vnk.n_words)
                    sentinels.append(_sentinels(v.dtype))
                else:
                    norm_widths.append(0)
                    sentinels.append((0, 0))
            plan = _AggPlan(tuple(val_specs), tuple(norm_widths), tuple(sentinels))
            shards = _per_shard([_block(w, c) for w in words] + val_arrays + norm_planes, L)
            for j, p in enumerate(shards):
                i = c * L + j
                local[i] = _agg_local(plan, p[:nkw], p[nkw:nkw + len(val_arrays)],
                                      p[nkw + len(val_arrays):], cnts[c][0][mesh.shards[i]])
            del shards
    outs, gcounts = _agg_combine(mesh, plan, local)
    del local

    # 3. densify on each card: one all_gather and one host read of the group
    # counts, every shard's (the total) then this process's
    gc = mesh.read_gathered(gcounts, gcounts).tolist()
    shift = nkw - nk.n_words  # the hash word is not a key column
    out = []
    for c in mesh.cards:
        mine = slice(c * L, (c + 1) * L)
        with mesh.on(c):
            dense = _dense(outs[mine], gc[D:][mine])
            cols = _key_columns(by_list, nk, dense[shift:nkw])
        for (out_name, _), plane in zip(plan.val_specs, dense[nkw:]):
            cols[out_name] = plane
        out.append(Table(cols))
    total = torch.tensor(sum(gc[:D]), dtype=torch.int32, device=mesh.device)
    return _per_card(out), total


# ---------------------------------------------------------------------------
# The join
# ---------------------------------------------------------------------------


def _join_local(lw, lpay, lcnt, rw, rpay, rcnt, out_cap, how):
    """One shard's sort-merge join of co-partitioned sides (dtable.py
    ``_join_body``).  Both sides arrive from the exchange with their valid
    prefix sorted by key; the probe is the bounded lexicographic binary
    search.  Inner joins expand duplicate right matches into ``out_cap``
    rows (the returned total may exceed it: the caller raises).  Returns
    (output planes, rows in the output, matches)."""
    lcap = lw[0].shape[0]
    rcap = rw[0].shape[0]
    dev = lw[0].device
    lo, hi = tops._equal_range(rw, lw, bound=rcnt)
    matched = (torch.arange(lcap, device=dev) < lcnt) & (hi > lo)

    def pick(p, idx, ok, fill):
        return P.where(ok, P.take(p, idx), P.fill_like(idx.shape[0], fill, p))

    if how == "left":
        ri = lo.clamp(0, max(rcap - 1, 0))
        outs = list(lw) + list(lpay) + [pick(p, ri, matched, 0) for p in rpay]
        outs.append(P.narrow(matched.to(torch.int64), torch.uint32))
        return outs, lcnt, matched.sum()

    mult = torch.where(matched, hi - lo, 0)
    offs = torch.cumsum(mult, 0)
    total = offs[-1]
    j = torch.arange(out_cap, device=dev)
    li = torch.searchsorted(offs, j, right=True).clamp(0, lcap - 1)
    ri = (lo[li] + j - (offs - mult)[li]).clamp(0, max(rcap - 1, 0))
    ok = j < total
    outs = ([pick(p, li, ok, -1) for p in lw] + [pick(p, li, ok, 0) for p in lpay]
            + [pick(p, ri, ok, 0) for p in rpay])
    return outs, total, total


def distributed_join(
    left: Table,
    right: Table,
    on,
    *,
    mesh: Mesh,
    axis: str = "shard",
    how: str = "inner",
    suffix: str = "_r",
    capacity_factor: float = 1.5,
    right_capacity_factor: float | None = None,
    join_capacity_factor: float = 1.0,
    overlap_exchange: bool = False,
    partition: str = "range",
):
    """Distributed sort-merge equi-join, finished on the mesh (duplicate
    right keys expand for ``how="inner"``; ``how="left"`` takes the first
    match and zero-fills the rest: :func:`rdst_tpu_torch.table.ops.join`
    semantics).

    Both sides are co-partitioned by the same partition: the left table's
    shuffle derives it with shard-atomic buckets (``split_uniform=False``:
    equal keys must not straddle shards), the right table routes through
    ``partition_exchange`` with it, and every shard joins its resident
    slices (:func:`_join_local`).  Returns (Table densified on the mesh's
    device, or on K > 1 cards one Table a card, densified on it; the match
    count as an int).  On a mesh over processes both
    sides are this rank's rows; each rank gets its own shards' output rows
    and the global match count.

    ``join_capacity_factor`` sizes each shard's inner-join output as a
    multiple of its left capacity; 1.0 covers any unique-right-key (pk-fk)
    join, duplicates may need more (``OverflowError`` says so).  A heavily
    skewed join key concentrates its bucket on one shard and needs
    ``capacity_factor`` headroom; small right sides get full-table capacity
    (``config.replicate_capacity_max``).

    ``partition="hash"`` prepends a 32-bit key hash as the leading shuffle
    word on both sides: distinct keys spread uniformly even when they
    cluster in one key range, and each shard's rows arrive in (hash, key)
    order.  Equal keys still meet, and the local merge matches on the
    (hash, key) composite."""
    if how not in ("inner", "left"):
        raise ValueError("how must be 'inner' or 'left'")
    _check_partition(partition)
    on_list = [on] if isinstance(on, str) else list(on)
    if right_capacity_factor is None:
        right_capacity_factor = capacity_factor
    with mesh.call():
        return _join(mesh, _on_mesh(left, mesh), _on_mesh(right, mesh), on_list,
                     axis, how, suffix, capacity_factor, right_capacity_factor,
                     join_capacity_factor, overlap_exchange, partition == "hash")


def _join(mesh, lefts, rights, on_list, axis, how, suffix, capacity_factor,
          right_capacity_factor, join_capacity_factor, overlap_exchange, hashed):
    def encode(tables):
        encs, words = [], []
        for c, t in enumerate(tables):
            with mesh.on(c):
                encs.append(_encode_table(t, on_list))
                nk = encs[-1][1]
                words.append(([_hash_plane(nk.words)] if hashed else []) + list(nk.words))
        return encs, _planes(words), _planes([e[4] for e in encs])

    lencs, lwords, lpay = encode(lefts)
    by, nk, _, enc, payload_words = lencs[0]
    words, payloads, counts, part = distributed_sort(
        lwords, lpay, mesh=mesh, axis=axis,
        capacity_factor=capacity_factor, stable=True,
        split_uniform=False, return_partition=True,
        overlap_exchange=overlap_exchange,
    )
    rencs, rwords_in, rpay = encode(rights)
    rnk, renc, rpayload_words = rencs[0][1], rencs[0][3], rencs[0][4]
    if rnk.n_words != nk.n_words:
        raise TypeError(
            "join key dtypes must normalize to the same width on both sides"
        )
    rwords, rpayloads, rcounts = partition_exchange(
        rwords_in, rpay, part, mesh=mesh, axis=axis,
        capacity_factor=right_capacity_factor, stable=True,
        overlap_exchange=overlap_exchange,
    )
    del lwords, lpay, rwords_in, rpay

    D, L = mesh.size, mesh.per_card
    lcap = _capacity(words[0], mesh)
    rcap = _capacity(rwords[0], mesh)
    both = torch.cat([counts, rcounts]).tolist()  # global: every rank alike
    if max(both[:D]) > lcap or max(both[D:]) > rcap:
        raise OverflowError("shuffle capacity exceeded; raise capacity_factor")
    out_cap = max(int(math.ceil(join_capacity_factor * lcap)), 16)
    # the local merge matches on every arriving key plane, the hash too
    nkw = (1 if hashed else 0) + nk.n_words
    cnts = mesh.replicas(counts, rcounts)
    outs, sizes = [None] * mesh.n_local, [None] * mesh.n_local
    for c in mesh.cards:
        with mesh.on(c):
            lsh = _per_shard([_block(p, c) for p in list(words) + list(payloads)], L)
            rsh = _per_shard([_block(p, c) for p in list(rwords) + list(rpayloads)], L)
            for j, (ls, rs) in enumerate(zip(lsh, rsh)):
                i = c * L + j
                s = mesh.shards[i]
                o, jc, mt = _join_local(ls[:nkw], ls[nkw:], cnts[c][0][s],
                                        rs[:nkw], rs[nkw:], cnts[c][1][s], out_cap, how)
                outs[i] = o
                sizes[i] = torch.stack([jc, mt]).to(torch.int64)
            del lsh, rsh
    del words, payloads, rwords, rpayloads
    # every shard's (output rows, matches): one all_gather, one host read,
    # so every rank raises the same OverflowError or none does
    got = mesh.read_gathered(sizes, sizes)
    jc, n_matched = got[:D, 0], int(got[:D, 1].sum())
    if how == "inner" and jc.max() > out_cap:
        raise OverflowError(
            f"join output overflow: a device produced {jc.max()} rows > "
            f"capacity {out_cap}; raise join_capacity_factor"
        )

    left_names = lefts[0].column_names
    right_names = [name + (suffix if name in left_names else "")
                   for name, _ in renc]
    order = list(left_names) + right_names
    tables = []
    for c in mesh.cards:
        mine = slice(c * L, (c + 1) * L)
        with mesh.on(c):
            planes = _dense(outs[mine], got[D:, 0][mine].tolist())
            outs[mine] = [None] * L
            cols = _key_columns(on_list, lencs[c][1], planes[nkw - nk.n_words:nkw])
            i = nkw + len(payload_words)
            cols.update(_decode_columns(lencs[c][3], planes[nkw:i]))
            cols.update(_decode_columns(rencs[c][3], planes[i:i + len(rpayload_words)],
                                        right_names))
            if how == "left":
                cols["_matched"] = P.sview(planes[-1]) != 0
        tables.append(Table({n: cols[n] for n in order + (["_matched"] if how == "left" else [])}))
    return _per_card(tables), n_matched
