"""Distributed MSB shuffle sort over a mesh of shards.

Port of ``rdst_tpu/parallel/shuffle.py``, whose docstring explains the
algorithm: each shard sorts its rows locally; an entropy-adaptive 16-bit
window over the global key range buckets them; a global histogram assigns
buckets to shards by stable rank (single-key buckets split exactly, the
hottest multi-key bucket refined by fresh windows); every shard sends each
destination its contiguous segment; every shard sorts what it received.
The device-major concatenation of the shards' valid rows is the global
order.

The JAX package runs the body inside ``shard_map``.  Here each process
runs the body in lockstep over the shards of a
:class:`~rdst_tpu_torch.parallel.mesh.Mesh` that it holds (all of them, or
one block after ``init_distributed``): per-shard values are lists over
``mesh.shards``, and the collectives are the mesh's methods.  The exchange
is kernel B6 (``parallel/remote_dma.py``) on CUDA shards and its plain
version on CPU shards.  Outputs keep the JAX package's conventions: each
plane is one (L * capacity,) tensor laid out shard-major over this
process's L shards (L = D in one process), with the global (D,) ``counts``
of each shard's demand, and :func:`gather_valid` raises ``OverflowError``
where a demand exceeds the capacity.  On the flat mesh the outputs are the
exchange's own receive buffers, each shard's sorted rows written back into
its view.

On a mesh of several cards (``Mesh.devices``) each shard's work runs on
its card's stream (``Mesh.each``), so the cards sort at once; the values
the collectives replicate are computed on card 0 and read on each card
through its own copy (``Mesh.replicas``); an exchange group on one card
launches B6 once on that card's stream, and a group on several cards
launches it once per receiving card (``remote_dma_exchange_cards``: peer
reads, events in place of the barrier).  The flat mesh still writes its
finished rows back into the receive buffers, card by card, and each output
plane is the list of the cards' blocks.

A group of shards that lies in more than one process exchanges in four
steps (:func:`_exchange_across`): an ``all_gather`` of every sender's
sizes; one host read of that size matrix (with this process's send
offsets), because ``all_to_all_single`` takes its split sizes on the host;
one ``all_to_all_single`` of exactly the words that land, each card's
words staged to the communicator's device (card 0, or the CPU under gloo)
on that card's stream; and B6, whose senders are the group's shards (local
ones from their own planes on their cards, remote ones from the transport
buffer on card 0) and whose receivers are this process's, one launch per
receiving card where the call spans cards.

Not ported, by design: the dense ``all_to_all`` emulation
(shuffle.py:807-820), which exists only because XLA:CPU lacks
``ragged_all_to_all``.  The exchange here always has the exact ragged
layout; ``use_ragged`` is accepted and has no effect.  The D == 1 exchange
stays an identity, as the JAX package's semantics; the libtpu fault that
motivated it there does not apply.

In one process no step of a call waits for the device except
:func:`distributed_sort_auto` (which reads the counts) and
:func:`gather_valid`.  On a mesh that spans processes under NCCL, each
exchange adds one wait: the read of the size matrix.  Under gloo every
collective of the mesh (the histograms, extrema and counts as well) is a
blocking round trip through the CPU (``parallel/mesh.py``).
"""
from __future__ import annotations

import collections
from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch.ops.fused_sort import fused_sort, fused_sort_available
from rdst_tpu_torch.ops.merge import merge_sorted
from rdst_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh, make_mesh_2d
from rdst_tpu_torch.parallel.remote_dma import (
    PAD_WORD, remote_dma_exchange, remote_dma_exchange_cards,
)
from rdst_tpu_torch.utils.trace import span, traced

__all__ = [
    "distributed_sort", "distributed_sort_auto", "partition_exchange",
    "gather_valid", "init_distributed", "make_mesh", "make_mesh_2d",
    "N_BUCKETS", "PAD_WORD",
]

#: Partition granularity: 16 window bits (shuffle.py N_BUCKETS).
N_BUCKETS = 1 << 16
_I64 = torch.int64

#: Every per-shard sort by the route it took: ``(planes, rows, "B2/B3" or
#: "lex_sort") -> calls``.  Never cleared here; a caller that prints the
#: routes of one call clears it first.
SORT_ROUTES: collections.Counter = collections.Counter()


def _local_sort(planes, n_keys, stable):
    """Per-shard sort: the fused bitonic executor (B2/B3) when it takes the
    shard's shape, else ``lex_sort``; the span ``rdst.shuffle.sort.fused``
    or ``rdst.shuffle.sort.lex`` names the route."""
    words, payloads = list(planes[:n_keys]), list(planes[n_keys:])
    fused = fused_sort_available(words, payloads, stable=stable)
    SORT_ROUTES[(len(planes), int(planes[0].shape[0]),
                 "B2/B3" if fused else "lex_sort")] += 1
    if fused:
        with span("shuffle.sort.fused"):
            out_w, out_p = fused_sort(words, payloads, stable=stable)
        return list(out_w) + list(out_p)
    with span("shuffle.sort.lex"):
        return P.lex_sort(planes, n_keys, stable=stable)


def _valid_rows(valid, mesh: Mesh):
    """Each local shard's count of rows that take part (``valid[i]``: an int
    or a 0-dim tensor, for ``mesh.shards[i]``) as a 0-dim int64 tensor on
    the shard's card, made there without a host read; None passes."""
    if valid is None:
        return None
    if len(valid) != mesh.n_local:
        raise ValueError(f"{len(valid)} valid counts for {mesh.n_local} shards")
    out = [None] * mesh.n_local
    for i, c in mesh.each():
        v, dev = valid[i], mesh.devices[c]
        out[i] = (v.to(dev, _I64, non_blocking=True) if isinstance(v, torch.Tensor)
                  else torch.full((), int(v), dtype=_I64, device=dev))
    return out


def _drop_invalid(planes, n_keys, valid):
    """A shard's planes with the key words of the rows at or past ``valid``
    set to the pad word: a stable sort keeps them after every row that
    takes part (they lie after those rows already)."""
    pos = torch.arange(int(planes[0].shape[0]), device=planes[0].device)
    off = pos >= valid
    pad = P.full(1, PAD_WORD, torch.uint32, planes[0].device)
    return [P.where(off, pad, w) for w in planes[:n_keys]] + list(planes[n_keys:])


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of uint32 values held in int64 (any shape)."""
    k = torch.arange(32, device=x.device)
    return ((x.unsqueeze(-1) >> k) > 0).sum(-1)


def _window(mins: torch.Tensor, maxs: torch.Tensor):
    """16 window bits over the words' global ranges, most significant word
    first (shuffle.py ``_window_params``).  (W,) int64 in, (gmins, shifts,
    bits) out.  A word takes min(its bit length, what earlier words left).
    The span wraps as uint32 does (an empty segment's 0 - PAD_WORD is 1)."""
    bl = _bit_length((maxs - mins) & PAD_WORD)
    before = torch.cumsum(bl, 0) - bl
    bits = torch.minimum(bl, torch.clamp(16 - before, min=0))
    return mins, bl - bits, bits


def _window_params(keys, mesh: Mesh, valid=None):
    """Entropy-adaptive window from every shard's key planes (global
    min/max per word through the mesh's collectives); with ``valid``, over
    each shard's first ``valid[i]`` rows only."""
    lo, hi = [None] * len(keys), [None] * len(keys)
    for i, _ in mesh.each():
        if valid is None:
            ext = [P.widen(w).aminmax() for w in keys[i]]
            lo[i] = torch.stack([e.min for e in ext])
            hi[i] = torch.stack([e.max for e in ext])
            continue
        m = torch.arange(int(keys[i][0].shape[0]), device=keys[i][0].device) < valid[i]
        lo[i] = torch.stack([torch.where(m, P.widen(w), PAD_WORD).min() for w in keys[i]])
        hi[i] = torch.stack([torch.where(m, P.widen(w), 0).max() for w in keys[i]])
    return _window(mesh.pmin(lo), mesh.pmax(hi))


def _apply_window(words, gmins, shifts, bits) -> torch.Tensor:
    """int32 bucket ids (shuffle.py ``_apply_window``), in the JAX
    package's int32 arithmetic: a key outside the window's range saturates
    per word, and equal keys always share a bucket."""
    result = torch.zeros(words[0].shape, dtype=torch.int32, device=words[0].device)
    one = torch.ones((), dtype=torch.int32, device=result.device)
    bits = bits.to(torch.int32)
    for i, w in enumerate(words):
        clamped = torch.clamp(P.widen(w) - gmins[i], min=0)
        part = (clamped >> shifts[i]).to(torch.int32)  # wraps as astype(int32)
        part = torch.minimum(part, (one << bits[i]) - 1)
        result = (result << bits[i]) | part
    return result


def _single_key(mesh, keys, edges, hists, n_local):
    """(R,) bool: buckets whose global key set is one value (shuffle.py
    :243-265): per word, global min of segment minima == global max of
    segment maxima.  A shard's segment minimum is its bucket's first row,
    its maximum the last (PAD_WORD / 0 for empty buckets)."""
    per_shard = [None] * len(keys)
    for i, _ in mesh.each():
        e = edges[i]
        first = torch.clamp(e[:-1], 0, n_local - 1)
        last = torch.clamp(e[1:] - 1, 0, n_local - 1)
        nonempty = hists[i] > 0
        per_shard[i] = [
            (torch.where(nonempty, P.widen(P.take(w, first)), PAD_WORD),
             torch.where(nonempty, P.widen(P.take(w, last)), 0))
            for w in keys[i]
        ]
    uniform = None
    for wi in range(len(keys[0])):
        gmin = mesh.pmin([x[wi][0] for x in per_shard])
        gmax = mesh.pmax([x[wi][1] for x in per_shard])
        eq = gmin == gmax
        uniform = eq if uniform is None else uniform & eq
    return uniform


def _shard_body(mesh, n_keys, capacity, stage1_cap, stable, split_uniform,
                return_partition, overlap, refine_levels, shards, valid=None):
    """The shard_map body of the JAX package, in lockstep over this
    process's shards, each shard's work on its card's stream and the
    replicated values on card 0's (each card reading its own copies,
    :meth:`Mesh.replicas`).  ``shards[i]``: shard ``mesh.shards[i]``'s word
    and payload planes; ``valid[i]`` (or None: all) how many of its rows
    take part, the rest being left out of every count and of the exchange.
    Returns (output planes, counts, partition or None)."""
    D = mesh.size
    L = len(shards)
    n_local = int(shards[0][0].shape[0])

    # 1. local sort by the full key (payloads ride along), the cards at once;
    # rows left out sort last (stable), behind every row that takes part
    sorted_all = [None] * L
    for i, _ in mesh.each():
        planes = shards[i] if valid is None else _drop_invalid(shards[i], n_keys, valid[i])
        sorted_all[i] = _local_sort(planes, n_keys, stable or valid is not None)
    keys = [p[:n_keys] for p in sorted_all]
    with span("shuffle.plan"):
        take_lt, extra, cum_mid, Rd, window = _assignment(
            mesh, keys, split_uniform, return_partition, refine_levels, n_local, valid)
    input_offsets, send_sizes = [None] * L, [None] * L
    for i, _ in mesh.each():
        boundary = take_lt[i].sum(1)  # (D+1,)
        if extra is not None:
            boundary = boundary + extra[i]
        send_sizes[i] = boundary[1:] - boundary[:-1]
        input_offsets[i] = boundary[:-1]
    del keys, take_lt, extra

    # 4-6. exchange and local finish
    outs, counts = _exchange_and_finish(
        mesh, sorted_all, n_keys, input_offsets, send_sizes, capacity, stable,
        overlap, stage1_cap,
    )
    partition = None
    if return_partition:
        # each shard's first bucket, by the atomic rule's comparison
        dev_start = torch.searchsorted(cum_mid, Rd)
        dev_start[D] = N_BUCKETS
        partition = (*window[0], dev_start)  # card 0's: (gmins, shifts, bits)
    return outs, counts, partition


def _assignment(mesh, keys, split_uniform, return_partition, refine_levels, n_local,
                valid):
    """Steps 1b-3 of the body: the window, every shard's histogram, and each
    shard's rows taken by each destination (``take_lt``, with the hot-bucket
    refinement's ``extra`` boundary counts or None).  Returns (take_lt,
    extra, cum_mid, Rd, window replicas)."""
    D = mesh.size
    L = len(keys)
    dev = mesh.device
    R = N_BUCKETS
    window = mesh.replicas(*_window_params(keys, mesh, valid))

    # 2. per-shard histograms by searchsorted over the sorted bucket ids (a
    # row left out counts in bucket R: past every edge)
    edges, hists, ars = [None] * L, [None] * L, {}
    for i, c in mesh.each():
        if c not in ars:
            ars[c] = torch.arange(R + 1, dtype=torch.int32, device=mesh.devices[c])
        ids = _apply_window(keys[i], *window[c])
        if valid is not None:
            pos = torch.arange(n_local, device=mesh.devices[c])
            ids = torch.where(pos < valid[i], ids, R)
        edges[i] = torch.searchsorted(ids, ars[c])
        hists[i] = edges[i][1:] - edges[i][:-1]
    hist_matrix = None
    if split_uniform:
        hist_matrix = mesh.all_gather(hists)  # (D, R)
        global_hist = hist_matrix.sum(0)
        uniform = _single_key(mesh, keys, edges, hists, n_local)
    else:
        global_hist = mesh.psum(hists)
        uniform = torch.zeros(R, dtype=torch.bool, device=dev)

    # 3. destination by global stable rank; float32 boundaries in the JAX
    # package's order of operations, so shard ranges match bit for bit
    total = torch.clamp(global_hist.sum(), min=1)
    cum = torch.cumsum(global_hist, 0)
    bstart = cum - global_hist
    cum_mid = cum - (global_hist + 1) // 2
    share = total.to(torch.float32) / torch.full((), D, dtype=torch.float32, device=dev)
    Rd = (torch.arange(D + 1, dtype=torch.float32, device=dev) * share).to(_I64)
    Rd[D] = total
    atomic_below = (cum_mid[None, :] < Rd[:, None]).to(_I64)
    rep = mesh.replicas(hist_matrix, uniform, bstart, Rd, atomic_below)
    take_lt = [None] * L
    for i, c in mesh.each():
        hm, uni, bs, rd_c, below = rep[c]
        c_me = hists[i][None, :]
        take = below * c_me
        if split_uniform:
            o_me = hm[:mesh.shards[i]].sum(0)
            cut = rd_c[:, None] - (bs + o_me)[None, :]
            take_uniform = torch.minimum(torch.clamp(cut, min=0), c_me)
            take = torch.where(uni[None, :], take_uniform, take)
        take_lt[i] = take
    extra = None
    if refine_levels > 0 and split_uniform and not return_partition and D > 1:
        take_lt, extra = _refined_assignment(
            mesh, keys, edges, global_hist, uniform, take_lt, bstart, Rd,
            total, refine_levels, n_local,
        )
    return take_lt, extra, cum_mid, Rd, window


def _refined_assignment(mesh, keys, edges, global_hist, uniform, take_lt,
                        bstart, Rd, total, levels, n_local):
    """Hot-bucket refinement (shuffle.py ``_refined_assignment``): each
    level re-windows the hottest multi-key bucket over its own exact key
    range (masked global extrema, the 37a2195 fix) and assigns its refined
    buckets by the same two rules.  Returns per-shard (take_lt with the
    chain head's column zeroed, (D+1,) extra boundary counts)."""
    D = mesh.size
    L = len(keys)
    dev = mesh.device
    R = N_BUCKETS
    riota = torch.arange(R, device=dev)

    hot = torch.argmax(global_hist)
    base_rank = _at(bstart, hot)
    active = (_at(global_hist, hot) > total // (2 * D)) & ~_at(uniform, hot)
    drop = ((riota == hot) & active)[None, :]
    rep = mesh.replicas(hot, drop)
    seg_lo, seg_hi, extra, take_lt = [None] * L, [None] * L, [None] * L, list(take_lt)
    iotas, ars = {}, {}  # per card
    for i, c in mesh.each():
        hot_c, drop_c = rep[c]
        seg_lo[i] = _at(edges[i], hot_c)
        seg_hi[i] = _at(edges[i], hot_c + 1)
        take_lt[i] = torch.where(drop_c, 0, take_lt[i])
        extra[i] = torch.zeros(D + 1, dtype=_I64, device=mesh.devices[c])
        if c not in iotas:
            iotas[c] = torch.arange(n_local, device=mesh.devices[c])
            ars[c] = torch.arange(R + 1, dtype=torch.int32, device=mesh.devices[c])
    for lvl in range(levels):
        # exact per-word extrema over the chain segment of every shard
        mins, maxs = [None] * L, [None] * L
        for i, c in mesh.each():
            m = (iotas[c] >= seg_lo[i]) & (iotas[c] < seg_hi[i])
            mins[i] = torch.stack(
                [torch.where(m, P.widen(w), PAD_WORD).min() for w in keys[i]])
            maxs[i] = torch.stack(
                [torch.where(m, P.widen(w), 0).max() for w in keys[i]])
        window = mesh.replicas(*_window(mesh.pmin(mins), mesh.pmax(maxs)))
        redges, rhists = [None] * L, [None] * L
        for i, c in mesh.each():
            iota = iotas[c]
            rbuck = _apply_window(keys[i], *window[c])
            rkey = torch.where(iota < seg_lo[i], -1,
                               torch.where(iota >= seg_hi[i], R, rbuck))
            redges[i] = torch.searchsorted(rkey.to(torch.int32), ars[c])
            rhists[i] = redges[i][1:] - redges[i][:-1]
        rmatrix = mesh.all_gather(rhists)
        rglobal = rmatrix.sum(0)
        rcum = torch.cumsum(rglobal, 0)
        rb_start = base_rank + rcum - rglobal
        rcum_mid = base_rank + rcum - (rglobal + 1) // 2
        runi = _single_key(mesh, keys, redges, rhists, n_local)
        atomic2 = (rcum_mid[None, :] < Rd[:, None]).to(_I64)
        hot2 = torch.argmax(rglobal)
        active_next = (active & (_at(rglobal, hot2) > total // (2 * D))
                       & ~_at(runi, hot2) & (lvl < levels - 1))
        drop2 = ((riota == hot2) & active_next)[None, :]
        rep = mesh.replicas(rmatrix, rb_start, runi, atomic2, drop2, active, hot2, Rd)
        for i, c in mesh.each():
            rm, rbs, ru, a2, d2, act, h2, rd_c = rep[c]
            rh = rhists[i][None, :]
            cut2 = rd_c[:, None] - (rbs + rm[:mesh.shards[i]].sum(0))[None, :]
            uni2 = torch.minimum(torch.clamp(cut2, min=0), rh)
            take2 = torch.where(ru[None, :], uni2, a2 * rh)
            take2 = torch.where(d2, 0, take2)
            extra[i] = extra[i] + torch.where(act, take2.sum(1), 0)
            seg_lo[i] = _at(redges[i], h2)
            seg_hi[i] = _at(redges[i], h2 + 1)
        base_rank = _at(rb_start, hot2)
        active = active_next
    return take_lt, extra


# ---------------------------------------------------------------------------
# The exchange and the local finish
# ---------------------------------------------------------------------------


@traced("shuffle.exchange")
def _exchange_raw(mesh, planes, input_offsets, send_sizes, capacity, groups):
    """The bare exchange inside each group of shards (all to all).

    Per-shard lists run over this process's shards (``mesh.shards``); the
    groups hold flat shard indices.  Returns
    (recv, n_valid, bufs): ``recv[i]`` local shard i's capacity-length
    planes (views of its group's receive buffers, the pad word where
    nothing landed), ``n_valid[i]`` the rows sent to it (its demand, which
    may exceed the capacity), ``bufs`` the receive buffers of each group
    with a shard here, in group order, each plane a tensor, or for a group
    on several cards a list of its cards' buffers.  A group on one card
    launches B6 once on its stream; a group on several launches it once
    per receiving card (``remote_dma_exchange_cards``)."""
    if mesh.spans(groups):
        return _exchange_across(mesh, planes, input_offsets, send_sizes,
                                capacity, groups)
    first = mesh.shards.start
    recv = [None] * len(planes)
    n_valid = [None] * len(planes)
    bufs = []
    for g in groups:
        if mesh.owner(g[0]) != mesh.rank:
            continue  # another process's group
        cards = [mesh.card_of(s) for s in g]
        if len(g) == 1:
            # a 1-shard group: the exchange is an identity
            i = g[0] - first
            with mesh.on(cards[0]):
                tail = capacity - int(planes[i][0].shape[0])
                recv[i] = [
                    P.cat([a, P.full(tail, PAD_WORD, a.dtype, a.device)])
                    if tail > 0 else a[:capacity].clone()
                    for a in planes[i]
                ]
                n_valid[i] = send_sizes[i].sum()
            bufs.append(recv[i])
            continue
        args = ([planes[s - first] for s in g], [input_offsets[s - first] for s in g],
                [send_sizes[s - first] for s in g], capacity)
        if len(set(cards)) == 1:
            with mesh.on(cards[0]):
                rb, demand, _ = remote_dma_exchange(*args)
            blocks = [(rb, demand, g)]
            bufs.append(rb)
        else:
            got = remote_dma_exchange_cards(*args, cards, cards, mesh.devices,
                                            mesh.streams)
            blocks = [(rb, demand, [s for s in g if mesh.card_of(s) == c])
                      for (rb, demand, _), c in zip(got, sorted(set(cards)))]
            bufs.append([[b[0][j] for b in got] for j in range(len(got[0][0]))])
        for rb, demand, members in blocks:
            for r, s in enumerate(members):
                recv[s - first] = [b[r * capacity:(r + 1) * capacity] for b in rb]
                n_valid[s - first] = demand[r]
    return recv, n_valid, bufs


def _exchange_across(mesh, planes, input_offsets, send_sizes, capacity, groups):
    """:func:`_exchange_raw` for groups whose shards lie in several
    processes: (a) ``all_gather`` of every sender's sizes, (b) one host read
    of them with this process's offsets, (c) one ``all_to_all_single`` of
    the words that land on another process's shards, each card's words
    staged to the communicator's device on that card's stream, (d) one B6
    call per group with a shard here: S = every shard of the group, R =
    this process's.  A remote sender's planes are its block of what (c)
    delivered, on card 0; a call whose senders and receivers lie on one
    card launches there, any other launches once per receiving card
    (``remote_dma_exchange_cards``)."""
    first = mesh.shards.start
    k = len(planes[0])
    # (a) and (b): ``all_to_all_single`` takes its split sizes on the host,
    # so every sender's sizes, (D, G), and this process's offsets, (L, G),
    # are read here, once per exchange
    host = mesh.read_gathered(send_sizes, input_offsets)
    sz, off = host[:mesh.size], host[mesh.size:]
    # what lands: a receiver's segments, in sender order, up to the capacity
    fit = np.zeros_like(sz)
    group_of = {}  # shard -> its group
    for g in groups:
        col = sz[g]
        lo = np.cumsum(col, 0) - col
        fit[g] = np.clip(np.minimum(col, capacity - lo), 0, None)
        group_of.update((s, g) for s in g)

    def toward(s, q):
        """Positions in shard s's group of the shards rank q holds."""
        return [b for b, r in enumerate(group_of[s]) if mesh.owner(r) == q]

    # (c) the transport: to each rank, for each local sender, for each
    # plane, the landing part of its segments for that rank's shards; a
    # rank's words come card by card, as the senders do
    pieces = [[[] for _ in range(mesh.world)] for _ in mesh.cards]  # [card][rank]
    send_counts = [0] * mesh.world
    for q in range(mesh.world):
        for s in mesh.shards if q != mesh.rank else ():
            segs = [(int(off[s - first, b]), int(fit[s, b])) for b in toward(s, q)]
            for j in range(k):
                for o, m in segs:
                    if m:
                        pieces[mesh.card_of(s)][q].append(
                            P.sview(planes[s - first][j][o:o + m]))
                        send_counts[q] += m
    recv_counts, block = [], {}  # block: remote sender -> (start, words a plane)
    for p in range(mesh.world):
        n = 0
        for s in range(p * mesh.n_local, (p + 1) * mesh.n_local) if p != mesh.rank else ():
            t = int(fit[s, toward(s, mesh.rank)].sum())
            block[s] = (sum(recv_counts) + n, t)
            n += k * t
        recv_counts.append(n)
    with mesh.on(0):
        send = torch.empty(sum(send_counts), dtype=torch.int32, device=mesh.comm_device)
    at = np.cumsum([0] + send_counts)
    for c in mesh.cards:
        for q in range(mesh.world):
            if pieces[c][q]:
                n = sum(int(x.shape[0]) for x in pieces[c][q])
                _stage(mesh, c, pieces[c][q], send[at[q]:at[q] + n])
                at[q] += n
    if mesh.streams is not None:
        for st in mesh.streams[1:]:
            mesh.streams[0].wait_stream(st)
    del pieces
    moved = mesh.all_to_all(send, send_counts, recv_counts)
    del send

    # (d) B6: local senders from their planes, remote ones from ``moved``;
    # each sender's offsets and sizes on its card, in one copy a card
    recv = [None] * len(planes)
    n_valid = [None] * len(planes)
    calls = []
    tables = [[] for _ in mesh.cards]  # per card: offsets then sizes of its senders
    for g in groups:
        mine = [b for b, r in enumerate(g) if mesh.owner(r) == mesh.rank]
        if not mine:
            continue
        src, send_cards, rows = [], [], []
        for s in g:
            if mesh.owner(s) == mesh.rank:
                c = mesh.card_of(s)
                src.append(planes[s - first])
                tab = [off[s - first, mine], sz[s, mine]]
            else:
                c, (start, t) = 0, block[s]
                src.append([moved[start + j * t:start + (j + 1) * t].view(torch.uint32)
                            for j in range(k)])
                tab = [np.cumsum(fit[s, mine]) - fit[s, mine], sz[s, mine]]
            send_cards.append(c)
            rows.append((c, sum(len(x) for x in tables[c])))
            tables[c].extend(tab)
        calls.append((g, mine, src, send_cards, rows))
    on_card = [None] * len(tables)
    for c in mesh.cards:
        if not tables[c]:
            continue
        tab = torch.from_numpy(np.concatenate(tables[c]).astype(np.int64))
        with mesh.on(c):
            if mesh.devices[c].type == "cuda":
                tab = tab.pin_memory().to(mesh.devices[c], non_blocking=True)
            on_card[c] = tab
    bufs = []
    for g, mine, src, send_cards, rows in calls:
        R = len(mine)
        offs = [on_card[c][o:o + R] for c, o in rows]
        sizes = [on_card[c][o + R:o + 2 * R] for c, o in rows]
        recv_cards = [mesh.card_of(g[b]) for b in mine]
        if len(set(send_cards + recv_cards)) == 1:
            with mesh.on(recv_cards[0]):
                rb, demand, _ = remote_dma_exchange(src, offs, sizes, capacity)
            got = [(rb, demand)]
            bufs.append(rb)
        else:
            got = remote_dma_exchange_cards(src, offs, sizes, capacity, send_cards,
                                            recv_cards, mesh.devices, mesh.streams)
            bufs.append([[x[0][j] for x in got] for j in range(k)])
        r = 0  # each receiving card's block holds its receivers in group order
        for rb, demand, *_ in got:
            for i in range(int(demand.shape[0])):
                s = g[mine[r]] - first
                recv[s] = [x[i * capacity:(i + 1) * capacity] for x in rb]
                n_valid[s] = demand[i]
                r += 1
    return recv, n_valid, bufs


def _stage(mesh, c, pieces, dst):
    """Card c's words for one rank (``pieces``, on card c) into ``dst``, a
    slice of the send buffer on the communicator's device, on card c's
    stream: the one copy between cards the transport takes.  The send
    buffer is card 0's allocation, so card c's stream first waits on card
    0's; card 0's stream waits on every card before the collective."""
    src_dev = mesh.devices[c]
    with mesh.on(c):
        if c and mesh.streams is not None:
            mesh.streams[c].wait_stream(mesh.streams[0])
        if dst.device == src_dev:
            torch.cat(pieces, out=dst)
        elif dst.device.type == "cpu":  # gloo: through the host
            dst.copy_(torch.cat(pieces))
        else:  # NCCL: another card's words onto card 0, peer to peer
            buf = torch.cat(pieces)
            with torch.cuda.stream(mesh.streams[0]):
                dst.copy_(buf, non_blocking=True)


def _validity(n_valid, capacity, device) -> torch.Tensor:
    """u32 plane: 0 for received rows, 1 for pads (sorts pads behind any
    real all-ones key)."""
    pos = torch.arange(capacity, device=device)
    return (pos >= n_valid).to(torch.int32).view(torch.uint32)


def _write_back(views, planes):
    for v, p in zip(views, planes):
        P.sview(v).copy_(P.sview(p))


def _pad_pow2(p, cap2):
    extra = cap2 - int(p.shape[0])
    return P.cat([p, P.full(extra, PAD_WORD, p.dtype, p.device)]) if extra else p


def _exchange_once(mesh, planes, n_keys, input_offsets, send_sizes, capacity,
                   stable, groups):
    """One exchange plus each shard's sort of what it received.  Returns
    (per-shard capacity planes LED by the validity plane, counts, each
    shard's receive views, receive buffers)."""
    recv, n_valid, bufs = _exchange_raw(
        mesh, planes, input_offsets, send_sizes, capacity, groups)
    out = [None] * len(recv)
    for i, _ in mesh.each():
        v = _validity(n_valid[i], capacity, recv[i][0].device)
        out[i] = [p[:capacity] for p in _local_sort([v] + recv[i], 1 + n_keys, stable)]
    return out, n_valid, recv, bufs


def _split_by_sender(mesh, send_sizes, first_phase):
    """Per-shard (phase-1 sizes, phase-2 sizes) of the overlapped exchange:
    ``first_phase(s)`` says whether flat shard s sends in phase 1."""
    sizes1, sizes2 = [None] * len(send_sizes), [None] * len(send_sizes)
    for i, _ in mesh.each():
        sz = send_sizes[i]
        sizes1[i] = sz if first_phase(mesh.shards[i]) else torch.zeros_like(sz)
        sizes2[i] = sz - sizes1[i]
    return sizes1, sizes2


def _by_card(mesh, per_shard):
    """Per-shard plane lists -> each plane as the outputs carry it: one
    tensor of this process's shards, shard-major, on one card; on several,
    a list of each card's such block."""
    per_card = []
    for c in mesh.cards:
        mine = per_shard[c * mesh.per_card:(c + 1) * mesh.per_card]
        with mesh.on(c):
            per_card.append([P.cat([x[j] for x in mine]) for j in range(len(mine[0]))])
    if len(per_card) == 1:
        return per_card[0]
    return [list(blocks) for blocks in zip(*per_card)]


def _exchange_and_finish(mesh, sorted_all, n_keys, input_offsets, send_sizes,
                         capacity, stable, overlap, stage1_cap):
    """Exchange the locally sorted planes and sort every shard's receipt.
    Takes ownership of ``sorted_all`` (cleared once sent).  Returns (planes
    of L * capacity for this process's L shards, (D,) counts)."""
    if len(mesh.axis_names) == 2:
        return _hier_exchange_and_finish(
            mesh, sorted_all, n_keys, input_offsets, send_sizes, capacity,
            stable, overlap, stage1_cap,
        )
    D = mesh.size
    groups = [list(range(D))]
    if overlap and D > 1:
        # two phases split by SENDER half; phase-1 senders all precede
        # phase-2 senders, and the merge's a-side wins ties
        sizes1, sizes2 = _split_by_sender(mesh, send_sizes, lambda s: s < D // 2)
        q1, v1, _, _ = _exchange_once(mesh, sorted_all, n_keys, input_offsets,
                                      sizes1, capacity, stable, groups)
        q2, v2, recv, bufs = _exchange_once(mesh, sorted_all, n_keys, input_offsets,
                                            sizes2, capacity, stable, groups)
        sorted_all.clear()
        cap2 = 1 << max(0, (capacity - 1).bit_length())
        total = [None] * len(q1)
        for i, _ in mesh.each():
            merged = merge_sorted(
                [_pad_pow2(p, cap2) for p in q1[i]],
                [_pad_pow2(p, cap2) for p in q2[i]], 1 + n_keys, stable=stable,
            )
            q1[i] = q2[i] = None
            _write_back(recv[i], [p[:capacity] for p in merged[1:]])
            total[i] = v1[i] + v2[i]
        return bufs[0], mesh.all_gather(total)
    recv, n_valid, bufs = _exchange_raw(
        mesh, sorted_all, input_offsets, send_sizes, capacity, groups)
    sorted_all.clear()
    for i, _ in mesh.each():
        v = _validity(n_valid[i], capacity, recv[i][0].device)
        fin = _local_sort([v] + recv[i], 1 + n_keys, stable)
        _write_back(recv[i], [p[:capacity] for p in fin[1:]])
    return bufs[0], mesh.all_gather(n_valid)


def _hier_phase(mesh, planes, n_keys, input_offsets, send_sizes, capacity,
                stage1_cap, stable):
    """One two-stage exchange over the (host, chip) mesh plus the local
    sort (shuffle.py ``_hier_phase``).  Returns per-shard capacity planes
    LED by the validity plane (``[validity, keys..., (src,) payloads...]``)
    and per-shard counts, poisoned past the capacity when stage 1
    overflowed."""
    host_ax, chip_ax = mesh.axis_names
    H, C = mesh.shape
    L = len(planes)
    k = len(planes[0])
    n_local = int(planes[0][0].shape[0])
    ex, hs_off, hs_sizes, iotas = [None] * L, [None] * L, [None] * L, {}
    for i, c in mesh.each():
        dev = mesh.devices[c]
        if c not in iotas:
            iotas[c] = torch.arange(n_local, device=dev)
        # per-element flat destination, computed once on the source shard
        ends = input_offsets[i] + send_sizes[i]
        dest = torch.searchsorted(ends, iotas[c], right=True)
        ex[i] = list(planes[i]) + [P.narrow(dest, torch.uint32)]
        if stable:
            ex[i].append(P.full(n_local, mesh.shards[i], torch.uint32, dev))
        hs_sizes[i] = send_sizes[i].view(H, C).sum(1)
        hs_off[i] = input_offsets[i].view(H, C)[:, 0]

    # stage 1: one contiguous block per destination host, along the host axis
    p1, n1, _ = _exchange_raw(mesh, ex, hs_off, hs_sizes, stage1_cap,
                              mesh.groups(host_ax))
    del ex
    # stage 2: regroup by destination chip (pads route to C and sort last)
    routed, off2, sz2 = [None] * L, [None] * L, [None] * L
    for i, c in mesh.each():
        dev = mesh.devices[c]
        valid1 = torch.arange(stage1_cap, device=dev) < n1[i]
        route = torch.where(valid1, P.widen(p1[i][k]) % C, C)
        srt = _local_sort([P.narrow(route, torch.uint32)] + p1[i], 1, True)
        p1[i] = None
        routed[i] = srt[1:]
        bounds = torch.searchsorted(P.widen(srt[0]), torch.arange(C + 1, device=dev))
        off2[i] = bounds[:-1]
        sz2[i] = bounds[1:] - bounds[:-1]
    p2, n2, _ = _exchange_raw(mesh, routed, off2, sz2, capacity,
                              mesh.groups(chip_ax))
    del routed

    finished, counts = [None] * L, [None] * L
    for i, c in mesh.each():
        out = p2[i][:k]
        v = _validity(n2[i], capacity, mesh.devices[c])
        if stable:
            # the source shard follows the keys in compare order
            sort_planes = [v] + out[:n_keys] + [p2[i][k + 1]] + out[n_keys:]
            nk_sort = 2 + n_keys
        else:
            sort_planes = [v] + out
            nk_sort = 1 + n_keys
        finished[i] = [p[:capacity] for p in _local_sort(sort_planes, nk_sort, stable)]
        p2[i] = None
        counts[i] = torch.where(n1[i] > stage1_cap, torch.maximum(n1[i], n2[i]), n2[i])
    return finished, counts


def _hier_exchange_and_finish(mesh, planes, n_keys, input_offsets, send_sizes,
                              capacity, stable, overlap, stage1_cap):
    """Two-stage hierarchical exchange (shuffle.py
    ``_hier_exchange_and_finish``); ``overlap`` splits by sender-host
    half."""
    H, C = mesh.shape
    if overlap and H > 1:
        sizes1, sizes2 = _split_by_sender(mesh, send_sizes, lambda s: s // C < H // 2)
        q1, v1 = _hier_phase(mesh, planes, n_keys, input_offsets, sizes1,
                             capacity, stage1_cap, stable)
        q2, v2 = _hier_phase(mesh, planes, n_keys, input_offsets, sizes2,
                             capacity, stage1_cap, stable)
        planes.clear()
        cap2 = 1 << max(0, (capacity - 1).bit_length())
        per_shard, total = [None] * len(q1), [None] * len(q1)
        for i, _ in mesh.each():
            merged = merge_sorted([_pad_pow2(p, cap2) for p in q1[i]],
                                  [_pad_pow2(p, cap2) for p in q2[i]], 1 + n_keys,
                                  stable=stable)
            per_shard[i] = [p[:capacity] for p in merged[1:]]
            total[i] = v1[i] + v2[i]
        counts = mesh.all_gather(total)
    else:
        q, v = _hier_phase(mesh, planes, n_keys, input_offsets, send_sizes,
                           capacity, stage1_cap, stable)
        planes.clear()
        per_shard = [x[1:] for x in q]
        counts = mesh.all_gather(v)
    if stable:
        per_shard = [x[:n_keys] + x[n_keys + 1:] for x in per_shard]
    return _by_card(mesh, per_shard), counts


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check_axis(mesh: Mesh, axis):
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    if names != mesh.axis_names:
        raise ValueError(
            f"axis {axis!r} must name every axis of the mesh {mesh.axis_names}"
        )


def _to_planes(words, payloads, mesh: Mesh):
    """Every card's rows of each plane, on that card, as u32 (4-byte
    payloads viewed), and the payloads' dtypes to restore.  A plane is a
    tensor or numpy array of this process's rows, split over the cards in
    order, or (on several cards) the outputs' form: a list of each card's
    rows.  Rows that lie elsewhere are copied to their card on its
    stream."""
    K = len(mesh.devices)

    def blocks(a):
        if isinstance(a, (list, tuple)):
            if len(a) != K:
                raise ValueError(f"{len(a)} blocks of a plane for {K} cards")
            parts = list(a)
        else:
            x = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            n = int(x.shape[0])
            if n % mesh.n_local:
                raise ValueError(f"length {n} not divisible by the "
                                 f"{mesh.n_local} shards of this process")
            parts = [x[c * (n // K):(c + 1) * (n // K)] for c in range(K)]
        out = []
        for c, b in enumerate(parts):
            if not isinstance(b, torch.Tensor):
                b = torch.from_numpy(np.ascontiguousarray(b))
            with mesh.on(c):
                out.append(b.to(mesh.devices[c]).contiguous())
        return out

    ws = [blocks(w) for w in words]
    ps = [blocks(p) for p in payloads]
    for w in ws:
        if w[0].dtype != torch.uint32:
            raise TypeError(f"key words must be uint32 planes, got {w[0].dtype}")
    for p in ps:
        if p[0].dtype.itemsize != 4 or p[0].dtype.is_complex:
            raise TypeError(f"payloads must be 4-byte planes, got {p[0].dtype}")
    planes = ws + [[b.view(torch.uint32) for b in p] for p in ps]
    return [[p[c] for p in planes] for c in range(K)], [p[0].dtype for p in ps]


def _shard(cards, mesh: Mesh):
    """This process's shards of the rows it holds (all rows in one process,
    its own ``L * n_local`` on a mesh over processes), from each card's
    planes (``cards[c]``), and the global row count."""
    L = mesh.n_local
    n = sum(int(ps[0].shape[0]) for ps in cards)
    if any(int(p.shape[0]) != int(ps[0].shape[0]) for ps in cards for p in ps):
        raise ValueError("every plane must have the same length")
    if n % L != 0:
        raise ValueError(f"length {n} not divisible by the {L} shards of this process")
    n_local = n // L
    for c, ps in enumerate(cards):
        if int(ps[0].shape[0]) != mesh.per_card * n_local:
            raise ValueError(f"card {c} holds {int(ps[0].shape[0])} rows, not "
                             f"{mesh.per_card} shards of {n_local}")
    return ([[p[j * n_local:(j + 1) * n_local] for p in ps]
             for ps in cards for j in range(mesh.per_card)], n_local * mesh.size)


def _split(outs, n_words, pay_dtypes):
    def view(p, dt):
        return [b.view(dt) for b in p] if isinstance(p, list) else p.view(dt)

    return (list(outs[:n_words]),
            [view(p, dt) for p, dt in zip(outs[n_words:], pay_dtypes)])


def _capacity(plane, mesh: Mesh) -> int:
    """Rows a shard holds in an output plane (a tensor, or a per-card
    list)."""
    first = plane[0] if isinstance(plane, list) else plane
    return int(first.shape[0]) // mesh.per_card


def _stage1_cap(capacity: int) -> int:
    return max(int(np.ceil(capacity * config.hier_stage1_headroom)), capacity)


def distributed_sort(
    words: Sequence,
    payloads: Sequence = (),
    *,
    mesh: Mesh,
    axis="shard",
    capacity_factor: float = 1.5,
    stable: bool = False,
    split_uniform: bool = True,
    return_partition: bool = False,
    use_ragged: bool | None = None,
    overlap_exchange: bool = False,
    valid=None,
):
    """Sort globally over the mesh's shards.

    ``words``: uint32 key planes (most significant first), ``payloads``:
    4-byte planes; tensors or numpy arrays, one length divisible by the
    mesh size, shard s holding rows ``[s * n_local, (s + 1) * n_local)``.
    Returns ``(words, payloads, counts)``: each plane (D * capacity,) on the
    mesh's device, shard d's valid rows at ``[d * capacity, d * capacity +
    counts[d])``, their concatenation in shard order the global order.  On
    a mesh over processes each process passes its own shards' rows (``L *
    n_local``, L = ``len(mesh.shards)``) and gets their planes, (L *
    capacity,), with the global (D,) counts.  On a mesh of K > 1 cards each
    output plane is a list of K blocks, card c's (L_c * capacity,) on card
    c (concatenated, the one-card plane); ``counts`` stays one tensor on
    card 0.  A plane in may be such a list, or one tensor split over the
    cards.

    ``split_uniform=False`` keeps every bucket on one shard;
    ``return_partition=True`` appends the partition state (gmins, shifts,
    bits, dev_start) for :func:`partition_exchange`.  ``overlap_exchange``
    exchanges in two sender-half phases and merges (B4/B5): the same
    output.  On a 2-axis mesh pass ``axis=mesh.axis_names`` for the
    two-stage (host, chip) exchange.  ``use_ragged`` has no effect (the
    exchange is always the exact ragged layout).

    ``valid``: for each of this process's shards, how many of its first
    rows take part (ints or 0-dim tensors, never read on the host); the
    rest are left out of the sort, the counts and the exchange, as the
    rows past a shard's count in the static-length outputs of
    :func:`rdst_tpu_torch.parallel.distributed_filter`.  The local sort is
    then stable.  The call is the span ``rdst.shuffle``."""
    del use_ragged
    _check_axis(mesh, axis)
    with mesh.call(), span("shuffle"):
        planes, pay_dtypes = _to_planes(words, payloads, mesh)
        shards, n = _shard(planes, mesh)
        del planes
        capacity = max(int(np.ceil(capacity_factor * (n // mesh.size))), 16)
        outs, counts, partition = _shard_body(
            mesh, len(words), capacity, _stage1_cap(capacity), stable,
            split_uniform, return_partition, overlap_exchange,
            config.shuffle_refine_levels, shards, _valid_rows(valid, mesh),
        )
    w, p = _split(outs, len(words), pay_dtypes)
    if return_partition:
        return w, p, counts, partition
    return w, p, counts


def _partition_body(mesh, n_keys, capacity, stage1_cap, stable, overlap,
                    partition, shards, valid=None):
    """Route rows by a precomputed partition (shuffle.py
    ``_partition_body``); ``valid`` as in :func:`_shard_body`."""
    rep = mesh.replicas(*partition)  # gmins, shifts, bits, dev_start
    L = len(shards)
    sorted_all, offs, sizes = [None] * L, [None] * L, [None] * L
    for i, c in mesh.each():
        planes = shards[i]
        with span("shuffle.plan"):
            bucket = _apply_window(planes[:n_keys], *rep[c][:3])
            if valid is not None:  # a row left out goes to bucket R: past every shard
                pos = torch.arange(int(planes[0].shape[0]), device=bucket.device)
                bucket = torch.where(pos < valid[i], bucket, N_BUCKETS)
            # sort by (bucket, key): segments must be bucket-contiguous even
            # where a foreign window's saturation breaks key order.  The
            # signed bucket leads as a biased u32 (same order as int32).
            lead = P.narrow(bucket.to(_I64) + (1 << 31), torch.uint32)
        srt = _local_sort([lead] + list(planes), 1 + n_keys, stable)
        with span("shuffle.plan"):
            boundary = torch.searchsorted(P.widen(srt[0]) - (1 << 31), rep[c][3])
        sorted_all[i] = srt[1:]
        sizes[i] = boundary[1:] - boundary[:-1]
        offs[i] = boundary[:-1]
    return _exchange_and_finish(mesh, sorted_all, n_keys, offs, sizes,
                                capacity, stable, overlap, stage1_cap)


def partition_exchange(
    words: Sequence,
    payloads: Sequence,
    partition,
    *,
    mesh: Mesh,
    axis="shard",
    capacity_factor: float = 1.5,
    stable: bool = False,
    use_ragged: bool | None = None,
    overlap_exchange: bool = False,
    valid=None,
):
    """Route rows to shards by an existing partition (co-partitioning): the
    4-tuple from ``distributed_sort(..., split_uniform=False,
    return_partition=True)``.  Rows whose key falls in bucket b land on the
    shard that shuffle gave bucket b.  A dataset of at most
    ``config.replicate_capacity_max`` rows gets full-table capacity.  Same
    return convention, ``valid`` and span as :func:`distributed_sort`."""
    del use_ragged
    _check_axis(mesh, axis)
    with mesh.call(), span("shuffle"):
        planes, pay_dtypes = _to_planes(words, payloads, mesh)
        shards, n = _shard(planes, mesh)
        del planes
        capacity = int(np.ceil(capacity_factor * (n // mesh.size)))
        if n <= config.replicate_capacity_max:
            capacity = max(capacity, n)
        capacity = max(capacity, 16)
        part = tuple(
            torch.as_tensor(np.asarray(x).astype(np.int64)
                            if not isinstance(x, torch.Tensor) else x)
            .to(mesh.device, _I64)
            for x in partition
        )
        outs, counts = _partition_body(
            mesh, len(words), capacity, _stage1_cap(capacity), stable,
            overlap_exchange, part, shards, _valid_rows(valid, mesh),
        )
    w, p = _split(outs, len(words), pay_dtypes)
    return w, p, counts


def distributed_sort_auto(
    words: Sequence,
    payloads: Sequence = (),
    *,
    mesh: Mesh,
    capacity_factor: float = 1.5,
    max_capacity_factor: float = 16.0,
    **kwargs,
):
    """:func:`distributed_sort`, doubling ``capacity_factor`` until every
    shard's demand fits or ``max_capacity_factor`` is passed (then
    ``OverflowError``).  Reads the counts on the host after each try."""
    f = capacity_factor
    while True:
        out = distributed_sort(words, payloads, mesh=mesh, capacity_factor=f,
                               **kwargs)
        counts = out[2].cpu().numpy()  # global: every rank decides alike
        cap = _capacity(out[0][0], mesh)
        if int(counts.max(initial=0)) <= cap:
            return out
        if f >= max_capacity_factor:
            raise OverflowError(
                f"device demand {int(counts.max())} rows > capacity {cap} "
                f"at capacity_factor={f} (max {max_capacity_factor})"
            )
        f = min(f * 2.0, max_capacity_factor)


def gather_valid(planes: Sequence, counts, *, mesh: Mesh | None = None
                 ) -> list[np.ndarray]:
    """Host helper: the valid device-major slices, concatenated, as numpy.
    Raises ``OverflowError`` where a shard's demand exceeds its capacity.

    Pass the ``mesh`` of a call over processes: ``planes`` are then this
    process's shards and every rank gets the whole global order (each
    rank's valid rows, gathered after the counts).  A plane of a mesh on
    several cards is the list of its cards' blocks."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    counts = np.asarray(counts)
    D = counts.shape[0]
    first, L = (0, D) if mesh is None else (mesh.shards.start, mesh.n_local)
    mine = counts[first:first + L]
    out = []
    for p in planes:
        blocks = p if isinstance(p, list) else [p]
        p = np.concatenate([b.cpu().numpy() if isinstance(b, torch.Tensor)
                            else np.asarray(b) for b in blocks])
        p = p.reshape(L, -1)
        cap = p.shape[1]
        if (counts > cap).any():
            raise OverflowError(
                f"device received {int(counts.max())} rows > capacity {cap}; "
                "increase capacity_factor"
            )
        out.append(np.concatenate([p[i, : mine[i]] for i in range(L)]))
    if mesh is None or not mesh.processes or not out:
        return out
    # the ranks' valid rows, padded to the longest, through one all_gather
    per_rank = counts.reshape(mesh.world, L).sum(1)
    rows = np.zeros((len(out), int(per_rank.max())), np.int64)
    for r, o in zip(rows, out):
        r[:o.size] = o.view(np.int32)  # 4-byte planes, widened for the collective
    got = mesh.gather_blocks(torch.from_numpy(rows)).cpu().numpy()
    return [np.concatenate([got[q, j, :per_rank[q]] for q in range(mesh.world)])
            .astype(np.int32).view(o.dtype) for j, o in enumerate(out)]
