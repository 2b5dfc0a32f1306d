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

A group of shards that lies in more than one process exchanges in four
steps (:func:`_exchange_across`): an ``all_gather`` of every sender's
sizes; one host read of that size matrix (with this process's send
offsets), because ``all_to_all_single`` takes its split sizes on the host;
one ``all_to_all_single`` of exactly the words that land; and B6, whose
senders are the group's shards (local ones from their own planes, remote
ones from the transport buffer) and whose receivers are this process's.

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
from rdst_tpu_torch.parallel.remote_dma import PAD_WORD, remote_dma_exchange

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
    shard's shape, else ``lex_sort``."""
    words, payloads = list(planes[:n_keys]), list(planes[n_keys:])
    fused = fused_sort_available(words, payloads, stable=stable)
    SORT_ROUTES[(len(planes), int(planes[0].shape[0]),
                 "B2/B3" if fused else "lex_sort")] += 1
    if fused:
        out_w, out_p = fused_sort(words, payloads, stable=stable)
        return list(out_w) + list(out_p)
    return P.lex_sort(planes, n_keys, stable=stable)


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


def _window_params(keys, mesh: Mesh):
    """Entropy-adaptive window from every shard's key planes (global
    min/max per word through the mesh's collectives)."""
    lo, hi = [], []
    for k in keys:
        ext = [P.widen(w).aminmax() for w in k]
        lo.append(torch.stack([e.min for e in ext]))
        hi.append(torch.stack([e.max for e in ext]))
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
    per_shard = []
    for k, e, h in zip(keys, edges, hists):
        first = torch.clamp(e[:-1], 0, n_local - 1)
        last = torch.clamp(e[1:] - 1, 0, n_local - 1)
        nonempty = h > 0
        per_shard.append([
            (torch.where(nonempty, P.widen(P.take(w, first)), PAD_WORD),
             torch.where(nonempty, P.widen(P.take(w, last)), 0))
            for w in k
        ])
    uniform = None
    for wi in range(len(keys[0])):
        gmin = mesh.pmin([x[wi][0] for x in per_shard])
        gmax = mesh.pmax([x[wi][1] for x in per_shard])
        eq = gmin == gmax
        uniform = eq if uniform is None else uniform & eq
    return uniform


def _shard_body(mesh, n_keys, capacity, stage1_cap, stable, split_uniform,
                return_partition, overlap, refine_levels, shards):
    """The shard_map body of the JAX package, in lockstep over this
    process's shards.  ``shards[i]``: shard ``mesh.shards[i]``'s word and
    payload planes.  Returns (output planes, counts, partition or None)."""
    D = mesh.size
    dev = mesh.device
    n_local = int(shards[0][0].shape[0])
    R = N_BUCKETS

    # 1. local sort by the full key (payloads ride along)
    sorted_all = [_local_sort(p, n_keys, stable) for p in shards]
    keys = [p[:n_keys] for p in sorted_all]
    gmins, wshifts, wbits = _window_params(keys, mesh)

    # 2. per-shard histograms by searchsorted over the sorted bucket ids
    ar = torch.arange(R + 1, dtype=torch.int32, device=dev)
    edges = []
    for k in keys:
        edges.append(torch.searchsorted(_apply_window(k, gmins, wshifts, wbits), ar))
    hists = [e[1:] - e[:-1] for e in edges]
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
    take_lt = []
    for i, s in enumerate(mesh.shards):
        c_me = hists[i][None, :]
        take = atomic_below * c_me
        if split_uniform:
            o_me = hist_matrix[:s].sum(0)
            cut = Rd[:, None] - (bstart + o_me)[None, :]
            take_uniform = torch.minimum(torch.clamp(cut, min=0), c_me)
            take = torch.where(uniform[None, :], take_uniform, take)
        take_lt.append(take)
    extra = [torch.zeros(D + 1, dtype=_I64, device=dev)] * len(shards)
    if refine_levels > 0 and split_uniform and not return_partition and D > 1:
        take_lt, extra = _refined_assignment(
            mesh, keys, edges, global_hist, uniform, take_lt, bstart, Rd,
            total, refine_levels, n_local,
        )
    input_offsets, send_sizes = [], []
    for t, x in zip(take_lt, extra):
        boundary = t.sum(1) + x  # (D+1,)
        send_sizes.append(boundary[1:] - boundary[:-1])
        input_offsets.append(boundary[:-1])
    del keys, edges, take_lt, extra

    # 4-6. exchange and local finish
    outs, counts = _exchange_and_finish(
        mesh, sorted_all, n_keys, input_offsets, send_sizes, capacity, stable,
        overlap, stage1_cap,
    )
    partition = None
    if return_partition:
        # each shard's first bucket, by the atomic rule's comparison
        dev_start = torch.searchsorted(cum_mid, Rd)
        dev_start[D] = R
        partition = (gmins, wshifts, wbits, dev_start)
    return outs, counts, partition


def _refined_assignment(mesh, keys, edges, global_hist, uniform, take_lt,
                        bstart, Rd, total, levels, n_local):
    """Hot-bucket refinement (shuffle.py ``_refined_assignment``): each
    level re-windows the hottest multi-key bucket over its own exact key
    range (masked global extrema, the 37a2195 fix) and assigns its refined
    buckets by the same two rules.  Returns per-shard (take_lt with the
    chain head's column zeroed, (D+1,) extra boundary counts)."""
    D = mesh.size
    dev = mesh.device
    R = N_BUCKETS
    iota = torch.arange(n_local, device=dev)
    riota = torch.arange(R, device=dev)
    ar = torch.arange(R + 1, dtype=torch.int32, device=dev)

    hot = torch.argmax(global_hist)
    seg_lo = [_at(e, hot) for e in edges]
    seg_hi = [_at(e, hot + 1) for e in edges]
    base_rank = _at(bstart, hot)
    active = (_at(global_hist, hot) > total // (2 * D)) & ~_at(uniform, hot)
    drop = ((riota == hot) & active)[None, :]
    take_lt = [torch.where(drop, 0, t) for t in take_lt]
    extra = [torch.zeros(D + 1, dtype=_I64, device=dev) for _ in keys]
    for lvl in range(levels):
        # exact per-word extrema over the chain segment of every shard
        in_seg = [(iota >= lo) & (iota < hi) for lo, hi in zip(seg_lo, seg_hi)]
        mins, maxs = [], []
        for k, m in zip(keys, in_seg):
            mins.append(torch.stack(
                [torch.where(m, P.widen(w), PAD_WORD).min() for w in k]))
            maxs.append(torch.stack(
                [torch.where(m, P.widen(w), 0).max() for w in k]))
        rg, rs, rb = _window(mesh.pmin(mins), mesh.pmax(maxs))
        redges = []
        for k, lo, hi in zip(keys, seg_lo, seg_hi):
            rbuck = _apply_window(k, rg, rs, rb)
            rkey = torch.where(iota < lo, -1, torch.where(iota >= hi, R, rbuck))
            redges.append(torch.searchsorted(rkey.to(torch.int32), ar))
        rhists = [e[1:] - e[:-1] for e in redges]
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
        for i, s in enumerate(mesh.shards):
            rh = rhists[i][None, :]
            cut2 = Rd[:, None] - (rb_start + rmatrix[:s].sum(0))[None, :]
            uni2 = torch.minimum(torch.clamp(cut2, min=0), rh)
            take2 = torch.where(runi[None, :], uni2, atomic2 * rh)
            take2 = torch.where(drop2, 0, take2)
            extra[i] = extra[i] + torch.where(active, take2.sum(1), 0)
            seg_lo[i] = _at(redges[i], hot2)
            seg_hi[i] = _at(redges[i], hot2 + 1)
        base_rank = _at(rb_start, hot2)
        active = active_next
    return take_lt, extra


# ---------------------------------------------------------------------------
# The exchange and the local finish
# ---------------------------------------------------------------------------


def _exchange_raw(mesh, planes, input_offsets, send_sizes, capacity, groups):
    """The bare exchange inside each group of shards (all to all).

    Per-shard lists run over this process's shards (``mesh.shards``); the
    groups hold flat shard indices.  Returns
    (recv, n_valid, bufs): ``recv[i]`` local shard i's capacity-length
    planes (views of its group's receive buffers, the pad word where
    nothing landed), ``n_valid[i]`` the rows sent to it (its demand, which
    may exceed the capacity), ``bufs`` the receive buffers of each group
    with a shard here, in group order."""
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
        if len(g) == 1:
            # a 1-shard group: the exchange is an identity
            i = g[0] - first
            tail = capacity - int(planes[i][0].shape[0])
            recv[i] = [
                P.cat([a, P.full(tail, PAD_WORD, a.dtype, a.device)])
                if tail > 0 else a[:capacity].clone()
                for a in planes[i]
            ]
            n_valid[i] = send_sizes[i].sum()
            bufs.append(recv[i])
            continue
        rb, demand, _ = remote_dma_exchange(
            [planes[s - first] for s in g], [input_offsets[s - first] for s in g],
            [send_sizes[s - first] for s in g], capacity,
        )
        for r, s in enumerate(g):
            recv[s - first] = [b[r * capacity:(r + 1) * capacity] for b in rb]
            n_valid[s - first] = demand[r]
        bufs.append(rb)
    return recv, n_valid, bufs


def _exchange_across(mesh, planes, input_offsets, send_sizes, capacity, groups):
    """:func:`_exchange_raw` for groups whose shards lie in several
    processes: (a) ``all_gather`` of every sender's sizes, (b) one host read
    of them with this process's offsets, (c) one ``all_to_all_single`` of
    the words that land on another process's shards, (d) one B6 call per
    group with a shard here: S = every shard of the group, R = this
    process's."""
    first = mesh.shards.start
    k = len(planes[0])
    dev = planes[0][0].device
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
    # plane, the landing part of its segments for that rank's shards
    pieces, send_counts = [], []
    for q in range(mesh.world):
        n = 0
        for s in mesh.shards if q != mesh.rank else ():
            segs = [(int(off[s - first, b]), int(fit[s, b])) for b in toward(s, q)]
            for j in range(k):
                for o, m in segs:
                    if m:
                        pieces.append(P.sview(planes[s - first][j][o:o + m]))
                        n += m
        send_counts.append(n)
    recv_counts, block = [], {}  # block: remote sender -> (start, words a plane)
    for p in range(mesh.world):
        n = 0
        for s in range(p * mesh.n_local, (p + 1) * mesh.n_local) if p != mesh.rank else ():
            t = int(fit[s, toward(s, mesh.rank)].sum())
            block[s] = (sum(recv_counts) + n, t)
            n += k * t
        recv_counts.append(n)
    send = torch.cat(pieces) if pieces else torch.empty(0, dtype=torch.int32, device=dev)
    moved = mesh.all_to_all(send, send_counts, recv_counts)
    del send, pieces

    # (d) B6: local senders from their planes, remote ones from ``moved``
    recv = [None] * len(planes)
    n_valid = [None] * len(planes)
    bufs, calls, tables = [], [], []  # tables: per call, offsets then sizes
    for g in groups:
        mine = [b for b, r in enumerate(g) if mesh.owner(r) == mesh.rank]
        if not mine:
            continue
        src = []
        for s in g:
            if mesh.owner(s) == mesh.rank:
                src.append(planes[s - first])
                tables.append(off[s - first, mine])
            else:
                start, t = block[s]
                src.append([moved[start + j * t:start + (j + 1) * t].view(torch.uint32)
                            for j in range(k)])
                tables.append(np.cumsum(fit[s, mine]) - fit[s, mine])
            tables.append(sz[s, mine])
        calls.append((g, mine, src))
    # every call's offsets and sizes reach the device in one copy
    tab = torch.from_numpy(np.concatenate(tables).astype(np.int64))
    if dev.type == "cuda":
        tab = tab.pin_memory().to(dev, non_blocking=True)
    at = 0
    for g, mine, src in calls:
        rows = tab[at:at + 2 * len(g) * len(mine)].view(len(g), 2, len(mine))
        at += 2 * len(g) * len(mine)
        rb, demand, _ = remote_dma_exchange(src, list(rows[:, 0]), list(rows[:, 1]),
                                            capacity)
        for r, b in enumerate(mine):
            recv[g[b] - first] = [x[r * capacity:(r + 1) * capacity] for x in rb]
            n_valid[g[b] - first] = demand[r]
        bufs.append(rb)
    return recv, n_valid, bufs


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
    (per-shard capacity planes LED by the validity plane, counts, receive
    buffers)."""
    recv, n_valid, bufs = _exchange_raw(
        mesh, planes, input_offsets, send_sizes, capacity, groups)
    out = []
    for r, nv in zip(recv, n_valid):
        v = _validity(nv, capacity, r[0].device)
        out.append([p[:capacity] for p in _local_sort([v] + r, 1 + n_keys, stable)])
    return out, n_valid, bufs


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
        half = D // 2
        sizes1 = [sz if s < half else torch.zeros_like(sz)
                  for s, sz in zip(mesh.shards, send_sizes)]
        sizes2 = [sz - s1 for sz, s1 in zip(send_sizes, sizes1)]
        q1, v1, _ = _exchange_once(mesh, sorted_all, n_keys, input_offsets,
                                   sizes1, capacity, stable, groups)
        q2, v2, bufs = _exchange_once(mesh, sorted_all, n_keys, input_offsets,
                                      sizes2, capacity, stable, groups)
        sorted_all.clear()
        cap2 = 1 << max(0, (capacity - 1).bit_length())
        out = bufs[0]
        for i in range(len(q1)):
            merged = merge_sorted(
                [_pad_pow2(p, cap2) for p in q1[i]],
                [_pad_pow2(p, cap2) for p in q2[i]], 1 + n_keys, stable=stable,
            )
            q1[i] = q2[i] = None
            _write_back([b[i * capacity:(i + 1) * capacity] for b in out],
                        [p[:capacity] for p in merged[1:]])
        return out, mesh.all_gather([a + b for a, b in zip(v1, v2)])
    recv, n_valid, bufs = _exchange_raw(
        mesh, sorted_all, input_offsets, send_sizes, capacity, groups)
    sorted_all.clear()
    for r, nv in zip(recv, n_valid):
        v = _validity(nv, capacity, r[0].device)
        fin = _local_sort([v] + r, 1 + n_keys, stable)
        _write_back(r, [p[:capacity] for p in fin[1:]])
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
    k = len(planes[0])
    n_local = int(planes[0][0].shape[0])
    dev = mesh.device
    iota = torch.arange(n_local, device=dev)
    ex, hs_off, hs_sizes = [], [], []
    for i, s in enumerate(mesh.shards):
        # per-element flat destination, computed once on the source shard
        ends = input_offsets[i] + send_sizes[i]
        dest = torch.searchsorted(ends, iota, right=True)
        ex_s = list(planes[i]) + [P.narrow(dest, torch.uint32)]
        if stable:
            ex_s.append(P.full(n_local, s, torch.uint32, dev))
        ex.append(ex_s)
        hs_sizes.append(send_sizes[i].view(H, C).sum(1))
        hs_off.append(input_offsets[i].view(H, C)[:, 0])

    # stage 1: one contiguous block per destination host, along the host axis
    p1, n1, _ = _exchange_raw(mesh, ex, hs_off, hs_sizes, stage1_cap,
                              mesh.groups(host_ax))
    del ex
    # stage 2: regroup by destination chip (pads route to C and sort last)
    routed, off2, sz2 = [], [], []
    cs = torch.arange(C + 1, device=dev)
    for i in range(len(p1)):
        valid1 = torch.arange(stage1_cap, device=dev) < n1[i]
        route = torch.where(valid1, P.widen(p1[i][k]) % C, C)
        srt = _local_sort([P.narrow(route, torch.uint32)] + p1[i], 1, True)
        p1[i] = None
        routed.append(srt[1:])
        bounds = torch.searchsorted(P.widen(srt[0]), cs)
        off2.append(bounds[:-1])
        sz2.append(bounds[1:] - bounds[:-1])
    p2, n2, _ = _exchange_raw(mesh, routed, off2, sz2, capacity,
                              mesh.groups(chip_ax))
    del routed

    finished, counts = [], []
    for i in range(len(p2)):
        out = p2[i][:k]
        v = _validity(n2[i], capacity, dev)
        if stable:
            # the source shard follows the keys in compare order
            sort_planes = [v] + out[:n_keys] + [p2[i][k + 1]] + out[n_keys:]
            nk_sort = 2 + n_keys
        else:
            sort_planes = [v] + out
            nk_sort = 1 + n_keys
        finished.append([p[:capacity] for p in
                         _local_sort(sort_planes, nk_sort, stable)])
        p2[i] = None
        counts.append(torch.where(n1[i] > stage1_cap,
                                  torch.maximum(n1[i], n2[i]), n2[i]))
    return finished, counts


def _hier_exchange_and_finish(mesh, planes, n_keys, input_offsets, send_sizes,
                              capacity, stable, overlap, stage1_cap):
    """Two-stage hierarchical exchange (shuffle.py
    ``_hier_exchange_and_finish``); ``overlap`` splits by sender-host
    half."""
    H, C = mesh.shape
    if overlap and H > 1:
        half = H // 2
        sizes1 = [sz if s // C < half else torch.zeros_like(sz)
                  for s, sz in zip(mesh.shards, send_sizes)]
        sizes2 = [sz - s1 for sz, s1 in zip(send_sizes, sizes1)]
        q1, v1 = _hier_phase(mesh, planes, n_keys, input_offsets, sizes1,
                             capacity, stage1_cap, stable)
        q2, v2 = _hier_phase(mesh, planes, n_keys, input_offsets, sizes2,
                             capacity, stage1_cap, stable)
        planes.clear()
        cap2 = 1 << max(0, (capacity - 1).bit_length())
        per_shard = []
        for a, b in zip(q1, q2):
            merged = merge_sorted([_pad_pow2(p, cap2) for p in a],
                                  [_pad_pow2(p, cap2) for p in b], 1 + n_keys,
                                  stable=stable)
            per_shard.append([p[:capacity] for p in merged[1:]])
        counts = mesh.all_gather([a + b for a, b in zip(v1, v2)])
    else:
        q, v = _hier_phase(mesh, planes, n_keys, input_offsets, send_sizes,
                           capacity, stage1_cap, stable)
        planes.clear()
        per_shard = [x[1:] for x in q]
        counts = mesh.all_gather(v)
    if stable:
        per_shard = [x[:n_keys] + x[n_keys + 1:] for x in per_shard]
    outs = [P.cat([x[j] for x in per_shard]) for j in range(len(per_shard[0]))]
    return outs, counts


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
    """Planes on the mesh's device, as u32 (4-byte payloads viewed), and
    the payloads' dtypes to restore."""
    def t(a):
        x = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return x.to(mesh.device).contiguous()

    ws = [t(w) for w in words]
    ps = [t(p) for p in payloads]
    for w in ws:
        if w.dtype != torch.uint32:
            raise TypeError(f"key words must be uint32 planes, got {w.dtype}")
    for p in ps:
        if p.dtype.itemsize != 4 or p.dtype.is_complex:
            raise TypeError(f"payloads must be 4-byte planes, got {p.dtype}")
    return ws + [p.view(torch.uint32) for p in ps], [p.dtype for p in ps]


def _shard(planes, mesh: Mesh):
    """This process's shards of the rows it holds (all rows in one process,
    its own ``L * n_local`` on a mesh over processes) and the global row
    count."""
    L = mesh.n_local
    n = int(planes[0].shape[0])
    if any(int(p.shape[0]) != n for p in planes):
        raise ValueError("every plane must have the same length")
    if n % L != 0:
        raise ValueError(f"length {n} not divisible by the {L} shards of this process")
    n_local = n // L
    return ([[p[i * n_local:(i + 1) * n_local] for p in planes] for i in range(L)],
            n_local * mesh.size)


def _split(outs, n_words, pay_dtypes):
    return (list(outs[:n_words]),
            [p.view(dt) for p, dt in zip(outs[n_words:], pay_dtypes)])


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
    capacity,), with the global (D,) counts.

    ``split_uniform=False`` keeps every bucket on one shard;
    ``return_partition=True`` appends the partition state (gmins, shifts,
    bits, dev_start) for :func:`partition_exchange`.  ``overlap_exchange``
    exchanges in two sender-half phases and merges (B4/B5): the same
    output.  On a 2-axis mesh pass ``axis=mesh.axis_names`` for the
    two-stage (host, chip) exchange.  ``use_ragged`` has no effect (the
    exchange is always the exact ragged layout)."""
    del use_ragged
    _check_axis(mesh, axis)
    planes, pay_dtypes = _to_planes(words, payloads, mesh)
    shards, n = _shard(planes, mesh)
    del planes
    capacity = max(int(np.ceil(capacity_factor * (n // mesh.size))), 16)
    outs, counts, partition = _shard_body(
        mesh, len(words), capacity, _stage1_cap(capacity), stable,
        split_uniform, return_partition, overlap_exchange,
        config.shuffle_refine_levels, shards,
    )
    w, p = _split(outs, len(words), pay_dtypes)
    if return_partition:
        return w, p, counts, partition
    return w, p, counts


def _partition_body(mesh, n_keys, capacity, stage1_cap, stable, overlap,
                    partition, shards):
    """Route rows by a precomputed partition (shuffle.py
    ``_partition_body``)."""
    gmins, wshifts, wbits, dev_start = partition
    sorted_all, offs, sizes = [], [], []
    for planes in shards:
        bucket = _apply_window(planes[:n_keys], gmins, wshifts, wbits)
        # sort by (bucket, key): segments must be bucket-contiguous even
        # where a foreign window's saturation breaks key order.  The signed
        # bucket leads as a biased u32 (same order as int32).
        lead = P.narrow(bucket.to(_I64) + (1 << 31), torch.uint32)
        srt = _local_sort([lead] + list(planes), 1 + n_keys, stable)
        boundary = torch.searchsorted(P.widen(srt[0]) - (1 << 31), dev_start)
        sorted_all.append(srt[1:])
        sizes.append(boundary[1:] - boundary[:-1])
        offs.append(boundary[:-1])
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
):
    """Route rows to shards by an existing partition (co-partitioning): the
    4-tuple from ``distributed_sort(..., split_uniform=False,
    return_partition=True)``.  Rows whose key falls in bucket b land on the
    shard that shuffle gave bucket b.  A dataset of at most
    ``config.replicate_capacity_max`` rows gets full-table capacity.  Same
    return convention as :func:`distributed_sort`."""
    del use_ragged
    _check_axis(mesh, axis)
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
        overlap_exchange, part, shards,
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
        cap = int(out[0][0].shape[0]) // mesh.n_local
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
    rank's valid rows, gathered after the counts)."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    counts = np.asarray(counts)
    D = counts.shape[0]
    first, L = (0, D) if mesh is None else (mesh.shards.start, mesh.n_local)
    mine = counts[first:first + L]
    out = []
    for p in planes:
        p = (p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p))
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
