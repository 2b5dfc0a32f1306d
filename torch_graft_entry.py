"""Entry points of the PyTorch port (``__graft_entry__.py`` on
``rdst_tpu_torch``).

``entry(device="cuda")``      -- one single-card step, the flagship pipeline:
                                 the two-word (u64-equivalent) sort of 2^16
                                 keys.  Returns ``(fn, (hi, lo))``.
``dryrun_multichip(n_devices, device="cuda", devices=None)``
                              -- one run of the whole distributed sequence on
                                 an ``n_devices``-shard mesh, 512 rows a
                                 shard: the stable overlapped shuffle sort,
                                 the aggregate, the filter, the range and
                                 hash joins, the 2-axis sort (even
                                 ``n_devices``), and a tight capacity that
                                 may overflow, then ``distributed_sort_auto``.
                                 Every check is an ``assert``.  All shards of
                                 the mesh lie on ``device``, in this process,
                                 or on the cards ``devices`` (a block of
                                 shards each, as the reference puts one
                                 shard on each of its devices).

Numpy draws the same numbers in the same order as ``__graft_entry__.py``,
so both packages see the same data.

    from torch_graft_entry import dryrun_multichip, entry
    fn, args = entry()                 # the card; entry("cpu") on the host
    hi_sorted, lo_sorted = fn(*args)
    dryrun_multichip(8)                # 8 shards on one card
    dryrun_multichip(8, devices=["cuda:0", "cuda:1"])  # 4 shards a card
"""
import numpy as np

#: rows of each shard in :func:`dryrun_multichip`
ROWS_PER_SHARD = 512


def entry(device="cuda"):
    import torch

    from rdst_tpu_torch.engine import sort_words
    from rdst_tpu_torch.keys import as_device

    dev = as_device(device)
    n = 1 << 16
    rng = np.random.default_rng(0)
    hi = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32)).to(dev)
    lo = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32)).to(dev)

    def fn(hi, lo):
        (shi, slo), _ = sort_words([hi, lo])
        return shi, slo

    return fn, (hi, lo)


def _u64(hi, lo):
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _np(t):
    return t.cpu().numpy()


def _column(t, name):
    """A table's column, or the per-card tables' column concatenated, on
    the host."""
    if isinstance(t, list):
        return np.concatenate([_np(x[name]) for x in t])
    return _np(t[name])


def _dryrun_steps(n_devices: int, device="cuda", devices=None) -> dict:
    """:func:`dryrun_multichip`'s sequence; returns each step's outputs by
    name: ``sort`` (words, payloads, counts), ``aggregate`` (table, group
    count), ``filter`` (table, counts), ``join_range`` and ``join_hash``
    (table, match count), ``sort_2d`` (words, payloads, counts; even
    ``n_devices`` only), ``tight`` ((words, counts), or None where the
    capacity overflowed) and ``auto`` (words, counts)."""
    from rdst_tpu_torch import keys as rkeys
    from rdst_tpu_torch.parallel import (
        distributed_filter,
        distributed_group_aggregate,
        distributed_join,
        distributed_sort,
        distributed_sort_auto,
        gather_valid,
        make_mesh,
        make_mesh_2d,
    )
    from rdst_tpu_torch.table import Table

    mesh = make_mesh(n_devices, device=device, devices=devices)
    dev = mesh.device
    steps = {}
    n = ROWS_PER_SHARD * n_devices
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    payload = np.arange(n, dtype=np.uint32)
    nk = rkeys.normalize(x, device=dev)
    words, payloads, counts = distributed_sort(
        list(nk.words), [payload], mesh=mesh, stable=True,
        overlap_exchange=True,
    )
    steps["sort"] = (words, payloads, counts)
    total = int(counts.sum())
    assert total == n, (total, n)
    dense = gather_valid(list(words), counts)
    assert np.array_equal(_u64(*dense), np.sort(x)), "distributed sort mismatch"

    # distributed table pipeline: shuffle + hash aggregate + filter
    grp = rng.integers(0, 32, n).astype(np.uint32)
    qty = rng.integers(1, 10, n).astype(np.uint32)
    t = Table({"grp": grp, "qty": qty}, device=dev)
    agg, n_groups = distributed_group_aggregate(
        t, "grp", {"total": ("qty", "sum")}, mesh=mesh
    )
    steps["aggregate"] = (agg, n_groups)
    assert int(n_groups) == len(np.unique(grp))
    steps["filter"] = distributed_filter(t, qty > 5, mesh=mesh)

    # distributed co-partitioned join (left fact x right dim)
    dim = Table(
        {
            "grp": np.arange(32, dtype=np.uint32),
            "name": (np.arange(32, dtype=np.uint32) * 11),
        },
        device=dev,
    )
    for step, kw in (("join_range", dict(overlap_exchange=True)),
                     ("join_hash", dict(partition="hash"))):
        joined, n_matched = distributed_join(t, dim, "grp", mesh=mesh, **kw)
        steps[step] = (joined, n_matched)
        assert int(n_matched) == n
        assert np.array_equal(_column(joined, "name"), _column(joined, "grp") * 11)

    # 2-axis (host x chip) mesh: the two-stage exchange
    if n_devices >= 2 and n_devices % 2 == 0:
        mesh2 = make_mesh_2d(2, n_devices // 2, device=device, devices=devices)
        w2, p2, c2 = distributed_sort(
            list(nk.words), [payload], mesh=mesh2, axis=mesh2.axis_names,
            stable=True, overlap_exchange=True,
        )
        steps["sort_2d"] = (w2, p2, c2)
        d2 = gather_valid(list(w2) + list(p2), c2)
        assert np.array_equal(_u64(d2[0], d2[1]), np.sort(x)), "2-axis sort mismatch"
        order = np.argsort(x, kind="stable")
        assert np.array_equal(d2[2], payload[order]), "2-axis stability"

    # overflow scenario: a hot bucket of many distinct keys overflows a
    # tight capacity (detected, not silent), and the auto wrapper retries
    # with a doubled factor until it fits
    hot = rng.integers(0, 1 << 8, size=n, dtype=np.uint64)  # low entropy,
    hot[: n // 8] = rng.integers(0, 2**64, size=n // 8, dtype=np.uint64)
    hnk = rkeys.normalize(hot, device=dev)
    steps["tight"] = None
    try:
        ow, _, oc = distributed_sort(
            list(hnk.words), mesh=mesh, capacity_factor=1.05
        )
        gather_valid(list(ow), oc)
        steps["tight"] = (ow, oc)
    except OverflowError:
        pass  # tight capacity may overflow at tiny n: detected, never
        # silent; the auto wrapper below must always converge
    aw, _, ac = distributed_sort_auto(
        list(hnk.words), mesh=mesh, capacity_factor=1.05
    )
    steps["auto"] = (aw, ac)
    adense = gather_valid(list(aw), ac)
    assert np.array_equal(_u64(*adense), np.sort(hot)), "auto-retry mismatch"
    return steps


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> None:
    _dryrun_steps(n_devices, device, devices)

