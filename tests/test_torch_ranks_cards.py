"""The port's mesh over processes whose ranks each hold several cards
(``init_distributed`` with ``make_mesh(..., devices=[...])``) against its
one-process mesh and the JAX package's virtual 8-device mesh.

Each (world, K) of ``CONFIGS`` starts its ranks once, as fresh processes
running this file (:func:`_child`), with gloo on the CPU, a ``file://``
rendezvous in a temporary directory of its own and the time limit of
``test_torch_distributed.py``; each rank holds ``8 // world`` shards on K
CPU card entries (``["cpu"] * K``: the cards' grouping through the plain
versions).  Every rank runs every shuffle case of
``test_torch_distributed.CASES`` and every table case of
``test_torch_dtable_distributed.CASES`` on its own rows and saves each
card's output block.  The parent reassembles them rank-major, then card by
card within a rank, and holds every plane, column and count bit-equal to
the port's one-process mesh of the same shape, and to the JAX package by
the rules of those two files.  The children import neither JAX nor
``rdst_tpu``.

The cross-process exchange lands through B6's multi-card form: a remote
sender's planes lie on card 0 (the transport's buffer), a local sender's
on its own card, and every receiving card launches once.  The children
record each such call whose senders lie on two cards; the parent holds it,
and a call built here with the same card layout, against the square
exchange.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_distributed as tdist
import test_torch_dtable_distributed as tdtab
from rdst_tpu_torch import parallel as tp
from rdst_tpu_torch.parallel import mesh as tmesh
from rdst_tpu_torch.parallel import remote_dma as rd
from rdst_tpu_torch.parallel import shuffle as tsh

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = [(2, 2), (2, 4), (4, 2)]  # (world, cards a rank)
D = 8


def _ids(cfg):
    return f"world{cfg[0]}x{cfg[1]}cards"


def _mesh(shape, K):
    cards = ["cpu"] * K
    if len(shape) == 1:
        return tp.make_mesh(shape[0], devices=cards)
    return tp.make_mesh_2d(*shape, devices=cards)


def _blocks(plane, K):
    """A K-card output plane as its K blocks, checked to be K of one
    length."""
    assert isinstance(plane, list) and len(plane) == K, type(plane)
    assert len({int(b.shape[0]) for b in plane}) == 1
    return plane


def _recording(calls):
    """``shuffle.remote_dma_exchange_cards`` that keeps the inputs and
    outputs of every call whose senders lie on more than one card."""
    real = tsh.remote_dma_exchange_cards

    def rec(planes, offs, sizes, capacity, send_cards, recv_cards, devices, streams=None):
        out = real(planes, offs, sizes, capacity, send_cards, recv_cards, devices, streams)
        if len(set(send_cards)) > 1:
            calls.append(dict(
                planes=[[tdist._u32(p) for p in ps] for ps in planes],
                offs=[o.numpy() for o in offs], sizes=[z.numpy() for z in sizes],
                capacity=capacity, send_cards=list(send_cards),
                recv_cards=list(recv_cards),
                out=[([tdist._u32(r) for r in recv], demand.numpy(), arrived.numpy())
                     for recv, demand, arrived in out]))
        return out
    return rec


def _child(world, rank, K, init, outdir):
    """One rank: every shuffle case, then every table case, on its own rows
    over K card entries."""
    torch.set_num_threads(1)
    out = pathlib.Path(outdir)
    tp.init_distributed(device="cpu", init_method=init, rank=rank, world_size=world)
    record = {"shuffle": {}, "dtable": {}}
    calls = []
    tsh.remote_dma_exchange_cards = _recording(calls)
    for name, (shape, *_rest) in tdist.CASES.items():
        mesh = _mesh(shape, K)
        L = mesh.n_local
        rows = slice(rank * L * tdist.N_LOCAL, (rank + 1) * L * tdist.N_LOCAL)
        results, part = tdist._run(name, mesh, rows)
        rec = record["shuffle"][name] = {}
        for i, (w, p, c) in enumerate(results):
            planes = [_blocks(x, K) for x in list(w) + list(p)]
            np.save(out / f"{name}.{i}.{rank}.planes.npy",  # (K, planes, block)
                    np.stack([np.stack([tdist._u32(x[c]) for x in planes])
                              for c in range(K)]))
            np.save(out / f"{name}.{i}.{rank}.counts.npy", c.numpy())
            try:
                g = tp.gather_valid(planes, c, mesh=mesh)
                np.save(out / f"{name}.{i}.{rank}.gathered.npy",
                        np.stack([x.view(np.uint32) for x in g]))
            except OverflowError:
                rec[f"{i}.gather_overflows"] = True
        if part is not None:
            np.save(out / f"{name}.{rank}.partition.npy",
                    np.stack([x.numpy().astype(np.int64) for x in part[:3]]))
    mixed = [c for c in calls if 0 in c["send_cards"] and min(c["recv_cards"]) > 0]
    if mixed:  # a call whose remote senders lie on card 0, its receivers elsewhere
        c = mixed[0]
        np.savez(out / f"mixed.{rank}.npz",
                 **{f"p{s}_{j}": x for s, ps in enumerate(c["planes"]) for j, x in enumerate(ps)},
                 offs=np.stack(c["offs"]), sizes=np.stack(c["sizes"]),
                 **{f"r{b}_{j}": x for b, (recv, _, _) in enumerate(c["out"])
                    for j, x in enumerate(recv)},
                 **{f"d{b}": d for b, (_, d, _) in enumerate(c["out"])},
                 **{f"a{b}": a for b, (_, _, a) in enumerate(c["out"])})
        record["mixed"] = {k: c[k] for k in ("capacity", "send_cards", "recv_cards")}
        record["mixed"]["planes"] = len(c["planes"][0])
    record["cards_calls"] = len(calls)
    del calls[:]
    for name, (shape, *_rest) in tdtab.CASES.items():
        res = tdtab._run(name, _mesh(shape, K), world, rank)
        if isinstance(res, OverflowError):
            record["dtable"][name] = {"raised": str(res)}
            continue
        tables, count = res
        assert isinstance(tables, list) and len(tables) == K
        names = tables[0].column_names
        record["dtable"][name] = {"columns": names, "count": tdtab._np(count).tolist()}
        np.savez(out / f"{name}.{rank}.npz",
                 **{f"c{i}.{c}": tdtab._np(t[n]) for c, t in enumerate(tables)
                    for i, n in enumerate(names)})
    record["no_jax"] = "jax" not in sys.modules and "rdst_tpu.parallel" not in sys.modules
    record["transport"] = dict(tmesh.TRANSPORT)
    (out / f"record.{rank}.json").write_text(json.dumps(record))
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def _start(world, K, tmp):
    init = "file://" + str(tmp / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--child",
         str(world), str(r), str(K), init, str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every (world, K), started together, waited for when first needed:
    (directory, the ranks' records)."""
    tmps = {cfg: tmp_path_factory.mktemp(_ids(cfg)) for cfg in CONFIGS}
    procs = {cfg: _start(*cfg, tmps[cfg]) for cfg in CONFIGS}
    done = {}

    def get(cfg):
        if cfg not in done:
            tdist._wait(procs[cfg])
            done[cfg] = (tmps[cfg], [json.loads((tmps[cfg] / f"record.{r}.json").read_text())
                                     for r in range(cfg[0])])
        return done[cfg]

    yield get
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _planes(out, name, i, world):
    """The ranks' planes, rank-major and within a rank card by card, and
    the counts (equal on every rank)."""
    per_rank = [np.load(out / f"{name}.{i}.{r}.planes.npy") for r in range(world)]
    planes = np.concatenate([blk for x in per_rank for blk in x], axis=1)
    counts = [np.load(out / f"{name}.{i}.{r}.counts.npy") for r in range(world)]
    for c in counts[1:]:
        np.testing.assert_array_equal(c, counts[0])
    return planes, counts[0]


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
@pytest.mark.parametrize("name", list(tdist.CASES))
def test_shuffle_matches_one_process_mesh(runs, name, cfg):
    """Every plane (pads included), the counts, the partition and
    ``gather_valid``'s global order equal the one-process mesh's."""
    out, records = runs(cfg)
    world = cfg[0]
    results, part = tdist.one_process_result(name)
    for i, (w, p, c) in enumerate(results):
        planes, counts = _planes(out, name, i, world)
        np.testing.assert_array_equal(counts, c.numpy())
        np.testing.assert_array_equal(planes, np.stack([tdist._u32(x) for x in list(w) + list(p)]))
        try:
            ref = np.stack([x.view(np.uint32) for x in tp.gather_valid(list(w) + list(p), c)])
        except OverflowError:
            assert all(r["shuffle"][name].get(f"{i}.gather_overflows") for r in records)
            continue
        for r in range(world):
            np.testing.assert_array_equal(np.load(out / f"{name}.{i}.{r}.gathered.npy"), ref)
    if part is not None:
        want = np.stack([x.numpy().astype(np.int64) for x in part[:3]])
        for r in range(world):
            np.testing.assert_array_equal(np.load(out / f"{name}.{r}.partition.npy"), want)


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
@pytest.mark.parametrize("name", list(tdist.CASES))
def test_shuffle_matches_jax(runs, name, cfg):
    """The reassembled output against the JAX package's, by
    ``test_torch_shuffle.py``'s rules (the stage-1 overflow: its poisoned
    counts)."""
    from test_torch_shuffle import _assert_same

    out, _ = runs(cfg)
    shape, inp, entry, kw, conf = tdist.CASES[name]
    n_words = 1 if entry == "partition" else len(tdist._inputs(inp)[0])
    for i, want in enumerate(tdist.jax_result(name)):
        planes, counts = _planes(out, name, i, cfg[0])
        if conf:
            np.testing.assert_array_equal(counts, np.asarray(want[2]))
            assert counts.max() > planes.shape[1] // D
            continue
        pays = [np.asarray(x) for x in want[1]]
        got = ([planes[j] for j in range(n_words)],
               [planes[j].view(pays[k].dtype) for k, j in enumerate(range(n_words, len(planes)))],
               counts)
        _assert_same(want, got, n_words, kw.get("stable", False))


def _table(runs, name, cfg):
    """The ranks' tables, rank-major and card by card, as (Table, count),
    or the ``OverflowError`` message every rank raised."""
    from rdst_tpu_torch.table import Table

    out, records = runs(cfg)
    world, K = cfg
    recs = [r["dtable"][name] for r in records]
    if "raised" in recs[0]:
        assert all(r.get("raised") == recs[0]["raised"] for r in recs), recs
        return recs[0]["raised"]
    for r in recs[1:]:
        assert r["count"] == recs[0]["count"] and r["columns"] == recs[0]["columns"]
    parts = [np.load(out / f"{name}.{r}.npz") for r in range(world)]
    cols = {n: np.concatenate([p[f"c{i}.{c}"] for p in parts for c in range(K)])
            for i, n in enumerate(recs[0]["columns"])}
    return Table(cols, device="cpu"), recs[0]["count"]


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
@pytest.mark.parametrize("name", list(tdtab.CASES))
def test_dtable_matches_one_process_mesh(runs, name, cfg):
    """Every column, bit for bit and in row order, and the counts equal the
    one-process mesh's; an overflow raises on every rank as it does
    there."""
    from test_torch_dtable import _same

    got = _table(runs, name, cfg)
    want = tdtab.one_process_result(name)
    if isinstance(want, OverflowError):
        assert got == str(want)
        return
    assert not isinstance(got, str), got
    _same(want, (got[0], np.asarray(got[1])))


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
@pytest.mark.parametrize("name", list(tdtab.CASES))
def test_dtable_matches_jax(runs, name, cfg):
    """The reassembled tables against the JAX package's by
    ``test_torch_dtable.py``'s rules; an overflow raises in both."""
    from test_torch_dtable import _same

    got = _table(runs, name, cfg)
    want = tdtab.jax_result(name)
    if isinstance(want, OverflowError):
        assert isinstance(got, str) and "join_capacity_factor" in got, got
        return
    assert not isinstance(got, str), got
    fsums = None
    if name in tdtab.FSUMS:
        by, sums = tdtab.FSUMS[name]
        fsums = (tdtab._inputs(tdtab.CASES[name][2])[0][0], by, sums)
    _same(want, (got[0], np.asarray(got[1])), means=tdtab.MEANS, fsums=fsums)


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_children_import_no_jax_and_move_rows(runs, cfg):
    """No rank imported JAX or the JAX package; every rank read the size
    matrices on the host, moved rows between processes (no host copy: CPU
    cards) and landed them through B6's multi-card form."""
    _, records = runs(cfg)
    for r in records:
        assert r["no_jax"] is True
        t = r["transport"]
        assert t["host_reads"] > t["calls"] > 0 and t["bytes_received"] > 0
        assert t["host_copy_bytes"] == 0
        assert r["cards_calls"] > 0


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_remote_senders_on_card_zero_land_on_another_card(runs, cfg):
    """Some rank's exchange read remote senders from card 0 and local ones
    from another card in one multi-card call whose receivers lie off card
    0; its blocks, pads and arrival counts equal the square exchange's on
    the same inputs."""
    out, records = runs(cfg)
    ranks = [r for r, rec in enumerate(records) if "mixed" in rec]
    assert ranks, "no call with remote senders on card 0 and receivers elsewhere"
    for r in ranks:
        m = records[r]["mixed"]
        z = np.load(out / f"mixed.{r}.npz")
        S, k = len(m["send_cards"]), m["planes"]
        assert 0 in m["send_cards"] and set(m["send_cards"]) - {0}
        planes = [[torch.from_numpy(z[f"p{s}_{j}"]) for j in range(k)] for s in range(S)]
        offs = [torch.from_numpy(x) for x in z["offs"]]
        sizes = [torch.from_numpy(x) for x in z["sizes"]]
        recv, demand, arrived = rd.remote_dma_exchange_plain(planes, offs, sizes, m["capacity"])
        n_blocks = len(set(m["recv_cards"]))
        for j in range(k):
            got = np.concatenate([z[f"r{b}_{j}"] for b in range(n_blocks)])
            np.testing.assert_array_equal(got, tdist._u32(recv[j]))
        np.testing.assert_array_equal(
            np.concatenate([z[f"d{b}"] for b in range(n_blocks)]), demand.numpy())
        np.testing.assert_array_equal(
            np.concatenate([z[f"a{b}"] for b in range(n_blocks)], 1), arrived.numpy())


@pytest.mark.parametrize("case", ["random", "edges", "overflow"])
def test_mixed_sender_cards_are_the_square_exchange(case):
    """One rank's view of a flat exchange over two ranks of two cards each:
    the four remote senders are blocks of one transport buffer on card 0
    (each plane the landing part of its segments, in receiver order, its
    offsets their running sums), two local senders lie on card 0 and two on
    card 1, and the receivers are the rank's four shards, two a card.  The
    per-card launches, concatenated, equal the square exchange of every
    sender's whole planes: buffers (pads included), demand and arrivals;
    each card's block as the kernel walks it equals its plain block."""
    from test_torch_exchange import _kernel_model

    rng = np.random.default_rng(len(case) + 71)
    S, R, n_local, k = 8, 4, 1 << 9, 3
    sm = rng.integers(0, n_local // R, size=(S, R)).astype(np.int64)
    if case == "edges":
        sm[0, 1], sm[:, 3], sm[5, :] = 0, 0, 0
    elif case == "overflow":
        sm[:, 2] = n_local // 4
    cap = int(sm.sum(0).max()) + 5 if case != "overflow" else n_local // 2 + 1
    whole = [[rng.integers(0, 2**32, size=n_local, dtype=np.uint32) for _ in range(k)]
             for _ in range(S)]
    offs = np.cumsum(sm, 1) - sm
    landed = rd.exchange_layout(torch.from_numpy(sm), cap).landed.numpy()
    remote = range(4)  # the other rank's shards
    moved = np.concatenate([whole[s][j][offs[s, d]:offs[s, d] + landed[s, d]]
                            for s in remote for j in range(k) for d in range(R)])
    mem, send_offs, at = [], [], 0
    for s in range(S):
        if s in remote:
            t = int(landed[s].sum())
            mem.append([moved[at + j * t:at + (j + 1) * t] for j in range(k)])
            send_offs.append(np.cumsum(landed[s]) - landed[s])
            at += k * t
        else:
            mem.append(whole[s])
            send_offs.append(offs[s])

    def tensors(rows):
        return [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)) for x in rows]

    planes = [[torch.from_numpy(np.ascontiguousarray(p)) for p in ps] for ps in mem]
    recv_cards = [0, 0, 1, 1]
    blocks = rd.remote_dma_exchange_cards(planes, tensors(send_offs), tensors(sm), cap,
                                          [0, 0, 0, 0, 0, 0, 1, 1], recv_cards, ["cpu"] * 2)
    recv, demand, arrived = rd.remote_dma_exchange_plain(
        [[torch.from_numpy(p) for p in ps] for ps in whole], tensors(offs), tensors(sm), cap)
    assert len(blocks) == 2
    for j in range(k):
        assert torch.equal(torch.cat([b[0][j] for b in blocks]), recv[j])
    assert torch.equal(torch.cat([b[1] for b in blocks]), demand)
    assert torch.equal(torch.cat([b[2] for b in blocks], 1), arrived)
    so = np.stack(send_offs)
    # the model loads 4 aligned words at a time: a block's storage ends on one
    padded = [[np.pad(p, (0, -len(p) % 4)) for p in ps] for ps in mem]
    for (c, cols), (brecv, _, barr) in zip(rd._blocks(recv_cards), blocks):
        got, writes, arr = _kernel_model(padded, 0, so[:, cols], sm[:, cols], cap, 256)
        for j in range(k):
            np.testing.assert_array_equal(got[j], brecv[j].numpy())
            assert (writes[j] == 1).all()
        np.testing.assert_array_equal(arr, barr.numpy())


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    world, rank, K = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    sys.exit(_child(world, rank, K, sys.argv[5], sys.argv[6]))
