"""The port's exchange (parallel/remote_dma.py, kernel B6's plain version)
against the JAX package's ``shuffle._exchange_raw``.

The JAX side runs the ragged branch (``use_ragged=True``) on the virtual
8-device CPU mesh, with ``jax.lax.ragged_all_to_all`` replaced by the
traceable emulation of ``tests/test_exchange_parity.py`` (XLA:CPU has no
ragged all-to-all).  The port runs the same exchange on ``make_mesh(D,
device="cpu")``.  Received planes are bit-equal, pads included; validity
masks and counts are equal, including a receiver whose demand exceeds its
capacity.  Nothing in ``rdst_tpu`` changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS
from test_exchange_parity import _emulated_ragged_all_to_all

from rdst_tpu.parallel import make_mesh as jmake_mesh
from rdst_tpu.parallel import shuffle as jshuffle
from rdst_tpu_torch.parallel import remote_dma as rd
from rdst_tpu_torch.parallel import shuffle as tshuffle

torch.set_num_threads(1)

PAD = 0xFFFFFFFF


def _size_matrix(rng, D, n_local, case):
    """(D, D) [sender, receiver] sizes, each row summing to <= n_local."""
    if D == 1:
        return np.array([[n_local]], np.int64)
    m = rng.integers(0, 2 * n_local // D, size=(D, D))
    if case == "edges":
        m[0, 1] = 0  # zero
        m[D // 2, D - 1] = 128  # an exact multiple of a lane row
        m[1, D // 2] = 1  # one element
        m[:, D - 2] = 0  # a receiver that gets nothing
        m[D - 1, :] = 0  # a sender that sends nothing
    elif case == "overflow":
        m[:, 2] = n_local // 2  # receiver 2's demand: 4 n_local
    m = np.minimum(m, n_local // D)  # rows never exceed n_local
    return m.astype(np.int64)


def _offsets(rng, sm, n_local):
    """Send offsets: segments in destination order, with a random gap in
    front (the exchange takes any offsets, not only a prefix sum)."""
    off = np.cumsum(sm, 1) - sm
    slack = n_local - sm.sum(1)
    return off + rng.integers(0, slack + 1)[:, None]


def _jax_exchange(planes, offs, sizes, capacity, monkeypatch):
    """JAX ``_exchange_raw`` (ragged branch) under shard_map."""
    monkeypatch.setattr(jax.lax, "ragged_all_to_all", _emulated_ragged_all_to_all)
    D = offs.shape[0]
    k = len(planes)
    n_local = planes[0].shape[0] // D

    def body(*args):
        me = jax.lax.axis_index("shard")
        out, valid, nv = jshuffle._exchange_raw(
            list(args[:k]), args[k], args[k + 1], capacity, True, "shard", D,
            me, n_local,
        )
        return tuple(out) + (valid, nv[None])

    fn = jax.shard_map(
        body, mesh=jmake_mesh(D), in_specs=tuple(PS("shard") for _ in range(k + 2)),
        out_specs=tuple(PS("shard") for _ in range(k + 2)),
    )
    res = fn(*[jnp.asarray(p) for p in planes],
             jnp.asarray(offs.reshape(-1).astype(np.int32)),
             jnp.asarray(sizes.reshape(-1).astype(np.int32)))
    return [np.asarray(r) for r in res]


def _port_exchange(planes, offs, sizes, capacity):
    D = offs.shape[0]
    n_local = planes[0].shape[0] // D
    shards = [[torch.from_numpy(p[s * n_local:(s + 1) * n_local].copy())
               for p in planes] for s in range(D)]
    recv, n_valid, bufs = tshuffle._exchange_raw(
        tshuffle.make_mesh(D, device="cpu"), shards, [torch.from_numpy(o) for o in offs],
        [torch.from_numpy(z) for z in sizes], capacity, [list(range(D))],
    )
    valid = torch.cat([torch.arange(capacity) < nv for nv in n_valid])
    return [b.numpy() for b in bufs[0]], valid.numpy(), torch.stack(n_valid).numpy()


@pytest.mark.parametrize(
    "D,n_planes,case",
    [(8, 1, "random"), (8, 2, "edges"), (8, 1, "overflow"), (4, 1, "edges"),
     (1, 2, "random")],
)
def test_exchange_matches_jax_ragged(monkeypatch, D, n_planes, case):
    rng = np.random.default_rng(D * 100 + n_planes)
    n_local = 1 << 10
    sm = _size_matrix(rng, D, n_local, case)
    offs = _offsets(rng, sm, n_local)
    if D == 1:
        offs[:] = 0  # the 1-shard exchange is an identity of the whole shard
    capacity = int(sm.sum(0).max()) + 37 if case != "overflow" else n_local // 2
    planes = [rng.integers(0, 2**32, size=D * n_local, dtype=np.uint32)
              for _ in range(n_planes)]
    planes[0][::97] = PAD  # real all-ones words among the data
    want = _jax_exchange(planes, offs, sm, capacity, monkeypatch)
    before = rd.EXCHANGE.plain_calls
    got, valid, counts = _port_exchange(planes, offs, sm, capacity)
    assert rd.EXCHANGE.plain_calls - before == (D * n_planes if D > 1 else 0)
    for g, w in zip(got, want[:n_planes]):
        np.testing.assert_array_equal(g, w)  # pads included
    np.testing.assert_array_equal(valid, want[n_planes])
    np.testing.assert_array_equal(counts, want[n_planes + 1])
    np.testing.assert_array_equal(counts, sm.sum(0))
    if case == "overflow":
        assert counts[2] > capacity


def _layout_matrix(rng):
    m = rng.integers(0, 3 * 2048, size=(8, 8))
    m[0, 1], m[2, 3], m[4, 5], m[6, 7] = 0, 2048, 4096, 17
    return torch.from_numpy(m)


def test_layout_sender_receiver_symmetry(rng):
    """Where sender s writes on receiver d is where d expects s: segments
    tile each receiver's buffer in sender order, without gaps."""
    sm = _layout_matrix(rng)
    lay = rd.exchange_layout(sm, int(sm.sum(0).max()))
    off = lay.recv_offsets.numpy()
    for d in range(8):
        assert off[0, d] == 0
        for s in range(7):
            assert off[s + 1, d] == off[s, d] + int(sm[s, d])
    np.testing.assert_array_equal(lay.landed.numpy(), sm.numpy())
    np.testing.assert_array_equal(lay.demand.numpy(), sm.numpy().sum(0))


def test_layout_writes_stay_in_buffer(rng):
    """Under overflow every landed segment ends inside the buffer, the
    arrivals are min(demand, capacity) and the demand still signals."""
    sm = _layout_matrix(rng)
    sm[:, 2] = 20 * 2048
    cap = int(_layout_matrix(np.random.default_rng(0)).sum(0).max())
    lay = rd.exchange_layout(sm, cap)
    off, landed = lay.recv_offsets.numpy(), lay.landed.numpy()
    assert ((landed == 0) | (off + landed <= cap)).all()
    assert (landed >= 0).all() and (landed <= sm.numpy()).all()
    np.testing.assert_array_equal(landed.sum(0), np.minimum(sm.numpy().sum(0), cap))
    assert lay.demand[2] == 8 * 20 * 2048 > cap


def test_exchange_arrivals_and_pads(rng):
    """The wrapper's arrival counts and buffers against a numpy oracle."""
    D, n_local, cap = 8, 512, 300
    sm = _size_matrix(rng, D, n_local, "overflow")
    offs = _offsets(rng, sm, n_local)
    planes = [[torch.from_numpy(rng.integers(0, 2**32, n_local, dtype=np.uint32))
               for _ in range(2)] for _ in range(D)]
    recv, demand, arrived = rd.remote_dma_exchange(
        planes, [torch.from_numpy(o) for o in offs],
        [torch.from_numpy(z) for z in sm], cap)
    np.testing.assert_array_equal(demand.numpy(), sm.sum(0))
    np.testing.assert_array_equal(arrived.numpy(),
                                  np.tile(np.minimum(sm.sum(0), cap), (2, 1)))
    for j in range(2):
        want = np.full(D * cap, PAD, np.uint32)
        for d in range(D):
            seg = np.concatenate([planes[s][j].numpy()[offs[s, d]:offs[s, d] + sm[s, d]]
                                  for s in range(D)])[:cap]
            want[d * cap:d * cap + seg.size] = seg
        np.testing.assert_array_equal(recv[j].numpy(), want)


def test_pointer_table_layout():
    """The kernel's table: sender s's plane j at j * D + s, then receiver
    d's buffer of plane j at (k + j) * D + d, capacity words apart."""
    for D, k, cap in [(1, 2, 16), (3, 1, 7), (8, 3, 1000)]:
        store = torch.zeros(D * k * 64 + 8, dtype=torch.int32).view(torch.uint32)
        planes = [[store[(s * k + j) * 64 + s: (s * k + j) * 64 + s + 50]
                   for j in range(k)] for s in range(D)]
        recv = [torch.empty(D * cap, dtype=torch.uint32) for _ in range(k)]
        tab = rd._pointer_table(planes, recv, cap)
        assert len(tab) == 2 * k * D
        for j in range(k):
            for s in range(D):
                assert tab[j * D + s] == planes[s][j].data_ptr()
            for d in range(D):
                assert tab[(k + j) * D + d] == recv[j][d * cap:].data_ptr()


def _copy_model(out, writes, dst, mem, src, n):
    """csrc/exchange.cu copy_words on word indices (the receive buffer and
    ``mem`` start on 16-byte boundaries): scalar words until ``dst`` is
    aligned, 16-byte stores whose four words come from the aligned uint4s v
    and v + 1 at ``src - R``, a scalar tail."""
    head = min(n, (4 - dst % 4) % 4)
    pairs = [(dst + i, src + i) for i in range(head)]
    d0, s0 = dst + head, src + head
    nvec = (n - head) // 4
    r = s0 % 4
    base = s0 - r
    for v in range(nvec):
        blocks = [base + 4 * v] + ([base + 4 * v + 4] if r else [])
        for b in blocks:  # every load holds a word of the segment
            assert b < src + n and b + 3 >= src and b + 4 <= len(mem)
        words = np.concatenate([mem[b:b + 4] for b in blocks])[r:r + 4]
        out[d0 + 4 * v: d0 + 4 * v + 4] = words
        writes[d0 + 4 * v: d0 + 4 * v + 4] += 1
    pairs += [(d0 + i, s0 + i) for i in range(4 * nvec, n - head)]
    for d, s in pairs:
        out[d] = mem[s]
        writes[d] += 1


def _kernel_model(mem, shift, offs, sm, cap, chunk):
    """The exchange kernel block by block: block (c, d, j) owns receive
    words [c * chunk, (c + 1) * chunk) of receiver d's buffer of plane j,
    copies the part of each sender's segment that lands there (at the sum
    of the earlier senders' sizes), pads the part at or past min(demand,
    capacity) and adds what landed to arrived[j, d].  ``mem[s][j]``: sender
    s's storage, its plane starting at word ``shift`` (one for all senders,
    or a list of one per sender); ``sm`` (S, R): S senders, R receivers."""
    S, k = len(mem), len(mem[0])
    D = sm.shape[1]
    shifts = shift if isinstance(shift, list) else [shift] * S
    out = [np.zeros(D * cap, np.uint32) for _ in range(k)]
    writes = [np.zeros(D * cap, np.int64) for _ in range(k)]
    arrived = np.zeros((k, D), np.int64)
    for j in range(k):
        for d in range(D):
            for p0 in range(0, cap, chunk):
                p1 = min(p0 + chunk, cap)
                fill = landed = lo = 0
                for s in range(S):
                    fit = max(0, min(int(sm[s, d]), cap - lo))
                    fill += fit
                    a, b = max(p0, lo), min(p1, lo + fit)
                    if a < b:
                        _copy_model(out[j], writes[j], d * cap + a, mem[s][j],
                                    shifts[s] + int(offs[s, d]) + a - lo, b - a)
                        landed += b - a
                    lo += int(sm[s, d])
                a = max(p0, fill)
                out[j][d * cap + a: d * cap + p1] = PAD
                writes[j][d * cap + a: d * cap + p1] += 1
                arrived[j, d] += landed
    return out, writes, arrived


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("D,case", [(1, "random"), (1, "overflow"), (3, "edges"),
                                    (3, "overflow"), (8, "edges"), (8, "overflow")])
def test_exchange_kernel_model(D, case, shift):
    """The kernel's walk over the receive buffers, at every residue mod 4 of
    the source planes (``shift``) and of the capacity: every receive word is
    written exactly once, and buffers (pads included) and arrivals equal the
    plain version's, whose offsets are ``exchange_layout``'s, under empty
    segments and overflow too."""
    rng = np.random.default_rng(D * 10 + shift)
    n_local, k = 301, 2
    sm = _size_matrix(rng, D, n_local, case)  # D = 1: the whole shard
    offs =_offsets(rng, sm, n_local) if D > 1 else np.zeros((1, 1), np.int64)
    cap = (n_local // 2 if case == "overflow" else int(sm.sum(0).max()) + 5) + shift
    words = -(-(shift + n_local) // 4) * 4
    mem = [[rng.integers(0, 2**32, size=words, dtype=np.uint32) for _ in range(k)]
           for _ in range(D)]
    out, writes, arrived = _kernel_model(mem, shift, offs, sm, cap, chunk=64)
    for w in writes:
        assert (w == 1).all()
    planes = [[torch.from_numpy(m[shift:shift + n_local].copy()) for m in ms] for ms in mem]
    want, demand, want_arr = rd.remote_dma_exchange_plain(
        planes, [torch.from_numpy(o) for o in offs], [torch.from_numpy(z) for z in sm], cap)
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(arrived, want_arr.numpy())
    np.testing.assert_array_equal(arrived[0], np.minimum(demand.numpy(), cap))
    if case == "overflow":
        assert demand.max() > cap


@pytest.mark.parametrize("bad", [torch.uint16, torch.int64, torch.int32])
def test_non_u32_plane_raises_before_any_write(bad):
    """Only u32 planes cross the exchange; anything else raises TypeError
    before a buffer is allocated or a copy is made (the reference's
    docstring promised a fallback its code never had)."""
    D = 4
    good = [torch.arange(64, dtype=torch.int32).view(torch.uint32)]
    odd = [torch.zeros(64, dtype=bad)]
    planes = [good + (odd if s == 3 else good) for s in range(D)]
    sizes = [torch.full((D,), 16, dtype=torch.int64)] * D
    offs = [torch.arange(0, 64, 16)] * D
    before = rd.EXCHANGE.plain_calls
    with pytest.raises(TypeError):
        rd.remote_dma_exchange(planes, offs, sizes, 64)
    assert rd.EXCHANGE.plain_calls == before


def _rect_matrix(rng, S, R, n_local, case):
    """(S, R) sizes, each row summing to <= n_local: empty segments, a
    sender that sends nothing, a receiver that gets nothing; "overflow"
    sends receiver 0 more than its capacity."""
    m = np.minimum(rng.integers(0, 2 * n_local // max(R, 2), size=(S, R)),
                   n_local // (2 * R))
    m[0, 0] = 0
    if R > 1:
        m[:, R - 1] = 0
    if case == "overflow":
        m[:, 0] = n_local // 2
    m[S - 1, :] = 0
    return m.astype(np.int64)


@pytest.mark.parametrize("case", ["edges", "overflow"])
@pytest.mark.parametrize("S,R", [(8, 4), (8, 2), (4, 1), (3, 5), (2, 8)])
def test_exchange_kernel_model_rectangular(S, R, case):
    """S senders by R receivers, as on a mesh over processes (R: this
    process's shards; a remote sender's plane starts anywhere in the
    transport buffer): every receive word written once, buffers (pads
    included) and arrivals equal to the plain version's, with each sender's
    plane at its own word offset mod 4, empty segments and overflow."""
    rng = np.random.default_rng(S * 100 + R * 10 + len(case))
    n_local, k = 301, 2
    sm = _rect_matrix(rng, S, R, n_local, case)
    offs = np.cumsum(sm, 1) - sm + rng.integers(0, n_local - sm.sum(1) + 1)[:, None]
    cap = (n_local // 3 if case == "overflow" else int(sm.sum(0).max()) + 3)
    shifts = [int(x) for x in rng.integers(0, 4, size=S)]
    mem = [[rng.integers(0, 2**32, size=n_local + 8, dtype=np.uint32) for _ in range(k)]
           for _ in range(S)]
    out, writes, arrived = _kernel_model(mem, shifts, offs, sm, cap, chunk=64)
    for w in writes:
        assert (w == 1).all()
    planes = [[torch.from_numpy(m[sh:sh + n_local].copy()) for m in ms]
              for ms, sh in zip(mem, shifts)]
    before = rd.EXCHANGE.plain_calls
    want, demand, want_arr = rd.remote_dma_exchange(
        planes, [torch.from_numpy(o) for o in offs], [torch.from_numpy(z) for z in sm], cap)
    assert rd.EXCHANGE.plain_calls - before == S * k
    assert want[0].shape == (R * cap,) and want_arr.shape == (k, R)
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(arrived, want_arr.numpy())
    np.testing.assert_array_equal(demand.numpy(), sm.sum(0))
    np.testing.assert_array_equal(arrived[0], np.minimum(sm.sum(0), cap))
    if case == "overflow":
        assert demand.max() > cap


@pytest.mark.parametrize("lo,hi", [(0, 4), (4, 8), (2, 3), (0, 8)])
def test_rectangular_is_a_block_of_the_square_exchange(rng, lo, hi):
    """The exchange to receivers [lo, hi) of D senders equals those
    receivers' part of the square exchange, pads and arrivals included; a
    sender whose segments for them are packed (as the transport delivers a
    remote sender's) gives the same buffers."""
    D, n_local, cap = 8, 512, 300
    sm = _size_matrix(rng, D, n_local, "overflow")
    offs = _offsets(rng, sm, n_local)
    planes = [[torch.from_numpy(rng.integers(0, 2**32, n_local, dtype=np.uint32))]
              for _ in range(D)]
    full, fdemand, farr = rd.remote_dma_exchange(
        planes, [torch.from_numpy(o) for o in offs], [torch.from_numpy(z) for z in sm], cap)
    block = sm[:, lo:hi]
    got, demand, arr = rd.remote_dma_exchange(
        planes, [torch.from_numpy(o[lo:hi].copy()) for o in offs],
        [torch.from_numpy(z.copy()) for z in block], cap)
    np.testing.assert_array_equal(got[0].numpy(), full[0].numpy()[lo * cap:hi * cap])
    np.testing.assert_array_equal(demand.numpy(), fdemand.numpy()[lo:hi])
    np.testing.assert_array_equal(arr.numpy(), farr.numpy()[:, lo:hi])
    # every sender packed: its segments for [lo, hi) back to back
    packed = [[torch.cat([p[0][o:o + z] for o, z in zip(offs[s, lo:hi], block[s])])]
              for s, p in enumerate(planes)]
    poffs = [torch.from_numpy(np.cumsum(z) - z) for z in block]
    again, _, _ = rd.remote_dma_exchange(
        packed, poffs, [torch.from_numpy(z.copy()) for z in block], cap)
    np.testing.assert_array_equal(again[0].numpy(), got[0].numpy())


def test_pointer_table_rectangular():
    """S senders, R receivers: sender s's plane j at j * S + s, then
    receiver d's buffer of plane j at k * S + j * R + d."""
    S, R, k, cap = 5, 3, 2, 11
    planes = [[torch.zeros(20, dtype=torch.int32).view(torch.uint32) for _ in range(k)]
              for _ in range(S)]
    recv = [torch.empty(R * cap, dtype=torch.uint32) for _ in range(k)]
    tab = rd._pointer_table(planes, recv, cap)
    assert len(tab) == k * (S + R)
    for j in range(k):
        for s in range(S):
            assert tab[j * S + s] == planes[s][j].data_ptr()
        for d in range(R):
            assert tab[k * S + j * R + d] == recv[j][d * cap:].data_ptr()
