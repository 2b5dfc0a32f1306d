"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips unless ``torch.cuda.is_available()``.
The machine with the card has no JAX, so run this file there without the
suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version get identical tensors on the card and must agree
bit for bit (integer planes: exact); sorts through the kernels must equal
numpy's.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import rdst_tpu_torch as rt
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch.ops import fused_merge as fm
from rdst_tpu_torch.ops import fused_sort as fs
from rdst_tpu_torch.ops import histogram as th
from rdst_tpu_torch.ops import radix_sort as rs
from rdst_tpu_torch import parallel as tpar
from rdst_tpu_torch.parallel import remote_dma as rd

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _planes(dev, n, dtypes, seed, high=None):
    rng = np.random.default_rng(seed)
    out = []
    for dt in dtypes:
        top = P.all_ones(dt) + 1 if high is None else high
        v = torch.from_numpy(rng.integers(0, top, size=n, dtype=np.int64))
        out.append(P.narrow(v, dt).to(dev))
    return out


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(P.sview(x), P.sview(y))


# (level0, n_levels) pairs of the one-level and general instances
_LEVEL_PAIRS = {1: [(0, 1), (2, 1), (3, 1), (1, 2), (0, 3)],
                2: [(0, 7), (3, 1), (1, 5), (4, 4)],
                3: [(5, 6), (0, 11)], 4: [(3, 1)], 5: [(0, 19)], 8: [(0, 31), (17, 9)]}


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 100_003])
@pytest.mark.parametrize("n_words", [1, 2, 3, 4, 5, 8])
def test_histogram_kernel(dev, n, n_words):
    """Full keys and the (level0, n_levels) pairs of the other instances,
    on planes that start at word offsets 0-3 (the carved buckets of
    sorts/msb.py start anywhere), with all keys one but one (one hot); a
    CUDA tensor never reaches the plain version."""
    big = _planes(dev, n + 3, [torch.uint32] * n_words, n + n_words, high=1 << 32)
    big[0] = P.narrow(P.widen(big[0]) % 3, torch.uint32)
    hot = [P.full(n + 3, 0x01020304 + k, torch.uint32, dev) for k in range(n_words)]
    P.sview(hot[-1])[n // 2] = 7
    for off in range(4):
        for planes in (big, hot):
            w = [p[off:off + n] for p in planes]
            before, plain = th.HISTOGRAM.launches, th.HISTOGRAM.plain_calls
            got = [th.histogram_cuda(w, 4 * n_words)] + [
                th.histogram_cuda(w, nl, l0) for l0, nl in _LEVEL_PAIRS[n_words]]
            assert th.HISTOGRAM.launches == before + len(got)
            assert th.HISTOGRAM.plain_calls == plain
            _same(got, [th.histogram_plain(w, 4 * n_words)] + [
                th.histogram_plain(w, nl, l0) for l0, nl in _LEVEL_PAIRS[n_words]])
    # planes at different offsets from each other: some load word by word
    w = [p[k % 4: k % 4 + n] for k, p in enumerate(big)]
    _same([th.histogram_cuda(w, 4 * n_words)], [th.histogram_plain(w, 4 * n_words)])
    s = [P.narrow(P.widen(big[-1][:n]).sort().values, torch.uint32)]
    res = th.multi_level_histogram(s, 4)
    assert res.sorted_prefix == n and res.level_sorted[3]
    torch.cuda.synchronize()
    for work in th._workspaces.values():  # every launch leaves it zero
        assert int(work.abs().sum()) == 0


@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_histogram_kernel_zipf(dev, n_words):
    """2^22 keys drawn from 2^20 distinct ones at Zipf(1.1) rank
    frequencies (numpy, seeded), and the same keys sorted."""
    rng = np.random.default_rng(n_words)
    pool = rng.integers(0, 2**32, size=(n_words, 1 << 20), dtype=np.uint32)
    rank = np.arange(1, (1 << 20) + 1, dtype=np.float64) ** -1.1
    keys = pool[:, rng.choice(1 << 20, size=1 << 22, p=rank / rank.sum())]
    for w in (keys, keys[:, np.lexsort(keys[::-1])]):
        t = [torch.from_numpy(x.copy()).to(dev) for x in w]
        _same([th.histogram_cuda(t, 4 * n_words)], [th.histogram_plain(t, 4 * n_words)])
        _same([th.histogram_cuda(t[-1:], 1, 2)], [th.histogram_plain(t[-1:], 1, 2)])


def test_histogram_kernel_streams(dev):
    """Launches on the current stream and on a side stream, in turns and
    unsynchronized: each stream has its own workspace, every output equals
    the plain version, and each workspace is zero afterwards."""
    w = _planes(dev, 1 << 20, [torch.uint32] * 2, 11, high=1 << 32)
    want = th.histogram_plain(w, 8)
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(main)
    got = []
    for _ in range(3):
        got.append(th.histogram_cuda(w, 8))
        with torch.cuda.stream(side):
            got.append(th.histogram_cuda(w, 8))
    torch.cuda.synchronize(dev)
    works = [th._workspaces[(dev.index, s.cuda_stream)] for s in (main, side)]
    assert works[0].data_ptr() != works[1].data_ptr()
    _same(got, [want] * len(got))
    for work in works:
        assert int(work.abs().sum()) == 0


def test_histogram_build_has_no_spills(dev):
    """Every histogram.cu instance builds without spills (nvcc -Xptxas -v);
    the registers of each are printed."""
    import re
    import subprocess
    import tempfile

    from rdst_tpu_torch import _build

    src = Path(_build.__file__).resolve().parent / "csrc" / "histogram.cu"
    flags = [f for f in _build._FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "h.o"), str(src)],
                             capture_output=True, text=True, check=True)
    regs = re.findall(r"Used (\d+) registers", res.stderr)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", res.stderr)
    print(f"histogram.cu: {len(regs)} instances, registers {sorted(map(int, regs))}")
    assert len(regs) >= 17 and len(spills) >= len(regs)
    assert all(a == "0" and b == "0" for a, b in spills), res.stderr
    assert _build.library().rdst_histogram_work_bytes() == 8 * th._WORK_WORDS


U8, U16, U32 = torch.uint8, torch.uint16, torch.uint32


def _every_level(block):
    """Levels (l, 2^(l-1)) for l = 1 .. log2(block): every stride of the
    tile, on each side of every layout boundary (registers, lanes, warps,
    the moves through shared memory)."""
    return [(lv, 1 << (lv - 1)) for lv in range(1, block.bit_length())]


@pytest.mark.parametrize(
    "n,block,dtypes,n_keys,levels,unflip",
    [
        (1 << 12, 256, [U32], 1, [(8, 128)], None),
        (1 << 16, 1024, [U32, U32], 2, [(8, 128), (9, 256), (10, 512)], 7),
        (1 << 16, 16384, [U32], 1, [(13, 4096), (14, 8192)], 12),
        (1 << 15, 4096, [U16, U32, U8], 2, [(20, 2048)], None),
        (1 << 15, 2048, [U32] * 8, 3, [(11, 1024)], 10),
        # the headline's trip 1 and sweep at the 2-plane block, 512 tiles
        # for 132 persistent CTAs
        (1 << 23, 1 << 14, [U32] * 2, 2, [(13, 4096), (14, 8192)], 12),
        (1 << 23, 1 << 14, [U32] * 2, 2, [(23, 8192)], None),
        # every stride, one case per template instance (1-5 and 8 planes)
        (1 << 20, 1 << 14, [U32], 1, _every_level(1 << 14), 0),
        (1 << 20, 1 << 14, [U32] * 2, 1, _every_level(1 << 14), 9),
        (1 << 20, 1 << 13, [U32] * 3, 2, _every_level(1 << 13), 5),
        (1 << 20, 1 << 13, [U32] * 4, 3, _every_level(1 << 13), None),
        (1 << 21, 1 << 12, [U32] * 5, 4, _every_level(1 << 12), 13),
        (1 << 20, 1 << 11, [U32] * 8, 3, _every_level(1 << 11), None),
        # the shuffle's finish-sort trip 1 at 5 planes
        (1 << 21, 1 << 12, [U32] * 5, 4, [(12, 2048)], 11),
        # mixed widths at 6 and 7 planes
        (1 << 18, 1 << 12, [U8, U16, U32, U8, U16, U32], 4, _every_level(1 << 12), 6),
        (1 << 16, 1 << 10, [U8] * 3 + [U16] * 2 + [U32] * 2, 7, _every_level(1 << 10), 2),
        # blocks below 32 x ELEMS: 2 elements a thread, down to a part warp
        (1 << 14, 512, [U32, U16], 2, _every_level(512), 4),
        (1 << 10, 64, [U32], 1, _every_level(64), 1),
        (256, 8, [U8, U32], 2, _every_level(8), 0),
    ],
)
def test_tail_kernel(dev, n, block, dtypes, n_keys, levels, unflip):
    pl = _planes(dev, n, dtypes, n + block, high=7)
    before = fs.TAIL.launches
    _same(fs.tail_cuda(pl, n, block, n_keys, levels, unflip),
          fs.tail_plain(pl, n, block, n_keys, levels, unflip))
    assert fs.TAIL.launches == before + 1


@pytest.mark.parametrize(
    "n,s_hi,s_lo,two_r,block,dtypes,n_keys",
    [
        (1 << 16, 1 << 12, 1 << 12, 1 << 13, 1 << 12, [U32] * 2, 2),
        (1 << 16, 1 << 14, 1 << 8, 1 << 16, 1 << 13, [U32] * 2, 1),
        (1 << 17, 1 << 15, 1 << 11, 1 << 18, 1 << 13, [U16, U32, U8], 2),
        (1 << 16, 1 << 12, 1 << 10, 1 << 14, 1 << 11, [U32] * 8, 4),
        # the headline's span trips at the 2-plane block: P = 128 and 2
        (1 << 23, 1 << 22, 1 << 16, 1 << 23, 1 << 14, [U32] * 2, 2),
        (1 << 23, 1 << 13, 1 << 13, 1 << 15, 1 << 14, [U32] * 2, 2),
        # the shuffle's 4- and 5-plane trips, 8 planes, 6 mixed planes
        (1 << 22, 1 << 20, 1 << 16, 1 << 21, 1 << 13, [U32] * 4, 3),
        (1 << 22, 1 << 20, 1 << 15, 1 << 22, 1 << 12, [U32] * 5, 4),
        (1 << 20, 1 << 16, 1 << 11, 1 << 18, 1 << 11, [U32] * 8, 3),
        (1 << 20, 1 << 15, 1 << 12, 1 << 17, 1 << 12, [U8, U32, U16, U32, U32, U8], 3),
        # u8 pieces of 8 bytes: no 16-byte copies
        (1 << 16, 1 << 9, 1 << 3, 1 << 12, 1 << 10, [U8, U32], 1),
    ],
)
def test_span_kernel(dev, n, s_hi, s_lo, two_r, block, dtypes, n_keys):
    pl = _planes(dev, n, dtypes, n + s_hi, high=7)
    before = fs.SPAN.launches
    _same(fs.span_cuda(pl, n, s_hi, s_lo, two_r, block, n_keys),
          fs.span_plain(pl, n, s_hi, s_lo, two_r, block, n_keys))
    assert fs.SPAN.launches == before + 1


def test_bitonic_kernels_unaligned_planes(dev):
    """Planes that start off a 16-byte boundary take the kernels' element
    by element copies; the results are the same."""
    n, block = 1 << 16, 1 << 13
    base = _planes(dev, n + 4, [U32, U32, U16], 5, high=7)
    pl = [p[1:n + 1] for p in base]
    assert pl[0].data_ptr() % 16
    _same(fs.tail_cuda(pl, n, block, 2, [(12, 2048), (13, 4096)], 11),
          fs.tail_plain(pl, n, block, 2, [(12, 2048), (13, 4096)], 11))
    _same(fs.span_cuda(pl, n, 1 << 14, 1 << 10, 1 << 15, block, 2),
          fs.span_plain(pl, n, 1 << 14, 1 << 10, 1 << 15, block, 2))


@pytest.mark.parametrize("stable", [False, True])
def test_fused_sort_default_blocks(dev, stable, monkeypatch):
    """fused_sort's network at the default blocks (2^14 at 3 planes with a
    payload or the index plane) and a length that takes the piece path;
    the radix route, which these rows would take, is shut."""
    monkeypatch.setattr(rs, "takes", lambda *a, **k: False)
    n = (1 << 21) + (1 << 19)
    rng = np.random.default_rng(31 + stable)
    keys = rng.integers(0, 2**32, size=(2, n), dtype=np.uint32)
    keys[0] %= 50
    pay = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    out_k, out_p = fs.fused_sort([torch.from_numpy(k).to(dev) for k in keys],
                                 [torch.from_numpy(pay).to(dev)], stable=stable)
    order = np.lexsort(keys[::-1])
    for i in range(2):
        np.testing.assert_array_equal(out_k[i].cpu().numpy(), keys[i][order])
    if stable:
        np.testing.assert_array_equal(out_p[0].cpu().numpy(), pay[order])
    else:
        got = np.stack([out_k[0].cpu().numpy(), out_k[1].cpu().numpy(),
                        out_p[0].cpu().numpy()])
        want = np.stack([keys[0], keys[1], pay])
        np.testing.assert_array_equal(got[:, np.lexsort(got[::-1])],
                                      want[:, np.lexsort(want[::-1])])


@pytest.mark.parametrize("n,stable", [(1 << 15, False), (1 << 15, True),
                                      (50_000, True), (50_000, False)])
def test_fused_sort_through_kernels(dev, monkeypatch, n, stable):
    monkeypatch.setattr(config, "fused_min_piece", 1 << 11)
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, size=(2, n), dtype=np.uint32)
    keys[0] %= 1000
    pay = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    before = fs.TAIL.launches, fs.SPAN.launches
    monkeypatch.setattr(rs, "takes", lambda *a, **k: False)  # the network
    out_k, out_p = fs.fused_sort(
        [torch.from_numpy(k).to(dev) for k in keys],
        [torch.from_numpy(pay).to(dev)], stable=stable, row=512, block=2048)
    assert fs.TAIL.launches > before[0] and fs.SPAN.launches > before[1]
    order = np.lexsort(keys[::-1])
    for i in range(2):
        np.testing.assert_array_equal(out_k[i].cpu().numpy(), keys[i][order])
    got_p = out_p[0].cpu().numpy()
    if stable:
        np.testing.assert_array_equal(got_p, pay[order])
    else:
        got = sorted(zip(out_k[0].cpu().numpy().tolist(),
                         out_k[1].cpu().numpy().tolist(), got_p.tolist()))
        assert got == sorted(zip(keys[0].tolist(), keys[1].tolist(),
                                 pay.tolist()))


def test_builder_on_cuda_tensors(dev, monkeypatch):
    monkeypatch.setattr(config, "fused_min_elems", 1 << 12)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(100_000)
    x[:4] = [np.nan, -0.0, np.inf, -np.inf]
    v = np.arange(x.size, dtype=np.int32)
    k, (p,) = rt.radix_sort_builder(torch.from_numpy(x).to(dev),
                                    [torch.from_numpy(v).to(dev)]
                                    ).with_stable().sort()
    assert k.device.type == "cuda" and p.device.type == "cuda"
    u = x.view(np.uint64)
    order = np.argsort(np.where(u >> np.uint64(63) == 1, ~u,
                                u | np.uint64(1 << 63)), kind="stable")
    np.testing.assert_array_equal(k.cpu().numpy().view(np.uint64),
                                  x[order].view(np.uint64))
    np.testing.assert_array_equal(p.cpu().numpy(), v[order])


def _u64_arrays(count, n=1 << 22, seed=22):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2**64, size=n, dtype=np.uint64) for _ in range(count)]


def test_numpy_answers_are_page_locked(dev):
    """The keys and the payload of a numpy call on the card come back in
    page-locked host memory."""
    (x,) = _u64_arrays(1)
    v = np.arange(x.size, dtype=np.uint32)
    ys = rt.radix_sort_unstable(x)
    ks, (vs,) = rt.sort_key_value(x, [v], stable=True)
    for a in (ys, ks, vs):
        assert torch.from_numpy(a).is_pinned()
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(ys, x[order])
    np.testing.assert_array_equal(ks, x[order])
    np.testing.assert_array_equal(vs, v[order])


def test_numpy_answers_held_at_once_share_no_memory(dev):
    xs = _u64_arrays(4)
    outs = [rt.radix_sort_unstable(x) for x in xs]
    for i, a in enumerate(outs):
        for b in outs[i + 1:]:
            assert not np.shares_memory(a, b)


def test_numpy_answer_held_across_later_calls_is_unchanged(dev):
    """An answer held while 3 more calls on other arrays copy back (each
    earlier one freed, so their blocks are recycled) still equals np.sort
    of its input."""
    first, *others = _u64_arrays(4)
    held = rt.radix_sort_unstable(first)
    for x in others:
        out = rt.radix_sort_unstable(x)
        np.testing.assert_array_equal(out, np.sort(x))
        del out
    np.testing.assert_array_equal(held, np.sort(first))


def _host_blocks_pinned() -> int:
    """Blocks torch's caching host allocator has pinned in this process so
    far, from its own statistics (which read as empty until torch's CUDA
    state is set up, and pinning alone does not set it up)."""
    torch.cuda.init()
    return torch.cuda.host_memory_stats_as_nested_dict()["num_host_alloc"]


def test_copy_back_into_a_freed_block_counts_as_recycled(dev):
    """A second answer of the same size, after the first is freed, lands in
    the first one's page-locked block: the call pins no new block."""
    a, b = _u64_arrays(2)
    out = rt.radix_sort_unstable(a)
    del out
    pinned = _host_blocks_pinned()
    out = rt.radix_sort_unstable(b)
    assert _host_blocks_pinned() == pinned
    np.testing.assert_array_equal(out, np.sort(b))


@pytest.mark.parametrize(
    "n,s,dtypes,n_keys",
    [
        (1 << 16, 1 << 15, [torch.uint32], 1),
        (1 << 16, 1 << 7, [torch.uint32] * 4, 3),
        (1 << 17, 1 << 12, [torch.uint16, torch.uint32, torch.uint8], 2),
        (1 << 15, 1 << 9, [torch.uint32] * 8, 3),
        (1 << 10, 1, [torch.uint32, torch.uint32], 1),
    ],
)
def test_merge_stage_kernel(dev, n, s, dtypes, n_keys):
    pl = _planes(dev, n, dtypes, n + s, high=7)
    want = fm.merge_stage_plain(pl, n, s, n_keys)
    _same(fm.merge_stage_cuda(pl, n, s, n_keys), want)
    own = [p.clone() for p in pl]
    out = fm.merge_stage_cuda(own, n, s, n_keys, in_place=True)
    assert all(o.data_ptr() == p.data_ptr() for o, p in zip(out, own))
    _same(own, want)


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize(
    "n,block,dtypes,n_keys",
    [
        # B2's block at every plane count (pick_block), 256 tiles or more
        # for 132 persistent CTAs
        (1 << 22, None, [U32], 1),
        (1 << 22, None, [U32, U32], 2),
        (1 << 21, None, [U16, U32, U8], 2),
        (1 << 21, None, [U32] * 4, 3),
        (1 << 20, None, [U32] * 5, 4),
        (1 << 20, None, [U8, U16, U32, U8, U16, U32], 4),
        (1 << 20, None, [U8] * 3 + [U16] * 2 + [U32] * 2, 5),
        (1 << 19, None, [U32] * 8, 3),
        # the old two-CTA blocks, and blocks below 32 x ELEMS
        (1 << 16, 4096, [U32] * 4, 3),
        (1 << 14, 512, [U32, U16], 2),
        (256, 256, [U32], 1),
    ],
)
def test_merge_tail_kernel(dev, n, block, dtypes, n_keys, unaligned):
    """B5 (``rdst_bitonic_tail`` on a direction-less plan) against its plain
    version, out of place and in place; planes that start off a 16-byte
    boundary take the element by element copies."""
    block = block or fm.pick_block(len(dtypes))
    pl = _planes(dev, n + 4, dtypes, n + block, high=7)
    pl = [p[1:n + 1] if unaligned else p[:n] for p in pl]
    assert bool(pl[0].data_ptr() % 16) == unaligned
    want = fm.merge_tail_plain(pl, n, block, n_keys)
    before = fm.MERGE_TAIL.launches, fs.TAIL.launches
    _same(fm.merge_tail_cuda(pl, n, block, n_keys), want)
    own = [p.clone() for p in pl]
    out = fm.merge_tail_cuda(own, n, block, n_keys, in_place=True)
    assert all(o.data_ptr() == p.data_ptr() for o, p in zip(out, own))
    _same(own, want)
    assert (fm.MERGE_TAIL.launches, fs.TAIL.launches) == (before[0] + 2, before[1])


def _ascending_runs(dev, la, lb, dtypes, n_keys, seed, high=7):
    """Two runs on the card, each sorted ascending by its first ``n_keys``
    planes, with few values a key plane so that ties cross the runs."""
    a = P.lex_sort(_planes(dev, la, dtypes, seed, high), n_keys)
    b = P.lex_sort(_planes(dev, lb, dtypes, seed + 1, high), n_keys)
    return a, b


_MIXED = [U16, U32, U8, U32, U16, U32, U8, U32]


@pytest.mark.parametrize("k", range(1, fs.MAX_PLANES + 1))
def test_piece_merge_kernel_at_tile_edges(dev, k):
    """B7 against its plain version at every key-plane count (its own tile,
    ``merge_tile``), on runs that end on, just before and just after tile
    boundaries, one of them empty or far shorter than a tile; mixed widths
    and one rider plane where the planes allow."""
    from rdst_tpu_torch import _build

    tile = fs.merge_tile(k)
    assert _build.library().rdst_piece_merge_tile(k) == tile
    dtypes = _MIXED[:k] + ([U32] if k < fs.MAX_PLANES else [])
    for la, lb in [(tile, tile), (tile - 1, 1), (1, tile), (3 * tile + 1, 2 * tile - 1),
                   (5, 7 * tile + 3), (0, tile + 1), (tile + 1, 0), (1, 1)]:
        a, b = _ascending_runs(dev, la, lb, dtypes, k, la + 3 * lb + k)
        before = fs.PIECE_MERGE.launches, fs.PIECE_MERGE.plain_calls
        got = fs.piece_merge(a, b, k)
        assert fs.PIECE_MERGE.launches == before[0] + 1
        assert fs.PIECE_MERGE.plain_calls == before[1]
        _same(got, fs.piece_merge_plain(a, b, k))


@pytest.mark.parametrize("la,lb,dtypes,n_keys", [
    (8 << 22, 4 << 22, [U32, U32], 2),            # the 50M u64 sort's merge
    (8 << 21, 1 << 21, [U32] * 6, 5),             # a 6-plane shard sort's
    (8 << 21, 1 << 21, [U32, U16, U32, U8, U32, U32], 5),
])
def test_piece_merge_kernel_main_path_shapes(dev, la, lb, dtypes, n_keys):
    """B7 bit-equal to its plain version at the shapes the piece path
    gives it, with runs that start off a 16-byte boundary too."""
    a, b = _ascending_runs(dev, la + 1, lb, dtypes, n_keys, la + n_keys, high=1 << 8)
    _same(fs.piece_merge(a[:la], b, n_keys), fs.piece_merge_plain(a[:la], b, n_keys))
    _same(fs.piece_merge([p[1:] for p in a], b, n_keys),
          fs.piece_merge_plain([p[1:] for p in a], b, n_keys))


def test_piece_merge_build_has_no_spills(dev):
    """Every piece_merge.cu instance (partition and tile kernels at 1-8 key
    planes) builds without spills (nvcc -Xptxas -v)."""
    import re
    import subprocess
    import tempfile

    from rdst_tpu_torch import _build

    src = Path(_build.__file__).resolve().parent / "csrc" / "piece_merge.cu"
    flags = [f for f in _build._FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "m.o"), str(src)],
                             capture_output=True, text=True, check=True)
    regs = re.findall(r"Used (\d+) registers", res.stderr)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", res.stderr)
    print(f"piece_merge.cu: {len(regs)} instances, registers {sorted(map(int, regs))}")
    assert len(regs) >= 16 and len(spills) >= len(regs)
    assert all(x == "0" and y == "0" for x, y in spills), res.stderr


# -- B8: the radix passes ----------------------------------------------------

_U8, _U16, _U32 = torch.uint8, torch.uint16, torch.uint32


def _packed_order(keys):
    """The stable order of rows by key planes of at most 64 bits, from
    torch.sort of the key packed into one int64 (top bit flipped)."""
    v = torch.zeros_like(P.widen(keys[0]))
    for k in keys:
        v = (v << (8 * k.dtype.itemsize)) | P.widen(k)
    if sum(k.dtype.itemsize for k in keys) == 8:
        v = v ^ (-(1 << 63))
    return torch.sort(v, stable=True).indices


def _b8(planes, n_keys, byte, scratch):
    """One B8 launch into fresh planes, on the level's counts from B1."""
    counts = th.histogram_cuda(rs.hist_words(planes[:n_keys]), 1, byte)
    return rs.radix_pass(planes, [torch.empty_like(p) for p in planes], n_keys, byte,
                         counts, scratch)


@pytest.mark.parametrize("n,keys,pay", [
    (50_000_000, (_U32, _U32), None),   # the tensor cell's shape
    (1 << 21, (_U32, _U32), None),
    ((1 << 21) + 1, (_U32, _U32), _U32),
    ((1 << 21) + 1, (_U8, _U16, _U32), _U16),
    (1 << 20, (_U16,), _U8),
    (4097, (_U32,), None),
    (1, (_U32, _U32), _U32),
])
def test_radix_passes_equal_plain_and_sort(dev, n, keys, pay):
    """Each B8 pass bit-equal to its plain version (on the plain version's
    own input, so every pass sees partly sorted rows), the whole sort equal
    to torch.sort's stable order, and the caller's planes unchanged."""
    ks = _planes(dev, n, keys, n)
    ps = _planes(dev, n, (pay,), n + 1) if pay else []
    kept = [t.clone() for t in ks + ps]
    planes = ks + ps
    scratch = rs.pass_scratch(n, dev).fill_(-1)  # one buffer, any contents
    for b in range(sum(k.itemsize for k in keys)):
        _same(_b8(planes, len(ks), b, scratch), rs.radix_pass_plain(planes, len(ks), b))
        planes = rs.radix_pass_plain(planes, len(ks), b)
    del planes
    before = rs.RADIX_PASS.launches
    ok, op = rs.radix_sort(ks, ps)
    assert rs.RADIX_PASS.launches - before == sum(k.itemsize for k in keys)
    order = _packed_order(ks)
    _same(ok + op, [P.take(t, order) for t in ks + ps])
    _same(ks + ps, kept)


def test_radix_ties_across_tiles(dev):
    """Three key values over 2^22 rows: every digit's run crosses many
    tiles, and the look-back carries the counts; stable payload exact."""
    ks = _planes(dev, 1 << 22, (_U32, _U32), 5, high=3)
    ps = [torch.arange(1 << 22, dtype=torch.int32, device=dev).view(_U32)]
    ok, op = rs.radix_sort(ks, ps)
    order = _packed_order(ks)
    _same(ok + op, [P.take(t, order) for t in ks + ps])


def test_radix_build_has_no_spills(dev):
    """Every radix_pass.cu instance (digit plane of 1, 2 and 4 bytes)
    builds without spills (nvcc -Xptxas -v)."""
    import re
    import subprocess
    import tempfile

    from rdst_tpu_torch import _build

    src = Path(_build.__file__).resolve().parent / "csrc" / "radix_pass.cu"
    flags = [f for f in _build._FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "r.o"), str(src)],
                             capture_output=True, text=True, check=True)
    regs = re.findall(r"Used (\d+) registers", res.stderr)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", res.stderr)
    print(f"radix_pass.cu: {len(regs)} instances, registers {sorted(map(int, regs))}")
    assert len(regs) == 3 and len(spills) >= len(regs)
    assert all(x == "0" and y == "0" for x, y in spills), res.stderr


def test_radix_wrapper_refuses_bad_planes(dev):
    n = 1 << 12
    p = _planes(dev, n, (_U32, _U32, _U32), 7)
    counts = th.histogram_cuda(p[:2], 1, 0)
    scratch = rs.pass_scratch(n, dev)

    def launch(src, n_keys, dst=None, sc=scratch):
        dst = [torch.empty_like(t) for t in src] if dst is None else dst
        return rs.radix_pass(src, dst, n_keys, 0, counts, sc)

    before = rs.RADIX_PASS.launches
    with pytest.raises(ValueError):  # CPU planes
        launch([t.cpu() for t in p[:2]], 2)
    with pytest.raises(ValueError):  # lengths differ
        launch([p[0], p[1][:100]], 2)
    with pytest.raises(ValueError):  # two payload planes
        launch(p, 1)
    with pytest.raises(ValueError):  # an output plane on the CPU
        launch(p[:2], 2, dst=[torch.empty_like(p[0]), torch.empty(n, dtype=_U32)])
    with pytest.raises(ValueError):  # scratch too short for the length
        launch(p[:2], 2, sc=scratch[:-1])
    assert rs.RADIX_PASS.launches == before


def test_tensor_call_takes_the_radix_passes(dev):
    """A tensor-cell-shaped call (u64 keys on the card, 2^25 here) under the
    profiler: one ``rdst.fused_sort.radix`` span, B8 launches and no B2/B3
    launch; bit-equal to torch.sort."""
    from torch.autograd import DeviceType

    g = torch.Generator(device=dev)
    g.manual_seed(27)
    x = torch.empty(1 << 25, dtype=torch.int64, device=dev).random_(generator=g)
    x ^= torch.randint(0, 2, x.shape, dtype=torch.int64, device=dev, generator=g) << 63
    keys = x.view(torch.uint64)
    rt.radix_sort_unstable(keys)
    torch.cuda.synchronize()
    before = fs.TAIL.launches, fs.SPAN.launches, rs.RADIX_PASS.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = rt.radix_sort_unstable(keys)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    assert names.count("rdst.fused_sort.radix") == 1
    assert not any(nm.startswith(("rdst.fused_sort.phase0", "rdst.fused_sort.network"))
                   for nm in names)
    assert (fs.TAIL.launches, fs.SPAN.launches) == before[:2]
    assert rs.RADIX_PASS.launches - before[2] == 8
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    assert any("radix_pass_kernel" in k for k in kernels)
    assert not any("tail_kernel" in k or "span_kernel" in k for k in kernels)
    flip = -(1 << 63)
    assert torch.equal(out.view(torch.int64), torch.sort(x ^ flip).values ^ flip)


def _sorted_runs(dev, n_runs, m, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 5000, size=(n_runs, m)).astype(np.uint32), 1)
    pay = rng.standard_normal((n_runs, m)).astype(np.float32)
    return (torch.from_numpy(keys.reshape(-1)).to(dev),
            torch.from_numpy(pay.reshape(-1)).to(dev))


def test_fused_merge_and_merge_level_on_the_card(dev):
    k, v = _sorted_runs(dev, 2, 1 << 16, 1)
    z = [torch.cat([k[: 1 << 16], k[1 << 16:].flip(0)]),
         torch.cat([v[: 1 << 16], v[1 << 16:].flip(0)])]
    before = fm.MERGE_STAGE.launches, fm.MERGE_TAIL.launches
    got = fm.bitonic_merge_fused(z, 1)
    assert fm.MERGE_STAGE.launches > before[0]
    assert fm.MERGE_TAIL.launches > before[1]
    assert got[1].dtype == torch.float32
    cpu = fm.bitonic_merge_fused([p.cpu() for p in z], 1)
    _same([got[0], got[1].view(torch.uint32)],
          [cpu[0].to(dev), cpu[1].view(torch.uint32).to(dev)])
    k, v = _sorted_runs(dev, 16, 1 << 12, 2)
    got = fm.merge_level([k, v], 1 << 12, 1)
    cpu = fm.merge_level([k.cpu(), v.cpu()], 1 << 12, 1)
    _same([got[0], got[1].view(torch.uint32)],
          [cpu[0].to(dev), cpu[1].view(torch.uint32).to(dev)])


def test_chunked_sort_on_the_card(dev, monkeypatch):
    """A Regions pick above the (lowered) memory gate runs chunked_sort:
    chunk sorts on the executor's radix passes (B8: an int64 key and one
    int32 payload), then the B4/B5 merge tree."""
    monkeypatch.setattr(config, "low_mem_threshold_bytes", 1)
    monkeypatch.setattr(config, "fused_min_elems", 1 << 14)
    rng = np.random.default_rng(9)
    n = 300_000
    k = rng.integers(0, 2**63, size=n, dtype=np.int64)
    k[::3] = 42
    v = np.arange(n, dtype=np.int32)
    before = fm.MERGE_STAGE.launches, fm.MERGE_TAIL.launches, rs.RADIX_PASS.launches
    gk, (gv,) = rt.radix_sort_builder(
        torch.from_numpy(k).to(dev), [torch.from_numpy(v).to(dev)]
    ).with_algorithm(rt.Algorithm.REGIONS).with_stable().sort()
    after = fm.MERGE_STAGE.launches, fm.MERGE_TAIL.launches, rs.RADIX_PASS.launches
    assert all(a > b for a, b in zip(after, before))
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), k[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), v[order])


def test_bucketed_on_the_card(dev):
    rng = np.random.default_rng(10)
    n = 1 << 20
    k = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    k[(k >> 24) == 0x55] ^= np.uint32(1 << 24)
    k[: n // 2] = 0x5555AAAA
    rng.shuffle(k)
    v = np.arange(n, dtype=np.uint32)
    gk, (gv,) = rt.radix_sort_builder(
        torch.from_numpy(k).to(dev), [torch.from_numpy(v).to(dev)]
    ).with_algorithm(rt.Algorithm.MT_OOP).with_stable().sort()
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), k[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), v[order])


@pytest.mark.parametrize("algo", list(rt.Algorithm), ids=lambda a: a.value)
def test_every_algorithm_plan_on_the_card(dev, monkeypatch, algo):
    """Every plan of the registry sorts CUDA tensors (Regions with the
    memory gate forced open, so it runs the chunked path)."""
    monkeypatch.setattr(config, "low_mem_threshold_bytes", 1)
    monkeypatch.setattr(config, "fused_min_elems", 1 << 14)
    rng = np.random.default_rng(11)
    k = rng.integers(0, 2**32, size=200_000, dtype=np.uint32)
    k[::5] = 77
    v = np.arange(k.size, dtype=np.uint32)
    gk, (gv,) = rt.radix_sort_builder(
        torch.from_numpy(k).to(dev), [torch.from_numpy(v).to(dev)]
    ).with_algorithm(algo).with_stable().sort()
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), k[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), v[order])


def _exchange_inputs(dev, D, n_local, case, seed, shift=0, k=2):
    """Sender s's k planes start ``shift`` words past s * n_local of one
    allocation, so every source segment has its own residue mod 4."""
    rng = np.random.default_rng(seed)
    sm = rng.integers(0, n_local // D + 1, size=(D, D))
    if case == "edges":
        sm[0, :] = 0
        sm[:, D - 1] = 0
        sm[1 % D, 0] = 1
    if case == "overflow":
        sm[:, 1 % D] = n_local // D  # receiver 1 demands n_local
    offs = np.cumsum(sm, 1) - sm
    planes = _planes(dev, D * n_local + 4, [torch.uint32] * k, seed)
    planes = [[p[shift + s * n_local:shift + (s + 1) * n_local] for p in planes]
              for s in range(D)]
    return (planes, [torch.from_numpy(o).to(dev) for o in offs],
            [torch.from_numpy(z).to(dev) for z in sm], sm)


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("D,case,cap,k", [
    (8, "random", 1 << 14, 2), (8, "edges", 5001, 3), (8, "overflow", 3002, 1),
    (3, "random", 9003, 2), (3, "overflow", 2050, 3), (1, "random", 1 << 14, 2),
    (1, "overflow", 1001, 1),
])
def test_remote_exchange_kernel(dev, D, case, cap, k, shift):
    """B6 against its plain version at every residue mod 4 of the source
    planes and of the receiver buffers (the capacity): buffers bit-equal,
    pads included; every arrival counter min(demand, capacity); the demand
    reported; one launch per call.  On buffers that hold other words, the
    launch alone overwrites every one of them."""
    planes, offs, sizes, sm = _exchange_inputs(dev, D, 1 << 14, case, D + cap,
                                               shift, k)
    before = rd.EXCHANGE.launches
    got, demand, arrived = rd.remote_dma_exchange_cuda(planes, offs, sizes, cap)
    torch.cuda.synchronize()
    assert rd.EXCHANGE.launches == before + 1
    want, wdemand, warrived = rd.remote_dma_exchange_plain(planes, offs, sizes, cap)
    _same(got, want)
    assert torch.equal(demand, wdemand) and torch.equal(arrived, warrived)
    want_arr = np.minimum(sm.sum(0), cap)
    np.testing.assert_array_equal(arrived.cpu().numpy(), np.tile(want_arr, (k, 1)))
    np.testing.assert_array_equal(demand.cpu().numpy(), sm.sum(0))
    so, sz = torch.stack(offs), torch.stack(sizes)
    recv = [torch.full((D * cap,), 0x5A5A5A5A, dtype=torch.int64, device=dev)
            .to(torch.int32).view(torch.uint32) for _ in range(k)]
    arr = torch.zeros((k, D), dtype=torch.int64, device=dev)
    rd.launch_all(planes, so, sz, recv, arr, cap)
    _same(recv, want)
    assert torch.equal(arr, warrived)


@pytest.mark.parametrize("S,R,case,cap", [
    (8, 4, "random", 9001), (8, 1, "overflow", 3001), (2, 4, "edges", 1 << 14),
    (3, 5, "overflow", 2050),
])
def test_remote_exchange_kernel_rectangular(dev, S, R, case, cap):
    """B6 with S senders and R receivers (a mesh over processes: R local
    shards, S shards in the group) against its plain version: buffers
    bit-equal, pads included, arrivals and demand; one launch per call.
    Senders start at every residue mod 4 (a remote sender's block lies
    anywhere in the transport buffer).  Receivers [lo, lo + R) of the
    square exchange of S shards give the same buffers."""
    D, n_local, k = max(S, R), 1 << 14, 2
    _, offs, sizes, sm = _exchange_inputs(dev, D, n_local, case, S * 10 + R)
    lo = D - R
    store = _planes(dev, S * (n_local + 4), [torch.uint32] * k, S + R)
    planes = [[p[s * (n_local + 4) + s % 4:][:n_local] for p in store] for s in range(S)]
    offs = [o[lo:].contiguous() for o in offs[:S]]
    sizes = [z[lo:].contiguous() for z in sizes[:S]]
    before = rd.EXCHANGE.launches
    got, demand, arrived = rd.remote_dma_exchange_cuda(planes, offs, sizes, cap)
    torch.cuda.synchronize()
    assert rd.EXCHANGE.launches == before + 1
    assert got[0].shape == (R * cap,) and arrived.shape == (len(got), R)
    want, wdemand, warrived = rd.remote_dma_exchange_plain(planes, offs, sizes, cap)
    _same(got, want)
    assert torch.equal(demand, wdemand) and torch.equal(arrived, warrived)
    np.testing.assert_array_equal(demand.cpu().numpy(), sm[:S, lo:].sum(0))
    if S == D:
        square, _, _ = rd.remote_dma_exchange_plain(
            planes, [torch.cat([torch.zeros(lo, dtype=torch.int64, device=dev), o])
                     for o in offs],
            [torch.cat([torch.zeros(lo, dtype=torch.int64, device=dev), z])
             for z in sizes], cap)
        _same([x[lo * cap:] for x in square], got)


def test_remote_exchange_after_a_collective(dev, tmp_path):
    """Stream order with NCCL: a sender's block written just before by an
    ``all_to_all_single`` (one rank, on NCCL's own stream) is what B6 reads
    right after it on the current stream; the source was itself written
    just before the collective."""
    import torch.distributed as dist
    tpar.init_distributed(init_method=f"file://{tmp_path}/rendezvous", rank=0,
                          world_size=1)
    try:
        n, cap = 1 << 22, (1 << 22) + 5
        src = torch.empty(n, dtype=torch.int32, device=dev)
        for _ in range(3):
            src.random_()  # written just before the collective
            moved = torch.empty_like(src)
            dist.all_to_all_single(moved, src)
            moved = moved.view(torch.uint32)
            got, demand, _ = rd.remote_dma_exchange_cuda(
                [[moved]], [torch.zeros(1, dtype=torch.int64, device=dev)],
                [torch.full((1,), n, dtype=torch.int64, device=dev)], cap)
            torch.cuda.synchronize()
            assert torch.equal(P.sview(got[0][:n]), src)
            assert int(demand[0]) == n
            assert bool((P.sview(got[0][n:]) == -1).all())
    finally:
        dist.destroy_process_group()


def _u64_on(dev, n, seed, high=None):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**64 if high is None else high, size=n, dtype=np.uint64)
    return x, [torch.from_numpy((x >> np.uint64(32)).astype(np.uint32)).to(dev),
               torch.from_numpy((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)).to(dev)]


@pytest.mark.parametrize("overlap", [False, True])
def test_distributed_sort_on_the_card(dev, monkeypatch, overlap):
    """distributed_sort on make_mesh(4) on the card: through B8 (the fused
    local sorts of a u64 key and one payload) and B6 (every exchange),
    bit-equal to numpy and to the same call on a CPU mesh."""
    monkeypatch.setattr(config, "fused_min_elems", 1 << 14)
    n = 4 * (1 << 15)
    x, words = _u64_on(dev, n, 21, high=1 << 40)
    pay = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    before = rd.EXCHANGE.launches, rs.RADIX_PASS.launches
    w, p, c = tpar.distributed_sort(words, [pay], mesh=tpar.make_mesh(4),
                                    stable=True, overlap_exchange=overlap)
    assert rd.EXCHANGE.launches > before[0] and rs.RADIX_PASS.launches > before[1]
    assert w[0].device.type == "cuda" and c.shape == (4,)
    hi, lo, got_p = tpar.gather_valid(w + p, c)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal((hi.astype(np.uint64) << np.uint64(32)) | lo,
                                  x[order])
    np.testing.assert_array_equal(got_p, order.astype(np.uint32))
    cw, cp, cc = tpar.distributed_sort([t.cpu() for t in words], [pay.cpu()],
                                       mesh=tpar.make_mesh(4, device="cpu"),
                                       stable=True, overlap_exchange=overlap)
    _same([c.cpu().view(torch.int64)], [cc.view(torch.int64)])
    _same([t.cpu() for t in w + p], cw + cp)


def test_copartition_and_hot_key_on_the_card(dev):
    """Unstable single-key rank split and co-partitioning on the card."""
    mesh = tpar.make_mesh(8)
    n = 8 * 4096
    x, words = _u64_on(dev, n, 22)
    x[: n // 2] = 0xDEADBEEF12345678
    words = [torch.from_numpy((x >> np.uint64(32)).astype(np.uint32)).to(dev),
             torch.from_numpy((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)).to(dev)]
    w, _, c = tpar.distributed_sort(words, mesh=mesh, capacity_factor=1.05)
    assert int(c.max()) <= int(1.05 * n / 8)
    hi, lo = tpar.gather_valid(w, c)
    np.testing.assert_array_equal((hi.astype(np.uint64) << np.uint64(32)) | lo,
                                  np.sort(x))
    _, _, c, part = tpar.distributed_sort(
        words, mesh=mesh, capacity_factor=3.0, split_uniform=False,
        return_partition=True)
    rng = np.random.default_rng(23)
    q = np.concatenate([x[rng.integers(0, n, n // 2)], x[: n // 2] + np.uint64(1)])
    qw = [torch.from_numpy((q >> np.uint64(32)).astype(np.uint32)).to(dev),
          torch.from_numpy((q & np.uint64(0xFFFFFFFF)).astype(np.uint32)).to(dev)]
    rw, _, rc = tpar.partition_exchange(qw, [], part, mesh=mesh, capacity_factor=3.0)
    cw, _, cc = tpar.partition_exchange([t.cpu() for t in qw], [], part,
                                        mesh=tpar.make_mesh(8, device="cpu"),
                                        capacity_factor=3.0)
    np.testing.assert_array_equal(rc.cpu().numpy(), cc.numpy())
    _same([t.cpu() for t in rw], cw)


def _cat(p):
    return torch.cat([P.sview(b) for b in p]).view(p[0].dtype) if isinstance(p, list) else p


@pytest.mark.parametrize("K,overlap", [(2, False), (4, False), (4, True), (8, True)])
def test_cards_mesh_on_one_card(dev, monkeypatch, K, overlap):
    """make_mesh(8, devices=[dev] * K): K streams on the one card.  The
    shuffle (fused local and finish sorts, B4/B5 when overlapped) is
    bit-equal to the one-entry mesh, each output plane K blocks on the
    card, and B6 launches once per receiving card of an exchange."""
    monkeypatch.setattr(config, "fused_min_elems", 1 << 12)
    n = 8 * (1 << 14)
    x, words = _u64_on(dev, n, 31, high=1 << 40)
    pay = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    kw = dict(stable=True, overlap_exchange=overlap)
    ref = tpar.distributed_sort(words, [pay], mesh=tpar.make_mesh(8), **kw)
    before = rd.EXCHANGE.launches
    got = tpar.distributed_sort(words, [pay], mesh=tpar.make_mesh(8, devices=[dev] * K),
                                **kw)
    torch.cuda.synchronize()
    assert rd.EXCHANGE.launches - before == K * (2 if overlap else 1)
    for a, b in zip(ref[0] + ref[1], got[0] + got[1]):
        assert len(b) == K and all(x.device == dev for x in b)
        _same([_cat(b)], [a])
    assert torch.equal(ref[2], got[2])
    hi, lo, p = tpar.gather_valid(got[0] + got[1], got[2])
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal((hi.astype(np.uint64) << np.uint64(32)) | lo, x[order])


@pytest.mark.parametrize("K", [2, 4, 8])
def test_cards_mesh_2d_and_tables_on_one_card(dev, K):
    """make_mesh_2d(2, 4, devices=[dev] * K) and the four table operators
    on make_mesh(8, devices=[dev] * K): bit-equal to one entry, one Table
    a card."""
    from rdst_tpu_torch.table import Table

    n = 8 * 4096
    x, words = _u64_on(dev, n, 32, high=1 << 20)
    m1, mk = tpar.make_mesh_2d(2, 4), tpar.make_mesh_2d(2, 4, devices=[dev] * K)
    ref = tpar.distributed_sort(words, mesh=m1, axis=m1.axis_names, stable=True)
    got = tpar.distributed_sort(words, mesh=mk, axis=mk.axis_names, stable=True)
    for a, b in zip(ref[0], got[0]):
        _same([_cat(b)], [a])
    assert torch.equal(ref[2], got[2])
    rng = np.random.default_rng(33)
    t = Table({"k": torch.from_numpy(rng.integers(0, 500, n).astype(np.int32)).to(dev),
               "v": torch.from_numpy(rng.integers(0, 9, n).astype(np.int64)).to(dev)})
    d = Table({"k": torch.arange(512, dtype=torch.int32, device=dev).repeat(16),
               "w": torch.arange(8192, dtype=torch.int64, device=dev)})
    one, many = tpar.make_mesh(8), tpar.make_mesh(8, devices=[dev] * K)
    for fn in (lambda m: tpar.distributed_sort_table(t, "k", mesh=m),
               lambda m: tpar.distributed_filter(t, t["v"] > 3, mesh=m),
               lambda m: tpar.distributed_group_aggregate(
                   t, "k", {"s": ("v", "sum"), "m": ("v", "max")}, mesh=m),
               lambda m: tpar.distributed_join(t, d, "k", mesh=m, partition="hash",
                                               join_capacity_factor=24.0)):
        (rt_, rn), (gt, gn) = fn(one), fn(many)
        assert len(gt) == K and all(x.device == dev for x in gt)
        for c in rt_.column_names:
            assert torch.equal(P.sview(torch.cat([g[c] for g in gt])), P.sview(rt_[c])), c
        assert (torch.equal(rn, gn) if isinstance(rn, torch.Tensor) else rn == gn)


@pytest.mark.parametrize("drain", [True, False])
def test_cards_exchange_drains_before_senders_reuse(dev, monkeypatch, drain):
    """Two senders on card 0 of a 4-entry mesh, four receivers on cards 1-3
    whose launches wait behind a spin on their streams; card 0 overwrites
    its planes right after the call.  With the drain (every sending card's
    stream waits on every receiving card's completion) the receive buffers
    equal the plain version's; without it (patched out) card 0's overwrite
    lands first and the receivers read it: the test sees a missing wait.
    The call enqueues without a host wait (sync debug mode "error"), which
    is also what lets the overwrite overtake the receivers."""
    mesh = tpar.make_mesh(4, devices=[dev] * 4)
    S, R, n, cap = 2, 4, 1 << 20, 1 << 19
    planes = [_planes(dev, n, [torch.uint32] * 2, 40 + s) for s in range(S)]
    sizes = [torch.full((R,), n // R, dtype=torch.int64, device=dev) for _ in range(S)]
    offs = [torch.arange(R, device=dev) * (n // R) for _ in range(S)]
    recv_cards = [1, 1, 2, 3]
    want = rd.remote_dma_exchange_cards_plain(planes, offs, sizes, cap, recv_cards,
                                              mesh.devices)
    if not drain:
        monkeypatch.setattr(rd, "_drain", lambda *a: None)
    with mesh.call():
        for c in (1, 2, 3):
            with mesh.on(c):
                torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = rd.remote_dma_exchange_cards(planes, offs, sizes, cap, [0, 0],
                                               recv_cards, mesh.devices, mesh.streams)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for ps in planes:
            for p in ps:
                P.sview(p).fill_(0)  # on card 0's stream, the mesh's current
    torch.cuda.synchronize()
    same = all(torch.equal(P.sview(a), P.sview(b))
               for (gr, _, _), (wr, _, _) in zip(got, want) for a, b in zip(gr, wr))
    assert same == drain


def test_cards_peer_access_between_cards(dev):
    """Where the machine has two cards: each pair maps (or raises
    RuntimeError, never a staged copy), and a 2-card flat shuffle is
    bit-equal to the one-card one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    if not torch.cuda.can_device_access_peer(a, b):
        with pytest.raises(RuntimeError):
            rd.enable_peer(a, b)
        return
    rd.enable_peer(a, b)
    n = 8 * 4096
    _, words = _u64_on(dev, n, 34)
    ref = tpar.distributed_sort(words, mesh=tpar.make_mesh(8), stable=True)
    got = tpar.distributed_sort(words, mesh=tpar.make_mesh(8, devices=[a, b]), stable=True)
    for x, y in zip(ref[0], got[0]):
        assert [t.device for t in y] == [a, b]
        _same([torch.cat([t.cpu() for t in y])], [x.cpu()])


def test_kernel_wrappers_raise_on_bad_input(dev):
    p = _planes(dev, 1 << 13, [torch.uint32], 1)
    with pytest.raises(ValueError):
        fs.tail_cuda(p, 1 << 13, 1000, 1, [(8, 128)], None)  # block not pow2
    with pytest.raises(ValueError):
        fs.tail_cuda(p * 8, 1 << 13, 1 << 13, 1, [(8, 128)], None)  # smem
    with pytest.raises(TypeError):
        th.histogram_cuda([P.widen(p[0])], 1)  # int64 is not a u32 plane
    with pytest.raises(ValueError):
        fm.merge_stage_cuda(p, 1 << 13, 1 << 13, 1)  # stride too large
    with pytest.raises(ValueError):
        fm.merge_tail_cuda(p * 8, 1 << 13, 1 << 13, 1)  # smem
    with pytest.raises(ValueError):  # 4 planes: B2's block is 2^13
        fm.merge_tail_cuda(_planes(dev, 1 << 14, [torch.uint32] * 4, 2),
                           1 << 14, 1 << 14, 1)
    sizes = [torch.zeros(2, dtype=torch.int64, device=dev)] * 2
    with pytest.raises(TypeError):  # B6 carries u32 planes only
        rd.remote_dma_exchange_cuda([[P.widen(p[0])]] * 2, sizes, sizes, 16)
    with pytest.raises(ValueError):  # B7 merges unsigned planes only
        fs.piece_merge_cuda([P.widen(p[0])], [P.widen(p[0])], 1)


# ---------------------------------------------------------------------------
# jit_api, the table engine and the distributed table pipeline
# ---------------------------------------------------------------------------


class _NoSync:
    """Raise on any synchronising CUDA call inside the block."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)


def _plain_calls():
    from rdst_tpu_torch import _build

    return {k: v.plain_calls for k, v in _build.KERNELS.items()}


def test_every_host_sync_of_the_sort_call_is_named(dev):
    """No host sync of a 2^25 u64 tensor call goes unnamed: under sync
    debug mode "warn" it raises as many sync warnings as it records
    ``rdst.sync.*`` spans (the histogram's readback), and it sorts
    bit-equal to torch.sort."""
    import warnings

    g = torch.Generator(device=dev)
    g.manual_seed(25)
    x = torch.empty(1 << 25, dtype=torch.int64, device=dev).random_(generator=g)
    x ^= torch.randint(0, 2, x.shape, dtype=torch.int64, device=dev, generator=g) << 63
    keys = x.view(torch.uint64)
    rt.radix_sort_unstable(keys)  # kernels loaded, workspaces made
    torch.cuda.synchronize()
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.profiler.profile(activities=cpu) as prof:
                out = rt.radix_sort_unstable(keys)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    named = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("rdst.sync.")]
    assert named == ["rdst.sync.histogram"]
    assert len(syncs) == len(named), syncs
    flip = -(1 << 63)
    assert torch.equal(out.view(torch.int64), torch.sort(x ^ flip).values ^ flip)


@pytest.mark.parametrize("n", [1 << 10, 1 << 22])
def test_jit_api_sort_has_no_host_sync(dev, n):
    """``jit_api.sort`` and ``argsort`` on CUDA tensors under sync debug
    mode "error": ``lex_sort`` at 2^10, the fused executor at 2^22 (the
    sort's u64 key and one payload on B8, the stable argsort's 12-byte
    composite key on B2/B3); bit-equal to torch.sort."""
    from rdst_tpu_torch import jit_api

    g = torch.Generator(device=dev)
    g.manual_seed(n)
    x = torch.empty(n, dtype=torch.int64, device=dev).random_(generator=g)
    v = torch.arange(n, dtype=torch.int32, device=dev)
    before = fs.TAIL.launches, fs.SPAN.launches, rs.RADIX_PASS.launches
    torch.cuda.synchronize()
    with _NoSync():
        ks, (vs,) = jit_api.sort(x.view(torch.uint64), payloads=[v], stable=True)
        idx = jit_api.argsort(x)
    torch.cuda.synchronize()
    fused = (fs.TAIL.launches > before[0] and fs.SPAN.launches > before[1]
             and rs.RADIX_PASS.launches > before[2])
    assert fused == (n >= config.fused_min_elems)
    ref, order = torch.sort(x ^ (-(1 << 63)), stable=True)
    assert torch.equal(ks.view(torch.int64), ref ^ (-(1 << 63)))
    assert torch.equal(vs, order.to(torch.int32))
    assert torch.equal(idx.view(torch.int32).to(torch.int64),
                       torch.sort(x, stable=True).indices)


def test_jit_api_gradient_on_the_card(dev):
    from rdst_tpu_torch import jit_api

    rng = np.random.default_rng(40)
    k = torch.from_numpy(rng.integers(0, 100, 1 << 22).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.standard_normal(1 << 22).astype(np.float32)).to(dev)
    v.requires_grad_()
    _, (vs,) = jit_api.sort(k, payloads=[v])
    _, (plain,) = jit_api.sort(k, payloads=[v.detach()])
    assert torch.equal(vs.detach(), plain)
    (grad,) = torch.autograd.grad((vs * vs).sum(), [v])
    assert torch.equal(grad, 2 * v.detach())


def _table(dev, n, seed, n_keys):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return {
        "k": torch.randint(0, n_keys, (n,), generator=g, device=dev) * 97,
        "q": torch.randint(1, 51, (n,), generator=g, device=dev, dtype=torch.int32),
        "p": torch.randint(0, 1 << 40, (n,), generator=g, device=dev),
    }


@pytest.mark.parametrize("partition", ["hash", "range"])
def test_distributed_group_aggregate_on_the_card(dev, monkeypatch, partition):
    """2^20 rows on make_mesh(8) on the card: one B6 launch, B2/B3 in the
    shuffle's sorts (``fused_min_elems`` lowered to the 2^17-row shards),
    no plain version on a CUDA tensor; bit-equal to a torch.unique
    oracle."""
    from rdst_tpu_torch.table import Table

    monkeypatch.setattr(config, "fused_min_elems", 1 << 14)

    cols = _table(dev, 1 << 20, 41, 1 << 17)
    aggs = {"s": ("q", "sum"), "n": ("q", "count"), "m": ("q", "mean"),
            "mx": ("p", "max"), "mn": ("p", "min")}
    plain = _plain_calls()
    before = rd.EXCHANGE.launches, fs.TAIL.launches, fs.SPAN.launches
    out, n_groups = tpar.distributed_group_aggregate(
        Table(cols), "k", aggs, mesh=tpar.make_mesh(8), partition=partition)
    assert rd.EXCHANGE.launches == before[0] + 1
    assert fs.TAIL.launches > before[1] and fs.SPAN.launches > before[2]
    assert _plain_calls() == plain
    keys, inv, cnt = torch.unique(cols["k"], sorted=True, return_inverse=True,
                                  return_counts=True)
    s = torch.zeros_like(keys).index_add_(0, inv, cols["q"].to(torch.int64))
    mx = torch.zeros_like(keys).scatter_reduce_(0, inv, cols["p"], "amax",
                                                include_self=False)
    mn = torch.zeros_like(keys).scatter_reduce_(0, inv, cols["p"], "amin",
                                                include_self=False)
    order = torch.sort(out["k"]).indices
    assert int(n_groups) == keys.numel()
    assert torch.equal(out["k"][order], keys)
    assert torch.equal(out["s"][order], s)
    assert torch.equal(out["n"][order], cnt.to(torch.int32))
    assert torch.equal(out["m"][order], s.to(torch.float32) / cnt.to(torch.float32))
    assert torch.equal(out["mx"][order], mx) and torch.equal(out["mn"][order], mn)


@pytest.mark.parametrize("partition", ["hash", "range"])
def test_distributed_join_on_the_card(dev, partition):
    """A pk-fk join of 2^20 fact rows and 2^18 dimension rows on
    make_mesh(8) on the card: one B6 launch per exchange (two), no plain
    version on a CUDA tensor; bit-equal to a torch.searchsorted oracle."""
    from rdst_tpu_torch.table import Table

    fact = _table(dev, 1 << 20, 42, 1 << 18)
    g = torch.Generator(device=dev)
    g.manual_seed(43)
    dim = {"k": torch.randperm(1 << 18, generator=g, device=dev) * 97,
           "d": torch.randint(0, 1 << 30, (1 << 18,), generator=g, device=dev,
                              dtype=torch.int32)}
    plain = _plain_calls()
    before = rd.EXCHANGE.launches
    out, matches = tpar.distributed_join(Table(fact), Table(dim), "k",
                                         mesh=tpar.make_mesh(8),
                                         partition=partition)
    assert rd.EXCHANGE.launches == before + 2
    assert _plain_calls() == plain
    assert matches == out.n_rows == 1 << 20
    dk, di = torch.sort(dim["k"])
    want_d = dim["d"][di][torch.searchsorted(dk, fact["k"])]

    def rows(t, d):  # rows in one order: by (k, p, q)
        idx = torch.argsort(t["q"], stable=True)
        for c in ("p", "k"):
            idx = idx[torch.argsort(t[c][idx], stable=True)]
        return [t[c][idx] for c in ("k", "q", "p")] + [d[idx]]

    got = rows({c: out[c] for c in ("k", "q", "p")}, out["d"])
    for a, b in zip(got, rows(fact, want_d)):
        assert torch.equal(a, b)


def test_table_ops_on_the_card(dev):
    """The single-card operators on CUDA tensors equal the same calls on
    the CPU, and launch no kernel."""
    from rdst_tpu_torch import _build
    from rdst_tpu_torch.table import Table

    cols = _table(dev, 1 << 18, 44, 1 << 12)
    dim = {"k": torch.arange(1 << 12, device=dev) * 97,
           "d": torch.arange(1 << 12, device=dev, dtype=torch.int32)}
    t, d = Table(cols), Table(dim)
    tc, dc = (Table({k: v.cpu() for k, v in x.items()}) for x in (cols, dim))
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    aggs = {"s": ("q", "sum"), "mx": ("p", "max"), "m": ("q", "mean")}
    pairs = [
        (t.sort_by(["k", "p"]), tc.sort_by(["k", "p"])),
        (t.filter(cols["q"] > 25)[0], tc.filter(cols["q"].cpu() > 25)[0]),
        (t.group_aggregate("k", aggs)[0], tc.group_aggregate("k", aggs)[0]),
        (t.join(d, "k")[0], tc.join(dc, "k")[0]),
        (t.join(d, "k", how="left")[0], tc.join(dc, "k", how="left")[0]),
    ]
    assert {k: v.launches for k, v in _build.KERNELS.items()} == launches
    for a, b in pairs:
        assert a.column_names == b.column_names and a.n_rows == b.n_rows
        for c in a.column_names:
            assert a[c].device.type == "cuda"
            assert torch.equal(a[c].cpu(), b[c])


def test_tpch_queries_on_the_card(dev, monkeypatch):
    """TPC-H Q1 and Q18 (``table.tpch``) at SF 1, chunk 1 of 4 (375,000
    orders, ~1.5M lines) on make_mesh(8) on the card, B2/B3 and the piece
    merge B7 in Q18's aggregate (``fused_min_elems`` and ``fused_min_piece``
    lowered to its shards and their pieces) and lex_sort in Q1's: no plain
    version on a CUDA tensor, and equal to the plain reference of
    ``tests/tpch_plain.py`` on the card."""
    import tpch_plain as tp
    from rdst_tpu_torch.table import Table, tpch

    monkeypatch.setattr(config, "fused_min_elems", 1 << 14)
    monkeypatch.setattr(config, "fused_min_piece", 1 << 13)
    li, od, cu = tp.generate(1, 1, 4, 2**31 + 41, dev)
    tables = [Table(d) for d in (li, od, cu)]
    mesh = tpar.make_mesh(8, device=dev)
    plain = _plain_calls()
    before = fs.TAIL.launches, rd.EXCHANGE.launches, fs.PIECE_MERGE.launches
    for delta, quantity in ((60, 250), (120, 300)):
        got = tpch.q1(tables[0], delta_days=delta, mesh=mesh)
        want = tp.q1_plain(li, delta)
        for c in tp.Q1_COLUMNS:
            assert got[c].dtype == want[c].dtype and torch.equal(got[c], want[c]), c
        got = tpch.q18(*tables, quantity=quantity, mesh=mesh)
        want = tp.q18_plain(li, od, cu, quantity)
        assert got.n_rows == want["o_orderkey"].numel() > 0
        for c in tp.Q18_COLUMNS:
            assert torch.equal(got[c], want[c]), c
    assert fs.TAIL.launches > before[0] and rd.EXCHANGE.launches > before[1]
    assert fs.PIECE_MERGE.launches > before[2]
    assert _plain_calls() == plain
