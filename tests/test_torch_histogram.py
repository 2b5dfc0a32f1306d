"""Kernel B1's plain version against ``rdst_tpu.ops.histogram``.

The JAX side runs its Pallas kernel in interpret mode (forced, as
tests/test_pallas_sort.py does); the port runs ``histogram_plain`` because
its tensors lie on the CPU.  Counts, per-level sortedness and the sorted
prefix are integers and booleans: every comparison is exact.

``_kernel_model`` runs the decomposition of ``csrc/histogram.cu`` block by
block on the CPU (head peel, 4-key groups, lane predecessors,
sub-histograms, per-block adds and the last block's copy), so its index
arithmetic is checked here before the card.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdst_tpu.ops.histogram as jh
from rdst_tpu_torch.ops import histogram as th

torch.set_num_threads(1)

N = 3001  # a multiple of no tile


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setenv("RDST_TPU_FORCE_INTERPRET", "1")


def _words(kind: str, n_words: int, rng) -> np.ndarray:
    w = rng.integers(0, 2**32, size=(n_words, N), dtype=np.uint32)
    w[0] %= 5  # ties in the top word: the lower words decide
    if kind in ("presorted", "reversed"):
        w = w[:, np.lexsort(w[::-1])]
        if kind == "reversed":
            w = w[:, ::-1].copy()
    elif kind == "equal":
        w[:] = w[:, :1]
    elif kind == "prefix":
        head = w[:, : N // 2]
        w[:, : N // 2] = head[:, np.lexsort(head[::-1])]
    return w


@pytest.mark.parametrize("n_words", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["random", "presorted", "reversed", "equal",
                                  "prefix"])
def test_multi_level_histogram_matches_jax(kind, n_words):
    rng = np.random.default_rng(n_words * 10 + len(kind))
    w = _words(kind, n_words, rng)
    n_bytes = 4 * n_words - (1 if n_words == 2 else 0)
    want = jh.multi_level_histogram([jnp.asarray(x) for x in w], n_bytes)
    before = th.HISTOGRAM.plain_calls
    got = th.multi_level_histogram([torch.from_numpy(x) for x in w], n_bytes)
    assert th.HISTOGRAM.plain_calls == before + 1
    assert th.HISTOGRAM.launches == 0
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.level_sorted, want.level_sorted)
    assert got.sorted_prefix == want.sorted_prefix
    assert got.n == N
    np.testing.assert_array_equal(got.constant_levels(), want.constant_levels())
    assert got.fully_sorted() == want.fully_sorted()


@pytest.mark.parametrize("level", [0, 3, 5, 7])
def test_level_histogram_matches_jax(level):
    rng = np.random.default_rng(level)
    w = rng.integers(0, 2**32, size=(2, N), dtype=np.uint32)
    w[1] &= 0x00FF0F0F  # a few skewed levels
    want = np.asarray(jh.level_histogram([jnp.asarray(x) for x in w], level))
    got = th.level_histogram([torch.from_numpy(x) for x in w], level)
    assert got.shape == (th.RADIX,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 129])
def test_tiny_inputs(n):
    w = np.arange(n, dtype=np.uint32)[::-1].copy()
    got = th.multi_level_histogram([torch.from_numpy(w)], 4)
    assert got.n == n
    assert got.sorted_prefix == (n if n == 1 else 1)
    assert got.level_sorted[0] == (n == 1)


def test_buffer_layout_and_argument_checks():
    w = [torch.zeros(10, dtype=torch.uint32)]
    buf = th.histogram_plain(w, 2)
    assert buf.dtype == torch.int64 and buf.shape == (2 * th.RADIX + 2 + 1,)
    assert buf[0] == 10 and buf[th.RADIX] == 10 and buf[-1] == 10
    with pytest.raises(ValueError):
        th.histogram_plain(w, 5)  # levels beyond the key words
    with pytest.raises(ValueError):
        th.histogram_plain(w * 9, 36)  # keys wider than 32 bytes
    with pytest.raises(ValueError):
        th.histogram_cuda(w, 1)  # the kernel takes CUDA tensors only


def _cu_const(name: str) -> int:
    """A ``constexpr int`` of csrc/histogram.cu (``N`` or ``N * M``), so
    the model sizes its blocks as the kernel does."""
    src = (Path(th.__file__).resolve().parent.parent / "csrc" / "histogram.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", src)
    return int(m[1]) * int(m[2] or 1)


# for keys of 1-4 words; wider keys take half of each
_SMEM = _cu_const("kSmemBudget")
_THREADS = _cu_const("kBlockThreads")
_UNROLL = _cu_const("kGroupUnroll")  # for keys of 1-2 words


def _mode(nw, level0, n_levels):
    if level0 == 0 and n_levels == 4 * nw:
        return "all"
    return "one" if nw == 1 and n_levels == 1 else "some"


def _parts(nw, mode):
    """Cfg::kParts: sub-histograms that fit the shared budget, 1..32."""
    rows = 1 if mode == "one" else 4 * nw
    smem = _SMEM if nw <= 4 else _SMEM // 2
    fit = min(32, max(1, smem // (rows * th.RADIX * 4)))
    return 1 << (fit.bit_length() - 1)


def _lex_gt(a, b):
    """Rows of a (predecessors) > rows of b, most significant word first."""
    diff = a != b
    at = np.argmax(diff, axis=1)
    r = np.arange(a.shape[0])
    return diff.any(axis=1) & (a[r, at] > b[r, at])


def _kernel_model(mem, offs, n, n_levels, level0=0, grid=3, warps=None,
                  parts=None, unroll=None):
    """csrc/histogram.cu block by block.  ``mem[k]`` is a 16-byte-aligned
    buffer in which plane k starts at word ``offs[k]``.  Block 0 takes the
    head (keys before plane 0's 16-byte boundary) and the ragged tail one
    key per thread; warp w takes chunks w, w + W, ... of 32 * U four-key
    groups, lane t of step u the group chunk * 32 * U + u * 32 + t, its first
    predecessor from lane t - 1 (lane 0: a scalar load at step 0, lane 31 of
    the step before after that).  Each key adds 1 per level into part
    lane % P.  Each block adds its summed parts to the workspace; the last
    one writes the output.  A thread looks for a lexicographic descent only
    until it has found one; the head and tail keys go straight into the
    block's minimum.  Returns the int64 buffer."""
    nw = len(mem)
    mode = _mode(nw, level0, n_levels)
    P = parts or _parts(nw, mode)
    U = unroll or (_UNROLL if nw <= 2 else 1)
    warps = warps or (_THREADS if nw <= 4 else _THREADS // 2) // 32
    planes = np.stack([m[o:o + n].astype(np.int64) for m, o in zip(mem, offs)], 1)
    head = min(n, (4 - offs[0] % 4) % 4)
    groups = (n - head) // 4
    body_end = head + 4 * groups
    vec = [(o + head) % 4 == 0 for o in offs]
    assert vec[0] or groups == 0  # the head brings plane 0 to 16 bytes
    if mode == "one":
        counted = [(0, level0, 0)]  # (word, byte, row)
    else:
        counted = [(k, b, 4 * (nw - 1 - k) + b - level0)
                   for k in range(nw) for b in range(4)]
        counted = [(k, b, l) for k, b, l in counted if 0 <= l < n_levels]
    work = np.zeros(n_levels * th.RADIX, np.int64)
    work_desc = np.zeros(n_levels, bool)
    work_first = n
    for blk in range(grid):
        hist = np.zeros((n_levels, th.RADIX, P), np.int64)
        desc = np.zeros(n_levels, bool)
        first = n  # the block's minimum
        tfirst = {}  # (warp, lane) -> that thread's first descent
        if blk == 0:  # head and tail, thread t on key i
            for t in range(head + n - body_end):
                i = t if t < head else body_end + t - head
                cur = planes[i]
                prev = planes[i - 1] if i > 0 else cur
                for k, b, l in counted:
                    dc, dp = (cur[k] >> 8 * b) & 0xFF, (prev[k] >> 8 * b) & 0xFF
                    desc[l] |= dp > dc
                    hist[l, dc, t % 32 % P] += 1
                if _lex_gt(prev[None], cur[None])[0]:
                    first = min(first, i)
        for w in range(blk * warps, (blk + 1) * warps):
            for chunk in range(w, -(-groups // (32 * U)), grid * warps):
                g0 = chunk * 32 * U
                cur = np.zeros((U, 32, nw, 4), np.int64)
                for u in range(U):
                    for lane in range(32):
                        g = g0 + u * 32 + lane
                        if g >= groups:
                            continue
                        for k in range(nw):
                            a = offs[k] + head + 4 * g
                            assert not vec[k] or a % 4 == 0  # 16-byte loads
                            cur[u, lane, k] = mem[k][a:a + 4]
                i_first = head + 4 * g0
                carry = planes[i_first - 1] if i_first > 0 else np.zeros(nw, np.int64)
                for u in range(U):
                    g = g0 + u * 32 + np.arange(32)
                    valid = g < groups
                    i0 = head + 4 * g
                    pred = np.empty((32, nw), np.int64)
                    pred[1:] = cur[u, :31, :, 3]
                    pred[0] = carry if i0[0] > 0 else cur[u, 0, :, 0]
                    carry = cur[u, 31, :, 3]
                    v = valid.nonzero()[0]
                    assert (planes[i0[v] - 1][i0[v] > 0] == pred[v][i0[v] > 0]).all()
                    seq = np.concatenate([pred[:, :, None], cur[u]], axis=2)[v]
                    gt = np.stack([_lex_gt(seq[:, :, j], seq[:, :, j + 1])
                                   for j in range(4)], 1)
                    for t, lane in enumerate(v):
                        if tfirst.get((w, lane), n) == n and gt[t].any():
                            tfirst[w, lane] = int(i0[lane]) + int(np.argmax(gt[t]))
                    for k, b, l in counted:
                        d = (seq[:, k] >> 8 * b) & 0xFF  # pred, keys 0-3
                        desc[l] |= bool((d[:, :-1] > d[:, 1:]).any())
                        np.add.at(hist[l], (d[:, 1:], (v % P)[:, None]), 1)
        first = min([first] + list(tfirst.values()))
        assert hist.max(initial=0) < 2**32
        work += hist.sum(axis=2).reshape(-1)
        work_desc |= desc
        work_first = min(work_first, first)
    return np.concatenate([work, (~work_desc).astype(np.int64), [work_first]])


def _keys(kind, nw, n, rng):
    """(nw, n) u32 planes, most significant first."""
    if kind == "zipf":  # 2^20 distinct keys at Zipf(1.1) rank frequencies
        pool = np.unique(rng.integers(0, 2**64, size=(1 << 20) + 4096, dtype=np.uint64))
        pool = rng.permutation(pool)[: 1 << 20]
        top = np.stack([(pool >> np.uint64(32)).astype(np.uint32),
                        pool.astype(np.uint32)])
        if nw == 1:
            top = np.unique(top[1])[None]
        rank = np.arange(1, top.shape[1] + 1, dtype=np.float64)
        p = rank ** -1.1
        pick = rng.choice(top.shape[1], size=n, p=p / p.sum())
        rest = rng.integers(0, 2**32, size=(max(0, nw - 2), top.shape[1]), dtype=np.uint32)
        return np.concatenate([top[:nw], rest])[:, pick]
    w = rng.integers(0, 2**32, size=(nw, n), dtype=np.uint32)
    w[0] %= 5  # ties in the top word: the lower words decide
    if kind in ("presorted", "reversed"):
        w = w[:, np.lexsort(w[::-1])]
        if kind == "reversed":
            w = w[:, ::-1].copy()
    elif kind == "equal":
        w[:] = w[:, :1]
    elif kind == "prefix":
        head = w[:, : n // 2]
        w[:, : n // 2] = head[:, np.lexsort(head[::-1])]
    return w


def _placed(w, offs, rng):
    """Each plane copied into a fresh buffer at word ``offs[k]``."""
    mem = []
    for k, o in enumerate(offs):
        m = rng.integers(0, 2**32, size=o + w.shape[1] + 8, dtype=np.uint32)
        m[o:o + w.shape[1]] = w[k]
        mem.append(m)
    return mem


def _plain(w, n_levels, level0=0):
    return th.histogram_plain([torch.from_numpy(x.copy()) for x in w],
                              n_levels, level0).numpy()


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("nw", [1, 2, 3, 8])
def test_kernel_model_offsets_and_residues(nw, off):
    """Every head length (plane 0 at word offsets 0-3), n at every residue
    mod 4 from 0 to 33 and beyond, grids of 1, 3 and 7 blocks; the other
    planes at their own offsets, so some load their words one by one."""
    rng = np.random.default_rng(nw * 10 + off)
    offs = [off] + [(off + k) % 4 for k in range(1, nw)]
    for n in list(range(34)) + [257, 1002, 1003, 2049]:
        w = _keys("random", nw, n, rng)
        mem = _placed(w, offs, rng)
        want = _plain(w, 4 * nw)
        for grid in (1, 3, 7):
            got = _kernel_model(mem, offs, n, 4 * nw, grid=grid, warps=1)
            np.testing.assert_array_equal(got, want, err_msg=f"n={n} grid={grid}")


@pytest.mark.parametrize("nw", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["random", "presorted", "reversed", "equal",
                                  "prefix", "zipf"])
def test_kernel_model_matches_jax(kind, nw):
    """The model against histogram_plain and the JAX kernel, 7 blocks of 2
    warps, plane 0 one word past a 16-byte boundary."""
    rng = np.random.default_rng(len(kind) * 10 + nw)
    n = 5003
    w = _keys(kind, nw, n, rng)
    offs = [1] + [k % 4 for k in range(1, nw)]
    got = _kernel_model(_placed(w, offs, rng), offs, n, 4 * nw, grid=7, warps=2)
    want = jh.multi_level_histogram([jnp.asarray(x) for x in w], 4 * nw)
    res = th.unpack(got, 4 * nw)
    np.testing.assert_array_equal(got, _plain(w, 4 * nw))
    np.testing.assert_array_equal(res.counts, want.counts)
    np.testing.assert_array_equal(res.level_sorted, want.level_sorted)
    assert res.sorted_prefix == want.sorted_prefix


@pytest.mark.parametrize("nw,level0,n_levels", [
    (1, 0, 1), (1, 2, 1), (1, 3, 1),  # the one-level instance
    (1, 1, 2), (2, 0, 7), (2, 3, 1), (2, 1, 5), (2, 4, 4), (3, 5, 6), (8, 0, 31),
])
def test_kernel_model_level_ranges(nw, level0, n_levels):
    """The one-level instance and the general one at (level0, n_levels)
    pairs, against histogram_plain; one level of one word against the JAX
    level_histogram."""
    rng = np.random.default_rng(level0 * 10 + n_levels)
    n = 3001
    w = _keys("prefix", nw, n, rng)
    w[-1] &= 0x00FF0F0F  # a few skewed levels
    offs = [3] * nw
    got = _kernel_model(_placed(w, offs, rng), offs, n, n_levels, level0,
                           grid=3, warps=2)
    np.testing.assert_array_equal(got, _plain(w, n_levels, level0))
    if nw == 1 and n_levels == 1:
        want = np.asarray(jh.level_histogram([jnp.asarray(w[0])], level0))
        np.testing.assert_array_equal(got[:th.RADIX], want)


@pytest.mark.parametrize("parts,unroll", [(1, 1), (2, 2), (32, 1), (32, 2)])
def test_kernel_model_parts_and_unroll(parts, unroll):
    """Other sub-histogram counts and group unrolls than the kernel's give
    the same buffer; so does the kernel's own block of 32 warps."""
    rng = np.random.default_rng(parts + unroll)
    n = 4099
    for kind in ("zipf", "presorted"):
        w = _keys(kind, 2, n, rng)
        offs = [2, 2]
        got = _kernel_model(_placed(w, offs, rng), offs, n, 8, grid=3, warps=3,
                               parts=parts, unroll=unroll)
        np.testing.assert_array_equal(got, _plain(w, 8))
    got = _kernel_model(_placed(w, offs, rng), offs, n, 8, grid=1)
    np.testing.assert_array_equal(got, _plain(w, 8))
