"""The fused bitonic executor of the port (ops/fused_sort.py, kernels B2/B3),
with the radix route shut (every case here takes the network).

Two kinds of check, both exact (integer bit patterns throughout):

* the cases of tests/test_pallas_sort.py at the same ``row``/``block``
  settings, against the same numpy oracles that pin the JAX executor: keys
  bit-equal, stable payloads bit-equal, unstable runs compared as (key,
  payload) multisets because phase 0's unstable tie order is left to
  ``torch.sort`` (as the JAX package leaves it to ``lax.sort``);
* the plain versions of B2 and B3 against the Pallas ``_tail_call`` and
  ``_span_call`` in interpret mode on identical inputs: bit for bit,
  payloads included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdst_tpu.ops.pallas_sort as ps
from rdst_tpu_torch.ops import fused_sort as fs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setenv("RDST_TPU_FORCE_INTERPRET", "1")


@pytest.fixture(autouse=True)
def _network_route(monkeypatch):
    """These cases hold the network: the radix route, which rows of at most
    64 key bits and one payload plane take (tests/test_torch_radix_sort.py),
    is shut."""
    monkeypatch.setattr(fs.radix_sort, "takes", lambda *a, **k: False)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(tensors):
    return [t.numpy() for t in tensors]


def _check_unstable(keys, pays, out_k, out_p):
    """Keys bit-equal to lexsorted; (key, payload) multiset preserved."""
    order = np.lexsort(keys[::-1])
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(out_k[i], k[order])
    if len(pays):
        got = sorted(map(tuple, np.stack(list(out_k) + list(out_p), 1).tolist()))
        want = sorted(map(tuple, np.concatenate([keys, pays]).T.tolist()))
        assert got == want


def _check_stable(keys, pays, out_k, out_p):
    order = np.lexsort(keys[::-1])
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(out_k[i], k[order])
    for i, p in enumerate(pays):
        np.testing.assert_array_equal(out_p[i], p[order])


def _sort(keys, pays, **kw):
    out_k, out_p = fs.fused_sort(_t(keys), _t(pays), **kw)
    return _np(out_k), _np(out_p)


@pytest.mark.parametrize(
    "n,nk,npay,stable,lo",
    [
        (1 << 12, 1, 0, False, False),
        (1 << 12, 2, 1, False, True),
        (1 << 13, 2, 2, True, True),
        (1 << 12, 1, 1, True, False),
        (1 << 13, 3, 0, False, True),
    ],
)
def test_pow2_parity(n, nk, npay, stable, lo):
    rng = np.random.default_rng(n + nk * 7 + npay)
    keys = rng.integers(0, 2**32, size=(nk, n), dtype=np.uint32)
    if lo:
        keys %= 97
    pays = rng.integers(0, 2**32, size=(npay, n), dtype=np.uint32)
    before = fs.TAIL.plain_calls
    out_k, out_p = _sort(keys, pays, stable=stable, row=256, block=1024)
    assert fs.TAIL.plain_calls > before
    (_check_stable if stable else _check_unstable)(keys, pays, out_k, out_p)


@pytest.mark.parametrize(
    "n,stable,npay",
    [(5000, False, 0), (5000, False, 1), (4429, True, 1), (3000, True, 0)],
)
def test_non_pow2_padding(n, stable, npay):
    """Pads slice off cleanly even when real keys are all-ones."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, size=(2, n), dtype=np.uint32)
    keys[:, :17] = 0xFFFFFFFF  # collide with the pad sentinel
    pays = rng.integers(0, 2**32, size=(npay, n), dtype=np.uint32)
    out_k, out_p = _sort(keys, pays, stable=stable, row=256, block=1024)
    assert out_k[0].shape[0] == n
    (_check_stable if stable else _check_unstable)(keys, pays, out_k, out_p)


def test_piece_path_late_marker(monkeypatch):
    """Unstable + payload at a length far from a power of two: the piece
    path sorts pieces through the core (lowered piece minimum) and the u8
    pad marker joins only the final piece and the merges after it."""
    monkeypatch.setattr(fs.config, "fused_min_piece", 1024)
    rng = np.random.default_rng(77)
    n = 9000  # next power of two 16384 > 1.13 n -> pieces of T/16 = 1024
    keys = rng.integers(0, 2**32, size=(1, n), dtype=np.uint32)
    keys[0, :31] = 0xFFFFFFFF
    pays = rng.integers(0, 2**32, size=(1, n), dtype=np.uint32)
    out_k, out_p = _sort(keys, pays, stable=False, row=256, block=1024)
    _check_unstable(keys, pays, out_k, out_p)


def test_span_multiple_groups():
    """A small block splits one level's span stages over several trips."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=(1, 1 << 13), dtype=np.uint32)
    before = fs.SPAN.plain_calls
    out_k, _ = _sort(keys, [], row=128, block=256)
    assert fs.SPAN.plain_calls > before
    np.testing.assert_array_equal(out_k[0], np.sort(keys[0]))


def test_degenerate_inputs():
    rng = np.random.default_rng(5)
    n = 1 << 12
    for arr in [
        np.zeros(n, np.uint32),
        np.arange(n, dtype=np.uint32),
        np.arange(n, dtype=np.uint32)[::-1].copy(),
        rng.integers(0, 2, size=n, dtype=np.uint32),
    ]:
        out_k, _ = _sort([arr], [], row=256, block=1024)
        np.testing.assert_array_equal(out_k[0], np.sort(arr))


def test_narrow_and_float_payloads_round_trip():
    """u16 keys stay u16; f32 and i16 payloads ride bit-exactly."""
    rng = np.random.default_rng(9)
    n = 1 << 12
    k16 = rng.integers(0, 2**16, size=n).astype(np.uint16)
    pf = rng.standard_normal(n).astype(np.float32)
    pi = rng.integers(-(2**15), 2**15, size=n).astype(np.int16)
    out_k, out_p = fs.fused_sort(_t([k16]), _t([pf, pi]), stable=True,
                                 row=256, block=1024)
    assert out_k[0].dtype == torch.uint16
    assert out_p[0].dtype == torch.float32 and out_p[1].dtype == torch.int16
    order = np.argsort(k16, kind="stable")
    np.testing.assert_array_equal(out_k[0].numpy(), k16[order])
    np.testing.assert_array_equal(out_p[0].numpy(), pf[order])
    np.testing.assert_array_equal(out_p[1].numpy(), pi[order])


@pytest.mark.parametrize("stable", [False, True])
def test_mixed_width_keys_pow2(stable):
    rng = np.random.default_rng(21)
    n = 1 << 13
    k0 = rng.integers(0, 2**16, size=n).astype(np.uint16)
    k1 = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    out_k, out_p = fs.fused_sort(_t([k0, k1]), _t([pay]), stable=stable,
                                 row=256, block=1024)
    assert out_k[0].dtype == torch.uint16
    keys = [k0.astype(np.uint32), k1]
    (_check_stable if stable else _check_unstable)(
        keys, [pay], [k.numpy().astype(np.uint32) for k in out_k], _np(out_p))


@pytest.mark.parametrize("n,stable", [(4429, True), (5000, False)])
def test_mixed_width_keys_non_pow2(n, stable):
    rng = np.random.default_rng(n)
    k0 = rng.integers(0, 2**16, size=n).astype(np.uint16)
    k1 = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    k0[:9] = 0xFFFF  # collide with the narrow pad sentinel
    pay = np.arange(n, dtype=np.uint32)
    pays = [pay] if stable else []
    out_k, out_p = fs.fused_sort(_t([k0, k1]), _t(pays), stable=stable,
                                 row=256, block=1024)
    keys = [k0.astype(np.uint32), k1]
    got_k = [k.numpy().astype(np.uint32) for k in out_k]
    (_check_stable if stable else _check_unstable)(keys, pays, got_k, _np(out_p))


def test_u8_planes():
    rng = np.random.default_rng(23)
    n = 1 << 13
    k = rng.integers(0, 256, size=n).astype(np.uint8)
    p8 = rng.integers(0, 256, size=n).astype(np.uint8)
    out_k, out_p = fs.fused_sort(_t([k]), _t([p8]), stable=True, row=256,
                                 block=1024)
    assert out_k[0].dtype == torch.uint8 and out_p[0].dtype == torch.uint8
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(out_k[0].numpy(), k[order])
    np.testing.assert_array_equal(out_p[0].numpy(), p8[order])


def test_stable_exactness_on_heavy_ties():
    rng = np.random.default_rng(11)
    n = 1 << 12
    keys = (rng.zipf(1.3, size=n) % 50).astype(np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    out_k, out_p = _sort([keys], [pay], stable=True, row=256, block=1024)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(out_k[0], keys[order])
    np.testing.assert_array_equal(out_p[0], pay[order])


def test_availability_gate(monkeypatch):
    n = 4096
    monkeypatch.setattr(fs.config, "fused_min_elems", n)
    u32 = torch.zeros(n, dtype=torch.uint32)
    small = torch.zeros(n - 1, dtype=torch.uint32)
    i32 = torch.zeros(n, dtype=torch.int32)
    b = torch.zeros(n, dtype=torch.bool)
    u64 = torch.zeros(n, dtype=torch.uint64)
    assert fs.fused_sort_available([u32], [])
    assert fs.fused_sort_available([u32], [i32])          # signed payload ok
    assert not fs.fused_sort_available([small], [])       # below crossover
    assert not fs.fused_sort_available([i32], [])         # signed key
    assert not fs.fused_sort_available([u64], [])         # 8-byte plane
    assert not fs.fused_sort_available([u32], [b])        # bool payload
    assert not fs.fused_sort_available([u32] * 4, [u32] * 4)  # plane bound
    odd = torch.zeros(n + 5, dtype=torch.uint32)
    assert fs.fused_sort_available([odd], [odd], stable=False)


def test_tiny_fallback():
    rng = np.random.default_rng(13)
    arr = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    out_k, _ = _sort([arr], [], row=256, block=1024)
    np.testing.assert_array_equal(out_k[0], np.sort(arr))


def test_pick_blocks_fit_shared_memory():
    """The B2/B3 block is the largest power of two one CTA holds: at most
    512 threads of ELEMS elements, and a u32 staging tile of every plane plus
    a u32 transpose buffer in ``bitonic_smem_bytes``.  B5 runs on B2's
    kernel and takes B2's block."""
    from rdst_tpu_torch.ops import fused_merge as fm

    cfg = fs.config
    for planes in range(1, fs.MAX_PLANES + 1):
        small, big = fs.pick_blocks(planes)
        assert small == big and big & (big - 1) == 0
        e = fs.ELEMS[planes]
        assert big // e <= 512
        assert big * 4 * (planes + 1) <= cfg.bitonic_smem_bytes
        assert (2 * big // e > 512
                or 2 * big * 4 * (planes + 1) > cfg.bitonic_smem_bytes)
    assert [fs.pick_blocks(k)[0] for k in range(1, 9)] == [
        1 << 14, 1 << 14, 1 << 13, 1 << 13, 1 << 12, 1 << 12, 1 << 12, 1 << 11]
    assert [fm.pick_block(k) for k in range(1, 9)] == [
        1 << 14, 1 << 14, 1 << 13, 1 << 13, 1 << 12, 1 << 12, 1 << 12, 1 << 11]


def _trips(T, blk, row):
    """(tail, span) launches of ``_core`` on a power-of-two length T with
    small = big block ``blk``: trip 1, then per level above the block span
    trips of at most log2(blk / GRAIN) strides each and one tail sweep."""
    log_b, log_t = blk.bit_length() - 1, T.bit_length() - 1
    max_span = max(1, (blk // fs.GRAIN).bit_length() - 1)
    spans = sum(-(-(log_r - log_b + 1) // max_span) for log_r in range(log_b, log_t))
    return 1 + (log_t - log_b), spans


def test_core_trip_counts(monkeypatch):
    """TAIL and SPAN plain calls of one sort at small n equal the trip count
    of the block rule; at the 2^25 x 2 headline the same rule gives 12 tail
    and 15 span trips with 2^14 blocks (13 and 18 with the 2^13 blocks of
    two CTAs per SM)."""
    assert fs.pick_blocks(2)[0] == 1 << 14
    assert _trips(1 << 25, 1 << 14, 4096) == (12, 15)
    assert _trips(1 << 25, 1 << 13, 4096) == (13, 18)
    monkeypatch.setattr(fs.config, "bitonic_smem_bytes", 18432)  # 1024 at 2 planes
    blk = fs.pick_blocks(2)[0]
    assert blk == 1024
    rng = np.random.default_rng(41)
    n = 1 << 14
    keys = rng.integers(0, 2**32, size=(2, n), dtype=np.uint32)
    before = fs.TAIL.plain_calls, fs.SPAN.plain_calls
    out_k, _ = _sort(keys, [])
    got = fs.TAIL.plain_calls - before[0], fs.SPAN.plain_calls - before[1]
    assert got == _trips(n, blk, 4096) == (5, 5)
    _check_unstable(keys, np.zeros((0, n), np.uint32), out_k, [])


# -- the plan a B2/B3 launch runs, on a register-level model of the kernel ----


def _lex_gt(a, b, n_keys):
    r = np.zeros(a[0].shape, bool)
    for k in range(n_keys - 1, -1, -1):
        r = np.where(a[k] != b[k], a[k] > b[k], r)
    return r


def _model(planes, block, n_keys, plan, tile_index, tile_u, n_tiles):
    """Run ``plan`` as csrc/bitonic.cu does, thread by thread and register by
    register: reg i of thread tid holds element
    ((tid >> a) << (a + R)) | (i << a) | (tid & (2^a - 1)) in layout a; a REG
    step compares two registers of a thread, a LANE step a register with the
    partner lane's (both ascending), a MOVE step goes through a transpose
    buffer, a FLIP complements the key planes where exactly one of its
    (one or two) direction bits is set."""
    a0, ops, bits, dirs = plan
    k = len(planes)
    E = fs.elems_per_thread(k, block)
    R, L = E.bit_length() - 1, block.bit_length() - 1
    T = block // E
    tid = np.arange(T)[:, None]
    reg = np.arange(E)[None, :]
    ones = [int(np.iinfo(p.dtype).max) if j < n_keys else 0 for j, p in enumerate(planes)]
    out = [np.empty_like(p) for p in planes]

    def elems(a):
        return ((tid >> a) << (a + R)) | (reg << a) | (tid & ((1 << a) - 1))

    for t in range(n_tiles):
        g = tile_index(t)
        u = tile_u(t)
        a = a0
        e = elems(a)
        assert sorted(e.ravel()) == list(range(block))
        v = [p[g].astype(np.int64)[e] for p in planes]
        for op, bit, d in zip(ops, bits, dirs):
            if op == fs._MOVE:
                a = bit
                buf = [np.empty(block, np.int64) for _ in planes]
                for b, x in zip(buf, v):
                    b[e] = x
                e = elems(a)
                v = [b[e] for b in buf]
            elif op == fs._REG:  # ascending: swap where lo > hi
                rb = bit - a
                assert 0 <= rb < R
                lo = [i for i in range(E) if not (i >> rb) & 1]
                hi = [i | (1 << rb) for i in lo]
                x = [w[:, lo] for w in v]
                y = [w[:, hi] for w in v]
                swap = _lex_gt(x, y, n_keys)
                for w, xi, yi in zip(v, x, y):
                    w[:, lo] = np.where(swap, yi, xi)
                    w[:, hi] = np.where(swap, xi, yi)
            elif op == fs._LANE:
                tb = bit if bit < a else bit - R
                assert tb < min(5, L - R)  # a lane of the same warp
                partner = (tid ^ (1 << tb))[:, 0]
                is_hi = ((tid >> tb) & 1) == 1
                y = [w[partner] for w in v]
                lo = [np.where(is_hi, b, c) for b, c in zip(y, v)]
                hi = [np.where(is_hi, c, b) for b, c in zip(y, v)]
                swap = _lex_gt(lo, hi, n_keys)
                v = [np.where(swap, b, c) for b, c in zip(y, v)]
            else:
                assert op == fs._FLIP
                f = np.zeros(e.shape, bool)
                for dd in [d] + ([] if bit == fs._NO_DIR else [bit]):
                    if dd < 0:
                        f ^= bool((u >> (-dd - 1)) & 1)
                    else:
                        f ^= ((e >> dd) & 1) == 1
                v = [np.where(f, w ^ o, w) for w, o in zip(v, ones)]
        for o, w in zip(out, v):
            o[g[e]] = w.astype(o.dtype)
    return out


@pytest.mark.parametrize(
    "n,block,dtypes,n_keys,levels,unflip",
    [
        (1 << 15, 1 << 14, [np.uint32] * 2, 2, [(13, 4096), (14, 8192)], 12),
        (1 << 15, 1 << 14, [np.uint32] * 2, 2, [(21, 8192)], None),
        (1 << 14, 1 << 12, [np.uint32] * 5, 3, [(11, 1024), (12, 2048)], 10),
        (1 << 13, 1 << 11, [np.uint16, np.uint32, np.uint8] + [np.uint32] * 5, 4,
         [(8, 128), (9, 256), (10, 512), (11, 1024)], 7),
        (1 << 12, 1 << 10, [np.uint8, np.uint16], 2, [(5, 16), (6, 32), (7, 64)], 4),
        (1 << 10, 1 << 8, [np.uint32] * 3, 1, [(9, 128)], None),
        (64, 8, [np.uint32], 1, [(2, 2), (3, 4)], 1),
    ],
)
def test_tail_plan_on_kernel_model(n, block, dtypes, n_keys, levels, unflip):
    """B2's plan on the register-level model equals ``tail_plain``."""
    rng = np.random.default_rng(n + block + len(dtypes))
    planes = _planes(rng, n, dtypes)
    net, flip = fs._tail_net(levels, unflip, block)
    plan = fs._net_plan(net, block, len(planes), flip)
    assert [b for o, b in zip(plan[1], plan[2]) if o in (fs._REG, fs._LANE)] == [
        j for _, bits in net for j in bits]
    got = _model(planes, block, n_keys, plan,
                 lambda t: t * block + np.arange(block), lambda t: t, n // block)
    want = fs.tail_plain(_t(planes), n, block, n_keys, levels, unflip)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize(
    "n,s_hi,s_lo,two_r,block,dtypes,n_keys",
    [
        (1 << 17, 1 << 15, 1 << 9, 1 << 17, 1 << 14, [np.uint32] * 2, 2),
        (1 << 16, 1 << 13, 1 << 7, 1 << 14, 1 << 14, [np.uint32] * 2, 2),
        (1 << 16, 1 << 13, 1 << 8, 1 << 15, 1 << 12, [np.uint32] * 5, 4),
        (1 << 15, 1 << 10, 1 << 10, 1 << 13, 1 << 11,
         [np.uint8, np.uint32, np.uint16, np.uint32, np.uint32, np.uint32], 3),
        (1 << 12, 1 << 9, 1 << 7, 1 << 12, 1 << 9, [np.uint32], 1),
    ],
)
def test_span_plan_on_kernel_model(n, s_hi, s_lo, two_r, block, dtypes, n_keys):
    """B3's plan and cell geometry on the register-level model equal
    ``span_plain``: tile t is cell (a, b) = (t >> log2(s_lo / w), the rest),
    element e at a * 2 s_hi + b * w + (e >> log2 w) * s_lo + (e & (w - 1))."""
    rng = np.random.default_rng(n + s_hi + s_lo + len(dtypes))
    planes = _planes(rng, n, dtypes)
    p_dim = 2 * s_hi // s_lo
    w = block // p_dim
    wc = s_lo // w
    L = block.bit_length() - 1
    desc = -1 - ((two_r // (2 * s_hi)).bit_length() - 1)
    net = [(desc, list(range(L - 1, L - 1 - (p_dim.bit_length() - 1), -1)))]
    plan = fs._net_plan(net, block, len(planes))
    e = np.arange(block)

    def index(t):
        base = (t // wc) * 2 * s_hi + (t % wc) * w
        return base + (e // w) * s_lo + e % w

    got = _model(planes, block, n_keys, plan, index, lambda t: t // wc,
                 n // (2 * s_hi) * wc)
    want = fs.span_plain(_t(planes), n, s_hi, s_lo, two_r, block, n_keys)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


_WIDTHS = [np.uint32, np.uint16, np.uint32, np.uint8]


def _bitonic_blocks(rng, n, block, dtypes, n_keys):
    """Planes whose every aligned block is an ascending run then a
    descending one, with ties (five values a key plane) and all-ones keys."""
    planes = [(rng.integers(0, 5, size=n, dtype=np.uint64)).astype(dt)
              for dt in dtypes]
    planes[0][::7] = np.iinfo(dtypes[0]).max
    half = block // 2
    for lo in range(0, n, half):
        order = np.lexsort([p[lo:lo + half] for p in planes[:n_keys]][::-1])
        if (lo // half) % 2:
            order = order[::-1]
        for p in planes:
            p[lo:lo + half] = p[lo:lo + half][order]
    return planes


@pytest.mark.parametrize(
    "k,block",
    [(k, 1 << lb) for k in range(1, fs.MAX_PLANES + 1)
     for lb in range(fs._log2(2 * fs.GRAIN), fs._log2(fs.pick_blocks(k)[1]) + 1)],
)
def test_merge_tail_plan_on_kernel_model(k, block):
    """B5's plan (one level with no direction: strides block/2 .. 1, as
    ``fused_merge.merge_tail_cuda`` launches it) on the register-level model
    of the kernel equals ``merge_tail_plain``, and sorts every bitonic
    block; it has no FLIP step."""
    from rdst_tpu_torch.ops import fused_merge as fm

    n_keys = 1 + (k - 1) % 3
    dtypes = [_WIDTHS[(k + i) % 4] for i in range(k)]
    n = 2 * block
    rng = np.random.default_rng(1000 * k + block)
    planes = _bitonic_blocks(rng, n, block, dtypes, n_keys)
    net, flip = fs._tail_net([(None, block // 2)], None, block)
    plan = fs._net_plan(net, block, k, flip)
    assert fs._FLIP not in plan[1]
    assert [b for o, b in zip(plan[1], plan[2]) if o != fs._MOVE] == list(
        range(block.bit_length() - 2, -1, -1))
    got = _model(planes, block, n_keys, plan,
                 lambda t: t * block + np.arange(block), lambda t: t, n // block)
    want = fm.merge_tail_plain(_t(planes), n, block, n_keys)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    for lo in range(0, n, block):
        keys = [p[lo:lo + block].astype(np.int64) for p in got[:n_keys]]
        assert not _lex_gt([x[:-1] for x in keys], [x[1:] for x in keys], n_keys).any()


# -- the plain B2/B3 against the Pallas kernels, bit for bit ------------------


def _planes(rng, n, dtypes):
    return [
        (rng.integers(0, np.iinfo(dt).max + 1, size=n, dtype=np.uint64) % 5)
        .astype(dt)
        for dt in dtypes
    ]


@pytest.mark.parametrize(
    "n,block,dtypes,n_keys,levels,unflip",
    [
        (2048, 1024, [np.uint32, np.uint32], 1, [(9, 256), (10, 512)], 8),
        (2048, 512, [np.uint16, np.uint32, np.uint8], 2, [(11, 256)], None),
        (4096, 1024, [np.uint32] * 8, 3, [(12, 512)], None),
        (2048, 1024, [np.uint8, np.uint16], 2, [(8, 128), (9, 256), (10, 512)], 7),
    ],
)
def test_tail_plain_matches_pallas(n, block, dtypes, n_keys, levels, unflip):
    rng = np.random.default_rng(n + block + n_keys)
    planes = _planes(rng, n, dtypes)
    want = ps._tail_call([jnp.asarray(p) for p in planes], n, block, n_keys,
                         levels, unflip, True)
    got = fs.tail_call(_t(planes), n, block, n_keys, levels, unflip)
    for a, b in zip(want, got):
        assert b.dtype == torch.from_numpy(np.array(a)).dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize(
    "n,s_hi,s_lo,two_r,block,dtypes,n_keys",
    [
        (4096, 1024, 256, 4096, 1024, [np.uint32, np.uint32], 1),
        (4096, 512, 512, 2048, 512, [np.uint32, np.uint16, np.uint8], 2),
        (8192, 2048, 256, 8192, 2048, [np.uint32] * 3, 3),
        (4096, 1024, 128, 2048, 2048, [np.uint8, np.uint32], 1),
    ],
)
def test_span_plain_matches_pallas(n, s_hi, s_lo, two_r, block, dtypes, n_keys):
    rng = np.random.default_rng(n + s_hi + s_lo)
    planes = _planes(rng, n, dtypes)
    want = ps._span_call([jnp.asarray(p) for p in planes], n, s_hi, s_lo,
                         two_r, block, n_keys, True)
    got = fs.span_call(_t(planes), n, s_hi, s_lo, two_r, block, n_keys)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never run the plain path."""
    p = [torch.zeros(1024, dtype=torch.uint32)]
    before = fs.TAIL.launches, fs.SPAN.launches
    with pytest.raises(ValueError):
        fs.tail_cuda(p, 1024, 256, 1, [(9, 128)], None)
    with pytest.raises(ValueError):
        fs.span_cuda(p, 1024, 256, 128, 512, 256, 1)
    assert (fs.TAIL.launches, fs.SPAN.launches) == before


# -- B7, the piece merge ------------------------------------------------------


def _runs(rng, la, lb, dtypes, n_keys, values=3):
    """Two ascending runs (by the first ``n_keys`` planes) of few values a
    key plane, so ties cross the runs; every other plane a random rider."""
    out = []
    for ln in (la, lb):
        planes = [rng.integers(0, min(values, np.iinfo(dt).max + 1), size=ln)
                  .astype(dt) if j < n_keys else
                  rng.integers(0, np.iinfo(dt).max + 1, size=ln, dtype=np.uint64).astype(dt)
                  for j, dt in enumerate(dtypes)]
        order = np.lexsort(planes[:n_keys][::-1])
        out.append([p[order] for p in planes])
    return out


def _merge_oracle(a, b, n_keys):
    """The stable lexsort of a ++ b: on equal keys, a's elements first."""
    cat = [np.concatenate([x, y]) for x, y in zip(a, b)]
    order = np.lexsort(cat[:n_keys][::-1])
    return [c[order] for c in cat], order


@pytest.mark.parametrize("la,lb,dtypes,n_keys,values", [
    (1000, 1000, [np.uint32], 1, 3),
    (3000, 17, [np.uint32, np.uint32], 2, 3),
    (5, 4000, [np.uint8, np.uint16, np.uint32], 3, 3),
    (3841, 3839, [np.uint16, np.uint32, np.uint8, np.uint32, np.uint16, np.uint32], 5, 3),
    (2304, 1, [np.uint8, np.uint32, np.uint8, np.uint16, np.uint32], 4, 2),
    (1, 1, [np.uint32, np.uint8], 1, 1),
])
def test_piece_merge_plain_matches_oracle(la, lb, dtypes, n_keys, values):
    """The plain B7 is the stable merge: keys and riders of the stable
    lexsort of a ++ b, ties across the runs with a's elements first (an
    origin rider shows it); u8, u16 and u32 planes mixed, 1-5 key planes."""
    rng = np.random.default_rng(la * 7 + lb + n_keys)
    a, b = _runs(rng, la, lb, dtypes, n_keys, values)
    a.append(np.zeros(la, np.uint8))  # origin: 0 for a, 1 for b
    b.append(np.ones(lb, np.uint8))
    before = fs.PIECE_MERGE.plain_calls
    got = fs.piece_merge(_t(a), _t(b), n_keys)
    assert fs.PIECE_MERGE.plain_calls == before + 1
    want, _ = _merge_oracle(a, b, n_keys)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)
    keys = [w.astype(np.int64) for w in want[:n_keys]]
    tie = np.ones(la + lb - 1, bool)
    for k in keys:
        tie &= k[:-1] == k[1:]
    assert tie.any()  # ties exist, and across them a's elements come first
    assert not (want[-1][:-1][tie] > want[-1][1:][tie]).any()


def _source_constants():
    import re
    from pathlib import Path

    src = (Path(fs.__file__).resolve().parent.parent / "csrc" / "piece_merge.cu").read_text()
    threads = int(re.search(r"constexpr int kMergeThreads = (\d+);", src).group(1))
    m = re.search(r"return n_keys <= (\d+) \? (\d+) : \(n_keys <= (\d+) \? (\d+) : (\d+)\);", src)
    k1, e1, k2, e2, e3 = map(int, m.groups())
    return threads, {k: e1 if k <= k1 else e2 if k <= k2 else e3 for k in range(1, 9)}


def test_merge_tile_mirrors_the_kernel():
    """MERGE_THREADS and MERGE_ELEMS are the kernel's constants; E is odd
    (bank-free index writes) and a tile's shared memory fits a block."""
    threads, elems = _source_constants()
    assert (threads, elems) == (fs.MERGE_THREADS, fs.MERGE_ELEMS)
    for k, e in elems.items():
        assert e % 2 == 1
        assert (k + 1) * fs.merge_tile(k) * 4 <= fs._SMEM_MAX


def _lt(x, y):
    return tuple(int(v) for v in x) < tuple(int(v) for v in y)


def _merge_model(a, b, n_keys, threads, e):
    """csrc/piece_merge.cu block by block and thread by thread: the
    partition's binary search on every tile boundary, then in each tile
    every thread's search and serial merge of ``e`` outputs.  Returns the
    source of each output as an index into a ++ b."""
    ka = list(zip(*a[:n_keys]))
    kb = list(zip(*b[:n_keys]))
    la, lb = len(ka), len(kb)
    n, nv = la + lb, threads * e

    def corank(diag, xa, xb):
        lo, hi = max(0, diag - len(xb)), min(diag, len(xa))
        while lo < hi:
            mid = (lo + hi) >> 1
            if _lt(xb[diag - 1 - mid], xa[mid]):
                hi = mid
            else:
                lo = mid + 1
        return lo

    tiles = -(-n // nv)
    splits = [corank(min(t * nv, n), ka, kb) for t in range(tiles + 1)]
    src = []
    for t in range(tiles):
        d0, d1 = t * nv, min(t * nv + nv, n)
        a0, a1 = splits[t], splits[t + 1]
        b0 = d0 - a0
        na, nt = a1 - a0, d1 - d0
        win = ka[a0:a1] + kb[b0:b0 + nt - na]
        sidx = [None] * nt
        for tid in range(threads):
            d = min(tid * e, nt)
            ai = corank(d, win[:na], win[na:])
            bi = na + d - ai
            for i in range(e):
                pos = tid * e + i
                if pos >= nt:
                    break
                if bi >= nt or (ai < na and not _lt(win[bi], win[ai])):
                    sidx[pos], ai = ai, ai + 1
                else:
                    sidx[pos], bi = bi, bi + 1
        src += [a0 + s if s < na else la + b0 + s - na for s in sidx]
    return np.array(src)


@pytest.mark.parametrize("la,lb,n_keys,threads,e", [
    (300, 200, 1, 8, 5),      # many tiles of 40
    (37, 400, 2, 4, 3),       # one run shorter than a tile
    (250, 250, 3, 16, 7),     # a length that is no multiple of the tile
    (96, 0, 1, 8, 3),         # an empty run
    (500, 511, 2, 256, 15),   # the kernel's tile at 1-2 keys: one partial tile
    (2000, 1900, 4, 256, 11), # its tile at 3-4 keys: several tiles
])
def test_piece_merge_kernel_model(la, lb, n_keys, threads, e):
    """The kernel's partition and tile merge, modelled element by element,
    give the stable merge's order (a's elements first on ties)."""
    rng = np.random.default_rng(la + 3 * lb + n_keys)
    dtypes = [np.uint32, np.uint16, np.uint8, np.uint32][:n_keys]
    a, b = _runs(rng, la, lb, dtypes, n_keys, values=4)
    _, order = _merge_oracle(a, b, n_keys)
    np.testing.assert_array_equal(_merge_model(a, b, n_keys, threads, e), order)


@pytest.mark.parametrize("npay", [0, 1])
@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("n,pieces", [(12000, 2), (12288, 2), (11000, 3), (14400, 4)])
def test_piece_path_merges(monkeypatch, n, pieces, stable, npay):
    """The piece path at T = 2^14 (Q = 1024) with pieces through the core:
    M = 12 (8 + 4), 11 (8 + 2 + 1) and 15 (8 + 4 + 2 + 1) pieces of Q; 12288
    has no pad.  Each piece after the first merges once on B7; stable
    outputs are bit-equal, unstable ones a (key, payload) multiset, with the
    late pad marker where an unstable sort with a payload pads."""
    monkeypatch.setattr(fs.config, "fused_min_piece", 1024)
    rng = np.random.default_rng(n + 10 * stable + npay)
    keys = rng.integers(0, 2**32, size=(2, n), dtype=np.uint32)
    keys[0] %= 40
    keys[:, :23] = 0xFFFFFFFF  # real keys equal to the pad's
    pays = rng.integers(0, 2**32, size=(npay, n), dtype=np.uint32)
    before = fs.PIECE_MERGE.plain_calls, fs.TAIL.plain_calls
    out_k, out_p = _sort(keys, pays, stable=stable, row=256, block=1024)
    assert fs.PIECE_MERGE.plain_calls - before[0] == pieces - 1
    assert fs.TAIL.plain_calls > before[1]
    (_check_stable if stable else _check_unstable)(keys, pays, out_k, out_p)


def test_piece_merge_refuses_bad_runs():
    """B7's wrapper launches or raises: CPU planes never reach the kernel,
    and runs that differ in planes or dtypes are refused."""
    a = [torch.zeros(10, dtype=torch.uint32)]
    before = fs.PIECE_MERGE.launches
    with pytest.raises(ValueError):
        fs.piece_merge_cuda(a, a, 1)
    with pytest.raises(ValueError):
        fs.piece_merge(a, [torch.zeros(10, dtype=torch.uint16)], 1)
    with pytest.raises(ValueError):
        fs.piece_merge(a, a * 2, 1)
    assert fs.PIECE_MERGE.launches == before
