"""The fused bitonic executor of the port (ops/fused_sort.py, kernels B2/B3).

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
    for planes in range(1, fs.MAX_PLANES + 1):
        small, big = fs.pick_blocks(planes)
        assert small == big and big & (big - 1) == 0
        assert big * planes * 4 <= fs.config.bitonic_smem_bytes
        assert big * 2 * planes * 4 > fs.config.bitonic_smem_bytes


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
