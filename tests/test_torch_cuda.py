"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips unless ``torch.cuda.is_available()``.
The machine with the card has no JAX, so run this file there without the
suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version get identical tensors on the card and must agree
bit for bit (integer planes: exact); sorts through the kernels must equal
numpy's.
"""
import numpy as np
import pytest
import torch

import rdst_tpu_torch as rt
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch.ops import fused_sort as fs
from rdst_tpu_torch.ops import histogram as th

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


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 100_003])
@pytest.mark.parametrize("n_words", [1, 2, 3, 4, 5, 8])
def test_histogram_kernel(dev, n, n_words):
    w = _planes(dev, n, [torch.uint32] * n_words, n + n_words, high=1 << 32)
    w[0] = P.narrow(P.widen(w[0]) % 3, torch.uint32)
    before = th.HISTOGRAM.launches
    _same([th.histogram_cuda(w, 4 * n_words)], [th.histogram_plain(w, 4 * n_words)])
    _same([th.histogram_cuda(w, 3, 1)], [th.histogram_plain(w, 3, 1)])
    assert th.HISTOGRAM.launches == before + 2
    s = [P.narrow(P.widen(w[-1]).sort().values, torch.uint32)]
    res = th.multi_level_histogram(s, 4)
    assert res.sorted_prefix == n and res.level_sorted[3]


@pytest.mark.parametrize(
    "n,block,dtypes,n_keys,levels,unflip",
    [
        (1 << 12, 256, [torch.uint32], 1, [(8, 128)], None),
        (1 << 16, 1024, [torch.uint32, torch.uint32], 2,
         [(8, 128), (9, 256), (10, 512)], 7),
        (1 << 16, 16384, [torch.uint32], 1, [(13, 4096), (14, 8192)], 12),
        (1 << 15, 4096, [torch.uint16, torch.uint32, torch.uint8], 2,
         [(20, 2048)], None),
        (1 << 15, 2048, [torch.uint32] * 8, 3, [(11, 1024)], 10),
    ],
)
def test_tail_kernel(dev, n, block, dtypes, n_keys, levels, unflip):
    pl = _planes(dev, n, dtypes, n + block, high=7)
    _same(fs.tail_cuda(pl, n, block, n_keys, levels, unflip),
          fs.tail_plain(pl, n, block, n_keys, levels, unflip))


@pytest.mark.parametrize(
    "n,s_hi,s_lo,two_r,block,dtypes,n_keys",
    [
        (1 << 16, 1 << 12, 1 << 12, 1 << 13, 1 << 12, [torch.uint32] * 2, 2),
        (1 << 16, 1 << 14, 1 << 8, 1 << 16, 1 << 13, [torch.uint32] * 2, 1),
        (1 << 17, 1 << 15, 1 << 11, 1 << 18, 1 << 13,
         [torch.uint16, torch.uint32, torch.uint8], 2),
        (1 << 16, 1 << 12, 1 << 10, 1 << 14, 1 << 11, [torch.uint32] * 8, 4),
    ],
)
def test_span_kernel(dev, n, s_hi, s_lo, two_r, block, dtypes, n_keys):
    pl = _planes(dev, n, dtypes, n + s_hi, high=7)
    _same(fs.span_cuda(pl, n, s_hi, s_lo, two_r, block, n_keys),
          fs.span_plain(pl, n, s_hi, s_lo, two_r, block, n_keys))


@pytest.mark.parametrize("n,stable", [(1 << 15, False), (1 << 15, True),
                                      (50_000, True), (50_000, False)])
def test_fused_sort_through_kernels(dev, monkeypatch, n, stable):
    monkeypatch.setattr(config, "fused_min_piece", 1 << 11)
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, size=(2, n), dtype=np.uint32)
    keys[0] %= 1000
    pay = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    before = fs.TAIL.launches, fs.SPAN.launches
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


def test_kernel_wrappers_raise_on_bad_input(dev):
    p = _planes(dev, 1 << 13, [torch.uint32], 1)
    with pytest.raises(ValueError):
        fs.tail_cuda(p, 1 << 13, 1000, 1, [(8, 128)], None)  # block not pow2
    with pytest.raises(ValueError):
        fs.tail_cuda(p * 8, 1 << 13, 1 << 13, 1, [(8, 128)], None)  # smem
    with pytest.raises(TypeError):
        th.histogram_cuda([P.widen(p[0])], 1)  # int64 is not a u32 plane
