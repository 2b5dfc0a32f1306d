"""Kernel B1's plain version against ``rdst_tpu.ops.histogram``.

The JAX side runs its Pallas kernel in interpret mode (forced, as
tests/test_pallas_sort.py does); the port runs ``histogram_plain`` because
its tensors lie on the CPU.  Counts, per-level sortedness and the sorted
prefix are integers and booleans: every comparison is exact.
"""
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
