"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
CPU entries at a small size, once for each fault the cell can have."""
import numpy as np
import pytest
import torch

import bench_testing
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import builder, sorter
from rdst_tpu_torch.keys import NormalizedKeys

SORT_CELLS = ("sort_u64_50m_tensor", "sort_u64_50m_numpy")
_run = sorter.Sorter.run


def _unchanged(self, nk, payloads=(), **kw):
    """The sort's step returns its state unchanged."""
    return nk, list(payloads)


def _half(self, nk, payloads=(), **kw):
    """Half of the keys left out of the sort, the rest passed through."""
    h = int(nk.words[0].shape[0]) // 2
    head = NormalizedKeys(tuple(w[:h] for w in nk.words), nk.n_bytes, nk.meta)
    out, pays = _run(self, head, [p[:h] for p in payloads], **kw)
    words = tuple(P.cat([a, w[h:]]) for a, w in zip(out.words, nk.words))
    return (NormalizedKeys(words, nk.n_bytes, nk.meta),
            [P.cat([a, p[h:]]) for a, p in zip(pays, payloads)])


_sort = builder.RadixSortBuilder.sort


def _altered(self):
    """One key of the answer altered where the builder produces it."""
    out = _sort(self)
    if isinstance(out, np.ndarray):
        out = out.copy()
        out[len(out) // 2] ^= np.uint64(1)
    else:
        out = out.clone()
        out.view(torch.int64)[out.numel() // 2] ^= 1
    return out


def _late(after):
    """Every answer from the builder's ``after``-th call on altered: a
    fault that shows only late in the window."""
    calls = [0]

    def sort(self):
        calls[0] += 1
        return _altered(self) if calls[0] > after else _sort(self)

    return sort


@pytest.mark.parametrize("cell", SORT_CELLS)
def test_a_fault_late_in_the_window_is_judged(monkeypatch, cell):
    sound = bench_testing.run_small(cell, seconds=1.0)
    assert sound["correct"]
    late = len(sound["run"].spans) // 2
    assert late > 10
    monkeypatch.setattr(builder.RadixSortBuilder, "sort", _late(late))
    res = bench_testing.run_small(cell, seconds=1.0)
    assert not res["correct"]


@pytest.mark.parametrize("cell", SORT_CELLS)
@pytest.mark.parametrize("fault,target,name", [
    ("state unchanged", sorter.Sorter, "run"),
    ("half the keys left out", sorter.Sorter, "run"),
    ("answer altered", builder.RadixSortBuilder, "sort"),
])
def test_sort_faults(monkeypatch, cell, fault, target, name):
    patch = {"state unchanged": _unchanged, "half the keys left out": _half,
             "answer altered": _altered}[fault]
    assert bench_testing.run_small(cell)["correct"]
    monkeypatch.setattr(target, name, patch)
    res = bench_testing.run_small(cell)
    assert not res["correct"], fault
