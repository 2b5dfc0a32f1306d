"""The controls come out not correct, and a sound run correct.

The control puts the plain reference in the port's place at the next
lower precision: the keys ordered by their top 32 bits.  Here on the CPU at a size
a test run holds; on the card (marker ``cuda``) at each cell's own size,
on three seeds, as ``benchmark/control.py`` runs it."""
import pytest
import torch

import bench_testing
import control

CELLS = ("sort_u64_50m_tensor", "sort_u64_50m_numpy")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = bench_testing.run_small(cell)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    # 2^20 keys: the top 32 bits of some keys collide, as at 50M
    res = bench_testing.run_small(cell, program="control", n_keys=1 << 20)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card_at_the_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = control.controls(cell, [2**31 + 11, 2**31 + 12, 2**31 + 13], 3.0)
    assert not any(r["correct"] for r in res)
