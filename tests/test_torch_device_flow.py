"""Twin of ``tests/test_device_flow.py``: the port's default flow through
the device dispatcher (histogram -> tuner -> plan) with
``config.host_sort_max`` pinned to 0, against the JAX package on the CPU.

Each case is one entry of ``DEVICE_FLOW_CASES`` (``tests/flow_cases.py``),
which the card's device-flow phase runs at the same sizes on the H100.  The port's
side runs through ``flow_cases.flow_case`` with ``device="cpu"``, the code
the card runs, so its kernel wrappers take their plain versions and launch
nothing; the JAX side runs the same call through ``flow_cases.flow_runs``
on the same numpy input.  Held exactly: keys bit-equal to the JAX package
and to the numpy oracle (``flow_cases.flow_oracle``: floats in their
total order), stable payloads bit-equal, unstable payloads the same (key,
payload) multiset as the oracle's, and both packages' ``(level) PLAN:``
traces the identical string, equal to ``flow_cases.DEVICE_FLOW_TRACES``.
That table is what the card's picks must equal, so these tests bind the
card's picks to the reference's.

The JAX tests and what holds each here:

- ``test_device_default_flow_all_dtypes[dtype]`` (10 dtypes at 10,000,
  float specials) -> :func:`test_device_default_flow_all_dtypes`.
  ``test_torch_slice.py::test_radix_sort_unstable_matches_jax`` holds 9
  dtypes at N = 5000, but with ``fused_min_elems`` lowered, not the
  default flow.
- ``test_device_stable_key_value`` (u16 keys below 64 at 20,000) ->
  :func:`test_device_stable_key_value`.
- ``test_recombinating_natural_1m`` (1.2M), ``test_mt_lsb_natural_1m_skewed``
  (1M, stable key-value), ``test_regions_natural_4m_skewed`` (4.2M) -> the
  tests of the same names: ``_assert_pick`` through both packages'
  ``StandardTuner``, then the sort and its trace, which must name the
  Algorithm.  ``test_torch_slice.py::test_tuner_picks_match_jax`` holds
  the two tuners' picks over a sweep of sizes, not these sorts.
- ``test_scanning_natural_50m`` (50,000,001, ``slow``) -> the test of the
  same name, ``slow`` as there; :func:`test_scanning_ladder_and_trace`
  holds the ladder in both packages and the table's entry in Tier-1.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import flow_cases as fc
import rdst_tpu
import rdst_tpu_torch
from rdst_tpu import config as jconfig
from rdst_tpu import tuner as jtuner
from rdst_tpu_torch import _build
from rdst_tpu_torch import config as tconfig
from rdst_tpu_torch import tuner as ttuner
from rdst_tpu_torch.native import host as thost
from rdst_tpu_torch.parallel import remote_dma  # noqa: F401  (B6's launch counter)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _device_flow(monkeypatch):
    monkeypatch.setattr(jconfig, "host_sort_max", 0)
    monkeypatch.setattr(tconfig, "host_sort_max", 0)


def held(name, keys=None):
    """Run case ``name`` through the port (``flow_cases.flow_case`` on the
    CPU) and the JAX package, and hold both to each other, to the numpy
    oracle and to the trace table.  ``keys``: the input as the caller made
    it, which must be the case's.  Returns the port's runs."""
    x, v = fc.flow_input(name)
    if keys is not None:
        np.testing.assert_array_equal(keys, x)
    runs, counts, line = fc.flow_case(rdst_tpu_torch, tconfig, thost, _build.KERNELS,
                                      name, device="cpu")
    assert counts == {k: 0 for k in _build.KERNELS}  # plain versions on the CPU
    assert line.startswith(f"case {name}: ")
    want = fc.flow_runs(rdst_tpu, jconfig, name, x, v)
    assert len(runs) == len(want)
    for (gk, gp, gt), (wk, wp, wt) in zip(runs, want):
        assert gt == wt == fc.DEVICE_FLOW_TRACES[name]
        assert gk.dtype == wk.dtype
        np.testing.assert_array_equal(fc._bits(gk), fc._bits(wk))
        if fc.DEVICE_FLOW_CASES[name][0] == "kv unstable":
            # flow_case held the port's pairs to the oracle's multiset
            fc.flow_check(name, x, v, wk, wp)
        elif v is not None:
            assert gp.dtype == wp.dtype
            np.testing.assert_array_equal(gp, wp)
    return runs


@pytest.mark.parametrize("dtype", fc.FLOW_TYPES)
def test_device_default_flow_all_dtypes(dtype):
    x, _ = fc.flow_input(f"flow {dtype}")
    if dtype.startswith("float"):
        assert np.isnan(x[:2]).all() and np.signbit(x[1]) and np.isinf(x[2:4]).all()
    held(f"flow {dtype}")


def test_device_stable_key_value():
    held("flow stable kv u16")


def _assert_pick(n, skewed, expect):
    """The reference's ladder check, through both packages' StandardTuner."""
    counts = [n // 256] * 256
    if skewed:
        counts[3] += n // 2
    for tuner in (jtuner, ttuner):
        p = tuner.TuningParams(threads=8, level=3, total_levels=4, input_len=n,
                               parent_len=None)
        assert tuner.StandardTuner().pick_algorithm(p, counts) is tuner.Algorithm[expect]


def _natural(name, n, skewed, expect):
    _assert_pick(n, skewed, expect)
    (_, _, trace), = held(name)
    assert trace == f"(3) PLAN: {ttuner.Algorithm[expect].value} len={n}"


def test_recombinating_natural_1m():
    _natural("flow recombinating 1200000", 1_200_000, False, "RECOMBINATING")


def test_mt_lsb_natural_1m_skewed():
    _natural("flow mtlsb 1000000 skewed", 1_000_000, True, "MT_LSB")


def test_regions_natural_4m_skewed():
    _natural("flow regions 4200000 skewed", 4_200_000, True, "REGIONS")


def test_scanning_ladder_and_trace():
    """50,000,001 keys: both ladders pick Scanning (50,000,000 stays
    Recombinating), and the card's trace table says so."""
    _assert_pick(50_000_001, False, "SCANNING")
    _assert_pick(50_000_000, False, "RECOMBINATING")
    assert fc.DEVICE_FLOW_CASES[fc.SCANNING][1] == ("u32", 50_000_001, None)
    assert fc.DEVICE_FLOW_TRACES[fc.SCANNING] == "(3) PLAN: Scanning len=50000001"


@pytest.mark.slow
def test_scanning_natural_50m():
    _natural(fc.SCANNING, 50_000_001, False, "SCANNING")


def test_trace_table_covers_every_case():
    """One trace for every case, each one pick of its own length, and a
    pinned Algorithm's pick is that Algorithm."""
    assert list(fc.DEVICE_FLOW_TRACES) == list(fc.DEVICE_FLOW_CASES)
    for name, (call, (kind, *a), _) in fc.DEVICE_FLOW_CASES.items():
        n = a[1] if kind in ("typed", "below", "bimodal") else a[0]
        m = re.fullmatch(r"\(\d\) PLAN: (\w+) len=(\d+)", fc.DEVICE_FLOW_TRACES[name])
        assert m and int(m.group(2)) == n, name
        if call in fc.DET_ALGOS:
            assert m.group(1) == ttuner.Algorithm[call].value, name


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_flow_oracle_is_the_normalized_order(dt):
    """The oracle's float order is the stable order of the JAX package's
    normalized words."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(5000).astype(dt)
    x[:8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0]
    x[100:200] = x[:100]  # ties
    words = [np.asarray(w) for w in rdst_tpu.keys.normalize(x).words]
    want = np.lexsort((np.arange(x.size), *words[::-1]))
    np.testing.assert_array_equal(fc.flow_oracle(x), want)


def test_flow_check_rejects_wrong_results():
    """The card's check fails a wrong key, a stable payload out of order
    and a lost payload; an unstable payload may permute among equal
    keys."""
    name, uname = "ci f64 payload stable", "ci f64 payload unstable"
    x, v = fc.flow_input(name)
    x[1000:2000] = x[10:1010]  # ties
    order = fc.flow_oracle(x)
    k, p = x[order], v[order]
    fc.flow_check(name, x, v, k, p)
    bad = k.copy()
    bad[-1] = 0.5
    with pytest.raises(AssertionError, match="keys differ"):
        fc.flow_check(name, x, v, bad, p)
    ties = np.flatnonzero(fc._bits(k)[1:] == fc._bits(k)[:-1])
    swapped = p.copy()
    swapped[[ties[0], ties[0] + 1]] = swapped[[ties[0] + 1, ties[0]]]
    with pytest.raises(AssertionError, match="payload differs"):
        fc.flow_check(name, x, v, k, swapped)
    fc.flow_check(uname, x, v, k, swapped)
    lost = swapped.copy()
    lost[0] = lost[1]
    with pytest.raises(AssertionError, match="payload differs"):
        fc.flow_check(uname, x, v, k, lost)


def test_device_flow_child_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the no-CUDA rule is not reachable")
    p = subprocess.run([sys.executable, "chip_smoke.py", "--device-flow"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA is not available" in p.stderr
