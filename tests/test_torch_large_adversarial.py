"""Twin of ``tests/test_large_adversarial.py``: bimodal and bit-pattern
inputs at 1M-5M through the port's real dispatcher (no pinned tuner),
against the JAX package on the CPU, at the reference's sizes.

Each case is one entry of ``DEVICE_FLOW_CASES`` (``tests/flow_cases.py``;
the card's device-flow phase runs it at the same size on the H100), held by
``tests/test_torch_device_flow.py::held`` three ways: bit-equal to the JAX
package, bit-equal to numpy (``np.sort``, or the stable argsort's keys and
payload), and the identical ``(level) PLAN:`` trace in both packages, equal
to ``flow_cases.DEVICE_FLOW_TRACES``.  The bimodal inputs are made here by
``tests/helpers.gen_bimodal`` from the case's seed and must equal the
card's (``flow_cases.gen_bimodal``, its copy).  The sizes straddle
``config.fused_min_elems`` (2^21): 1M-2M sort through ``lex_sort`` on the
CPU and the card, 2.5M and the 5M spike through the fused executor's
non-power-of-two piece path.

The JAX tests (all ``slow`` there; none is marked here, the file runs in
about a minute alone on one CPU core) and what holds each here:

- ``test_bimodal_u32_large[n, shift]`` (1M and 2.5M, shift 0 and 16) ->
  :func:`test_bimodal_u32_large`.
- ``test_bimodal_u64_large[shift]`` (1.5M, shift 0 and 32) ->
  :func:`test_bimodal_u64_large`.
- ``test_pattern_masks_large[mask]`` (2M, four masks) ->
  :func:`test_pattern_masks_large`.  ``test_torch_slice.py`` holds no
  masked input; ``test_torch_keys.py`` holds the compaction of constant
  bytes at small sizes.
- ``test_skew_outliers_large`` (5M: one value and 5 outliers, shuffled) ->
  :func:`test_skew_outliers_large`.
- ``test_bimodal_stable_payload_large`` (1M bimodal u64 + u32 payload,
  stable) -> :func:`test_bimodal_stable_payload_large`, payload bit for
  bit.
"""
import numpy as np
import pytest

import flow_cases as fc
from tests.helpers import gen_bimodal
from tests.test_torch_device_flow import held


def _bimodal(name, n, dtype, shift):
    x = gen_bimodal(np.random.default_rng(fc.flow_seed(name)), n, np.dtype(dtype), shift)
    return held(name, keys=x)


@pytest.mark.parametrize("shift", [0, 16])
@pytest.mark.parametrize("n", [1_000_000, 2_500_000])
def test_bimodal_u32_large(n, shift):
    _bimodal(f"adv bimodal u32 {n} shift {shift}", n, "uint32", shift)


@pytest.mark.parametrize("shift", [0, 32])
def test_bimodal_u64_large(shift):
    _bimodal(f"adv bimodal u64 1500000 shift {shift}", 1_500_000, "uint64", shift)


@pytest.mark.parametrize("mask", fc.MASKS, ids=lambda m: f"0x{m:08X}")
def test_pattern_masks_large(mask):
    name = f"adv mask 0x{mask:08X}"
    x, _ = fc.flow_input(name)
    assert x.size == 2_000_000 and not (x & ~np.uint32(mask)).any()
    held(name)


def test_skew_outliers_large():
    name = "adv spike 5000000"
    x, _ = fc.flow_input(name)
    assert x.size == 5_000_000 and (x != 0x100).sum() == 5
    held(name)


def test_bimodal_stable_payload_large():
    name = "adv bimodal u64 payload stable"
    (k, p, _), = _bimodal(name, 1_000_000, "uint64", 32)
    x, v = fc.flow_input(name)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(k, x[order])
    np.testing.assert_array_equal(p, v[order])


@pytest.mark.parametrize("dtype,shift", [("uint32", 0), ("uint32", 16), ("uint64", 32),
                                         ("int16", 4), ("int64", 7)])
def test_chip_smoke_gen_bimodal_is_the_reference_s(dtype, shift):
    a = gen_bimodal(np.random.default_rng(5), 1001, np.dtype(dtype), shift)
    b = fc.gen_bimodal(np.random.default_rng(5), 1001, np.dtype(dtype), shift)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
