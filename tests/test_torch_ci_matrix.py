"""Twin of ``tests/test_ci_matrix.py``: single-program builds, the
single-tile regression, determinism and payload configurations, through
the port against the JAX package on the CPU.

Each case is one entry of ``DEVICE_FLOW_CASES`` (``tests/flow_cases.py``;
the card's device-flow phase runs it at the same size on the H100) and is held by
``tests/test_torch_device_flow.py::held``: the port through
``flow_cases.flow_case`` with ``device="cpu"`` (plain versions), the JAX
package through ``flow_cases.flow_runs``, keys bit-equal to each other and
to the numpy oracle, stable payloads bit-equal, unstable payloads the same
(key, payload) multiset, and both ``(level) PLAN:`` traces equal to
``flow_cases.DEVICE_FLOW_TRACES``.  Both packages run with
``config.host_sort_max = 0``, the port's default: every case takes the
device flow, where the JAX test's small sizes took its host path under
``conftest.py``'s 2048 (the port's host path is held against the JAX
package's by ``test_torch_host.py``).

The JAX tests and what holds each here:

- ``test_single_program_build[dtype]`` (``with_parallel(False)``, 10
  dtypes at 8000) -> :func:`test_single_program_build`.
  ``test_torch_slice.py::test_builder_tuners_and_traces_match_jax[no_parallel]``
  holds one u64 input at N = 5000 only.
- ``test_single_tile_regression`` (129, 2048, 2049, 4095) ->
  :func:`test_single_tile_regression`, one case a size.
- ``test_determinism`` (LSB/SKA/REGIONS/COMPARATIVE, stable with a
  payload, at 100,000) -> :func:`test_determinism`: three runs of each
  plan in both packages, bitwise identical to each other and across the
  packages.  The card also runs them at 2^22 + 3 (above
  ``fused_min_elems``, so the fused executor is what must repeat);
  :func:`test_determinism_traces_above_fused_min_elems` holds that size's
  trace table against one JAX run a plan.  ``test_torch_slice.py::
  test_every_algorithm_plan_runs_and_matches_jax`` runs every plan once at
  N = 5000.
- ``test_f64_payload_stable_and_unstable`` (30,000 f64 with +-NaN, +-Inf,
  +-0, u64 payload) -> :func:`test_f64_payload_stable_and_unstable`.
- ``test_u64_payload_parity_with_host_oracle`` (200,000 u64 below 2^16, u32
  payload) -> :func:`test_u64_payload_parity_with_host_oracle`, against the
  port's native host runtime (``rdst_tpu_torch/native/host.py``) and the JAX
  package's.

``tests/test_no_x64.py`` is not ported: it tests JAX's ``jax_enable_x64``
flag (64-bit keys with x64 off), which has no meaning in torch, whose
64-bit dtypes need no flag.
"""
import numpy as np
import pytest

import flow_cases as fc
import rdst_tpu
from rdst_tpu import config as jconfig
from rdst_tpu.native import host as jhost
from rdst_tpu_torch.native import host as thost
from tests.test_torch_device_flow import held


@pytest.mark.parametrize("dtype", fc.FLOW_TYPES)
def test_single_program_build(dtype):
    (_, _, trace), = held(f"ci serial {dtype}")
    assert ("LrLsb" if dtype.startswith("float") else "Lsb") in trace


@pytest.mark.parametrize("n", [129, 2048, 2049, 4095])
def test_single_tile_regression(n):
    held(f"ci one tile {n}")


@pytest.mark.parametrize("algo", fc.DET_ALGOS)
def test_determinism(algo):
    runs = held(f"ci determinism {algo} 100000")
    assert len(runs) == fc.DET_RUNS == 3
    for k, p, _ in runs[1:]:
        np.testing.assert_array_equal(k, runs[0][0])
        np.testing.assert_array_equal(p, runs[0][1])


@pytest.mark.parametrize("algo", fc.DET_ALGOS)
def test_determinism_traces_above_fused_min_elems(algo):
    """The card's 2^22 + 3 determinism cases: one JAX run a plan gives the
    table's trace and the numpy oracle's result (the port's plain
    versions take ~30 s a run at this size on the CPU; the card runs it)."""
    name = f"ci determinism {algo} {(1 << 22) + 3}"
    x, v = fc.flow_input(name)
    (k, p, trace), = fc.flow_runs(rdst_tpu, jconfig, name, x, v, runs=1)
    assert trace == fc.DEVICE_FLOW_TRACES[name]
    fc.flow_check(name, x, v, k, p)


@pytest.mark.parametrize("stable", [True, False], ids=["stable", "unstable"])
def test_f64_payload_stable_and_unstable(stable):
    name = f"ci f64 payload {'stable' if stable else 'unstable'}"
    x, v = fc.flow_input(name)
    assert x.dtype == np.float64 and v.dtype == np.uint64
    assert np.isnan(x[:2]).all() and np.isinf(x[2:4]).all() and np.signbit(x[5])
    held(name)


def test_u64_payload_parity_with_host_oracle():
    name = "ci u64 payload host"
    (k, p, _), = held(name)  # flow_case holds it to the port's host runtime
    x, v = fc.flow_input(name)
    assert len(np.unique(x)) < x.size  # duplicates guaranteed
    hk, hv = thost.host_radix_sort(x.copy(), v.copy())
    jk, jv = jhost.host_radix_sort(x.copy(), v.copy())
    for a, b in ((k, hk), (p, hv), (k, jk), (p, jv)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
