"""The port's small public helpers and package exports against the JAX
package's, and its config's environment overrides."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rdst_tpu.ops as jops
import rdst_tpu.sorts as jsorts
from rdst_tpu import keys as jkeys
from rdst_tpu.ops import prefix as jprefix
from rdst_tpu.ops import ragged_concat as jrc
import rdst_tpu_torch.ops as tops
import rdst_tpu_torch.sorts as tsorts
from rdst_tpu_torch import keys as tkeys
from rdst_tpu_torch.ops import prefix as tprefix
from rdst_tpu_torch.ops import ragged_concat as trc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float16", "uint32",
                                   "float32", "int64", "float64", "uint64"])
def test_num_levels(dtype):
    dt = np.dtype(dtype)
    x = np.zeros(3, dtype=dt)
    want = jkeys.num_levels(dt)
    assert tkeys.num_levels(dt) == want == tkeys.num_levels(x)
    assert tkeys.num_levels(torch.from_numpy(x)) == want
    assert tkeys.num_levels(torch.from_numpy(x).dtype) == want
    assert tkeys.num_levels(dt, width=3) == jkeys.num_levels(dt, width=3) == 3


@pytest.mark.parametrize("shape,axis", [((256,), -1), ((4, 256), -1), ((4, 256), 0)])
def test_end_offsets(shape, axis, rng):
    c = rng.integers(0, 1000, size=shape).astype(np.int32)
    got = tprefix.end_offsets(torch.from_numpy(c), axis)
    want = np.asarray(jprefix.end_offsets(c, axis))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    excl = tprefix.exclusive_prefix_sum(torch.from_numpy(c), axis)
    np.testing.assert_array_equal((got - excl).numpy(), c)


@pytest.mark.parametrize("host_lengths", [True, False])
def test_ragged_concat_rows(host_lengths, rng):
    B, cap = 16, 64
    src = rng.integers(0, 2**32, size=(B, cap), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, cap + 1, size=B).astype(np.int32)
    lengths[3] = 0
    for total in (int(lengths.sum()), int(lengths.sum()) + 7, int(lengths.sum()) - 5):
        lens = lengths if host_lengths else torch.from_numpy(lengths)
        got = trc.ragged_concat_rows(torch.from_numpy(src), lens, total)
        want = np.asarray(jrc.ragged_concat_rows(src, lengths, total))
        np.testing.assert_array_equal(got.numpy(), want)


def test_package_exports_match():
    assert tops.__all__ == jops.__all__
    assert tsorts.__all__ == jsorts.__all__
    for mod in (tops, tsorts):
        for name in mod.__all__:
            assert callable(getattr(mod, name))


@pytest.mark.parametrize("first", ["rdst_tpu_torch.ops", "rdst_tpu_torch.sorts",
                                   "rdst_tpu_torch.ops.rows", "rdst_tpu_torch.sorts.msb"])
def test_ops_and_sorts_import_first(first):
    """Each imported first, alone, without an import cycle."""
    subprocess.run([sys.executable, "-c", f"import {first}"], check=True,
                   timeout=120, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))


_OVERRIDES = [
    ("RDST_TPU_HOST_SORT_MAX", "12345", "host_sort_max", 12345),
    ("RDST_TPU_MAX_BUCKETED", "777", "max_bucketed_elements", 777),
    ("RDST_TPU_LOW_MEM_THRESHOLD", "4096", "low_mem_threshold_bytes", 4096),
    ("RDST_TPU_HIER_STAGE1_HEADROOM", "2.25", "hier_stage1_headroom", 2.25),
    ("RDST_TPU_REFINE_LEVELS", "0", "shuffle_refine_levels", 0),
    ("RDST_TPU_REPLICATE_CAP_MAX", "99", "replicate_capacity_max", 99),
    ("RDST_TPU_PRESORTED_MIN", "0", "presorted_merge_min", 0),
    ("RDST_TPU_WORK_PROFILES", "1", "work_profiles_enabled()", True),
]


def _read(knob, env):
    code = ("import sys; from rdst_tpu_torch import config; "
            f"print(repr(config.{knob})); assert 'jax' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=ROOT, env=env, check=True)
    return eval(r.stdout.strip())


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("RDST_TPU_")}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.mark.parametrize("var,value,knob,want", _OVERRIDES,
                         ids=[o[0] for o in _OVERRIDES])
def test_config_reads_jax_environment(var, value, knob, want):
    assert _read(knob, dict(_clean_env(), **{var: value})) == want


def test_config_defaults_without_environment():
    knobs = [o[2] for o in _OVERRIDES]
    code = ("from rdst_tpu_torch import config; print(repr(["
            + ", ".join(f"config.{k}" for k in knobs) + "]))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=ROOT, env=_clean_env(), check=True)
    got = dict(zip(knobs, eval(r.stdout.strip())))
    assert got["low_mem_threshold_bytes"] == 10 << 30
    assert got["max_bucketed_elements"] == 20_000_000
    assert got["hier_stage1_headroom"] == 1.5
    assert got["shuffle_refine_levels"] == 2
    assert got["replicate_capacity_max"] == 1 << 16
    assert got["presorted_merge_min"] == 1 << 17
    assert got["work_profiles_enabled()"] is False
    assert got["host_sort_max"] == 0  # the H100 crossover: off (config.py)
