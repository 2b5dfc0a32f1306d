"""The port's observability helpers (``rdst_tpu_torch.utils.trace``):
``profile_to`` writes a readable Chrome trace, and ``work_profiles`` prints
the same algorithm picks as the JAX package's on the same input."""
import contextlib
import io
import json

import numpy as np
import pytest

import rdst_tpu as jrt
import rdst_tpu.utils as jutils
import rdst_tpu_torch as rt
from rdst_tpu_torch import config, keys, utils
from rdst_tpu_torch.sorter import Sorter
from rdst_tpu_torch.utils import trace


def test_reexports_are_the_config_knob():
    assert utils.work_profiles is config.work_profiles
    assert trace.work_profiles_enabled is config.work_profiles_enabled
    assert utils.profile_to is trace.profile_to
    with utils.work_profiles(True):
        assert config.work_profiles_enabled()
    assert not config.work_profiles_enabled()


def test_profile_to_writes_chrome_trace(tmp_path, rng):
    x = rng.integers(0, 2**64, size=1 << 14, dtype=np.uint64)
    nk = keys.normalize(x, device="cpu")
    logdir = tmp_path / "new" / "dir"
    with utils.profile_to(str(logdir)) as path:
        out, _ = Sorter().run(nk)
    files = list(logdir.iterdir())
    assert [str(f) for f in files] == [path]
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)  # no card here
    got = (out.words[0].numpy().astype(np.uint64) << np.uint64(32)) | \
        out.words[1].numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, np.sort(x))


def test_profile_to_passes_errors_through(tmp_path):
    """An error inside the region propagates and stops the profiler, so the
    next region records again."""
    with pytest.raises(ValueError):
        with utils.profile_to(str(tmp_path / "a")):
            raise ValueError("inside the region")
    with utils.profile_to(str(tmp_path / "b")) as path:
        rt.radix_sort_unstable(np.arange(5000, 0, -1, dtype=np.uint32), device="cpu")
    assert json.loads(open(path).read())["traceEvents"]


def _picks(pkg, fn):
    buf = io.StringIO()
    with pkg.work_profiles(True), contextlib.redirect_stdout(buf):
        fn()
    return [ln for ln in buf.getvalue().splitlines() if "PLAN:" in ln]


@pytest.mark.parametrize("case", ["u64", "u32_narrow", "sorted", "f32", "kv"])
def test_work_profiles_prints_jax_picks(case, rng):
    n = 1 << 15
    if case == "u64":
        x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    elif case == "u32_narrow":
        x = rng.integers(0, 2**12, size=n, dtype=np.uint64).astype(np.uint32)
    elif case == "sorted":
        x = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32))
    else:
        x = rng.standard_normal(n).astype(np.float32)
    if case == "kv":
        v = np.arange(n, dtype=np.uint32)
        ours = _picks(utils, lambda: rt.sort_key_value(x, v, stable=True, device="cpu"))
        theirs = _picks(jutils, lambda: jrt.sort_key_value(x, v, stable=True))
    else:
        ours = _picks(utils, lambda: rt.radix_sort_unstable(x, device="cpu"))
        theirs = _picks(jutils, lambda: jrt.radix_sort_unstable(x))
    assert ours and ours == theirs
