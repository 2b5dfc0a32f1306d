"""The port's examples (``examples/torch_*.py``) run on the CPU and print
the same numbers as the JAX package's examples on the same seed; the
port's profiling script runs at a small size."""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [
    "simple_usage",
    "single_threaded",
    "custom_tuner",
    "composite_keys",
    "impl_radix_key",
    "distributed_pipeline",
    "batched_rows",
]
_NUMBER = re.compile(r"0x[0-9a-f]+|-?(?:inf|nan)|-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")


def _run(args, **env_extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    r = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _numbers(text):
    """Every number printed, as a float (hex as its integer value)."""
    return [float(int(t, 16)) if t.startswith("0x") else float(t)
            for t in _NUMBER.findall(text)]


def test_every_jax_example_has_a_port():
    ours = sorted(f[len("torch_"):-3] for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.startswith("torch_") and f.endswith(".py"))
    assert ours == sorted(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_jax(name):
    ours = _run([os.path.join("examples", f"torch_{name}.py"), "--device", "cpu"])
    theirs = _run([os.path.join("examples", f"{name}.py")], JAX_PLATFORMS="cpu",
                  RDST_TPU_FORCE_INTERPRET="1")
    assert ours.strip() and _numbers(ours) == _numbers(theirs), (ours, theirs)


def test_profiling_script_runs(tmp_path):
    out = _run([os.path.join("scripts", "torch_profiling.py"), "--device", "cpu",
                "--n", "20000", "--sleep", "0", "--trace", str(tmp_path)])
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and f"trace written to {files[0]}; sorted 20000 ok" in out
    assert json.loads(files[0].read_text())["traceEvents"]
    assert "PLAN:" in out  # the warm-up's picks (above the host path's size)
