"""The port's root entry points, ``torch_bench.py`` and
``torch_graft_entry.py``, against ``bench.py`` and ``__graft_entry__.py``, on
the CPU at small sizes.

The JAX side runs in this process on the virtual 8-device CPU mesh of
``conftest.py``; the port runs its plain versions on CPU tensors.  Both get
the same numpy inputs.  bench.py's step is a closure, so the test runs its
expression (checked against bench.py's source) under ``jax.jit``.  Where a
``main`` is compared, the timed calls are one stub in both modules, so the
printed lines are compared as strings.  ``dryrun_multichip`` returns
nothing; the JAX side's step outputs are recorded by wrapping the functions
it calls.

Tolerances: none.  Every step output is bit-equal: sorted keys and stable
payloads in order, each shard's valid rows and the counts, every table
column in order; the keys-only unstable sorts are compared as their sorted
keys, which is their multiset.
"""
import contextlib
import inspect
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdst_tpu.parallel as jparallel
import torch_bench as tb
import torch_graft_entry as tge
from rdst_tpu.parallel import dtable as jdtable
from rdst_tpu.parallel.shuffle import gather_valid as jgather
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.parallel import gather_valid as tgather

_saved_path = list(sys.path)
import __graft_entry__ as jge  # noqa: E402
import bench as jb  # noqa: E402

sys.path[:] = _saved_path

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = "w * np.uint32(2654435761) + np.uint32(i + 1)"


def _np(x):
    if isinstance(x, torch.Tensor):
        return P.sview(x).numpy().view(np.uint32) if x.dtype == torch.uint32 else x.numpy()
    return np.asarray(x)


def _equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# -- (a) the chained steps ----------------------------------------------------


def _jax_chain(words, steps):
    """bench.py:31-35's step, chained ``steps`` times inside one jit as
    bench.py's ``many`` chains it."""
    from rdst_tpu.engine import sort_words

    def step(ws):
        ws = [w * np.uint32(2654435761) + np.uint32(i + 1)
              for i, w in enumerate(ws)]
        return tuple(sort_words(ws, plan="auto")[0])

    @jax.jit
    def many(ws):
        return jax.lax.fori_loop(0, steps, lambda i, a: step(list(a)), tuple(ws))

    return many([jnp.asarray(w) for w in words])


def test_step_is_bench_py_s():
    """The expression :func:`_jax_chain` runs is the one in both of
    bench.py's harnesses."""
    for fn in (jb._bench_sort_words, jb._bench_sort_words_donated):
        assert STEP in inspect.getsource(fn)


def test_rehash_matches_uint32_arithmetic():
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x9E3779B1], np.uint32)
    w = np.concatenate([edge, np.random.default_rng(5).integers(0, 2**32, 4096,
                                                                dtype=np.uint32)])
    for i in range(3):
        want = (w.astype(np.uint64) * np.uint64(2654435761) + np.uint64(i + 1)) \
            & np.uint64(0xFFFFFFFF)
        got = tb._rehash(torch.from_numpy(w), i)
        assert got.dtype == torch.uint32
        _equal(got, want.astype(np.uint32), f"word {i}")


@pytest.mark.parametrize("n_words", [1, 2])
def test_chained_steps_match_bench_py(n_words):
    rng = np.random.default_rng(42)
    words = [rng.integers(0, 2**32, size=1 << 12, dtype=np.uint32)
             for _ in range(n_words)]
    want = _jax_chain(words, 3)
    tw = [torch.from_numpy(w) for w in words]
    got = tb._many(list(tw), 3, "auto")
    assert len(got) == n_words
    for i, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"word {i}")
    for t, w in zip(tw, words):  # the caller's words are untouched
        _equal(t, w, "input")


@pytest.mark.parametrize("n_words", [1, 2])
def test_last_step_check(n_words, capsys):
    rng = np.random.default_rng(6)
    x = [torch.from_numpy(rng.integers(0, 2**32, 1 << 12, dtype=np.uint32))
         for _ in range(n_words)]
    tb._check_last_step(list(x), "auto")
    assert "bit-equal to torch.sort" in capsys.readouterr().err


def test_last_step_check_rejects_a_wrong_sort(monkeypatch):
    def wrong(ws, plan="auto"):
        return [[P.flip(w) for w in ws], []]

    monkeypatch.setattr(tb, "sort_words", wrong)
    x = [torch.arange(1, 4097, dtype=torch.int32).view(torch.uint32)]
    with pytest.raises(SystemExit, match="differs from torch.sort"):
        tb._check_last_step(x, "auto")


@pytest.mark.parametrize("donated", [False, True])
def test_bench_functions_run_and_check(donated, capsys, monkeypatch):
    """On a scripted host clock the rate is exactly bench.py's formula,
    ``n / ((t_many - t_once) / (iters - 1))``; a real clock around one
    sub-millisecond step can read a difference of 0 or less."""
    readings = [10.0, 10.5, 20.0, 21.25]  # t0, t0 + t_once, t0', t0' + t_many
    clock = iter(readings)
    monkeypatch.setattr(tb.time, "perf_counter", lambda: next(clock))
    fn = tb._bench_sort_words_donated if donated else tb._bench_sort_words
    n, iters = 1 << 12, 2
    kps = fn(n, n_words=2, iters=iters, device="cpu")
    assert next(clock, None) is None  # every reading taken
    t_once, t_many = readings[1] - readings[0], readings[3] - readings[2]
    assert kps == n / ((t_many - t_once) / (iters - 1))
    assert capsys.readouterr().err.count("bit-equal to torch.sort") == 1


# -- (b) the printed lines ----------------------------------------------------

RATE = 2734567890.4321


def _main_lines(module, argv, monkeypatch, raise_at=None, error=None):
    """``module.main()``'s standard output with both timed calls stubbed,
    and the stub's calls (n, words, iters, plan)."""
    calls = []

    def stub(default_iters):
        def fn(n, n_words, iters=default_iters, plan="auto", **_):
            calls.append((n, n_words, iters, plan))
            if n == raise_at:
                raise error
            return RATE
        return fn

    monkeypatch.setattr(module, "_bench_sort_words", stub(8))
    monkeypatch.setattr(module, "_bench_sort_words_donated", stub(3))
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main()
    return buf.getvalue().splitlines(), calls


FLAGS = [[], ["--n", "4096"], ["--sweep"], ["--sweep-large"],
         ["--sweep-large", "--try-2e30", "--planes", "1"], ["--plan", "lowmem"]]


@pytest.mark.parametrize("argv", FLAGS, ids=[" ".join(a) or "default" for a in FLAGS])
def test_main_prints_bench_py_s_lines(argv, monkeypatch):
    want, want_calls = _main_lines(jb, argv, monkeypatch)
    got, got_calls = _main_lines(tb, argv + ["--device", "cpu"], monkeypatch)
    assert got == want
    assert got_calls == want_calls
    assert all(json.loads(line)["value"] == round(RATE) for line in got)


def test_main_records_out_of_memory(monkeypatch):
    argv = ["--sweep-large", "--try-2e30"]
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB")
    want, _ = _main_lines(jb, argv, monkeypatch, raise_at=1 << 30, error=oom)
    got, _ = _main_lines(tb, argv + ["--device", "cpu"], monkeypatch, raise_at=1 << 30,
                         error=oom)
    assert got == want
    assert json.loads(got[-1])["value"] == 0 and "OutOfMemoryError" in got[-1]


def test_main_raises_other_failures(monkeypatch):
    """bench.py records every exception of a large size as its line; the
    port records out-of-memory alone, and any other failure propagates."""
    argv = ["--sweep-large"]
    fault = RuntimeError("kernel failed to launch")
    want, _ = _main_lines(jb, argv, monkeypatch, raise_at=1 << 29, error=fault)
    assert "error" in json.loads(want[-1])
    with pytest.raises(RuntimeError, match="kernel failed"):
        _main_lines(tb, argv + ["--device", "cpu"], monkeypatch, raise_at=1 << 29,
                    error=fault)


# -- (c) entry() ----------------------------------------------------------------


def test_entry_matches_graft_entry():
    jfn, jargs = jge.entry()
    tfn, targs = tge.entry(device="cpu")
    for t, j in zip(targs, jargs):
        _equal(t, j, "input")
    for t, j in zip(tfn(*targs), jfn(*jargs)):
        _equal(t, j, "sorted")


# -- (d) dryrun_multichip ---------------------------------------------------------


def _jax_dryrun(n_devices, monkeypatch):
    """Run ``__graft_entry__.dryrun_multichip`` with the functions it calls
    wrapped; returns [(name, output or None where it raised OverflowError)]
    in call order."""
    rec = []

    def wrap(mod, name):
        real = getattr(mod, name)

        def fn(*a, **kw):
            try:
                out = real(*a, **kw)
            except OverflowError:
                rec.append((name, None))
                raise
            rec.append((name, out))
            return out
        monkeypatch.setattr(mod, name, fn)

    for name in ("distributed_sort", "distributed_sort_auto", "gather_valid"):
        wrap(jparallel, name)
    for name in ("distributed_group_aggregate", "distributed_filter", "distributed_join"):
        wrap(jdtable, name)
    jge.dryrun_multichip(n_devices)
    return rec


def _jax_steps(rec, n_devices):
    """The recorded calls as :func:`torch_graft_entry._dryrun_steps`'s dict."""
    names = [name for name, _ in rec]
    out = dict(zip(["sort", None, "aggregate", "filter", "join_range", "join_hash"],
                   [o for _, o in rec]))
    assert names[:6] == ["distributed_sort", "gather_valid", "distributed_group_aggregate",
                         "distributed_filter", "distributed_join", "distributed_join"]
    rest = rec[6:]
    if n_devices % 2 == 0:
        assert [nm for nm, _ in rest[:2]] == ["distributed_sort", "gather_valid"]
        out["sort_2d"] = rest[0][1]
        rest = rest[2:]
    assert rest[0][0] == "distributed_sort"
    tight = rest[0][1]
    rest = rest[1:]
    if tight is not None:
        assert rest[0][0] == "gather_valid"
        if rest[0][1] is None:
            tight = None
        rest = rest[1:]
    out["tight"] = None if tight is None else (tight[0], tight[2])
    assert [nm for nm, _ in rest] == ["distributed_sort_auto", "gather_valid"]
    out["auto"] = (rest[0][1][0], rest[0][1][2])
    return out


def _same_sort(want, got, what):
    """Counts, plane lengths and every shard's valid rows."""
    (ww, wp, wc), (gw, gp, gc) = want, got
    _equal(gc, wc, f"{what} counts")
    assert [int(p.shape[0]) for p in gw + gp] == [int(p.shape[0]) for p in ww + wp]
    dense_w = jgather(list(ww) + list(wp), wc)
    dense_g = tgather(list(gw) + list(gp), gc)
    for i, (g, w) in enumerate(zip(dense_g, dense_w)):
        _equal(g, w, f"{what} plane {i}")


def _same_table(want, got, what):
    (wt, wn), (gt, gn) = want, got
    assert int(gn) == int(wn), what
    assert gt.column_names == wt.column_names, what
    for c in wt.column_names:
        _equal(gt[c], wt[c], f"{what} column {c}")


def _joined_steps(steps):
    """A dryrun on several cards as on one: each per-card plane and table
    concatenated in card order."""
    from rdst_tpu_torch.table import Table

    def plane(p):
        return torch.cat(p) if isinstance(p, list) else p

    def table(t):
        if not isinstance(t, list):
            return t
        return Table({c: torch.cat([x[c] for x in t]) for c in t[0].column_names})

    out = {}
    for step, v in steps.items():
        if v is None:
            out[step] = None
        elif step in ("sort", "sort_2d"):
            out[step] = ([plane(p) for p in v[0]], [plane(p) for p in v[1]], v[2])
        elif step in ("tight", "auto"):
            out[step] = ([plane(p) for p in v[0]], v[1])
        else:
            out[step] = (table(v[0]), v[1])
    return out


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_dryrun_matches_graft_entry(n_devices, monkeypatch):
    want = _jax_steps(_jax_dryrun(n_devices, monkeypatch), n_devices)
    got = tge._dryrun_steps(n_devices, device="cpu")
    _check_dryrun(want, got, n_devices)
    assert tge.dryrun_multichip(n_devices, device="cpu") is None


def test_dryrun_on_card_entries_matches_graft_entry(monkeypatch):
    """``devices=["cpu"] * 4``: the reference's one shard a device becomes a
    block of two shards a card; every step, its per-card outputs joined in
    card order, is the JAX package's."""
    want = _jax_steps(_jax_dryrun(8, monkeypatch), 8)
    got = tge._dryrun_steps(8, device="cpu", devices=["cpu"] * 4)
    assert isinstance(got["sort"][0][0], list) and len(got["sort"][0][0]) == 4
    assert isinstance(got["aggregate"][0], list) and len(got["aggregate"][0]) == 4
    _check_dryrun(want, _joined_steps(got), 8)
    assert tge.dryrun_multichip(8, device="cpu", devices=["cpu"] * 4) is None


def _check_dryrun(want, got, n_devices):
    assert set(got) == set(want) - {None}
    _same_sort(want["sort"], got["sort"], "sort")
    for step in ("aggregate", "join_range", "join_hash"):
        _same_table(want[step], got[step], step)
    (wt, wc), (gt, gc) = want["filter"], got["filter"]
    _equal(gc, wc, "filter counts")
    _same_table((wt, 0), (gt, 0), "filter")
    if n_devices % 2 == 0:
        _same_sort(want["sort_2d"], got["sort_2d"], "sort_2d")
    assert (got["tight"] is None) == (want["tight"] is None), "tight capacity overflow"
    for step in ("tight", "auto") if got["tight"] is not None else ("auto",):
        (ww, wc), (gw, gc) = want[step], got[step]
        _same_sort((ww, [], wc), (gw, [], gc), step)


# -- (e) the card is the default ----------------------------------------------------


def test_entry_points_default_to_the_card():
    for fn in (tb._bench_sort_words, tb._bench_sort_words_donated, tge.entry,
               tge.dryrun_multichip, tge._dryrun_steps):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present: they would run")
def test_entry_points_refuse_cuda_without_a_card():
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = {"torch_bench.py": ["torch_bench.py"],
            "entry()": ["-c", "import torch_graft_entry as g; g.entry()"],
            "dryrun_multichip(8)": ["-c", "import torch_graft_entry as g; "
                                          "g.dryrun_multichip(8)"]}
    procs = {s: subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
             for s, args in runs.items()}
    try:
        for s, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode != 0 and "CUDA is not available" in stderr, s
            assert not stdout.strip(), s
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for call in (lambda: tb._bench_sort_words(1 << 12, 2),
                 lambda: tb._bench_sort_words_donated(1 << 12, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
