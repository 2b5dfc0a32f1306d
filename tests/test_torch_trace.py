"""The port's observability helpers (``rdst_tpu_torch.utils.trace``):
``profile_to`` writes a readable Chrome trace, ``work_profiles`` prints
the same algorithm picks as the JAX package's on the same input, and the
sort call's ``rdst.*`` spans nest as the module documents, recorded only
under a profiler."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import rdst_tpu as jrt
import rdst_tpu.utils as jutils
import rdst_tpu_torch as rt
from rdst_tpu_torch import config, keys, utils
from rdst_tpu_torch.sorter import Sorter
from rdst_tpu_torch.tuner import Algorithm
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


# ---------------------------------------------------------------------------
# The sort call's spans
# ---------------------------------------------------------------------------

#: Each span of one call and its documented parent (``utils/trace.py``);
#: ``PLAN`` stands for ``rdst.plan.<the pick>``.
PARENTS = {
    "rdst.sort": None,
    "rdst.keys.normalize": "rdst.sort",
    "rdst.keys.split_host": "rdst.keys.normalize",
    "rdst.copy.h2d": "rdst.keys.normalize",
    "rdst.sorter.run": "rdst.sort",
    "rdst.histogram": "rdst.sorter.run",
    "rdst.sync.histogram": "rdst.histogram",
    "rdst.tuner.pick": "rdst.sorter.run",
    "PLAN": "rdst.sorter.run",
    "rdst.fused_sort": "PLAN",
    "rdst.fused_sort.phase0": "rdst.fused_sort",
    "rdst.fused_sort.network": "rdst.fused_sort",
    "rdst.fused_sort.merge": "rdst.fused_sort",
    "rdst.keys.denormalize": "rdst.sort",
    "rdst.sync.to_numpy": "rdst.keys.denormalize",
}
NUMPY_ONLY = {"rdst.keys.split_host", "rdst.copy.h2d", "rdst.sync.to_numpy"}


@pytest.fixture
def executor(monkeypatch):
    """The fused executor at a CPU test's size."""
    monkeypatch.setattr(config, "fused_min_elems", 2048)
    monkeypatch.setattr(config, "fused_min_piece", 1024)


def _spans(fn):
    """``fn()``'s result, and its ``rdst.*`` spans under a CPU profiler as
    (name, parent span's name) in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = sorted((e.start_ns(), -e.end_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.name().startswith("rdst."))
    stack, spans = [], []
    for s, neg_end, name in ev:
        while stack and stack[-1][1] < s:
            stack.pop()
        spans.append((name, stack[-1][0] if stack else None))
        stack.append((name, -neg_end))
    return out, spans


def _u64(rng, n, high=2**64):
    return rng.integers(0, high, size=n, dtype=np.uint64)


def _call(x, kind):
    arg = x if kind == "numpy" else torch.from_numpy(x)
    return lambda: rt.radix_sort_unstable(arg, device="cpu")


def _as_numpy(out):
    return out if isinstance(out, np.ndarray) else out.numpy()


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_sort_call_spans_nest_as_documented(kind, rng, executor):
    """5000 keys: 5120 padded, pieces of 4096 and 1024, so the executor's
    merge runs too; the plan span is named by the pick work_profiles
    prints."""
    x = _u64(rng, 5000)
    buf = io.StringIO()
    with utils.work_profiles(True), contextlib.redirect_stdout(buf):
        out, spans = _spans(_call(x, kind))
    np.testing.assert_array_equal(_as_numpy(out), np.sort(x))
    (pick,) = [ln.split("PLAN: ")[1].split(" len=")[0]
               for ln in buf.getvalue().splitlines() if "PLAN:" in ln]
    plan = "rdst.plan." + pick
    want = {k for k in PARENTS if kind == "numpy" or k not in NUMPY_ONLY}
    named = {"PLAN" if n == plan else n for n, _ in spans}
    assert named == want
    for name, parent in spans:
        key = "PLAN" if name == plan else name
        assert parent == (plan if PARENTS[key] == "PLAN" else PARENTS[key]), name


@pytest.mark.parametrize("kind,syncs", [("tensor", 1), ("numpy", 2)])
def test_each_host_sync_is_one_span(kind, syncs, rng, executor):
    """The histogram's readback, and for numpy the result's copy back."""
    out, spans = _spans(_call(_u64(rng, 3000), kind))
    names = [n for n, _ in spans if n.startswith("rdst.sync.")]
    assert len(names) == syncs
    assert names[0] == "rdst.sync.histogram"


def test_msb_fetch_is_a_sync_span_of_its_plan(rng, executor):
    """The MtOop plan's one readback, inside its plan span."""
    x = _u64(rng, 5000)
    out, spans = _spans(lambda: rt.radix_sort_builder(x, device="cpu")
                        .with_algorithm(Algorithm.MT_OOP).sort())
    np.testing.assert_array_equal(out, np.sort(x))
    (parent,) = [p for n, p in spans if n == "rdst.sync.msb_fetch"]
    assert parent == "rdst.plan." + Algorithm.MT_OOP.value, spans


def test_each_payload_copy_is_a_sync_span(rng, executor):
    """Numpy keys with two payloads: the keys' copy in
    ``rdst.keys.denormalize``, each payload's in ``rdst.sort``."""
    x = _u64(rng, 3000)
    pay = [np.arange(3000, dtype=np.uint32), np.arange(3000, dtype=np.int32)[::-1].copy()]
    (ks, ps), spans = _spans(
        lambda: rt.radix_sort_builder(x, pay, device="cpu").with_stable().sort())
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(ks, x[order])
    for got, p in zip(ps, pay):
        np.testing.assert_array_equal(got, p[order])
    copies = [p for n, p in spans if n == "rdst.sync.to_numpy"]
    assert copies == ["rdst.keys.denormalize", "rdst.sort", "rdst.sort"]


@pytest.mark.parametrize("name", ["denormalize", "denormalize_host"])
def test_denormalize_is_its_span_for_any_caller(name, rng):
    """``keys.denormalize`` and ``denormalize_host`` called directly, not
    through the builder, still record ``rdst.keys.denormalize``."""
    x = _u64(rng, 100)
    nk = keys.normalize(x, device="cpu")
    out, spans = _spans(lambda: getattr(keys, name)(nk))
    np.testing.assert_array_equal(_as_numpy(out), x)
    assert spans[0] == ("rdst.keys.denormalize", None)
    assert {n for n, _ in spans} <= {"rdst.keys.denormalize", "rdst.sync.to_numpy"}


def test_traced_checks_the_profiler_at_each_call(monkeypatch):
    """A ``traced`` function keeps its name and docstring, records its span
    under a profiler, and enters nothing without one."""
    @trace.traced("probe")
    def probe(a, *, b):
        """doc"""
        return a + b

    assert (probe.__name__, probe.__doc__) == ("probe", "doc")
    assert _spans(lambda: probe(1, b=2)) == (3, [("rdst.probe", None)])

    def boom(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert probe(2, b=3) == 5


def test_spans_enter_nothing_without_a_profiler(rng, executor, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    x = _u64(rng, 3000)
    for kind in ("tensor", "numpy"):
        np.testing.assert_array_equal(_as_numpy(_call(x, kind)()), np.sort(x))
    with pytest.raises(AssertionError, match="record_function entered"):
        _spans(_call(x, "tensor"))


def test_profile_to_file_holds_the_spans(tmp_path, rng):
    x = _u64(rng, 3000)
    with utils.profile_to(str(tmp_path)) as path:
        rt.radix_sort_unstable(x, device="cpu")
    names = {e.get("name", "") for e in json.loads(open(path).read())["traceEvents"]}
    assert {"rdst.sort", "rdst.keys.normalize", "rdst.sorter.run",
            "rdst.sync.histogram", "rdst.keys.denormalize"} <= names


def test_profile_to_waits_on_every_card_in_use(tmp_path, monkeypatch):
    """Before export, the queue of each card that holds the process's
    memory is drained, not the current card's alone (a mesh's kernels on
    other cards must be in the file); a card it never used is not touched,
    so it gets no CUDA context."""
    synced = []

    class Prof:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            open(path, "w").write("{}")

    reserved = {0: 1 << 21, 1: 0, 2: 1 << 30}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: reserved[d])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    monkeypatch.setattr(torch.profiler, "profile", lambda **k: Prof())
    with utils.profile_to(str(tmp_path)):
        pass
    assert synced == [0, 2]
