"""The benchmark's core: it finds a cell's files by name and drives one run.

Everything that belongs to one configuration, traffic mix, operation or
metric is a file of its own under this folder, found by the name that
``BENCHMARK.json`` or a cell's file gives:

    workloads/<cell>.json    the cell: its configuration, traffic, chips, why
    configs/<config>.json    the deployment's sizes and guarantees
    traffic/<traffic>.json   the mix's parameters, naming its ``kind``
    traffic/<kind>.py        the calls into the program, the answers kept,
                             the check and the control
    reference/<kind>.py      the inputs' generator and the plain reference,
                             which imports nothing of the program
    metrics/<metric>.py      ``read(run)``: the metric's value, or None
    bytes/<op>.py            ``necessary_bytes(shapes)``: one operation's
                             input columns read once, output columns written once

A run makes its inputs from the seed, warms every operation the mix uses,
then measures for ``seconds`` in a closed loop (one caller: each call is
timed on the host clock from its start until its result is ready),
holding a sample of the answers where the program left them (no copy in
the window): for each operation a few calls drawn from the seed over the
whole window, and its last call.  The peak memory is read call by call,
less the bytes of the answers held.  When the window has closed, the
program's state is dropped and the kind's plain reference judges every
held answer.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import random
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "rdst_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_file(name: str, root: Path = HERE) -> dict:
    return load_json(root / "workloads" / f"{name}.json")


def config_file(name: str, root: Path = HERE) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def traffic_file(name: str, root: Path = HERE) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


_MODULES: dict = {}


def module(folder: str, name: str, root: Path = HERE):
    """``<root>/<folder>/<name>.py``, loaded once by its path (names may
    hold dots, as a metric named ``dispatch_ms.serve`` would)."""
    path = (root / folder / f"{name}.py").resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} file {path}")
        spec = importlib.util.spec_from_file_location(
            f"bench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reported(manifest: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, and those without a list (a
    per-layer one then wherever its ``moves`` metric is reported)."""
    e2e = {m["name"] for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in manifest[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``rdst_tpu_torch`` passes."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


class Devices:
    """The cards a run uses (or CPU entries, where a test drives the run
    on the host): completion, and the peak memory of the fullest."""

    def __init__(self, devices):
        import torch

        self.torch = torch
        self.list = [torch.device(d) for d in devices]
        self.cuda = self.list[0].type == "cuda"
        self.physical = list(dict.fromkeys(self.list))

    def sync(self):
        if self.cuda:
            for d in self.physical:
                self.torch.cuda.synchronize(d)

    def reset_peak(self):
        if self.cuda:
            for d in self.physical:
                self.torch.cuda.reset_peak_memory_stats(d)

    def peaks(self) -> list[int]:
        if not self.cuda:
            return [0]
        return [self.torch.cuda.max_memory_allocated(d) for d in self.physical]

    def empty_cache(self):
        if self.cuda:
            self.torch.cuda.empty_cache()


@dataclasses.dataclass
class Span:
    op: str
    start: float  # host clock, s
    end: float
    rows: int
    ok: bool


class Sampler:
    """Which answers are kept for the reference.  For each operation,
    ``cap`` of its calls drawn from the seed over the whole window (a
    reservoir: the i-th call, counted from 0, takes the place of a kept
    one with chance cap / (i + 1)), and its last call.  Which calls are
    kept depends on the seed and the number of calls alone."""

    def __init__(self, seed: int, cap: int):
        self.seed, self.cap = seed, cap
        self.rng: dict[str, random.Random] = {}
        self.seen: dict[str, int] = {}
        self.drawn: dict[str, list] = {}  # op -> [(call index, answer)]
        self.last: dict[str, tuple] = {}

    def offer(self, op: str, answer) -> None:
        """The answer of ``op``'s next call."""
        if op not in self.rng:
            self.rng[op] = random.Random(f"{self.seed}:{op}")
            self.seen[op], self.drawn[op] = 0, []
        i = self.seen[op]
        self.seen[op] = i + 1
        if i < self.cap:
            self.drawn[op].append((i, answer))
        else:
            j = self.rng[op].randrange(i + 1)
            if j < self.cap:
                self.drawn[op][j] = (i, answer)
        self.last[op] = (i, answer)

    def kept(self) -> list:
        """(op, call index, answer) of every answer held, each call once."""
        out = []
        for op, drawn in self.drawn.items():
            idx = {i for i, _ in drawn}
            out += [(op, i, a) for i, a in sorted(drawn, key=lambda d: d[0])]
            if self.last[op][0] not in idx:
                out.append((op, *self.last[op]))
        return out

    def held_bytes(self) -> dict:
        """Device bytes of the answers held, by device."""
        return tensor_bytes([a for _, _, a in self.kept()])


@dataclasses.dataclass
class Run:
    """What a run hands its metric readers."""

    cell: str
    config: dict
    traffic: dict
    spans: list
    window_s: float
    setup_s: float
    peaks: list  # bytes, one per physical card
    op_bytes: dict  # op -> necessary bytes of one call
    profile: object = None  # bench_trace.Reading of the traced stretch, or None


def percentile(values, q: float) -> float:
    """The q-th percentile (0 <= q <= 100), linear between order statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    k = (len(xs) - 1) * q / 100
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def run_cell(cell: str, config: dict, traffic: dict, *, seed: int, seconds: float,
             trace: bool, devices, t_process: float, program: str = "port",
             root: Path = HERE, log=print) -> dict:
    """One run of ``cell``: set-up, warm-up, (the traced stretch), the
    window, then the reference.  ``program`` is ``"port"`` or
    ``"control"`` (the kind's reference at a lower precision in the
    port's place).  Returns the record the command prints."""
    kind = module("traffic", traffic["kind"], root)
    devs = Devices(devices)
    state = kind.setup(config, traffic, seed, devs)
    call = kind.call if program == "port" else kind.control_call
    op_bytes = {}
    for op in kind.ops(state):
        for j in range(traffic.get("warm_calls", 1)):
            if j == 0:
                out, picks = _with_picks(lambda: call(state, op))
                log(f"bench: tuner picks in {op}'s first call: {picks or 'none'}")
            else:
                out = call(state, op)
            devs.sync()
            shapes = kind.shapes(state, op, out)
            del out
        op_bytes[op] = module("bytes", op, root).necessary_bytes(shapes)
    log(kind.setup_note(state))

    reading = None
    if trace:
        from bench_trace import profile_stretch

        reading = profile_stretch(state, call, kind.trace_ops(state, traffic), devs)

    counters = _counters()
    setup_s = time.monotonic() - t_process
    devs.empty_cache()
    sampler = Sampler(seed, traffic["keep"])
    spans, errors = [], []
    held: dict = {}  # bytes of kept answers, a card
    peak = dict.fromkeys(devs.physical, 0)
    rows_of = kind.rows(state)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    for unit in kind.schedule(state, traffic, seed):
        if time.perf_counter() >= deadline:
            break
        for op in unit:
            devs.reset_peak()
            c0 = time.perf_counter()
            try:
                out = call(state, op)
                devs.sync()
                ok = True
            except Exception:  # a call that raises is a failed call; the loop goes on
                out, ok = None, False
                errors.append(traceback.format_exc())
            c1 = time.perf_counter()
            spans.append(Span(op, c0, c1, rows_of[op], ok))
            for d, p in zip(devs.physical, devs.peaks()):
                peak[d] = max(peak[d], p - held.get(d, 0))
            if ok:
                sampler.offer(op, kind.keep(state, op, out))
                held = sampler.held_bytes()
            del out
    window_s = time.perf_counter() - t0
    peaks = [peak[d] for d in devs.physical]
    log(_counters_note(counters))
    kind.release(state)
    devs.empty_cache()
    kept = [(op, answer) for op, _, answer in sampler.kept()]
    log(f"bench: answers judged, by call: {[(op, i) for op, i, _ in sampler.kept()]}")
    del sampler
    unjudged = [op for op in kind.ops(state) if op not in {k[0] for k in kept}]
    judged = kind.check(state, kept, devs)
    del kept
    if errors:
        log(f"bench: {len(errors)} calls raised; the first:\n{errors[0]}")
    return dict(
        run=Run(cell, config, traffic, spans, window_s, setup_s, peaks, op_bytes, reading),
        checks=judged["checks"],
        wrong_answers=judged["wrong_answers"],
        answers=judged["answers"],
        errors=len(errors),
        unjudged=unjudged,
    )


def tensor_bytes(obj, seen=None) -> dict:
    """Device bytes of the storages that ``obj`` (tensors in tuples, lists
    or dicts) holds, by device, each storage once."""
    import torch

    seen = set() if seen is None else seen
    out: dict = {}

    def add(d):
        for k, v in d.items():
            out[k] = out.get(k, 0) + v

    if isinstance(obj, torch.Tensor):
        st = obj.untyped_storage()
        if st.data_ptr() not in seen and obj.device.type == "cuda":
            seen.add(st.data_ptr())
            out[obj.device] = st.nbytes()
    elif isinstance(obj, dict):
        for v in obj.values():
            add(tensor_bytes(v, seen))
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            add(tensor_bytes(v, seen))
    return out


def _with_picks(fn):
    """``fn()`` with the tuner's picks traced (``work_profiles``): its
    result and the picks, counted by their line."""
    import collections
    import contextlib
    import io

    from rdst_tpu_torch import config

    buf = io.StringIO()
    with config.work_profiles(True), contextlib.redirect_stdout(buf):
        out = fn()
    picks = collections.Counter(line.split(" len=")[0] for line in buf.getvalue().splitlines()
                                if "PLAN:" in line)
    return out, dict(picks)


def _counters():
    """The program's kernel launch counters at the window's start."""
    from rdst_tpu_torch import _build

    return {k: v.launches for k, v in _build.KERNELS.items()}


def _counters_note(before) -> str:
    from rdst_tpu_torch import _build

    got = {k: v.launches - before.get(k, 0) for k, v in _build.KERNELS.items()}
    return f"bench: in the window, kernel launches {got}"


def judge(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def correct(res: dict) -> bool:
    """A run is correct when every compared number is within its limit, no
    call raised, and every operation had an answer judged."""
    return (judge(res["checks"]) and res["errors"] == 0 and not res["unjudged"]
            and res["answers"] > 0)


def metric_values(run: Run, metrics: list[dict], root: Path = HERE) -> dict:
    """Each metric's reader on the run; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in metrics:
        v = module("metrics", m["name"], root).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
