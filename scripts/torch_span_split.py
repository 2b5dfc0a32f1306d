"""Split a call of the port by its own ``rdst.*`` spans, from one profiler
trace: the reading that ``torch_shuffle_stages.py``,
``torch_regions_stages.py`` and ``torch_table_stages.py`` share.

:func:`record` runs a call once inside ``utils.trace.profile_to`` (the
package's spans are recorded only under a profiler, and add no sync) and
reads the Chrome-trace file it writes with :func:`read`.  A device record
(kernel, copy or set) belongs to the spans that were open on the host
thread that launched it, at its launch: the launch and the record share a
correlation id.  :func:`report` prints

- the spans as a tree of name paths (a span inside another is a row under
  it; a span nested in one of its own name is a row of its own): calls,
  host time, and the device time of what was launched inside, each also
  as the part in no child span (the stage's own work, where a stage has no
  span of its own);
- the port's kernels by ID, with launches and device time: B1 ``hist``,
  B2 ``tail`` launched inside ``rdst.fused_sort``, B3 ``span``, B4
  ``merge_stage``, B5 ``tail`` launched outside it (B5 runs on B2's
  kernel), B6 ``exchange``, B7 ``merge_partition`` and ``merge_tile``, B8
  ``radix_pass``; then torch's kernels that took the most, copies and
  sets.

Times are in ms: host times on the host clock, device times the records'
durations, both from the profiled call (the profiler slows the host side).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import re
import time

#: The port's kernels in ``csrc/*.cu`` (all in an anonymous namespace), by
#: the stem of their name.
_KERNEL = re.compile(
    r"::(hist|tail|span|merge_stage|exchange|merge_partition|merge_tile|radix_pass)"
    r"_kernel\b")
_IDS = {"hist": "B1", "span": "B3", "merge_stage": "B4", "exchange": "B6",
        "merge_partition": "B7", "merge_tile": "B7", "radix_pass": "B8"}
_DEVICE = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "set"}
_LAUNCH = ("cuda_runtime", "cuda_driver")
SHUFFLE, EXCHANGE, SORT = "rdst.shuffle", "rdst.shuffle.exchange", "rdst.shuffle.sort."


@dataclasses.dataclass
class Span:
    name: str
    thread: tuple  # (pid, tid)
    start: float  # us
    end: float
    path: tuple = ()  # names from the outermost span down to this one
    host_child: float = 0.0  # us in its child spans
    device: float = 0.0  # us of device records launched inside it
    device_child: float = 0.0
    parent: int = -1  # its index among its thread's spans (by start), or -1


@dataclasses.dataclass
class Record:
    name: str
    kind: str  # kernel, copy or set
    start: float  # us
    end: float
    path: tuple  # the path of the innermost span open at its launch, or ()

    @property
    def kernel(self) -> str | None:
        """B1-B8 for a kernel of the port, else None."""
        m = _KERNEL.search(self.name) if self.kind == "kernel" else None
        if m is None:
            return None
        if m.group(1) == "tail":
            return "B2" if "rdst.fused_sort" in self.path else "B5"
        return _IDS[m.group(1)]


@dataclasses.dataclass
class Trace:
    spans: list
    records: list

    def by_path(self) -> dict:
        """path -> [calls, host us, host us in no child span, device us,
        device us in no child span], in the order the paths first start."""
        rows = {}
        for s in sorted(self.spans, key=lambda s: s.start):
            r = rows.setdefault(s.path, [0, 0.0, 0.0, 0.0, 0.0])
            r[0] += 1
            r[1] += s.end - s.start
            r[2] += s.end - s.start - s.host_child
            r[3] += s.device
            r[4] += s.device - s.device_child
        first = {p: i for i, p in enumerate(rows)}
        tree = sorted(rows, key=lambda p: [first[p[:i + 1]] for i in range(len(p))])
        return {p: rows[p] for p in tree}

    def busy_us(self) -> float:
        """The union of the device records' intervals."""
        busy, end = 0.0, float("-inf")
        for r in sorted(self.records, key=lambda r: r.start):
            if r.end > end:
                busy += r.end - max(r.start, end)
                end = r.end
        return busy


def read(path: str) -> Trace:
    """The ``rdst.*`` spans and the device records of a Chrome-trace file
    that ``torch.profiler`` wrote.  A ``rdst.shuffle.sort.*`` span is named
    ``... [local]`` before its shuffle's first exchange and ``... [finish]``
    after it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launches, spans, device = {}, [], []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat == "user_annotation" and e["name"].startswith("rdst."):
            spans.append(Span(e["name"], (e["pid"], e["tid"]), e["ts"], e["ts"] + e["dur"]))
        elif cat in _LAUNCH and "correlation" in args:
            launches[args["correlation"]] = ((e["pid"], e["tid"]), e["ts"])
        elif cat in _DEVICE:
            device.append(e)
    threads = collections.defaultdict(list)
    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        threads[s.thread].append(s)
    for ordered in threads.values():
        _nest(ordered)
    starts = {t: [s.start for s in ordered] for t, ordered in threads.items()}
    records = []
    for e in device:
        at = launches.get((e.get("args") or {}).get("correlation"))
        inner = None
        if at is not None and at[0] in threads:
            inner = _innermost(threads[at[0]], starts[at[0]], at[1])
        r = Record(e["name"], _DEVICE[e["cat"]], e["ts"], e["ts"] + e["dur"],
                   inner.path if inner else ())
        records.append(r)
        if inner is not None:
            inner.device += r.end - r.start
            ordered, i = threads[at[0]], inner.parent
            while i >= 0:
                ordered[i].device += r.end - r.start
                ordered[i].device_child += r.end - r.start
                i = ordered[i].parent
    return Trace(spans, records)


def _nest(ordered: list) -> None:
    """Give each span of one thread (by start, the longer first on a tie)
    its parent, its path and its children's host time, and name the
    shuffle's sorts by their side of its exchange."""
    stack, exchanged = [], set()
    for i, s in enumerate(ordered):
        while stack and ordered[stack[-1]].end <= s.start:
            stack.pop()
        shuffle = next((j for j in reversed(stack) if ordered[j].name == SHUFFLE), None)
        if shuffle is not None and s.name == EXCHANGE:
            exchanged.add(shuffle)
        if shuffle is not None and s.name.startswith(SORT):
            s.name += " [finish]" if shuffle in exchanged else " [local]"
        s.parent = stack[-1] if stack else -1
        s.path = (ordered[s.parent].path if stack else ()) + (s.name,)
        if stack:
            ordered[s.parent].host_child += s.end - s.start
        stack.append(i)


def _innermost(ordered: list, starts: list, t: float):
    """The innermost span of one thread open at time t, or None: the last
    to start at or before t, or the nearest of its enclosing spans that is
    still open."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and ordered[i].end < t:
        i = ordered[i].parent
    return ordered[i] if i >= 0 else None


def record(call, logdir: str):
    """Run ``call()`` once inside ``profile_to(logdir)``: (its result, the
    host-clock ms from its start until the card is done, the trace)."""
    import torch

    from rdst_tpu_torch.utils.trace import profile_to

    with profile_to(logdir) as path:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, wall, read(path)


def report(label: str, trace: Trace, wall_ms: float, top: int = 8) -> None:
    """Print the span tree and the kernels of one profiled call."""
    busy = trace.busy_us() / 1e3
    print(f"{label}: profiled call {wall_ms:.2f} ms (host clock); card busy {busy:.2f} ms "
          f"(idle share {1 - busy / wall_ms:.3f})")
    print(f"  {'span':<52} {'calls':>6} {'host ms':>10} {'own':>10} {'device ms':>10} "
          f"{'own':>10}")
    rows = trace.by_path()
    for p, (n, host, own, dev, dev_own) in rows.items():
        name = "  " * (len(p) - 1) + p[-1]
        print(f"  {name:<52} {n:>6} {host / 1e3:>10.3f} {own / 1e3:>10.3f} "
              f"{dev / 1e3:>10.3f} {dev_own / 1e3:>10.3f}")
    outside = sum(r.end - r.start for r in trace.records if not r.path) / 1e3
    top_host = sum(v[1] for p, v in rows.items() if len(p) == 1) / 1e3
    print(f"  {'outside every span (host: the final wait too)':<52} {'':>6} "
          f"{wall_ms - top_host:>10.3f} {'':>10} {outside:>10.3f}")
    kernels = collections.defaultdict(list)
    others = collections.Counter()
    for r in trace.records:
        k = r.kernel
        if k is not None:
            kernels[k].append(r.end - r.start)
        else:
            others[r.name[:60] if r.kind == "kernel" else f"({r.kind})"] += r.end - r.start
    for k in sorted(kernels):
        d = kernels[k]
        print(f"  kernel {k}: {len(d)} launches, {sum(d) / 1e3:.3f} ms of device time "
              f"(each {min(d) / 1e3:.4f}-{max(d) / 1e3:.4f})")
    for name, us in others.most_common(top):
        print(f"  other: {name}: {us / 1e3:.3f} ms")
