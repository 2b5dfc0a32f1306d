"""The traced stretch and its reading, from ``torch.profiler``'s events.

A traced run profiles a short steady stretch right after its warm-up,
while the process is young (on the card's machine an old CUDA context has
been seen to drop the first kernels of a trace): one call outside the
stretch that the trace may drop, then the stretch, each call under a
``bench.op:<op>`` annotation and the whole under ``bench.stretch``, each
call ending when its result is ready, as in the window.

The reading keeps, per card, the device operations (kernels, copies,
sets) inside the stretch; busy time is the union of their intervals, idle
time the rest of the stretch.  Each idle gap is named by what the host
was doing at its midpoint: the call's annotation and the innermost host
operation (an aten op or a CUDA runtime call) that covers it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses



@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # kernel, copy or set
    device: int
    start: int  # ns
    end: int


@dataclasses.dataclass
class Reading:
    start: int  # ns: the stretch on the host's clock
    end: int
    ops: list  # (op, start ns, end ns): the stretch's calls
    device_ops: list  # DeviceOp, clipped to the stretch
    host: list  # (name, start ns, end ns): the main thread's host events, by start
    n_cards: int

    def __post_init__(self):
        self.host.sort(key=lambda h: h[1])
        self._starts = [h[1] for h in self.host]

    @property
    def window_ns(self) -> int:
        return self.end - self.start

    def calls(self) -> int:
        return len(self.ops)

    def busy_intervals(self, device: int) -> list:
        iv = sorted((d.start, d.end) for d in self.device_ops if d.device == device)
        merged = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def devices(self) -> list[int]:
        seen = sorted({d.device for d in self.device_ops})
        return seen + [None] * max(0, self.n_cards - len(seen))

    def busy_ns(self, device) -> int:
        if device is None:
            return 0
        return sum(b - a for a, b in self.busy_intervals(device))

    def mean_busy_ns(self) -> float:
        return sum(self.busy_ns(d) for d in self.devices()) / max(1, self.n_cards)

    def gaps(self, device) -> list:
        if device is None:
            return [(self.start, self.end)]
        out, t = [], self.start
        for a, b in self.busy_intervals(device):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def host_at(self, t: int) -> str:
        """The call and the innermost host operation covering time t (host
        events of one thread nest, so walking back from the last one to
        start before t, the first that still runs at t is the innermost)."""
        op = next((o[0] for o in self.ops if o[1] <= t <= o[2]), "between calls")
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self.host[i][2] < t:
            i -= 1
        return f"{op}: {self.host[i][0] if i >= 0 else 'python'}"

    def top_device_ops(self, k: int = 10) -> list:
        tot = collections.Counter()
        for d in self.device_ops:
            tot[d.name[:160]] += d.end - d.start
        return [[n, v / 1e9] for n, v in tot.most_common(k)]

    def top_idle(self, k: int = 10) -> list:
        tot, cnt = collections.Counter(), collections.Counter()
        for dev in self.devices():
            for a, b in self.gaps(dev):
                label = self.host_at((a + b) // 2)
                if dev is not None and self.n_cards > 1:
                    label = f"card {dev}, {label}"
                tot[label] += b - a
                cnt[label] += 1
        return [[f"{n} ({cnt[n]} gaps)", v / 1e9] for n, v in tot.most_common(k)]


def _get(e, attr, default=None):
    v = getattr(e, attr, None)
    if v is None:
        return default
    return v() if callable(v) else v


def _kind(e) -> str:
    """kernel, copy, set or annotation for a device event (by the
    activity type where this torch gives it, else by name)."""
    k = _get(e, "activity_type")
    if k is not None:
        k = str(k).split(".")[-1].lower()
        return {"kernel": "kernel", "gpu_memcpy": "copy",
                "gpu_memset": "set"}.get(k, "annotation")
    name = e.name()
    if _get(e, "is_user_annotation", False) or name.startswith("bench."):
        return "annotation"
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


def read(events, n_cards: int) -> Reading:
    """The stretch's reading from the profiler's kineto events."""
    events = list(events)
    stretch, ops, dev_ops, host = None, [], [], []
    main = None
    annotations = set()
    for e in events:
        if e.device_type().name != "CPU":
            continue
        name = e.name()
        if name == "bench.stretch":
            stretch = (e.start_ns(), e.end_ns())
            main = _get(e, "start_thread_id")
        if _get(e, "is_user_annotation", False) or name.startswith("bench."):
            annotations.add(name)
    if stretch is None:
        raise RuntimeError("the trace holds no bench.stretch annotation")
    a0, a1 = stretch
    for e in events:
        name, s, t = e.name(), e.start_ns(), e.end_ns()
        if e.device_type().name == "CUDA":
            kind = _kind(e)
            if kind == "annotation" or name in annotations:
                continue
            s, t = max(s, a0), min(t, a1)
            if t > s:
                dev_ops.append(DeviceOp(name, kind, e.device_index(), s, t))
        elif e.device_type().name == "CPU" and _get(e, "start_thread_id", main) == main:
            if name.startswith("bench.op:"):
                ops.append((name[len("bench.op:"):], s, t))
            elif t > a0 and s < a1 and not name.startswith("bench."):
                host.append((name, s, t))
    ops.sort(key=lambda o: o[1])
    return Reading(a0, a1, ops, dev_ops, host, n_cards)


def profile_stretch(state, call, ops, devs) -> Reading:
    """Profile one call outside the stretch, then ``ops`` inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if devs.cuda else [])
    with profile(activities=acts) as prof:
        out = call(state, ops[0])
        devs.sync()
        del out
        with record_function("bench.stretch"):
            for op in ops:
                with record_function(f"bench.op:{op}"):
                    out = call(state, op)
                    devs.sync()
                    del out
    return read(prof.profiler.kineto_results.events(), len(devs.physical))
