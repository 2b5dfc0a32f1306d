"""The program's own spans in a traced stretch, and the layer each belongs to.

``rdst_tpu_torch.utils.trace.span`` records stages of the sort call as
``torch.profiler`` events named ``rdst.<stage>``; ``bench_trace.read``
keeps them among the main thread's host events (``Reading.host``), on the
clock of the card's records.  A checkout without them (the program before
it had spans) gives an empty list, and each reader built on this returns
None there.

Layers (``layer`` in ``BENCHMARK.json``) by span name, the first rule that
matches: a name equal to an entry, or starting with it and a dot (an entry
ending in a dot: starting with it).
"""
from __future__ import annotations

import bisect

PREFIX = "rdst."
SYNC = "rdst.sync."
CALL = "rdst.sort"
RUN = "rdst.sorter.run"

LAYERS = (
    ("executor", ("rdst.fused_sort",)),
    ("plans", ("rdst.sorter.run", "rdst.histogram", "rdst.tuner.", "rdst.plan.")),
    ("api", ("rdst.sort", "rdst.keys.", "rdst.copy.")),
)


def _matches(name: str, entry: str) -> bool:
    if entry.endswith("."):
        return name.startswith(entry)
    return name == entry or name.startswith(entry + ".")


def layer_of(name: str) -> str | None:
    """``api``, ``plans`` or ``executor`` for a span name; None for a sync
    span or one no rule names."""
    if name.startswith(SYNC):
        return None
    for layer, entries in LAYERS:
        if any(_matches(name, e) for e in entries):
            return layer
    return None


def spans(p) -> list:
    """The stretch's ``rdst.`` spans, (name, start ns, end ns), by start."""
    return [h for h in p.host if h[0].startswith(PREFIX)]


def innermost(ordered: list, starts: list, t: int):
    """The innermost span of ``ordered`` (nested spans of one thread, by
    start; ``starts`` their starts) that covers t, or None: walking back
    from the last to start at or before t, the first that still runs at t."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and ordered[i][2] < t:
        i -= 1
    return ordered[i] if i >= 0 else None


def _profile(run):
    """The run's traced stretch if it holds calls and ``rdst.`` spans."""
    p = run.profile
    if p is None or not p.calls() or not spans(p):
        return None
    return p


def idle_ns_by_layer(p) -> dict:
    """Card idle ns in the stretch, summed over cards, by the layer of the
    innermost span that is not ``rdst.sync.*`` at each gap's midpoint, for
    gaps inside an ``rdst.sort`` span.  Idle time outside every
    ``rdst.sort`` span (between calls, the caller's own wait after a call)
    is in no layer."""
    found = spans(p)
    calls = [s for s in found if s[0] == CALL]
    stages = [s for s in found if not s[0].startswith(SYNC)]
    call_starts = [s[1] for s in calls]
    stage_starts = [s[1] for s in stages]
    out = {layer: 0 for layer, _ in LAYERS}
    for dev in p.devices():
        for a, b in p.gaps(dev):
            t = (a + b) // 2
            if innermost(calls, call_starts, t) is None:
                continue
            layer = layer_of(innermost(stages, stage_starts, t)[0])
            if layer is not None:
                out[layer] += b - a
    return out


def idle_ms_per_call(run, layer: str):
    """Card idle ms a call in ``layer`` (mean over cards), or None."""
    p = _profile(run)
    if p is None:
        return None
    return idle_ns_by_layer(p)[layer] / 1e6 / max(1, p.n_cards) / p.calls()


def api_host_ms_per_call(run):
    """Host ms a call in the API layer: each ``rdst.sort`` span's duration
    less that of the ``rdst.sorter.run`` spans inside it, or None."""
    p = _profile(run)
    if p is None:
        return None
    found = spans(p)
    calls = [(s, e) for name, s, e in found if name == CALL]
    if not calls:
        return None
    ns = sum(e - s for s, e in calls)
    for name, s, e in found:
        if name == RUN and any(c0 <= s and e <= c1 for c0, c1 in calls):
            ns -= e - s
    return ns / 1e6 / p.calls()


def syncs_per_call(run):
    """``rdst.sync.*`` spans a call, or None."""
    p = _profile(run)
    if p is None:
        return None
    return sum(1 for name, _, _ in spans(p) if name.startswith(SYNC)) / p.calls()
