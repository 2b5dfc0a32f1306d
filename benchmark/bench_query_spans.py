"""The table engine's spans in a traced stretch of a query cell: card idle
time by the layer of the host's innermost span, and the shuffle's sorts
by route (``rdst_tpu_torch/utils/trace.py`` lists the spans).

A query is an ``rdst.query.*`` span.  Layers (``layer`` in
``BENCHMARK.json``) by the innermost span that is not ``rdst.sync.*``:

    shuffle     ``rdst.shuffle`` and ``rdst.shuffle.*``, ``rdst.fused_sort``
                and ``rdst.fused_sort.*``: parallel/shuffle.py and the
                executor and exchange it calls
    operators   ``rdst.table.*``, ``rdst.query.*`` and the key encoding the
                operators call, ``rdst.keys.*``: table/tpch.py,
                parallel/dtable.py, table/ops.py

A program without these spans (one from before them) gives None.
"""
from __future__ import annotations

import bench_spans

QUERY = "rdst.query."
LEX = "rdst.shuffle.sort.lex"
LAYERS = (
    ("shuffle", ("rdst.shuffle", "rdst.fused_sort")),
    ("operators", ("rdst.table", "rdst.query", "rdst.keys")),
)


def layer_of(name: str) -> str | None:
    if name.startswith(bench_spans.SYNC):
        return None
    for layer, roots in LAYERS:
        if any(name == r or name.startswith(r + ".") for r in roots):
            return layer
    return None


def _profile(run):
    """The run's traced stretch if it holds calls and ``rdst.query.*``
    spans."""
    p = run.profile
    if p is None or not p.calls():
        return None
    if not any(name.startswith(QUERY) for name, _, _ in bench_spans.spans(p)):
        return None
    return p


def idle_ns_by_layer(p) -> dict:
    """Card idle ns in the stretch, summed over cards, by the layer of the
    innermost span that is not ``rdst.sync.*`` at each gap's midpoint, for
    gaps inside an ``rdst.query.*`` span."""
    found = bench_spans.spans(p)
    queries = [s for s in found if s[0].startswith(QUERY)]
    stages = [s for s in found if not s[0].startswith(bench_spans.SYNC)]
    query_starts = [s[1] for s in queries]
    stage_starts = [s[1] for s in stages]
    out = {layer: 0 for layer, _ in LAYERS}
    for dev in p.devices():
        for a, b in p.gaps(dev):
            t = (a + b) // 2
            if bench_spans.innermost(queries, query_starts, t) is None:
                continue
            layer = layer_of(bench_spans.innermost(stages, stage_starts, t)[0])
            if layer is not None:
                out[layer] += b - a
    return out


def idle_ms_per_query(run, layer: str):
    """Card idle ms a query in ``layer`` (mean over cards), or None."""
    p = _profile(run)
    if p is None:
        return None
    return idle_ns_by_layer(p)[layer] / 1e6 / max(1, p.n_cards) / p.calls()


def lex_sorts_per_query(run):
    """``rdst.shuffle.sort.lex`` spans a query, or None."""
    p = _profile(run)
    if p is None:
        return None
    return sum(1 for name, _, _ in bench_spans.spans(p) if name == LEX) / p.calls()
