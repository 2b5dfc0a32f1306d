"""Observability: algorithm-pick tracing, the port's spans, and the
profiler helper.

Port of ``rdst_tpu/utils/trace.py``.  ``work_profiles`` prints each level's
algorithm pick (the reference's ``work_profiles`` feature, Cargo.toml:18,
sorter.rs:78-79).  :func:`span` names a stage of the sort call as a
``torch.profiler`` event (``rdst.<name>``), recorded only while a profiler
runs, so it shares the profiler's clock with the card's kernel and copy
records; :func:`traced` makes a whole function such a span.
:func:`profile_to` records the enclosed region with
``torch.profiler`` (host activity always, the card's kernels when CUDA is
present) and writes one Chrome-trace JSON file, which ``chrome://tracing``
or Perfetto opens; it needs no TensorBoard package.

The spans of one sort call (children indented under their parent):

    rdst.sort                     RadixSortBuilder.sort, the whole call
      rdst.keys.normalize         keys.normalize
        rdst.copy.h2d             a numpy array's upload
      rdst.sorter.run             Sorter.run
        rdst.histogram            B1 and its readback
          rdst.sync.histogram     the readback
        rdst.tuner.pick           the tuner's pick
        rdst.plan.<Algorithm>     the plan body, named as work_profiles
                                  prints the pick
          rdst.sync.msb_fetch                 the MtOop plan's one readback
          rdst.fused_sort                     one fused executor call
            rdst.fused_sort.phase0            a piece's phase-0 rows
            rdst.fused_sort.network           a piece's B2/B3 trips
            rdst.fused_sort.merge             the pieces' merge
      rdst.keys.denormalize       keys.denormalize, keys.denormalize_host
        rdst.sync.to_numpy        the keys' copy to numpy
      rdst.sync.to_numpy          each payload's copy to numpy

Every deliberate device-to-host read of the call is an ``rdst.sync.*``
span.  A child span belongs to the call whose ``rdst.sort`` span covers it
on the same thread.

The table engine's spans (``table/tpch.py``, ``parallel/dtable.py``,
``parallel/shuffle.py``, ``parallel/mesh.py``):

    rdst.query.q1, rdst.query.q18 a TPC-H query plan, the whole call
      rdst.table.filter           distributed_filter
      rdst.table.encode           an operator's key and payload encoding
        rdst.keys.normalize       the key words
      rdst.shuffle                distributed_sort, partition_exchange
        rdst.shuffle.sort.fused   a shard's sort on B2/B3 (-> rdst.fused_sort)
        rdst.shuffle.sort.lex     a shard's sort by lex_sort
        rdst.shuffle.plan         the window, histograms and assignment
        rdst.shuffle.exchange     the exchange (B6)
          rdst.sync.read_gathered a read across processes
      rdst.sync.capacity          an aggregate's or join's demand read
      rdst.table.aggregate        the segment reductions and the combine
      rdst.table.join             every shard's sort-merge join
      rdst.sync.read_gathered     the gathered group or match counts
      rdst.sync.densify           distributed_densify's counts
      rdst.table.densify          the valid rows made dense
        rdst.keys.denormalize     the key columns
"""
from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.autograd import profiler as _profiler

from rdst_tpu_torch.config import work_profiles, work_profiles_enabled

__all__ = ["work_profiles", "work_profiles_enabled", "profile_to", "span", "traced"]

#: What :func:`span` returns while no profiler runs.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``rdst.<name>`` as a ``torch.profiler`` event
    while a profiler runs, and enters nothing otherwise: the check costs
    well under a microsecond."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function("rdst." + name)


def traced(name: str):
    """Decorate a function so that each call is the span ``rdst.<name>``
    (the profiler is checked at every call, as :func:`span` does)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def profile_to(logdir: str):
    """Record the enclosed region and write its trace into ``logdir`` (made
    if missing).  Yields the path of the trace file, which is written when
    the region ends; the queued work of every card that holds memory of
    this process is waited for first, so every kernel the region launched,
    on any card of a mesh, has finished.  A card the process never used is
    not touched (waiting on it would give it a CUDA context).  The file
    holds the port's ``rdst.*`` spans beside torch's host operations and
    the cards' kernels, copies and sets."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"rdst_tpu_torch.{os.getpid()}.{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if cuda:
                for i in range(torch.cuda.device_count()):
                    if torch.cuda.memory_reserved(i) > 0:
                        torch.cuda.synchronize(i)
    prof.export_chrome_trace(path)
