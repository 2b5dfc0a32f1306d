"""Observability: algorithm-pick tracing and the profiler helper.

Port of ``rdst_tpu/utils/trace.py``.  ``work_profiles`` prints each level's
algorithm pick (the reference's ``work_profiles`` feature, Cargo.toml:18,
sorter.rs:78-79).  :func:`profile_to` records the enclosed region with
``torch.profiler`` (host activity always, the card's kernels when CUDA is
present) and writes one Chrome-trace JSON file, which ``chrome://tracing``
or Perfetto opens; it needs no TensorBoard package.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from rdst_tpu_torch.config import work_profiles, work_profiles_enabled

__all__ = ["work_profiles", "work_profiles_enabled", "profile_to"]


@contextlib.contextmanager
def profile_to(logdir: str):
    """Record the enclosed region and write its trace into ``logdir`` (made
    if missing).  Yields the path of the trace file, which is written when
    the region ends; the card's queued work is waited for first, so every
    kernel the region launched has finished."""
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
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
