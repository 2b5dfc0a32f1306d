"""MtOop plan: bucketed MSB partition (``rdst_tpu/sorts/msb.py``).

Not ported yet (ROADMAP A7).  The plan is registered so that a tuner or
``with_algorithm(Algorithm.MT_OOP)`` reaching it raises; no built-in tuner
picks MT_OOP.
"""
from __future__ import annotations

__all__ = ["bucketed_sort"]


def bucketed_sort(words, payloads, counts, *, stable=False, tuner=None,
                  parallel=True):
    raise NotImplementedError("bucketed MSB plan (MtOop): ROADMAP A7")
