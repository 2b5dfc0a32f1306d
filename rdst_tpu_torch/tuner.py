"""Tuner: pluggable algorithm-selection policy driven by digit histograms.

Copy of ``rdst_tpu/tuner.py`` (pure Python; copied rather than imported
because importing ``rdst_tpu`` imports JAX).  What each Algorithm name
executes in the port is registered in ``rdst_tpu_torch/sorter.py``.

The reference's most distinctive API feature (reference: src/tuner.rs:1-35):
a pure function from ``(TuningParams, per-digit counts)`` to an ``Algorithm``.
We keep it as a user-pluggable policy evaluated on the host between jitted
stages — histograms are computed on device anyway, and 256 ints are cheap to
bring back.

The three built-in tuners reproduce the reference's decision ladders exactly
(src/tuners/standard_tuner.rs:14-63, low_memory_tuner.rs:16-44,
single_threaded_tuner.rs:15-43) — including the skew rule
``any(count) >= (len/256)*2`` for inputs >= 5_000. On TPU each Algorithm
names an execution *plan* (see rdst_tpu.sorts) rather than a thread
strategy; the thresholds still carve the same size/skew regimes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Protocol, Sequence, runtime_checkable

__all__ = [
    "Algorithm",
    "TuningParams",
    "Tuner",
    "StandardTuner",
    "LowMemoryTuner",
    "SingleThreadedTuner",
    "SingleAlgoTuner",
]


class Algorithm(enum.Enum):
    """The eight interchangeable sort plans (reference: src/tuner.rs:10-22).

    What each name EXECUTES on TPU (the authoritative registry is
    rdst_tpu/sorter.py:_register_default_plans, in the port
    rdst_tpu_torch/sorter.py; the mapping is
    measurement-driven, see BENCH_NOTES.md and scripts/probe9.py):
      COMPARATIVE    - XLA variadic sorting network (sorts/comparative.py)
      LSB, MT_LSB    - level-compacted packed stable sort (sorts/lsb.py)
      LR_LSB, SKA    - same compaction; SKA may run unstable
      RECOMBINATING,
      SCANNING       - level-compaction pre-pass into the comparative
                       network (the measured-fastest dense large-input
                       plan on TPU; compaction narrows or drops words
                       when the histogram allows)
      MT_OOP         - bucketed MSB partition + batched per-bucket row
                       sorts + ragged writeback (sorts/msb.py)
      REGIONS        - low-memory chunked sort + bitonic merge tree
                       (sorts/regions.py)
    """

    MT_OOP = "MtOop"
    MT_LSB = "MtLsb"
    SCANNING = "Scanning"
    RECOMBINATING = "Recombinating"
    COMPARATIVE = "Comparative"
    LR_LSB = "LrLsb"
    LSB = "Lsb"
    REGIONS = "Regions"
    SKA = "Ska"


#: Algorithms available in single-threaded (single-program) mode
#: (reference: src/tuner.rs:24-31 — the no-default-features enum).
SINGLE_PROGRAM_ALGORITHMS = frozenset(
    {Algorithm.COMPARATIVE, Algorithm.LR_LSB, Algorithm.LSB, Algorithm.SKA}
)


@dataclasses.dataclass(frozen=True)
class TuningParams:
    """Inputs to the tuning decision (reference: src/tuner.rs:1-8).

    ``threads`` becomes the number of parallel tiles/programs the plan may
    use (1 when the user forced single-program mode via
    ``with_parallel(False)``).
    """

    threads: int
    level: int
    total_levels: int
    input_len: int
    parent_len: int | None = None

    @property
    def depth(self) -> int:
        # depth 0 == top (most significant) level; reference computes
        # depth = total_levels - level - 1 (standard_tuner.rs:19).
        return self.total_levels - self.level - 1


@runtime_checkable
class Tuner(Protocol):
    def pick_algorithm(
        self, p: TuningParams, counts: Sequence[int]
    ) -> Algorithm: ...


def _is_skewed(p: TuningParams, counts: Sequence[int]) -> bool:
    """Skew rule: any digit holds >= 2x the uniform share
    (standard_tuner.rs:20-25)."""
    if p.input_len < 5_000:
        return False
    threshold = (p.input_len // 256) * 2
    return any(c >= threshold for c in counts)


class StandardTuner:
    """Default tuner (src/tuners/standard_tuner.rs:14-63)."""

    def pick_algorithm(self, p: TuningParams, counts: Sequence[int]) -> Algorithm:
        if p.input_len <= 128:
            return Algorithm.COMPARATIVE
        depth = p.depth
        if _is_skewed(p, counts):
            n = p.input_len
            if depth == 0:
                if n <= 200_000:
                    return Algorithm.LR_LSB
                if n <= 350_000:
                    return Algorithm.SKA
                if n <= 4_000_000:
                    return Algorithm.MT_LSB
                return Algorithm.REGIONS
            if n <= 200_000:
                return Algorithm.LR_LSB
            if n <= 800_000:
                return Algorithm.SKA
            if n <= 5_000_000:
                return Algorithm.RECOMBINATING
            return Algorithm.REGIONS
        n = p.input_len
        if depth > 0:
            if n <= 200_000:
                return Algorithm.LSB
            if n <= 800_000:
                return Algorithm.SKA
            if n <= 50_000_000:
                return Algorithm.RECOMBINATING
            return Algorithm.SCANNING
        if n <= 150_000:
            return Algorithm.LSB
        if n <= 260_000:
            return Algorithm.SKA
        if n <= 50_000_000:
            return Algorithm.RECOMBINATING
        return Algorithm.SCANNING


class LowMemoryTuner:
    """Prefers in-place / low-memory plans (src/tuners/low_memory_tuner.rs:16-44)."""

    def pick_algorithm(self, p: TuningParams, counts: Sequence[int]) -> Algorithm:
        if p.input_len <= 128:
            return Algorithm.COMPARATIVE
        n = p.input_len
        if _is_skewed(p, counts):
            if n <= 50_000:
                return Algorithm.LR_LSB
            if n <= 1_000_000:
                return Algorithm.SKA
            return Algorithm.REGIONS
        if n <= 50_000:
            return Algorithm.LSB
        if n <= 1_000_000:
            return Algorithm.SKA
        return Algorithm.REGIONS


class SingleThreadedTuner:
    """Single-program-only picks (src/tuners/single_threaded_tuner.rs:15-43)."""

    def pick_algorithm(self, p: TuningParams, counts: Sequence[int]) -> Algorithm:
        if p.input_len <= 128:
            return Algorithm.COMPARATIVE
        depth = p.depth
        if _is_skewed(p, counts):
            if p.input_len > 100_000 and depth < 2:
                return Algorithm.SKA
            return Algorithm.LR_LSB
        if p.input_len > 800_000 and depth == 0:
            return Algorithm.SKA
        return Algorithm.LSB


class SingleAlgoTuner:
    """Test-only tuner pinning one algorithm (reference: src/test_utils.rs:40-49).

    Makes the hybrid dispatcher deterministic for per-algorithm suites.
    """

    def __init__(self, algorithm: Algorithm):
        self.algorithm = algorithm

    def pick_algorithm(self, p: TuningParams, counts: Sequence[int]) -> Algorithm:
        return self.algorithm
