"""Runtime knobs of the PyTorch port.

Counterpart of ``rdst_tpu/config.py``.  The knobs are plain module
attributes: set them at run time (the tests lower ``fused_min_elems`` so the
fused executor runs at small n).  There is no backend switch: a tensor's
device decides whether a kernel launches (CUDA) or its plain PyTorch version
runs (CPU), see ``rdst_tpu_torch/_build.py``.

Sizes taken over from the JAX package unchanged are parameters of the port,
not H100 measurements; PERF.md lists which ones have been re-derived.
"""
from __future__ import annotations

import contextlib

#: Below this many elements ``comparative_sort`` uses ``lex_sort`` instead of
#: the fused bitonic executor (``rdst_tpu/ops/pallas_sort.py`` MIN_ELEMS).
#: Kept at the JAX package's value until an H100 crossover is measured.
fused_min_elems = 1 << 21

#: Pieces of the piece-decomposition path below this length sort through
#: ``lex_sort``; larger ones run the power-of-two core
#: (``rdst_tpu/ops/pallas_sort.py`` MIN_PIECE).  A parameter, as above.
fused_min_piece = 1 << 20

#: Phase-0 row length of the fused executor: rows of this many elements sort
#: in one batched ``lex_sort`` before the bitonic merge levels
#: (``rdst_tpu/ops/pallas_sort.py`` ROW).  A parameter, as above.
row = 1 << 12

#: Shared memory one bitonic CTA may hold (bytes).  An H100 SM has 228 KB of
#: shared memory and a block may use at most 227 KB; half of that, less the
#: 1 KB the runtime reserves per block, keeps two CTAs resident per SM so one
#: CTA's loads overlap the other's compare-exchange stages.  Replaces the
#: v5e VMEM sizing of ``_pick_blocks`` (pallas_sort.py:98-118).
bitonic_smem_bytes = (227 * 1024) // 2 - 1024

#: Presorted-input advantage (``rdst_tpu/config.py`` presorted_merge_min):
#: a sorted prefix covering half the input is kept and only the suffix is
#: sorted, then merged.  A parameter, as above.
presorted_merge_min = 1 << 17

#: Working-set size (bytes, all operand planes) above which the Regions plan
#: would engage its chunked low-memory path.  The JAX package engages at
#: 2 GiB of a v5e's 16 GiB, i.e. when planes take 1/8 of device memory, since
#: the dense sort needs several times its planes in workspace.  The same
#: fraction of an H100's 80 GB is 10 GiB.  The chunked path itself is not
#: ported yet (ROADMAP A6), so above this size a Regions pick raises.
low_mem_threshold_bytes = 10 << 30

# work_profiles-equivalent: trace per-level algorithm picks
# (reference: Cargo.toml:18, src/sorter.rs:78-79).
_work_profiles = [False]


def work_profiles_enabled() -> bool:
    return _work_profiles[0]


@contextlib.contextmanager
def work_profiles(enabled: bool = True):
    old = _work_profiles[0]
    _work_profiles[0] = enabled
    try:
        yield
    finally:
        _work_profiles[0] = old
