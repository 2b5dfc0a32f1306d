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

#: Shared memory one B2/B3 CTA may hold (bytes): all 227 KB a block may
#: have on an H100, so one CTA per SM.  It holds a staging tile of every
#: plane, into which the next tile's copies land while the current one is
#: compared in registers, and a one-plane u32 transpose buffer
#: (``csrc/bitonic.cu``); with at most 512 threads of ``fused_sort.ELEMS``
#: elements that sets ``fused_sort.pick_blocks``: 2^14 elements at 1-2
#: planes, 2^13 at 3-4, 2^12 at 5-7, 2^11 at 8.  Measured against half of
#: it less 1 KB (two CTAs per SM, blocks of 2^13 at 2 planes and 2^12 at
#: 4-5) on an NVIDIA H100 80GB HBM3 at a 700 W power limit
#: (``scripts/torch_bitonic_ab.py --sizing``, medians of 5, two turns
#: each): ``fused_sort`` of 2^25 u64 keys 12.113 / 12.137 ms against
#: 12.377 / 12.390; with a u32 payload, stable (4 planes), 26.048 / 26.076
#: against 27.779 / 27.817; the shuffle's 5-plane finish sort of 1.5 x 2^25
#: rows 83.083 / 83.103 against 83.113 / 83.072 (the same blocks).  B5
#: (``fused_merge.pick_block``) runs on B2's kernel and takes B2's block.
#: Replaces the v5e VMEM sizing of ``_pick_blocks`` (pallas_sort.py:98-118).
bitonic_smem_bytes = 227 * 1024

#: Presorted-input advantage (``rdst_tpu/config.py`` presorted_merge_min):
#: a sorted prefix covering half the input is kept and only the suffix is
#: sorted, then merged.  A parameter, as above.
presorted_merge_min = 1 << 17

#: Working-set size (bytes, all operand planes) above which the Regions plan
#: engages its chunked low-memory path (``sorts/regions.py``
#: ``chunked_sort``).  The JAX package engages at 2 GiB of a v5e's 16 GiB,
#: i.e. when planes take 1/8 of device memory, since the dense sort needs
#: several times its planes in workspace.  The same fraction of an H100's
#: 80 GB is 10 GiB.
low_mem_threshold_bytes = 10 << 30

#: Inputs longer than this skip the bucketed MSB plan (``sorts/msb.py``) for
#: the comparative one.  In the JAX package it bounds XLA compile time of the
#: padded-bucket graph; PyTorch compiles nothing, so here it only keeps the
#: port's plan choices, and its ``(msb) FALLBACK`` trace, equal to the JAX
#: package's.  Either plan gives the same sorted output.
max_bucketed_elements = 20_000_000

# The distributed shuffle (``parallel/shuffle.py``).  These three are
# algorithm parameters of ``rdst_tpu/config.py``, carried over unchanged.
# ``use_remote_dma_exchange`` has no counterpart: with every shard in one
# process the exchange always runs kernel B6 on CUDA shards and its plain
# version on CPU shards.

#: Stage-1 buffer of the 2-axis (host, chip) exchange, as a multiple of the
#: final capacity: skewed routing can funnel more than one chip's final
#: share through one chip column in stage 1.
hier_stage1_headroom = 1.5

#: Hot-bucket refinement levels of the shuffle's partition (a fresh 16-bit
#: window over the hottest multi-key bucket per level); 0 disables.
shuffle_refine_levels = 2

#: ``partition_exchange`` of a dataset of at most this many rows gives every
#: shard full-table capacity, so a small table co-partitions against any skew.
replicate_capacity_max = 1 << 16

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
