"""Runtime knobs of the PyTorch port.

Counterpart of ``rdst_tpu/config.py``.  The knobs are plain module
attributes: set them at run time (the tests lower ``fused_min_elems`` so the
fused executor runs at small n).  There is no backend switch: a tensor's
device decides whether a kernel launches (CUDA) or its plain PyTorch version
runs (CPU), see ``rdst_tpu_torch/_build.py``.

Sizes taken over from the JAX package unchanged are parameters of the port,
not H100 measurements; PERF.md lists which ones have been re-derived.

The knobs the two packages share read the JAX package's environment
variables at import (``RDST_TPU_HOST_SORT_MAX``, ``RDST_TPU_MAX_BUCKETED``,
``RDST_TPU_LOW_MEM_THRESHOLD``, ``RDST_TPU_HIER_STAGE1_HEADROOM``,
``RDST_TPU_REFINE_LEVELS``, ``RDST_TPU_REPLICATE_CAP_MAX``,
``RDST_TPU_PRESORTED_MIN``, ``RDST_TPU_WORK_PROFILES``); the defaults are
the port's own.  Two variables have no counterpart:
``RDST_TPU_FORCE_INTERPRET``, because a CUDA kernel has no interpret mode
(a CPU tensor runs the plain version), and ``RDST_TPU_REMOTE_DMA``, because
the exchange here is always kernel B6 on CUDA shards.
"""
from __future__ import annotations

import contextlib
import os

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
presorted_merge_min = int(os.environ.get("RDST_TPU_PRESORTED_MIN", str(1 << 17)))

#: Working-set size (bytes, all operand planes) above which the Regions plan
#: engages its chunked low-memory path (``sorts/regions.py``
#: ``chunked_sort``).  The JAX package engages at 2 GiB of a v5e's 16 GiB,
#: i.e. when planes take 1/8 of device memory, since the dense sort needs
#: several times its planes in workspace.  The same fraction of an H100's
#: 80 GB is 10 GiB.
low_mem_threshold_bytes = int(
    os.environ.get("RDST_TPU_LOW_MEM_THRESHOLD", str(10 << 30))
)

#: The builder's host path (``builder.RadixSortBuilder._try_host_sort``): a
#: 1-D numpy input of at most this many elements, under a built-in tuner,
#: sorts on the C++ host runtime (``native/rdst_host.cpp``) instead of the
#: card.  0 disables.  Measured by ``chip_smoke.py``'s crossover phase
#: (numpy in and out, host clock, median of 5) on an NVIDIA H100 80GB HBM3 at
#: a 700.00 W power limit, with 8 cores of an Intel CPU (family 6, model 207;
#: its /proc/cpuinfo gives no model name): the host path was slower than the
#: device path at every power of two from 2 to 2^22 for
#: ``radix_sort_unstable`` (u32, u64, f64) and ``sort_key_value`` (u32 + u32,
#: stable) in each of three runs, e.g. 0.85 against 0.22 ms at 2 u32 keys
#: and 13.93 against 1.45 at 2^20; it beat only stable ``argsort`` of u64,
#: at some sizes up to 2^15, whose device path costs 2-7 ms there.  A
#: thread there took 0.26-0.90 ms to start and join, and the C++ sort
#: starts its threads twice in each byte pass.  So there is no
#: size at which the host path is no slower for every call, and the path is
#: off.  The JAX package's 2^18 was sized against a TPU's dispatch round
#: trip.
host_sort_max = int(os.environ.get("RDST_TPU_HOST_SORT_MAX", "0"))

#: Inputs longer than this skip the bucketed MSB plan (``sorts/msb.py``) for
#: the comparative one.  In the JAX package it bounds XLA compile time of the
#: padded-bucket graph; PyTorch compiles nothing, so here it only keeps the
#: port's plan choices, and its ``(msb) FALLBACK`` trace, equal to the JAX
#: package's.  Either plan gives the same sorted output.
max_bucketed_elements = int(
    os.environ.get("RDST_TPU_MAX_BUCKETED", str(20_000_000))
)

# The distributed shuffle (``parallel/shuffle.py``).  These three are
# algorithm parameters of ``rdst_tpu/config.py``, carried over unchanged.
# ``use_remote_dma_exchange`` has no counterpart: with every shard in one
# process the exchange always runs kernel B6 on CUDA shards and its plain
# version on CPU shards.

#: Stage-1 buffer of the 2-axis (host, chip) exchange, as a multiple of the
#: final capacity: skewed routing can funnel more than one chip's final
#: share through one chip column in stage 1.
hier_stage1_headroom = float(
    os.environ.get("RDST_TPU_HIER_STAGE1_HEADROOM", "1.5")
)

#: Hot-bucket refinement levels of the shuffle's partition (a fresh 16-bit
#: window over the hottest multi-key bucket per level); 0 disables.
shuffle_refine_levels = int(os.environ.get("RDST_TPU_REFINE_LEVELS", "2"))

#: ``partition_exchange`` of a dataset of at most this many rows gives every
#: shard full-table capacity, so a small table co-partitions against any skew.
replicate_capacity_max = int(
    os.environ.get("RDST_TPU_REPLICATE_CAP_MAX", str(1 << 16))
)

# work_profiles-equivalent: trace per-level algorithm picks
# (reference: Cargo.toml:18, src/sorter.rs:78-79).
_work_profiles = [os.environ.get("RDST_TPU_WORK_PROFILES", "0") not in ("0", "")]


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
