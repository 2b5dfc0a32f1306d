#!/usr/bin/env python3
"""Drive the PyTorch port (rdst_tpu_torch) on one CUDA card and check it.

Run from the checkout root:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card as nvidia-smi names it, and the kernel build;
  2. every kernel of the sort path against its plain PyTorch version on the
     card, at the shapes the single-card paths give it, bit for bit, with
     times from CUDA events (median of a few runs): B1 on uniform,
     presorted, all-equal, Zipf, one-hot, ragged and unaligned keys and at
     the piece path's 10M x 1 word (with ``torch.bincount`` timed beside its
     one-level use B1', a yardstick the port never calls), B2/B3, and the
     merge kernels B4/B5 at the chunked path's merge shape (2^25 x 4
     planes) and others, B5 in place too, B7 at the piece path's merges,
     and B8 at the passes of the 50M u64 sort and of narrower rows;
  3. the paths end to end through the public API, each driven with every
     launch count set to 0 just before it and read just after, each sorted
     bit-equal to numpy or to torch.sort, each printing its plan trace, time
     and rate:
       - 2^25 uniform u64 keys, a 10,000,000-pair stable u32 key-value sort
         and 2^22 f64 keys with +-NaN, +-0 and +-Inf (all on B8's radix
         passes);
       - ``Sorter.run`` on sorted 2^25 u64 keys on the card: keys that take
         the AlreadySorted short circuit (B1 alone) and uniform keys sorted;
       - the low-memory Regions path at the real gate: 2^30 int64 keys with
         int32 values on the card (12 GiB of planes, above the 10 GiB
         ``low_mem_threshold_bytes``), with its peak device memory, after
         B1 against its plain version on the keys' 2^30 x 2 planes, and
         then B8 against its plain version at every shape its chunk sorts
         gave it;
       - 20M u64 keys with the low-memory tuner and the gate forced open;
       - a presorted merge of 2^25 u64 keys whose first 15/16 are sorted;
       - the bucketed MtOop plan on 16M u32 key-value pairs, uniform and
         with one key holding half the rows;
       - the distributed shuffle on a mesh of 8 shards on the card, 2^25
         rows each: stable u64 + u32 payload (with its peak device memory),
         the same overlapped, one key on half the rows (unstable), a hot
         multi-key bucket that refines (2^26), and co-partitioning of a
         2^27-row dataset under a 2^28 sort's partition; each bit-exact
         against torch.sort on the card, with its balance (max count over
         the fair share); between them, the exchange kernel B6 against its
         plain version, pads, demand and arrivals included, with its
         launches per call, at the sizes the stable run sent (with the time
         of its launch alone, its kernel's device time and the host's time
         to enqueue it), at even aligned sizes, and on a random size matrix
         with empty segments and one overflowing receiver; and B2/B3 at
         every shape the stable run launched them with, B4/B5 at the
         overlapped run's merge shapes;
       - the table engine at TPC-H shape (``tpch_tables``: LINEITEM 2^26
         rows and ORDERS 2^24, SF ~11.2, made on the card) on the same
         mesh: Q1's ``distributed_filter``, Q18's inner aggregate through
         ``distributed_group_aggregate`` (hash and range), the
         lineitem-orders ``distributed_join`` (hash) and
         ``distributed_sort_table`` of orders; ``Table.filter``,
         ``group_aggregate``, ``join(orders)`` and ``sort_by`` on one
         shard's share; ``jit_api.sort`` and ``argsort`` on 2^25 u64 under
         ``torch.cuda.set_sync_debug_mode("error")``; ``batched_sort`` and
         ``batched_top_k`` on 4096 rows of 4096 u32 with a u32 payload.
         Each is bit-equal to an oracle of plain torch calls on the card
         (``torch.unique`` with ``index_add_``/``scatter_reduce_``,
         ``torch.sort`` with ``searchsorted``, boolean indexing, ``topk``),
         holds every plain version's count (none runs on a CUDA tensor),
         prints which of its shuffle sorts took B2/B3 and which
         ``lex_sort`` (``shuffle.SORT_ROUTES``), then runs three times more
         for its warm time (the median), rows per second and peak device
         memory; after the paths, B2/B3 at every shape the table paths
         launched them with and B6 at every exchange they made, each
         against its plain version;
       - the cards phase: the mesh over several card entries of this
         process (``cards_phase``): ``make_mesh(8, devices=[card] * 4)``
         (four streams on the one card) for the stable 2^28 shuffle, plain
         and overlapped, ``make_mesh_2d(2, 4)`` on 2 and 4 entries, and the
         table phase's TPC-H paths (filter, both aggregates, the hash join,
         ORDER BY), each driven with its launches counted and bit-equal to
         the same call on the one-entry mesh (read to the host first), with
         both warm times; then every multi-card B6 call's shape (one launch
         per receiving card) against the plain per-card form, its bound
         from the busiest card (words from other cards over NVLink's 450
         GB/s against its own reads and writes over HBM); where the machine
         has two or more cards, the same on every card with each pair's
         peer access, else one line saying that part did not run;
       - the native host runtime (``native/host.py``), built with g++: its
         sorts at 2^20 and 2^10 keys and its histogram against their numpy
         versions, and the time a thread takes to start;
       - the numpy calls: five calls of the builder, numpy in and out, at
         every power of two from 2 to 2^22 on the device path and at three
         sizes on the host path (``host_sort_max`` raised), each equal to
         numpy; the host path must launch no kernel;
       - the trace, in a fresh process (``chip_smoke.py --trace``): one
         ``Sorter.run`` of 2^25 u64 keys on the card inside
         ``utils.trace.profile_to``, whose trace must hold the B1, B2 and
         B3 kernels as often as their launches were counted;
       - the shuffle over processes (``init_distributed``), in fresh child
         processes on the one card (``chip_smoke.py --dist MODE RANK
         INIT``): one NCCL rank on ``make_mesh(8)`` and ``make_mesh_2d(1,
         8)`` at the stable 2^28 call; two gloo ranks, 4 shards each, at
         2^27 rows on ``make_mesh(8)``, ``make_mesh_2d(2, 4)`` and the
         overlapped exchange, whose exchanges cross processes and launch B6
         with 8 senders and 4 receivers (its launches, the transport's
         bytes, the size matrix's host reads and a split of the call into
         size read, staging, transport, B6 and sorts); the same two ranks
         each holding two entries of the card (``devices=[card] * 2``),
         whose exchanges land through B6's multi-card form, one call at
         least reading remote senders on card 0 into receivers on card 1,
         and every multi-card shape held, timed, against its plain per-card
         form; each bit-equal to torch.sort
         and to the one-process ``make_mesh(8)``; then the four table
         operators at the table phase's TPC-H shape (LINEITEM 2^26, ORDERS
         2^24, each rank passing its own rows): Q1's filter, Q18's
         aggregate (hash and range), the lineitem-orders hash join and
         ORDER BY on orders (on either gloo layout), each rank's rows and
         counts bit-equal to its shards' share of the one-process
         ``make_mesh(8)`` result and its
         count to the torch oracle's, with first and warm times, rows per
         second, peak device memory, launches, the transport and, over two
         ranks, a synchronized split; each rank then holds B6 at every
         (senders, receivers, planes, capacity) shape its counted calls
         launched, and B2-B5 and B8 at every shape they launched, against
         their plain versions; and two NCCL ranks on the one card, tried
         once, printing what NCCL answers inside its first collective (a
         finding, not a check; any failure before it fails the phase);
       - every ``examples/torch_*.py`` with ``--device cuda``, the
         measurement harnesses and the consumer fixture (``HARNESSES``),
         each in a fresh child (``chip_smoke.py --harness SCRIPT ARGS``),
         all started together, each of which must exit 0 and prints its
         rows: ``scripts/torch_bench_suite.py`` (configs c1-c6 at 10M, each
         step checked against torch.sort), ``torch_bench_single_algo.py``
         (the 21 rows at 2^22), ``torch_timings.py`` (2^16..2^22),
         ``torch_capacity_study.py`` (2^20 keys on 8 shards),
         ``torch_bench_mesh.py`` (2^20 rows a shard) and
         ``fixtures/torch_consumer.py``; each child records the shape of
         every kernel launch its script makes and afterwards holds B1 (each
         (words, levels) group's shortest and longest length), B2-B5 and
         B8 (every shape) and B6 (every shape, on a copy of its inputs) against their
         plain versions; their launches count on the paths;
       - the root entry points, each in a fresh child, one at a time (the
         2^30 sizes hold tens of GiB): ``torch_bench.py`` (``BENCH_RUNS``:
         the 2^25 headline, ``--plan lowmem``, ``--sweep``, and
         ``--sweep-large --try-2e30`` at 2 and 1 planes), every size
         printing a rate above 0 and its last step bit-equal to
         ``torch.sort``, except that an out-of-memory line at 2^30 is a
         finding printed with its peak device memory; then
         ``torch_graft_entry``'s ``entry()``, held against ``torch.sort``,
         and ``dryrun_multichip(n)`` for n = 1, 2, 4 and 8, each printing
         its launches and its shuffle sorts' routes; each child holds every
         kernel shape it launched against its plain version, as the
         harness children do;
       - the acceptance phase, each in a fresh child, one at a time
         (``ACCEPTANCE_RUNS``): ``scripts/torch_acceptance.py``, the JAX
         package's eleven acceptance checks at their sizes (u32 and u64 at
         50M, 20M u32, 20M u64 stable key-value, 20M f64 with NaN and Inf,
         Zipf 10M, u64 2^23 stable key-value, a (u16, f32) struct key at 4M,
         20M u64 on the low-memory plan with the gate forced, u64 2^27, and
         the distributed sort on a 1-shard mesh at 2^22), numpy in and out
         through the default dispatcher, each bit-equal to its numpy oracle,
         its results written to ``build/ACCEPT_torch_h100.json``; then
         ``scripts/torch_floor_table.py``, five shapes (2^25 x 2 keys, 10M x
         1 key, 10M 2 keys + payload unstable and stable, 10M u16 + u32 key
         + payload stable), each printing the dispatcher's time, the fused
         executor's raw, ``torch.sort``'s on the same planes, the bound and
         the executor's floor in ns per element; each child holds every
         kernel shape it launched against its plain version;
       - the device-flow phase, in a fresh child (``chip_smoke.py
         --device-flow``): the 52 cases of the JAX package's
         ``tests/test_ci_matrix.py``, ``test_device_flow.py`` and
         ``test_large_adversarial.py`` at their sizes
         (``tests/flow_cases.py``, which the CPU tests share:
         ``DEVICE_FLOW_CASES``, ``with_parallel(False)`` over 10 dtypes,
         the single-tile sizes, four pinned plans three times each, stable,
         at 100,000 and 2^22 + 3, f64 with a payload stable and unstable,
         u64 with a payload against the native host runtime, the default
         flow over 10 dtypes, the natural picks at 1.2M, 1M and 4.2M
         skewed and 50,000,001, bimodal, masked and spiked keys at 1M-5M),
         numpy in and out through the default entry points with
         ``config.host_sort_max = 0``, each with its launches counted from
         0, its PLAN trace equal to ``DEVICE_FLOW_TRACES`` (which the CPU
         tests hold to the JAX package's) and its result bit-equal to its
         numpy oracle; the child holds B1 at every length and B2-B5 and B8
         at every shape the cases launched against their plain versions;
  4. the launch counts, then one JSON line of the kernels, then the
     result line.  Its times are those of each kernel's most-launched shape
     on the shuffle (B2-B5), of B6 at the stable run's exchange, and of B1
     at 2^25 x 2 words.

Every check prints the kernel's bound beside its time: the bytes it must
move (each input read once, each output written once) over the HBM rate of
``benchmark/peaks.json`` (3.35 TB/s), or
its operations over 67 T/s (the data sheet's float32 rate outside the
tensor cores, standing in for 32-bit integer operations), whichever is
longer; for the compare-exchange kernels a compare-exchange is one compare
per key plane and two selects per plane.  No single PyTorch call computes
the function of any kernel at its main shape (multi-plane lexicographic
networks, an eight-level histogram with sortedness flags, a ragged exchange
with pad fill and counters), so every ``library_ms`` is null; B1's
one-level histogram, which ``torch.bincount`` does compute, is printed on
its own line.  After the sorts, ``Sorter.run``
on the 2^25 u64 headline keys runs under the profiler (its B2 and B3
totals), beside ``torch.sort`` of the same keys as int64 (a yardstick).

Exits non-zero, printing no result, when CUDA is absent, when the package is
not importable, or when any check fails.  Needs one card; uses no JAX.
"""
from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 20261016
REPS = 5
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark",
                       "peaks.json")) as _f:
    HBM = json.load(_f)["hbm_bytes_per_s"]  # bytes/s, the benchmark's figure
ALU = 67e12  # operations/s: float32 outside the tensor cores, for int32 too

# (kernel name, source, the Pallas call it replaces)
KERNEL_INFO = {
    "multi_level_histogram": (
        "rdst_tpu_torch/csrc/histogram.cu", "rdst_tpu/ops/histogram.py:180"),
    "bitonic_tail": (
        "rdst_tpu_torch/csrc/bitonic.cu", "rdst_tpu/ops/pallas_sort.py:267"),
    "bitonic_span": (
        "rdst_tpu_torch/csrc/bitonic.cu", "rdst_tpu/ops/pallas_sort.py:327"),
    "merge_stage": (
        "rdst_tpu_torch/csrc/merge.cu", "rdst_tpu/ops/pallas_merge.py:208"),
    "merge_tail": (
        "rdst_tpu_torch/csrc/bitonic.cu", "rdst_tpu/ops/pallas_merge.py:232"),
    "remote_exchange": (
        "rdst_tpu_torch/csrc/exchange.cu", "rdst_tpu/parallel/remote_dma.py:225"),
    "piece_merge": (  # no Pallas kernel: the XLA slice stages of _merge_asc_desc
        "rdst_tpu_torch/csrc/piece_merge.cu", "rdst_tpu/ops/pallas_sort.py:702"),
    "radix_pass": (  # no Pallas kernel: the networks' trips on rows of <= 64 key bits
        "rdst_tpu_torch/csrc/radix_pass.cu", "rdst_tpu/ops/pallas_sort.py (none)"),
}
#: A path's sorts run the fused executor: its radix passes (B8) on rows of at
#: most 8 key bytes and one payload plane, its network (B2/B3) on wider rows.
#: In a list of kernels a path must launch, a tuple is met by any one of its
#: kernels.
EXECUTOR = ("radix_pass", "bitonic_tail")


def not_launched(counts, need) -> list:
    """The entries of ``need`` (a kernel, or a tuple of which any one will
    do) that ``counts`` shows no launch of."""
    return [k for k in need
            if not any(counts[x] > 0 for x in ((k,) if isinstance(k, str) else k))]
GiB = 1 << 30
WARM_CALLS = 3  # timed calls of each table path after its first


def cuda_ms(torch, fn) -> float:
    """Median of REPS timed runs (CUDA events) after one warm-up run."""
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(ts) -> int:
    if not isinstance(ts, (list, tuple)):
        ts = [ts]
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a, b) -> int:
    """The largest absolute difference of two tensors or lists of them,
    which must match in dtype and shape."""
    import torch

    from rdst_tpu_torch import _planes as P

    if isinstance(a, torch.Tensor):
        a, b = [a], [b]
    err = 0
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"dtype/shape {x.dtype}{tuple(x.shape)} "
                                 f"vs {y.dtype}{tuple(y.shape)}")
        x, y = x.reshape(-1), y.reshape(-1)
        for s in range(0, x.numel(), LEAN_CHUNK):  # int64 temporaries of a chunk
            d = P.widen(x[s:s + LEAN_CHUNK]) - P.widen(y[s:s + LEAN_CHUNK])
            err = max(err, int(d.abs().max().item()))
    return err


def ce_ops(name, dtypes, n, args) -> int:
    """Operations of a compare-exchange launch: stages x n/2 pairs x (one
    compare per key plane + two selects per plane)."""
    if name == "bitonic_tail":
        _, nk, levels, _ = args
        stages = sum(s.bit_length() for _, s in levels)
    elif name == "bitonic_span":
        s_hi, s_lo, _, _, nk = args
        stages = (2 * s_hi // s_lo).bit_length() - 1
    elif name == "merge_stage":
        _, nk = args
        stages = 1
    else:
        block, nk = args
        stages = block.bit_length() - 1
    return stages * (n // 2) * (nk + 2 * len(dtypes))


def piece_merge_checks(torch, P, fs, planes_of, check):
    """B7 against its plain version at the piece path's merges: the 50M u64
    sort's (runs of 8Q and 4Q, Q = 2^22, two key planes; the kernels line's
    shape) and a 6-plane shard sort's (8Q + Q, Q = 2^21), then the same with
    mixed widths.  Bound: both runs read once, the merged run written once."""
    u8, u16, u32 = torch.uint8, torch.uint16, torch.uint32
    for la, lb, dtypes, n_keys in [(8 << 22, 4 << 22, (u32, u32), 2),
                                   (8 << 21, 1 << 21, (u32,) * 6, 5),
                                   (8 << 21, 1 << 21, (u32, u16, u32, u8, u32, u32), 5)]:
        a = P.lex_sort(planes_of(la, dtypes), n_keys)
        b = P.lex_sort(planes_of(lb, dtypes), n_keys)
        widths = "+".join(str(d).split(".")[-1] for d in dtypes)
        check("piece_merge", f"{la} + {lb} x {widths}, {n_keys} keys",
              lambda: fs.piece_merge_cuda(a, b, n_keys),
              lambda: fs.piece_merge_plain(a, b, n_keys), main_shape=la == 8 << 22)
        del a, b


def radix_case(torch, rs, H, planes, n_keys, byte):
    """(kernel, plain) of one B8 pass on ``planes``: the level's counts come
    from one B1 launch outside the timed call, and the launch zeroes its
    scratch (one memset) and runs B8."""
    counts = H.histogram_cuda(rs.hist_words(planes[:n_keys]), 1, byte)
    scratch = rs.pass_scratch(int(planes[0].shape[0]), planes[0].device)
    outs = [torch.empty_like(p) for p in planes]
    return (lambda: rs.radix_pass(planes, outs, n_keys, byte, counts, scratch),
            lambda: rs.radix_pass_plain(planes, n_keys, byte))


def radix_checks(torch, P, rs, H, planes_of, check):
    """B8 against its plain version at the main path's shapes: passes of the
    50M u64 sort (two u32 key planes: the lowest byte, the kernels line's
    shape, and the top byte), of ``sort_key_value``'s 10M u32 key and u32
    payload, of narrow planes (u8+u16+u32 keys, u16 payload), and of u64
    keys with a u32 payload at the distributed sort's local sorts (2^25
    rows) and the low-memory Regions sort's chunk sorts (2^28 rows), at the
    lowest and the top byte.  Bound: every plane read once and written
    once."""
    u8, u16, u32 = torch.uint8, torch.uint16, torch.uint32
    for n, dtypes, n_keys, byte in [(50_000_000, (u32, u32), 2, 0),
                                    (50_000_000, (u32, u32), 2, 7),
                                    (10_000_000, (u32, u32), 1, 3),
                                    (1 << 24, (u8, u16, u32, u16), 3, 6),
                                    (1 << 25, (u32, u32, u32), 2, 0),
                                    (1 << 25, (u32, u32, u32), 2, 7),
                                    (1 << 28, (u32, u32, u32), 2, 0),
                                    (1 << 28, (u32, u32, u32), 2, 7)]:
        planes = planes_of(n, dtypes)
        kernel, plain = radix_case(torch, rs, H, planes, n_keys, byte)
        widths = "+".join(str(d).split(".")[-1] for d in dtypes)
        check("radix_pass", f"{n} x {widths}, {n_keys} keys, byte {byte}", kernel,
              plain, main_shape=n == 50_000_000 and byte == 0)
        del planes, kernel, plain
        torch.cuda.empty_cache()


def plain_route(fm, fn):
    """Run ``fn`` with the merge wrappers routed to their plain versions:
    the same stage schedule on the same card, for a composite's check."""
    saved = fm.merge_stage_call, fm.merge_tail_call
    fm.merge_stage_call = lambda pl, n, s, k, in_place=False: \
        fm.merge_stage_plain(list(pl), n, s, k)
    fm.merge_tail_call = lambda pl, n, b, k, in_place=False: \
        fm.merge_tail_plain(list(pl), n, b, k)
    try:
        return fn()
    finally:
        fm.merge_stage_call, fm.merge_tail_call = saved


@contextlib.contextmanager
def record_shapes(fs, fm, seen):
    """While a path runs, count the launches of B2-B5 and B8 by their
    arguments: ``seen[kernel][(dtypes, n, *args)]`` (B8's args: its key
    planes and key byte).  Only dtypes and integers are kept, no tensors,
    so the path's time is unchanged."""
    from rdst_tpu_torch.ops import radix_sort as rs

    targets = [("bitonic_tail", fs, "tail_cuda"), ("bitonic_span", fs, "span_cuda"),
               ("merge_stage", fm, "merge_stage_cuda"),
               ("merge_tail", fm, "merge_tail_cuda"), ("radix_pass", rs, "radix_pass")]
    saved = [getattr(mod, attr) for _, mod, attr in targets]

    def note(name, sig):
        book = seen.setdefault(name, {})
        book[sig] = book.get(sig, 0) + 1

    def wrap(name, real):
        def fn(planes, n, *args, **kw):
            note(name, (tuple(p.dtype for p in planes), n) + tuple(
                tuple(a) if isinstance(a, list) else a for a in args))
            return real(planes, n, *args, **kw)
        return fn

    def wrap_radix(real):
        def fn(src, dst, n_keys, byte, *args):
            note("radix_pass", (tuple(p.dtype for p in src), int(src[0].shape[0]),
                                n_keys, byte))
            return real(src, dst, n_keys, byte, *args)
        return fn

    for (name, mod, attr), real in zip(targets, saved):
        setattr(mod, attr, wrap_radix(real) if name == "radix_pass" else wrap(name, real))
    try:
        yield seen
    finally:
        for (_, mod, attr), real in zip(targets, saved):
            setattr(mod, attr, real)


# planes above this many bytes are held against the plain version chunk by
# chunk (the plain version of 2^30 x 2 planes needs more than the card)
LEAN_BYTES = 6 * GiB
LEAN_CHUNK = 1 << 26


def _chunk_local(name, n, args, chunk) -> bool:
    """True when the plain version of a B2/B3 launch, run on each aligned
    ``chunk`` of the planes alone, computes what it computes on all ``n``:
    every compare-exchange pair and every direction bit (the index bits
    above a run's length) lies inside a chunk."""
    if n % chunk or name not in ("bitonic_tail", "bitonic_span"):
        return False
    if name == "bitonic_tail":
        block, _, levels, unflip = args
        top = max([block.bit_length() - 1, unflip or 0] + [lg for lg, _ in levels])
    else:
        s_hi, _, two_r, block, _ = args
        top = max(block, 2 * s_hi, two_r).bit_length() - 1
    return top + 1 <= chunk.bit_length() - 1


def _chunked_plain(plain, planes, n, args, chunk):
    """``plain`` on each aligned ``chunk`` of ``planes`` alone, written into
    one output of the full length."""
    import torch

    from rdst_tpu_torch import _planes as P

    out = [torch.empty_like(p) for p in planes]
    for s in range(0, n, chunk):
        got = plain([p[s:s + chunk] for p in planes], chunk, *args)
        for o, g in zip(out, got):
            P.sview(o[s:s + chunk]).copy_(P.sview(g))
    return out


def check_recorded(fs, fm, seen, planes_of, check, main=True):
    """Each kernel against its plain version at the shapes a path gave it:
    one case per (plane dtypes, length), the widest span trip or stride of
    that shape, on fresh random planes (the networks are oblivious, so
    data does not change their work).  With ``main``, each kernel's
    most-launched shape gives the kernels line its times.  The kernel runs
    at the recorded shape; above ``LEAN_BYTES`` of planes, where the
    launch's pairs and directions lie within aligned chunks of
    ``LEAN_CHUNK``, the plain version runs chunk by chunk.  B8 is held at
    every recorded (dtypes, length, key planes, byte), on B1's counts of
    the same planes, and leaves the kernels line to :func:`radix_checks`."""
    import torch

    from rdst_tpu_torch.ops import histogram as H
    from rdst_tpu_torch.ops import radix_sort as rs

    fns = {"bitonic_tail": (fs.tail_cuda, fs.tail_plain),
           "bitonic_span": (fs.span_cuda, fs.span_plain),
           "merge_stage": (fm.merge_stage_cuda, fm.merge_stage_plain),
           "merge_tail": (fm.merge_tail_cuda, fm.merge_tail_plain)}
    for name, book in seen.items():
        if name == "radix_pass":  # every recorded shape: its work moves with the byte
            for (dtypes, n, n_keys, byte), c in sorted(book.items(), key=str):
                planes = planes_of(n, dtypes)
                kernel, plain = radix_case(torch, rs, H, planes, n_keys, byte)
                check(name, f"path shape {n} x "
                      f"{'+'.join(str(d).split('.')[-1] for d in dtypes)}, {n_keys} keys, "
                      f"byte {byte}; {c} launches of this shape on the path", kernel, plain)
                del planes, kernel, plain
            continue
        groups = {}
        for sig, c in book.items():
            groups.setdefault(sig[:2], []).append((sig, c))
        top = max(groups, key=lambda g: sum(c for _, c in groups[g]))
        for shape, sigs in groups.items():
            if name == "bitonic_span":  # P = 2 s_hi / s_lo
                sig = max(sigs, key=lambda x: 2 * x[0][2] // x[0][3])[0]
            elif name == "merge_stage":  # the widest stride
                sig = max(sigs, key=lambda x: x[0][2])[0]
            else:  # the first: trip 1 where the path has one
                sig = sigs[0][0]
            dtypes, n, args = sig[0], sig[1], [
                list(a) if isinstance(a, tuple) else a for a in sig[2:]]
            planes = planes_of(n, dtypes)
            kern, plain = fns[name]
            lean = (sum(n * d.itemsize for d in dtypes) > LEAN_BYTES
                    and _chunk_local(name, n, args, LEAN_CHUNK))
            check(name, f"path shape {n} x {len(dtypes)} planes "
                  f"{'+'.join(str(d).split('.')[-1] for d in dtypes)}, args "
                  f"{args}; {sum(c for _, c in sigs)} launches of this shape "
                  f"on the path" + (f"; plain version on aligned chunks of {LEAN_CHUNK}"
                                    if lean else ""),
                  lambda: kern(planes, n, *args),
                  (lambda: _chunked_plain(plain, planes, n, args, LEAN_CHUNK)) if lean
                  else (lambda: plain(planes, n, *args)),
                  main_shape=main and shape == top,
                  ops=ce_ops(name, dtypes, n, args))
            del planes


def sorter_headline(torch, P, x64, dev):
    """``Sorter.run`` on the 2^25 u64 headline keys already on the card: its
    kernels' device time under the profiler with the B8, B2 and B3 totals
    (its keys take the radix passes: B2 and B3 read 0), and
    ``torch.sort`` of the same keys as int64 (sign bit flipped) beside it, a
    yardstick the port never calls.  The sorted words must equal it."""
    from torch.autograd import DeviceType

    from rdst_tpu_torch import keys
    from rdst_tpu_torch.sorter import Sorter

    nk = keys.normalize(x64, device=dev)
    sorter = Sorter()
    out, _ = sorter.run(nk)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        sorter.run(nk)
        torch.cuda.synchronize()
    tot = {"all": [0.0, 0], "radix_pass_kernel": [0.0, 0], "tail_kernel": [0.0, 0],
           "span_kernel": [0.0, 0]}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        for k, acc in tot.items():
            if k == "all" or k in e.key:
                acc[0] += e.self_device_time_total / 1e3
                acc[1] += e.count
    run_ms = cuda_ms(torch, lambda: sorter.run(nk))
    key = ((P.widen(nk.words[0]) << 32) | P.widen(nk.words[1])) ^ -(1 << 63)
    ref = torch.sort(key).values
    got = ((P.widen(out.words[0]) << 32) | P.widen(out.words[1])) ^ -(1 << 63)
    if not torch.equal(got, ref):
        raise AssertionError("Sorter.run 2^25 u64 differs from torch.sort")
    sort_ms = cuda_ms(torch, lambda: torch.sort(key))
    print(f"Sorter.run 2^25 u64 on the card: {run_ms:.3f} ms (CUDA events, median "
          f"of {REPS}); device time over kernels {tot['all'][0]:.3f} ms; B8 "
          f"{tot['radix_pass_kernel'][0]:.3f} ms in {tot['radix_pass_kernel'][1]} launches, B2 "
          f"{tot['tail_kernel'][0]:.3f} ms in {tot['tail_kernel'][1]} launches, B3 "
          f"{tot['span_kernel'][0]:.3f} ms in {tot['span_kernel'][1]}; bit-exact vs "
          f"torch.sort, whose time on the same keys as int64 is {sort_ms:.3f} ms")


def sorter_sorted(torch, P, K, rng, dev, drive):
    """``Sorter.run`` on sorted 2^25 u64 keys already on the card, in two
    forms.  Keys whose every byte level is nondecreasing (256 values in the
    top byte, the rest constant) take the AlreadySorted short circuit: B1
    and one copy of its buffer to the host, nothing else.  Uniform keys,
    sorted, do not: their low bytes descend between neighbours, so
    ``fully_sorted()`` is false and the plan runs in full, as in the
    reference.  Each must come back equal to its input; device time from
    CUDA events."""
    from rdst_tpu_torch.sorter import Sorter

    n = 1 << 25
    top = np.sort(rng.integers(0, 256, size=n, dtype=np.uint64))
    forms = [("256 top-byte values, every level nondecreasing",
              (top << np.uint64(56)) | np.uint64(0x0001020304050607)),
             ("uniform keys sorted", np.sort(rng.integers(0, 2**64, size=n, dtype=np.uint64)))]
    for label, x in forms:
        nk = K.normalize(x, device=dev)
        sorter = Sorter()
        (out, _), plans = drive(f"Sorter.run sorted 2^25 u64 on the card, {label}", n,
                                lambda: sorter.run(nk))
        if not all(torch.equal(P.sview(a), P.sview(b)) for a, b in zip(out.words, nk.words)):
            raise AssertionError(f"Sorter.run on sorted keys ({label}) changed them")
        short = "AlreadySorted" in plans
        if short != label.startswith("256"):
            raise AssertionError(f"Sorter.run sorted ({label}) plan: {plans}")
        ms = cuda_ms(torch, lambda: sorter.run(nk))
        print(f"Sorter.run sorted 2^25 u64 on the card, {label}: {ms:.4f} ms of device "
              f"time (CUDA events, median of {REPS}); "
              f"{'the AlreadySorted short circuit' if short else 'the full plan'}")
        del nk, out


def distributed_paths(torch, P, par, rd, fs, fm, dev, gen, planes_u32,
                      planes_of, drive, check, nl=1 << 25):
    """The distributed shuffle on a mesh of 8 shards on the card, 2^25 rows
    each (the JAX package's per-chip headline size), exchanged HBM to HBM
    by B6; B6 against its plain version at the sizes the shuffle sent, and
    B2-B5 and B8 at the shapes the stable and overlapped runs gave them.  Oracles
    are torch.sort on the card."""
    D = 8
    n28 = D * nl
    mesh = par.make_mesh(D, device=dev)
    sign = -(1 << 63)

    def okey(hi, lo):
        """u64 keys as int64 whose signed order is their unsigned order."""
        return ((P.widen(hi) << 32) | P.widen(lo)) ^ sign

    def split(k):
        u = k ^ sign
        return P.narrow(u >> 32, torch.uint32), P.narrow(u & 0xFFFFFFFF, torch.uint32)

    def dense(planes, counts):
        c = counts.tolist()
        cap = planes[0].shape[0] // D
        if max(c) > cap:
            raise AssertionError(f"a shard overflowed: {max(c)} > {cap}")
        return [P.cat([p[d * cap:d * cap + c[d]] for d in range(D)]) for p in planes]

    def flat(r):
        recv, demand, arrived = r
        return recv + [demand, arrived]

    def same(a, b):
        return all(torch.equal(P.sview(x), P.sview(y)) for x, y in zip(a, b))

    def balance(label, counts, n):
        r = int(counts.max()) * D / n
        print(f"path {label}: max(counts) / fair share = {r:.4f}")
        return r

    # stable u64 keys + u32 payload, uniform; the exchange's sizes recorded
    hi, lo = planes_u32(n28, 2)
    pay = P.arange(n28, torch.uint32, dev)
    recorded = []
    real_b6 = rd.remote_dma_exchange_cuda

    def recorder(planes, offs, sizes, capacity):
        if not recorded:
            recorded.append(([o.clone() for o in offs],
                             [z.clone() for z in sizes], capacity))
        return real_b6(planes, offs, sizes, capacity)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rd.remote_dma_exchange_cuda = recorder
    label = "distributed stable u64 + u32 payload, 2^28 on 8 shards"
    seen_flat, seen_overlap = {}, {}
    try:
        with record_shapes(fs, fm, seen_flat):
            (sw, sp, sc), _ = drive(label, n28, lambda: par.distributed_sort(
                [hi, lo], [pay], mesh=mesh, stable=True), exchange=True)
    finally:
        rd.remote_dma_exchange_cuda = real_b6
    peak = torch.cuda.max_memory_allocated()
    print(f"distributed 2^28 stable peak device memory: {peak} B "
          f"({peak / GiB:.2f} GiB), of which inputs {base} B "
          f"({base / GiB:.2f} GiB) held by the caller")
    balance(label, sc, n28)
    ref, idx = torch.sort(okey(hi, lo), stable=True)
    want = list(split(ref)) + [P.narrow(idx, torch.uint32)]
    del ref, idx
    got = dense(sw + sp, sc)
    if not same(got, want):
        raise AssertionError("distributed stable 2^28 differs from torch.sort")
    print("distributed stable 2^28: bit-exact vs torch.sort(stable=True) and its gather")
    del sw, sp, want

    label = "distributed stable u64 + u32 payload, 2^28, overlap_exchange"
    with record_shapes(fs, fm, seen_overlap):
        (ow, op, oc), _ = drive(label, n28, lambda: par.distributed_sort(
            [hi, lo], [pay], mesh=mesh, stable=True, overlap_exchange=True),
            merges=True, exchange=True)
    balance(label, oc, n28)
    if not (torch.equal(oc, sc) and same(dense(ow + op, oc), got)):
        raise AssertionError("the overlapped exchange differs from the sequential one")
    print("distributed overlapped 2^28: bit-exact vs the sequential exchange")
    del ow, op, oc, got, hi, lo, pay
    torch.cuda.empty_cache()

    # B8 at the stable run's local sorts, B2/B3 at its finish sorts, B4/B5
    # at the overlapped run's merges (its sorts have the stable run's shapes)
    if set(seen_flat) != {"bitonic_tail", "bitonic_span", "radix_pass"}:
        raise AssertionError(f"the stable shuffle ran {sorted(seen_flat)}")
    check_recorded(fs, fm, seen_flat, planes_of, check)
    check_recorded(fs, fm, {k: seen_overlap[k] for k in ("merge_stage", "merge_tail")},
                   planes_of, check)
    torch.cuda.empty_cache()

    # B6 at the stable run's exchange: 8 x 8, 2^25 per sender, one plane
    offs, sizes, cap = recorded[0]
    src = [planes_u32(nl, 1) for _ in range(D)]

    def b6_moved(sz, cap):
        """Each landed word read once, each receive word written once."""
        landed = int(rd.exchange_layout(sz, cap).landed.sum())
        return 4 * landed, 4 * (landed + D * cap)

    def b6_check(label, offs, sizes, cap, main_shape=False):
        """Receive planes, demand and arrival counters, compared as one
        flat list; the launches of one call counted."""
        before = rd.EXCHANGE.launches
        rd.remote_dma_exchange_cuda(src, offs, sizes, cap)
        per_call = rd.EXCHANGE.launches - before
        if per_call != 1:
            raise AssertionError(f"B6 [{label}]: {per_call} launches in one call")
        got = check("remote_exchange", label,
                    lambda: flat(rd.remote_dma_exchange_cuda(src, offs, sizes, cap)),
                    lambda: flat(rd.remote_dma_exchange_plain(src, offs, sizes, cap)),
                    main_shape=main_shape,
                    moved=lambda g: b6_moved(torch.stack(sizes), cap)[0] + nbytes(g))
        demand = torch.stack(sizes).sum(0)
        if not (torch.equal(got[-2], demand)
                and torch.equal(got[-1][0], torch.clamp(demand, max=cap))):
            raise AssertionError(f"B6 [{label}]: arrivals differ from min(demand, capacity)")
        print(f"remote_exchange [{label}]: {per_call} launch per call; demand "
              f"{demand.tolist()}, capacity {cap}, arrivals {got[-1][0].tolist()}")

    b6_check("8 x 8, 2^25 per sender, the 2^28 shuffle's sizes", offs, sizes,
             cap, main_shape=True)
    # every segment 2^22 rows, so every copy starts on a 16 MiB boundary:
    # the shuffle's segments start anywhere
    seg = nl // D
    even_offs = [torch.arange(D, device=dev) * seg] * D
    even = [torch.full((D,), seg, dtype=torch.int64, device=dev)] * D
    b6_check(f"8 x 8, even sizes of {seg} rows (aligned)", even_offs, even, cap)

    # where the wrapper's time goes: the launch alone on buffers made
    # beforehand (CUDA events), the kernel's device time in the profiler,
    # and the host's time to enqueue the whole call (no synchronize in it)
    def call():
        return rd.remote_dma_exchange_cuda(src, offs, sizes, cap)

    def launches_alone(offs, sizes, label):
        so, sz = torch.stack(offs), torch.stack(sizes)
        recv = [torch.empty(D * cap, dtype=torch.uint32, device=dev)]
        arrived = torch.zeros((1, D), dtype=torch.int64, device=dev)
        ms = cuda_ms(torch, lambda: rd.launch_all(src, so, sz, recv, arrived, cap))
        landed, moved = b6_moved(sz, cap)
        print(f"remote_exchange: the launch alone, {label}: {ms:.4f} ms "
              f"({moved} B: {landed} read, {moved - landed} written (pad "
              f"included), {moved / ms / 1e9:.4f} TB/s; counting the landed rows "
              f"read and written only, {2 * landed / ms / 1e9:.4f} TB/s; "
              f"CUDA events, median of {REPS})")
        return moved

    moved = launches_alone(offs, sizes, "the shuffle's sizes")
    launches_alone(even_offs, even, f"even sizes of {seg} rows (aligned)")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    kern_us = [e.self_device_time_total for e in prof.key_averages()
               if "exchange_kernel" in e.key]
    if not kern_us:
        raise AssertionError("the profiler saw no B6 launch")
    kern_ms = sum(kern_us) / 1e3 / REPS
    enqueue = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"remote_exchange at the shuffle's sizes: the kernel's device time per "
          f"call {kern_ms:.4f} ms ({moved / kern_ms / 1e9:.4f} TB/s; profiler, "
          f"mean of {REPS}); host time to enqueue the call "
          f"{statistics.median(enqueue):.4f} ms (median of {REPS})")
    sm = torch.randint(0, nl // 16, (D, D), generator=gen, device=dev)
    sm[0, 1] = 0
    sm[5, :] = 0
    sm[:, 6] = 0
    sm[:, 3] = nl // 4  # receiver 3 demands 2^26 rows of a 2^25 buffer
    roffs = list(torch.cumsum(sm, 1) - sm)
    b6_check("8 x 8, random sizes, empty segments, receiver 3 overflows",
             roffs, list(sm), nl)
    del src
    torch.cuda.empty_cache()

    # one key on half the rows, keys only, unstable: single-key rank split
    hi, lo = planes_u32(n28, 2)
    P.sview(hi)[: n28 // 2] = 0x5555AAAA
    P.sview(lo)[: n28 // 2] = 0x12345678
    label = "distributed unstable u64, one key on half of 2^28"
    (kw, _, kc), _ = drive(label, n28, lambda: par.distributed_sort(
        [hi, lo], mesh=mesh), exchange=True)
    if balance(label, kc, n28) > 1.05:
        raise AssertionError("the hot key did not split by rank")
    if not same(dense(kw, kc), split(torch.sort(okey(hi, lo)).values)):
        raise AssertionError("distributed hot-key 2^28 differs from torch.sort")
    print("distributed hot key 2^28: bit-exact vs torch.sort")
    del kw, kc, hi, lo
    torch.cuda.empty_cache()

    # test_overflow.py's hot multi-key bucket at 2^26: it must refine
    n26 = n28 // 4
    hi = P.full(n26, 0, torch.uint32, dev)
    lo = planes_u32(n26, 1, 256)[0]
    rhi, rlo = planes_u32(n26 // 8, 2)
    P.sview(hi)[: n26 // 8] = P.sview(rhi)
    P.sview(lo)[: n26 // 8] = P.sview(rlo)
    pay = P.arange(n26, torch.uint32, dev)
    label = "distributed stable hot multi-key bucket, 2^26 (refines)"
    (hw, hp, hc), _ = drive(label, n26, lambda: par.distributed_sort(
        [hi, lo], [pay], mesh=mesh, stable=True), exchange=True)
    if balance(label, hc, n26) > 1.35:
        raise AssertionError("the hot multi-key bucket did not refine")
    ref, idx = torch.sort(okey(hi, lo), stable=True)
    if not same(dense(hw + hp, hc), list(split(ref)) + [P.narrow(idx, torch.uint32)]):
        raise AssertionError("distributed hot bucket 2^26 differs from torch.sort")
    print("distributed hot bucket 2^26: bit-exact vs torch.sort(stable=True)")
    del hw, hp, hc, hi, lo, rhi, rlo, pay, ref, idx
    torch.cuda.empty_cache()

    # co-partitioning: a 2^28 sort's partition routes a 2^27-row dataset
    ahi, alo = planes_u32(n28, 2)
    label = "distributed 2^28 u64, split_uniform=False, return_partition"
    (aw, _, ac, part), _ = drive(label, n28, lambda: par.distributed_sort(
        [ahi, alo], mesh=mesh, split_uniform=False, return_partition=True),
        exchange=True)
    balance(label, ac, n28)
    n27 = n28 // 2
    pick = torch.randint(0, n28, (n27 // 2,), generator=gen, device=dev)
    bhi, blo = [P.cat([P.take(a, pick), planes_u32(n27 // 2, 1)[0]])
                for a in (ahi, alo)]
    bpay = P.arange(n27, torch.uint32, dev)
    del ahi, alo, pick
    label = "co-partition: partition_exchange of 2^27 rows + u32 payload"
    (bw, bp, bc), _ = drive(label, n27, lambda: par.partition_exchange(
        [bhi, blo], [bpay], part, mesh=mesh, stable=True), exchange=True)
    balance(label, bc, n27)
    ref, idx = torch.sort(okey(bhi, blo), stable=True)
    g = dense(bw + bp, bc)
    if not same(g, list(split(ref)) + [P.narrow(idx, torch.uint32)]):
        raise AssertionError("partition_exchange 2^27 differs from torch.sort")
    del ref, idx, bw, bp
    akeys = okey(*dense(aw, ac))
    bkeys = okey(g[0], g[1])
    ashard = torch.repeat_interleave(torch.arange(D, device=dev), ac)
    bshard = torch.repeat_interleave(torch.arange(D, device=dev), bc)
    pos = torch.searchsorted(akeys, bkeys).clamp_(max=akeys.numel() - 1)
    found = akeys[pos] == bkeys
    if int(found.sum()) < n27 // 2 or not torch.equal(ashard[pos][found], bshard[found]):
        raise AssertionError("co-partitioned keys landed on different shards")
    print(f"co-partition: bit-exact vs torch.sort; {int(found.sum())} of {n27} "
          "rows share a key with the 2^28 dataset, each on that key's shard")
    del aw, ac, akeys, bkeys, ashard, bshard, pos, found, g, bhi, blo, bpay
    torch.cuda.empty_cache()


def _lexsort(torch, cols):
    """The permutation that sorts rows by ``cols`` (most significant
    first): stable argsorts from the least significant column."""
    idx = torch.argsort(cols[-1], stable=True)
    for c in reversed(cols[:-1]):
        idx = idx[torch.argsort(c[idx], stable=True)]
    return idx


def tpch_tables(torch, dev, gen, n_lineitem=1 << 26, n_orders=1 << 24):
    """TPC-H's LINEITEM and ORDERS (Standard Specification rev. 3.0.1, §1.4
    and §4.2.5) at their cardinality ratio, four columns each, made on the
    card from ``gen``: orders' keys sparse as dbgen makes them (8 of every
    32 used), 1-7 lines an order (uniform, about 4), the lines of all orders
    in a random order (a table partitioned without regard to its key).
    Prices in cents, dates in days since 1970-01-01."""
    import datetime

    day = datetime.date(1970, 1, 1)
    start = (datetime.date(1992, 1, 1) - day).days
    end = (datetime.date(1998, 8, 2) - day).days  # ENDDATE - 151 days
    i = torch.arange(n_orders, device=dev)
    sf = n_lineitem / 6_000_000
    orders = {
        "orderkey": (i // 8) * 32 + i % 8 + 1,
        "custkey": torch.randint(1, int(150_000 * sf) + 1, (n_orders,), generator=gen,
                                 device=dev, dtype=torch.int32),
        "orderdate": torch.randint(start, end + 1, (n_orders,), generator=gen,
                                   device=dev, dtype=torch.int32),
    }
    per_order = torch.randint(1, 8, (n_orders,), generator=gen, device=dev)
    owner = torch.repeat_interleave(i, per_order)[:n_lineitem]
    short = n_lineitem - owner.numel()
    if short > 0:
        owner = torch.cat([owner, torch.randint(0, n_orders, (short,), generator=gen,
                                                device=dev)])
    owner = owner[torch.randperm(n_lineitem, generator=gen, device=dev)]
    qty = torch.randint(1, 51, (n_lineitem,), generator=gen, device=dev,
                        dtype=torch.int32)
    retail = torch.randint(90_100, 209_900, (n_lineitem,), generator=gen, device=dev)
    lineitem = {
        "orderkey": orders["orderkey"][owner],
        "quantity": qty,
        "extendedprice": qty.to(torch.int64) * retail,
        "shipdate": orders["orderdate"][owner] + torch.randint(
            1, 122, (n_lineitem,), generator=gen, device=dev, dtype=torch.int32),
    }
    orders["totalprice"] = torch.zeros(n_orders, dtype=torch.int64, device=dev) \
        .index_add_(0, owner, lineitem["extendedprice"])
    orders = {c: orders[c] for c in ("orderkey", "custkey", "totalprice", "orderdate")}
    # Q1's predicate: l_shipdate <= date '1998-12-01' - interval '90' day
    cutoff = (datetime.date(1998, 9, 2) - day).days
    return lineitem, orders, cutoff, sf


def table_paths(torch, par, dev, gen, drive, planes_of, check, n_lineitem=1 << 26,
                n_orders=1 << 24, n_sort=1 << 25, n_rows=4096):
    """The table engine at TPC-H shape (``tpch_tables``) on a mesh of 8
    shards on the card, and its single-card operators, ``jit_api`` and the
    row-batched sorts.  Each path runs once with its launches counted
    (``drive``) and the plain versions' counts held (no plain version may
    run on a CUDA tensor), then ``WARM_CALLS`` times more, each timed on
    the host clock to a synchronize (the median is the path's warm time),
    with their peak device memory.  Every output is held
    bit-equal against an oracle of plain torch calls on the card.  The
    counted calls record the arguments of their B2/B3 launches
    (``record_shapes``) and of every B6 launch; after the paths, each
    kernel runs against its plain version at those shapes."""
    import rdst_tpu_torch as rt
    from rdst_tpu_torch import _build
    from rdst_tpu_torch.ops import fused_merge as fm
    from rdst_tpu_torch.ops import fused_sort as fs
    from rdst_tpu_torch.parallel import remote_dma as rd
    from rdst_tpu_torch.parallel import shuffle

    D = 8
    t_phase = time.perf_counter()
    peaks = []
    mesh = par.make_mesh(D, device=dev)
    lineitem, orders, cutoff, sf = tpch_tables(torch, dev, gen, n_lineitem, n_orders)
    n_l, n_o = lineitem["orderkey"].numel(), orders["orderkey"].numel()
    li_b = sum(c.numel() * c.element_size() for c in lineitem.values())
    print(f"table phase: TPC-H shape, SF {sf:.2f}: lineitem {n_l} rows "
          f"({li_b / GiB:.2f} GiB), orders {n_o} rows; mesh of {D} shards on the card")

    # the counted calls' B2-B5 and B8 launches by their arguments, and each B6
    # launch: (path, each sender's plane dtypes and length, offsets, sizes,
    # capacity)
    seen, sent = {}, []
    real_b6 = rd.remote_dma_exchange_cuda

    def b6_recorder(label):
        def rec(planes, offs, sizes, capacity):
            sent.append((label, [([p.dtype for p in ps], int(ps[0].shape[0]))
                                 for ps in planes],
                         [o.clone() for o in offs], [z.clone() for z in sizes],
                         capacity))
            return real_b6(planes, offs, sizes, capacity)
        return rec

    def plain_calls():
        return {k: v.plain_calls for k, v in _build.KERNELS.items()}

    def run(label, rows, fn, need=(), exchanges=None, no_sync=False):
        def call():
            if not no_sync:
                return fn()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)

        plain = plain_calls()
        shuffle.SORT_ROUTES.clear()
        rd.remote_dma_exchange_cuda = b6_recorder(label)
        try:
            with record_shapes(fs, fm, seen):
                out, _ = drive(label, rows, call)
        finally:
            rd.remote_dma_exchange_cuda = real_b6
        counts = {k: _build.KERNELS[k].launches for k in KERNEL_INFO}
        missing = not_launched(counts, need)
        if missing:
            raise AssertionError(f"path {label} launched no {missing}")
        if exchanges is not None and counts["remote_exchange"] != exchanges:
            raise AssertionError(f"path {label}: {counts['remote_exchange']} B6 "
                                 f"launches for {exchanges} exchanges")
        if plain_calls() != plain:
            raise AssertionError(f"path {label} ran a plain version on the card")
        routes = ", ".join(f"{c} x {k[0]} planes of {k[1]} rows by {k[2]}"
                           for k, c in sorted(shuffle.SORT_ROUTES.items()))
        print(f"path {label}: no plain version ran; shuffle sorts: {routes or 'none'}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(WARM_CALLS):
            t0 = time.perf_counter()
            again = call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del again
        peak = torch.cuda.max_memory_allocated()
        peaks.append(peak)
        dt = statistics.median(times)
        print(f"path {label} warm: {dt * 1e3:.3f} ms (median of {WARM_CALLS}; "
              f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f}), {rows / dt:,.0f} "
              f"rows/s; peak device memory {peak} B ({peak / GiB:.2f} GiB), of which "
              f"{base} B ({base / GiB:.2f} GiB) held before the calls")
        return out

    def same(label, got, want):
        for name, (a, b) in zip(want, zip(got, want.values())):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"{label}: column {name} differs from its oracle")
        print(f"{label}: bit-exact vs its torch oracle ({', '.join(want)})")

    def dense(table, counts, names):
        c = counts.tolist()
        cap = table.n_rows // D
        return [torch.cat([table[n][d * cap:d * cap + c[d]] for d in range(D)])
                for n in names]

    li = rt.Table(lineitem)
    od = rt.Table(orders)

    # 1. Q1's filter, shard by shard (no exchange)
    mask = lineitem["shipdate"] <= cutoff
    out, counts = run("table: distributed_filter lineitem, Q1's shipdate cut",
                      n_l, lambda: par.distributed_filter(li, mask, mesh=mesh))
    m2 = mask.view(D, -1)
    want = {n: torch.cat([torch.cat([c.view(D, -1)[d][m2[d]], c.view(D, -1)[d][~m2[d]]])
                          for d in range(D)]) for n, c in lineitem.items()}
    same("distributed_filter (the whole static-length output)",
         [out[n] for n in want], want)
    if not torch.equal(counts, m2.sum(1).to(torch.int32)):
        raise AssertionError("distributed_filter counts differ")
    print(f"distributed_filter: {int(counts.sum())} of {n_l} rows kept "
          f"({int(counts.sum()) / n_l:.4f})")
    del out, want, m2

    # 2. Q18's inner aggregate, hash and range partitioned
    aggs = {"sum_qty": ("quantity", "sum"), "n": ("quantity", "count"),
            "avg_qty": ("quantity", "mean"), "max_price": ("extendedprice", "max")}
    keys, inv, cnt = torch.unique(lineitem["orderkey"], sorted=True,
                                  return_inverse=True, return_counts=True)
    s = torch.zeros_like(keys).index_add_(0, inv, lineitem["quantity"].to(torch.int64))
    want = {"orderkey": keys, "sum_qty": s, "n": cnt.to(torch.int32),
            "avg_qty": s.to(torch.float32) / cnt.to(torch.float32),
            "max_price": torch.zeros_like(keys).scatter_reduce_(
                0, inv, lineitem["extendedprice"], "amax", include_self=False)}
    del inv, cnt, s
    for part in ("hash", "range"):
        out, n_groups = run(
            f"table: distributed_group_aggregate lineitem by orderkey "
            f"(Q18's inner aggregate), partition={part}", n_l,
            lambda: par.distributed_group_aggregate(li, "orderkey", aggs, mesh=mesh,
                                                    partition=part),
            need=(EXECUTOR, "remote_exchange"), exchanges=1)
        if int(n_groups) != keys.numel():
            raise AssertionError(f"{n_groups} groups, want {keys.numel()}")
        order = torch.sort(out["orderkey"]).indices
        same(f"distributed_group_aggregate partition={part} ({keys.numel()} groups)",
             [out[n][order] for n in want], want)
        del out, order
    del want, keys

    # 3. the pk-fk join of Q3/Q18
    out, matches = run("table: distributed_join lineitem x orders on orderkey, "
                       "inner, partition=hash", n_l + n_o,
                       lambda: par.distributed_join(li, od, "orderkey", mesh=mesh,
                                                    partition="hash"),
                       need=("remote_exchange",), exchanges=2)
    ok, oi = torch.sort(orders["orderkey"])
    at = oi[torch.searchsorted(ok, lineitem["orderkey"])]
    del ok, oi
    want = dict(lineitem, **{c: orders[c][at] for c in ("custkey", "totalprice",
                                                        "orderdate")})
    del at
    if matches != n_l or out.n_rows != n_l or out.column_names != list(want):
        raise AssertionError(f"join: {matches} matches, {out.n_rows} rows, "
                             f"columns {out.column_names}")
    sort_cols = ("orderkey", "extendedprice", "quantity", "shipdate")
    g_idx = _lexsort(torch, [out[c] for c in sort_cols])
    w_idx = _lexsort(torch, [want[c] for c in sort_cols])
    same("distributed_join (rows ordered by every left column)",
         [out[n][g_idx] for n in want], {n: v[w_idx] for n, v in want.items()})
    del out, want, g_idx, w_idx

    # 4. ORDER BY totalprice over the mesh
    out, counts = run("table: distributed_sort_table orders by totalprice, stable",
                      n_o, lambda: par.distributed_sort_table(
                          od, "totalprice", mesh=mesh, stable=True),
                      need=(EXECUTOR, "remote_exchange"),
                      exchanges=1)
    idx = torch.sort(orders["totalprice"], stable=True).indices
    same("distributed_sort_table", dense(out, counts, list(orders)),
         {n: c[idx] for n, c in orders.items()})
    del out, idx

    # 5. the single-card operators on one shard's share of lineitem
    n1 = n_l // D
    one = {n: c[:n1] for n, c in lineitem.items()}
    t1 = rt.Table(one)
    m1 = mask[:n1]
    out, count = run("table: Table.filter on one shard", n1, lambda: t1.filter(m1))
    same("Table.filter (the whole static-length output)", [out[n] for n in one],
         {n: torch.cat([c[m1], c[~m1]]) for n, c in one.items()})
    if int(count) != int(m1.sum()):
        raise AssertionError("Table.filter count differs")
    keys, inv, cnt = torch.unique(one["orderkey"], sorted=True, return_inverse=True,
                                  return_counts=True)
    s = torch.zeros_like(keys).index_add_(0, inv, one["quantity"].to(torch.int64))
    want = {"orderkey": keys, "sum_qty": s, "n": cnt.to(torch.int32),
            "avg_qty": s.to(torch.float32) / cnt.to(torch.float32),
            "max_price": torch.zeros_like(keys).scatter_reduce_(
                0, inv, one["extendedprice"], "amax", include_self=False)}
    out, count = run("table: Table.group_aggregate on one shard", n1,
                     lambda: t1.group_aggregate("orderkey", aggs))
    g = int(count)
    if g != keys.numel():
        raise AssertionError("Table.group_aggregate count differs")
    same("Table.group_aggregate", [out[n][:g] for n in want], want)
    del inv, cnt, s, want
    out, matches = run("table: Table.join(orders) on one shard, inner", n1 + n_o,
                       lambda: t1.join(od, "orderkey"))
    ok, oi = torch.sort(orders["orderkey"])
    at = oi[torch.searchsorted(ok, one["orderkey"])]
    same("Table.join (left order kept)", [out[n] for n in out.column_names],
         dict(one, **{c: orders[c][at] for c in ("custkey", "totalprice", "orderdate")}))
    if int(matches) != n1:
        raise AssertionError("Table.join match count differs")
    del ok, oi, at
    out = run("table: Table.sort_by shipdate on one shard, stable", n1,
              lambda: t1.sort_by("shipdate"))
    idx = torch.sort(one["shipdate"], stable=True).indices
    same("Table.sort_by", [out[n] for n in one], {n: c[idx] for n, c in one.items()})
    del out, idx, t1, one, li, od, lineitem, orders, mask
    torch.cuda.empty_cache()

    # 6. jit_api on the card under sync debug mode "error"
    n = n_sort
    x = torch.empty(n, dtype=torch.int64, device=dev).random_(generator=gen)
    xu = x.view(torch.uint64)
    got = run(f"jit_api.sort 2^{n.bit_length() - 1} uniform u64, sync debug mode error", n,
              lambda: rt.jit_api.sort(xu), need=("radix_pass",),
              no_sync=True)
    sign = -(1 << 63)
    ref, order = torch.sort(x ^ sign, stable=True)
    same("jit_api.sort", [got.view(torch.int64)], {"keys": ref ^ sign})
    idx = run(f"jit_api.argsort 2^{n.bit_length() - 1} uniform u64, stable, sync debug "
              "mode error", n,
              lambda: rt.jit_api.argsort(xu), need=("bitonic_tail", "bitonic_span"),
              no_sync=True)
    same("jit_api.argsort", [idx.view(torch.int32).to(torch.int64)], {"index": order})
    del x, xu, got, ref, order, idx

    # 7. row-batched sorts: 4096 rows of 4096 u32 keys with a u32 payload
    keys = torch.randint(0, 1 << 32, (n_rows, n_rows), generator=gen, device=dev) \
        .to(torch.int32).view(torch.uint32)
    pay = torch.randint(0, 1 << 32, (n_rows, n_rows), generator=gen, device=dev) \
        .to(torch.int32).view(torch.uint32)

    def widen(t):
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    pairs = torch.sort((widen(keys) << 32) | widen(pay), dim=-1).values
    sk, (sp,) = run(f"batched_sort {n_rows} rows x {n_rows} u32 + u32 payload", keys.numel(),
                    lambda: rt.batched_sort(keys, [pay]))
    same("batched_sort (keys; (key, payload) pairs of each row)",
         [widen(sk), torch.sort((widen(sk) << 32) | widen(sp), dim=-1).values],
         {"keys": torch.sort(widen(keys), dim=-1).values, "pairs": pairs})
    tk, (tp,) = run("batched_top_k k=64 on the same rows", keys.numel(),
                    lambda: rt.batched_top_k(keys, 64, [pay]))
    got_pairs = (widen(tk) << 32) | widen(tp)
    at = torch.searchsorted(pairs, got_pairs).clamp_(max=pairs.shape[1] - 1)
    same("batched_top_k (keys; each (key, payload) pair one of its row's)",
         [widen(tk), torch.gather(pairs, 1, at)],
         {"keys": torch.topk(widen(keys), 64, dim=-1).values, "pairs": got_pairs})
    del keys, pay, pairs, sk, sp, tk, tp, got_pairs, at
    torch.cuda.empty_cache()
    print(f"table phase: {time.perf_counter() - t_phase:.1f} s; peak device memory "
          f"of its paths {max(peaks)} B ({max(peaks) / GiB:.2f} GiB)")

    # B2/B3 at every shape the table paths gave them, B6 at every exchange
    # they made (on fresh random planes of the same dtypes and lengths)
    if not {"bitonic_tail", "bitonic_span"} <= set(seen):
        raise AssertionError(f"the table paths ran {sorted(seen)}")
    check_recorded(fs, fm, seen, planes_of, check, main=False)

    def flat(r):  # receive planes, demand and arrival counters as one list
        recv, demand, arrived = r
        return recv + [demand, arrived]

    for label, senders, offs, sizes, cap in sent:
        src = [planes_of(n, dtypes) for dtypes, n in senders]
        k = len(src[0])
        landed = int(rd.exchange_layout(torch.stack(sizes), cap).landed.sum())
        check("remote_exchange", f"{label}: {D} x {D}, {k} planes, capacity {cap}",
              lambda: flat(rd.remote_dma_exchange_cuda(src, offs, sizes, cap)),
              lambda: flat(rd.remote_dma_exchange_plain(src, offs, sizes, cap)),
              moved=lambda g: 4 * k * landed + nbytes(g))
        del src
    torch.cuda.empty_cache()


NVLINK = 450e9  # bytes/s each way between two H100 SXM cards


def _plane_host(p, devices):
    """A plane of a result on the host: one tensor, or per-card blocks
    (each checked to lie on its card) concatenated in card order."""
    import torch

    from rdst_tpu_torch import _planes as P

    if not isinstance(p, list):
        return P.sview(p).cpu()
    if [b.device for b in p] != list(devices):
        raise AssertionError(f"blocks on {[str(b.device) for b in p]}, cards {devices}")
    return torch.cat([P.sview(b).cpu() for b in p])


def sort_host(r, devices):
    """``distributed_sort``'s (words, payloads, counts) on the host."""
    return [_plane_host(p, devices) for p in list(r[0]) + list(r[1])] + [r[2].cpu()]


def table_host(r, devices):
    """A table operator's (Table or one Table a card, count) on the host."""
    import torch

    from rdst_tpu_torch import _planes as P

    ts = r[0] if isinstance(r[0], list) else [r[0]]
    if len(ts) > 1 and [t.device for t in ts] != list(devices):
        raise AssertionError(f"tables on {[str(t.device) for t in ts]}, cards {devices}")
    cols = [torch.cat([P.sview(t[c]).cpu() for t in ts]) for c in ts[0].column_names]
    n = r[1]
    return cols + [n.cpu() if isinstance(n, torch.Tensor) else torch.tensor(n)]


def b6_cards_bound(rd, sizes, cap, k, send_cards, recv_cards, devices):
    """Bytes and bound of one multi-card exchange: per physical card, the
    words landing from other physical cards over NVLink against its own
    words read plus every receive word written over HBM; the largest card
    sets the bound.  Returns (hbm bytes of the largest, nvlink bytes of the
    largest, bound ms)."""
    landed = rd.exchange_layout(sizes, cap).landed  # (S, R)
    per_dev = {}
    for d, rc in enumerate(recv_cards):
        phys = devices[rc]
        hbm, link = per_dev.get(phys, (0, 0))
        for s, sc in enumerate(send_cards):
            words = int(landed[s, d]) * k
            if devices[sc] == phys:
                hbm += 4 * words
            else:
                link += 4 * words
        per_dev[phys] = (hbm + 4 * k * cap, link)
    bound = max(max(h / HBM, l / NVLINK) for h, l in per_dev.values()) * 1e3
    worst = max(per_dev.values(), key=lambda x: max(x[0] / HBM, x[1] / NVLINK))
    return worst[0], worst[1], bound


def cards_calls(torch, P, par, rd, dev, gen, planes_u32, drive, entries, entries_2d, nl=1 << 25, n_lineitem=1 << 26, n_orders=1 << 24):
    """The shuffle and the table operators on a mesh of 8 shards over the
    card entries ``entries`` (``entries_2d`` for ``make_mesh_2d(2, 4)``):
    each call's one-entry result on ``dev`` read to the host first, then
    the same call on the entries, driven with its launches counted,
    bit-equal; each call's warm time (host clock to a synchronize, median
    of ``WARM_CALLS``) beside the one-entry time; each multi-card B6 launch
    recorded and then held against its plain version."""
    from rdst_tpu_torch.parallel import shuffle

    D = 8
    n28 = D * nl
    sent = []  # (label, senders' (dtypes, length), offs, sizes, cap, cards, devices)
    recorder = keep_b6_cards_inputs(torch, shuffle, sent)

    def warm(fn):
        times = []
        for _ in range(WARM_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del again
        return statistics.median(times) * 1e3

    def compare(label, rows, one_fn, many_fn, mesh, exchanges, host=sort_host):
        """One entry, then the entries (launches counted; a call that
        exchanges must launch B6 on several cards); bit-equal; warm times."""
        ref = host(one_fn(), [dev])
        torch.cuda.empty_cache()
        t_one = warm(one_fn)
        with patched(shuffle, "remote_dma_exchange_cards", recorder(label)):
            got, _ = drive(f"{label} on {len(mesh.devices)} card entries", rows, many_fn,
                           exchange=exchanges > 0)
        b6 = sum(1 for x in sent if x[0] == label)
        if b6 < exchanges:
            raise AssertionError(f"{label}: {b6} multi-card exchanges, want >= {exchanges}")
        g = host(got, mesh.devices)
        del got
        if len(g) != len(ref) or not all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(g, ref)):
            raise AssertionError(f"{label}: {len(mesh.devices)} card entries differ "
                                 "from the one-entry mesh")
        del g, ref
        torch.cuda.empty_cache()
        t_many = warm(many_fn)
        print(f"cards {label}: bit-equal to the one-entry mesh; warm {t_many:.3f} ms "
              f"on {len(mesh.devices)} entries {[str(d) for d in mesh.devices]} "
              f"against {t_one:.3f} ms on one (median of {WARM_CALLS}, host clock to a "
              f"synchronize; {rows / t_many * 1e3:,.0f} rows/s against "
              f"{rows / t_one * 1e3:,.0f}); {b6} multi-card B6 calls")
        torch.cuda.empty_cache()

    one = par.make_mesh(D, device=dev)
    many = par.make_mesh(D, devices=entries)
    hi, lo = planes_u32(n28, 2)
    pay = P.arange(n28, torch.uint32, dev)
    for overlap in (False, True):
        compare(f"distributed_sort 2^28 u64 + u32 stable{', overlapped' if overlap else ''}",
                n28,
                lambda: par.distributed_sort([hi, lo], [pay], mesh=one, stable=True,
                                             overlap_exchange=overlap),
                lambda: par.distributed_sort([hi, lo], [pay], mesh=many, stable=True,
                                             overlap_exchange=overlap),
                many, 2 if overlap else 1)
    one2 = par.make_mesh_2d(2, 4, device=dev)
    for ents in entries_2d:
        many2 = par.make_mesh_2d(2, 4, devices=ents)
        compare(f"make_mesh_2d(2, 4) distributed_sort 2^28 u64 + u32 stable, "
                f"{len(ents)} entries", n28,
                lambda: par.distributed_sort([hi, lo], [pay], mesh=one2, stable=True,
                                             axis=one2.axis_names),
                lambda: par.distributed_sort([hi, lo], [pay], mesh=many2, stable=True,
                                             axis=many2.axis_names),
                many2, 1)
        del many2
    del hi, lo, pay
    torch.cuda.empty_cache()

    import rdst_tpu_torch as rt

    lineitem, orders, cutoff, _ = tpch_tables(torch, dev, gen, n_lineitem, n_orders)
    li, od = rt.Table(lineitem), rt.Table(orders)
    mask = lineitem["shipdate"] <= cutoff
    n_l, n_o = lineitem["orderkey"].numel(), orders["orderkey"].numel()
    aggs = {"sum_qty": ("quantity", "sum"), "n": ("quantity", "count"),
            "avg_qty": ("quantity", "mean"), "max_price": ("extendedprice", "max")}
    paths = [
        ("table: distributed_filter lineitem, Q1's shipdate cut", n_l,
         lambda m: par.distributed_filter(li, mask, mesh=m), 0),
        ("table: distributed_group_aggregate lineitem by orderkey, hash", n_l,
         lambda m: par.distributed_group_aggregate(li, "orderkey", aggs, mesh=m,
                                                   partition="hash"), 1),
        ("table: distributed_group_aggregate lineitem by orderkey, range", n_l,
         lambda m: par.distributed_group_aggregate(li, "orderkey", aggs, mesh=m), 1),
        ("table: distributed_join lineitem x orders on orderkey, inner, hash", n_l + n_o,
         lambda m: par.distributed_join(li, od, "orderkey", mesh=m, partition="hash"), 2),
        ("table: distributed_sort_table orders by totalprice, stable", n_o,
         lambda m: par.distributed_sort_table(od, "totalprice", mesh=m, stable=True), 1),
    ]
    for label, rows, fn, exchanges in paths:
        compare(label, rows, lambda: fn(one), lambda: fn(many), many, exchanges,
                table_host)
    del li, od, lineitem, orders, mask
    torch.cuda.empty_cache()
    return sent


def keep_b6_cards_inputs(torch, shuffle, sent):
    """``recorder(label)``: a stand-in for the multi-card B6 call the
    shuffle makes (``shuffle.remote_dma_exchange_cards``) that appends each
    call's (label, senders' (dtypes, length), offsets, sizes, capacity, send
    cards, receive cards, devices) to ``sent``, the vectors copied on their
    senders' streams, for :func:`check_b6_cards`."""
    real = shuffle.remote_dma_exchange_cards

    def recorder(label):
        def rec(planes, offs, sizes, capacity, send_cards, recv_cards, devs, streams=None):
            kept = []
            for sc, o, z in zip(send_cards, offs, sizes):  # on the sender's stream
                with (contextlib.nullcontext() if streams is None
                      else torch.cuda.stream(streams[sc])):
                    kept.append((o.clone(), z.clone()))
            sent.append((label, [([p.dtype for p in ps], int(ps[0].shape[0]))
                                 for ps in planes],
                         [o for o, _ in kept], [z for _, z in kept],
                         capacity, list(send_cards), list(recv_cards), list(devs)))
            return real(planes, offs, sizes, capacity, send_cards, recv_cards, devs,
                        streams)
        return rec
    return recorder


def cards_shapes(sent) -> list:
    """The (send cards, receive cards, planes, capacity) of recorded
    multi-card B6 calls, each once."""
    return sorted({(tuple(sc), tuple(rc), len(senders[0][0]), cap)
                   for _, senders, _, _, cap, sc, rc, _ in sent})


def cards_landed(sent) -> int:
    """Recorded multi-card B6 calls of a rank of several cards whose
    remote senders (the ones beyond its receivers, all on card 0, where the
    transport delivers) land on card 1."""
    return sum(1 for _, _, _, _, _, sc, rc, _ in sent
               if sc.count(0) > rc.count(0) and 1 in rc)


@contextlib.contextmanager
def patched(obj, name, fn):
    """``obj.name`` is ``fn`` inside the context."""
    real = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, real)


def check_b6_cards(torch, par, rd, dev, entries, sent, planes_of, check):
    """Every shape of multi-card B6 call in ``sent`` against the plain
    per-card form, on fresh random planes placed on the senders' cards,
    the launches of one call counted (one per receiving card); the call
    runs inside ``Mesh.call`` of a mesh on ``entries``, so CUDA events on
    the current stream time all its cards."""
    mesh = par.make_mesh(8, devices=entries)
    seen = set()
    for label, senders, offs, sizes, cap, sc, rc, devs in sent:
        key = (tuple((tuple(d), n) for d, n in senders), tuple(sc), tuple(rc), cap)
        if key in seen:
            continue
        seen.add(key)
        k = len(senders[0][0])
        src = [[p.to(devs[c]) for p in planes_of(n, dtypes)]
               for (dtypes, n), c in zip(senders, sc)]
        hbm, link, bound = b6_cards_bound(rd, torch.stack([z.to(dev) for z in sizes]),
                                          cap, k, sc, rc, devs)

        def flat(out):
            return [t for recv, demand, arrived in out for t in recv + [demand, arrived]]

        def kernel():
            with mesh.call():
                return flat(rd.remote_dma_exchange_cards(
                    src, offs, sizes, cap, sc, rc, devs, mesh.streams))

        before = rd.EXCHANGE.launches
        kernel()
        torch.cuda.synchronize()
        per_call = rd.EXCHANGE.launches - before
        if per_call != len(set(rc)):
            raise AssertionError(f"B6 cards: {per_call} launches for "
                                 f"{len(set(rc))} receiving cards")
        check("remote_exchange",
              f"multi-card, {label}: {len(sc)} senders x {len(rc)} receivers on "
              f"{len(set(rc))} receiving cards {sorted(set(rc))} of "
              f"{[str(d) for d in devs]}, {k} planes, capacity {cap}, "
              f"{per_call} launches a call; bound: {hbm} B over HBM, {link} B over "
              f"NVLink at the busiest card",
              kernel,
              lambda: flat(rd.remote_dma_exchange_cards_plain(
                  src, offs, sizes, cap, rc, devs)),
              moved=lambda g: bound * 1e-3 * HBM)
        del src


def cards_phase(torch, P, par, rd, dev, gen, planes_u32, planes_of, drive, check):
    """A mesh over several card entries of this process.  On every machine:
    ``make_mesh(8, devices=[dev] * 4)`` (four streams on the one card) and
    ``make_mesh_2d(2, 4)`` on 2 and 4 entries, each call bit-equal to the
    one-entry mesh, and every multi-card B6 launch against its plain
    version at the shape it ran (bytes over HBM: one physical card).  Where
    the machine has several cards, the same calls on every card, with each
    pair's peer access and B6's NVLink bound."""
    t0 = time.perf_counter()
    runs = [([dev] * 4, [[dev] * 2, [dev] * 4])]
    count = torch.cuda.device_count()
    if count >= 2:
        k = max(x for x in (2, 4, 8) if x <= count)
        cards = [torch.device("cuda", i) for i in range(k)]
        for a in cards:
            print("cards: peer access " + ", ".join(
                f"{a} -> {b}: {torch.cuda.can_device_access_peer(a, b)}"
                for b in cards if b != a))
        runs.append((cards, [cards[:2], cards] if k >= 4 else [cards[:2]]))
    else:
        print("cards: this machine has 1 card: the calls on several physical cards "
              "(peer reads over NVLink) did not run; the entries share the one card")
    for entries, entries_2d in runs:
        sent = cards_calls(torch, P, par, rd, dev, gen, planes_u32, drive, entries,
                           entries_2d)
        check_b6_cards(torch, par, rd, dev, entries, sent, planes_of, check)
        torch.cuda.empty_cache()
    print(f"cards phase: {time.perf_counter() - t0:.1f} s")


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it: its model name, vendor,
    family and model (a sandboxed kernel may report the name as unknown)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')})")


def host_runtime(rng):
    """The native host runtime (``native/host.py``): built with g++ from the
    checkout, each sort bit-equal to its numpy version at 2^20 keys (u32,
    u64, and both with a u32 payload, whose order among equal keys the
    stable sort fixes), and the byte histogram at every level of a u32 key.
    Times: host clock, median of REPS, each on a fresh copy."""
    from rdst_tpu_torch.native import host

    built = host._target(host._compiler()).exists()
    t0 = time.perf_counter()
    host.available()
    print(f"host runtime: {'loaded (built before)' if built else 'built with g++ and loaded'}"
          f" in {time.perf_counter() - t0:.2f} s ({cpu_model()}, os.cpu_count() "
          f"{os.cpu_count()})")

    def spawn():
        t = threading.Thread(target=lambda: None)
        t.start()
        t.join()

    spawn_ms = []
    for _ in range(21):
        t0 = time.perf_counter()
        spawn()
        spawn_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"host: one thread started and joined in {statistics.median(spawn_ms):.4f} ms "
          "(median of 21; the C++ sort starts its threads twice in each byte pass)")
    for n, label, dtype, pairs in ((1 << 20, "u32", np.uint32, False),
                                   (1 << 20, "u64", np.uint64, False),
                                   (1 << 10, "u32", np.uint32, False),
                                   (1 << 10, "u64", np.uint64, False),
                                   (1 << 20, "u32 pairs", np.uint32, True),
                                   (1 << 20, "u64 pairs", np.uint64, True)):
        high = 1 << 12 if pairs else np.iinfo(dtype).max  # ties, for the payload
        k = rng.integers(0, high, n, endpoint=not pairs, dtype=np.uint64).astype(dtype)
        v = np.arange(n, dtype=np.uint32) if pairs else None

        def args():
            return k.copy(), (v.copy() if pairs else None)

        got, want = host.host_radix_sort(*args()), host.host_radix_sort_plain(*args())
        for a, b in zip(got, want):
            if (a is None) != (b is None) or (a is not None and not (
                    a.dtype == b.dtype and np.array_equal(a, b))):
                raise AssertionError(f"host_radix_sort {label} differs from its "
                                     "numpy version")

        def timed(fn):
            times = []
            for _ in range(REPS):
                a = args()
                t0 = time.perf_counter()
                fn(*a)
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        ms, plain_ms = timed(host.host_radix_sort), timed(host.host_radix_sort_plain)
        print(f"host_radix_sort 2^{n.bit_length() - 1} {label}: bit-equal to its numpy version; "
              f"{ms:.4f} ms, numpy stable argsort {plain_ms:.4f} ms (host clock, "
              f"median of {REPS})")
    x = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    for level in range(4):
        if not np.array_equal(host.host_histogram(x, level),
                              host.host_histogram_plain(x, level)):
            raise AssertionError(f"host_histogram level {level} differs from bincount")
    print("host_histogram 2^20 u32, levels 0-3: equal to np.bincount")


NUMPY_SIZES = [1 << e for e in range(1, 23)]
HOST_PATH_SIZES = (1 << 4, 1 << 10, 1 << 15)


def numpy_calls(rt, config, _build, rng, launches):
    """The builder's five calls with numpy in and numpy out
    (``radix_sort_unstable`` on u32, u64 and f64, ``sort_key_value(stable=
    True)`` of u32 keys with a u32 payload, stable ``argsort`` of u64), each
    equal to numpy: once at every power of two from 2 to 2^22 on the device
    path (``host_sort_max`` 0), with B1 among its launches above
    ``sorter.COMPARATIVE_CUTOFF`` keys (below it the Sorter sorts without a
    histogram), and once at each of ``HOST_PATH_SIZES`` on the host path
    (``host_sort_max`` above the size), which must launch no kernel.  The
    device path's launches are the phase's."""
    from rdst_tpu_torch.sorter import COMPARATIVE_CUTOFF

    calls = {
        "radix_sort_unstable u32": lambda n: (
            (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),),
            lambda x: rt.radix_sort_unstable(x), lambda x: np.sort(x)),
        "radix_sort_unstable u64": lambda n: (
            (rng.integers(0, 2**64, n, dtype=np.uint64),),
            lambda x: rt.radix_sort_unstable(x), lambda x: np.sort(x)),
        "radix_sort_unstable f64": lambda n: (
            (rng.standard_normal(n),), lambda x: rt.radix_sort_unstable(x),
            lambda x: np.sort(x)),
        "sort_key_value u32 + u32, stable": lambda n: (
            (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
             rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)),
            lambda k, v: rt.sort_key_value(k, v, stable=True),
            lambda k, v: (k[np.argsort(k, kind="stable")], v[np.argsort(k, kind="stable")])),
        "argsort u64, stable": lambda n: (
            (rng.integers(0, 2**64, n, dtype=np.uint64),), lambda x: rt.argsort(x),
            lambda x: np.argsort(x, kind="stable")),
    }

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    saved = config.host_sort_max
    dev_counts = {name: 0 for name in _build.KERNELS}
    t_phase = time.perf_counter()
    try:
        for label, make in calls.items():
            for n in NUMPY_SIZES:
                args, fn, oracle = make(n)
                want = oracle(*args)
                paths = [("device", 0)] + [("host", 1 << 30)] * (n in HOST_PATH_SIZES)
                for path, limit in paths:
                    config.host_sort_max = limit
                    for k in _build.KERNELS.values():
                        k.launches = 0
                    if not same(fn(*args), want):
                        raise AssertionError(f"{label} 2^{n.bit_length() - 1} "
                                             f"{path} path differs from numpy")
                    c = {name: k.launches for name, k in _build.KERNELS.items()}
                    if path == "host" and any(c.values()):
                        raise AssertionError(f"{label} 2^{n.bit_length() - 1}: the host "
                                             f"path launched kernels: {c}")
                    if path == "device":
                        if n > COMPARATIVE_CUTOFF and c["multi_level_histogram"] <= 0:
                            raise AssertionError(f"{label} 2^{n.bit_length() - 1}: the "
                                                 "device path launched no B1")
                        for name in dev_counts:
                            dev_counts[name] += c[name]
    finally:
        config.host_sort_max = saved
    for name in KERNEL_INFO:
        launches[name] += dev_counts.get(name, 0)
    print(f"numpy calls: {len(calls)} calls at {len(NUMPY_SIZES)} sizes (2 to 2^22) on "
          f"the device path and at {len(HOST_PATH_SIZES)} on the host path, every result "
          f"equal to numpy's; host-path launches 0; device-path launches {dev_counts}; "
          f"{time.perf_counter() - t_phase:.1f} s")


def trace_phase(launches):
    """The trace phase, run in a fresh process (``chip_smoke.py --trace``,
    :func:`trace_child`): on the card's machine a process whose CUDA context
    had run for a minute or two dropped the first kernels of a trace, while a
    fresh one kept every kernel (``scripts/torch_trace_age.py``).  The
    child's launch counts are the phase's."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace"], cwd=root,
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    if r.returncode != 0:
        raise AssertionError(f"the trace phase failed ({r.returncode}):\n{r.stderr[-3000:]}")
    counted = json.loads(lines[-1])["launches"]
    for name in KERNEL_INFO:
        launches[name] += counted[name]


def trace_child() -> int:
    """One warm ``Sorter.run`` on 2^25 u64 keys already on the card inside
    ``utils.trace.profile_to``, with CUDA events around it and every launch
    count set to 0 just before it.  The trace's kernel events must name the
    B1 and B8 kernels (``hist_kernel`` of csrc/histogram.cu,
    ``radix_pass_kernel`` of csrc/radix_pass.cu), with as many events of
    each as its launches were counted; u64 keys launch no B2 or B3.  The
    last line printed is the launch counts, as JSON."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --trace: CUDA is not available", file=sys.stderr)
        return 2
    from rdst_tpu_torch import _build
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch import keys
    from rdst_tpu_torch import parallel  # noqa: F401  (B6's counter)
    from rdst_tpu_torch.sorter import Sorter
    from rdst_tpu_torch.utils.trace import profile_to

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    x = torch.empty(1 << 25, dtype=torch.int64, device=dev).random_(generator=gen)
    nk = keys.normalize(x.view(torch.uint64), device=dev)
    sorter = Sorter()
    sorter.run(nk)  # warm
    torch.cuda.synchronize()
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_trace")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for k in _build.KERNELS.values():
        k.launches = 0
    with profile_to(logdir) as path:
        ev[0].record()
        out, _ = sorter.run(nk)
        ev[1].record()
    counted = {name: _build.KERNELS[name].launches for name in KERNEL_INFO}
    event_ms = ev[0].elapsed_time(ev[1])
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    want = {"hist_kernel": counted["multi_level_histogram"],
            "radix_pass_kernel": counted["radix_pass"]}
    if counted["merge_tail"] or counted["merge_stage"]:
        raise AssertionError(f"Sorter.run merged: {counted}")
    if counted["bitonic_tail"] or counted["bitonic_span"]:
        raise AssertionError(f"Sorter.run took the network: {counted}")
    found, total_ms = {}, 0.0
    for e in events:
        total_ms += e["dur"] / 1e3
        for k in want:
            if k in e["name"]:
                n, ms = found.get(k, (0, 0.0))
                found[k] = (n + 1, ms + e["dur"] / 1e3)
    for k, n in want.items():
        if n <= 0 or found.get(k, (0, 0.0))[0] != n:
            order = sorted(events, key=lambda e: e["ts"])
            raise AssertionError(
                f"trace: {found.get(k, (0, 0.0))[0]} {k} events for {n} launches "
                f"counted ({len(events)} kernel events; first "
                f"{[e['name'][:48] for e in order[:4]]})")
    ref = torch.sort(x ^ -(1 << 63)).values ^ -(1 << 63)
    got = (P.widen(out.words[0]) << 32) | P.widen(out.words[1])
    if not torch.equal(got, ref):
        raise AssertionError("the traced Sorter.run differs from torch.sort")
    print(f"path trace: Sorter.run 2^25 u64 on the card under profile_to, in a fresh "
          f"process; launches {counted}")
    print(f"trace: {os.path.relpath(path)} ({os.path.getsize(path)} B): "
          + ", ".join(f"{k} {found[k][0]} events, {found[k][1]:.4f} ms" for k in want)
          + f"; every kernel event {total_ms:.4f} ms in {len(events)}; the call "
          f"{event_ms:.4f} ms (CUDA events, under the profiler); bit-exact vs torch.sort")
    print(json.dumps({"launches": counted}))
    return 0


DIST_MODES = {  # mode: (world size, backend, rows in all, card entries a rank)
    "nccl1": (1, "nccl", 1 << 28, 1),
    "gloo2": (2, "gloo", 1 << 27, 1),
    "gloo2x2": (2, "gloo", 1 << 27, 2),  # two entries of the one card a rank
    "nccl2": (2, "nccl", 1 << 24, 1),  # tried once: NCCL may refuse one card twice
}
NCCL_PROBE = "probing: an all_reduce over two NCCL ranks on one card"


def multiprocess_phase(launches):
    """The shuffle and the table operators over processes, in fresh child
    processes on the one card (``chip_smoke.py --dist MODE RANK``,
    :func:`dist_child`): (i) one NCCL rank, (ii) two gloo ranks with 4
    shards each, whose exchanges cross processes through B6's rectangular
    launch, (iii) the same two ranks each holding two entries of the card
    (``devices=[card] * 2``, two shards an entry), whose exchanges land
    through B6's multi-card form, (iv) two NCCL ranks on the
    one card, tried once.  What NCCL answers in (iii), inside its first
    collective (an error, a hang or a crash there), is printed as a finding;
    any other failure fails the phase.  Each child's last line is its
    launch counts."""
    root = os.path.dirname(os.path.abspath(__file__))
    rdv = os.path.join(root, "build", "chip_smoke_dist")
    os.makedirs(rdv, exist_ok=True)
    for mode, (world, *_rest) in DIST_MODES.items():
        init = os.path.join(rdv, mode)
        if os.path.exists(init):
            os.remove(init)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist", mode, str(r),
             "file://" + init], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        outs = []
        try:
            for r, p in enumerate(procs):
                try:
                    out, err = p.communicate(timeout=150 if mode == "nccl2" else 600)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, err = p.communicate()
                    err += f"\nrank {r}: no exit within the time limit, killed"
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (rc, out, err) in enumerate(outs):
            lines = out.strip().splitlines()
            for line in lines[:-1]:
                print(f"[{mode} rank {r}] {line}")
            verdict = [x for x in lines if x.startswith("finding: NCCL")]
            if mode == "nccl2" and not verdict and NCCL_PROBE in lines:
                # no answer from inside the collective: the crash or hang
                # there is NCCL's answer
                tail = " | ".join(err.strip().splitlines()[-6:])
                print(f"[{mode} rank {r}] finding: NCCL gave no answer inside its first "
                      f"collective (exit {rc}); stderr ends: {tail}")
                continue
            if rc != 0 or not lines:
                raise AssertionError(f"the {mode} phase failed on rank {r} ({rc}):\n"
                                     f"{err[-4000:]}")
            for name, c in json.loads(lines[-1])["launches"].items():
                launches[name] += c
        print(f"multi-process {mode}: {world} rank(s) done in "
              f"{time.perf_counter() - t0:.1f} s")


def dist_child(mode, rank, init) -> int:
    """One rank of :func:`multiprocess_phase`.  Inputs are made on the card
    from a seed, the same on every rank, and the one-process
    ``make_mesh(8)`` results (the sort's, and this rank's share of the
    table paths', :func:`dist_table_refs`) are computed before the process
    group starts; each rank then passes its own rows.  Every sort variant's
    output is held bit-equal to that result (planes and counts on the flat
    mesh, the valid rows elsewhere) and to torch.sort, then the table
    paths run (:func:`dist_table_paths`).  The counted call of each
    variant and path records the shapes of its B2-B6 launches (B6's
    multi-card form with its cards, where a rank holds several entries);
    afterwards each shape is held against its plain version on this
    rank."""
    import datetime

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke --dist: CUDA is not available", file=sys.stderr)
        return 2
    from rdst_tpu_torch import _build
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch import parallel as par
    from rdst_tpu_torch.ops import fused_merge as fm
    from rdst_tpu_torch.ops import fused_sort as fs
    from rdst_tpu_torch.parallel import mesh as M
    from rdst_tpu_torch.parallel import remote_dma as rd
    from rdst_tpu_torch.parallel import shuffle as sh

    world, backend, n, K = DIST_MODES[mode]
    dev = torch.device("cuda", 0)
    entries = [dev] * K if K > 1 else None
    _build.library()
    sign = -(1 << 63)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    hi, lo = [P.narrow(torch.randint(0, 1 << 32, (n,), generator=gen, device=dev,
                                     dtype=torch.int64), torch.uint32) for _ in range(2)]
    pay = P.arange(n, torch.uint32, dev)
    ref_key, ref_idx = torch.sort(((P.widen(hi) << 32) | P.widen(lo)) ^ sign, stable=True)
    ref_key ^= sign
    want = [P.narrow(ref_key >> 32, torch.uint32), P.narrow(ref_key & 0xFFFFFFFF, torch.uint32),
            P.narrow(ref_idx, torch.uint32)]
    del ref_key, ref_idx
    one = par.distributed_sort([hi, lo], [pay], mesh=par.make_mesh(8), stable=True)
    one_planes, one_counts = one[0] + one[1], one[2]
    del one
    cap = one_planes[0].shape[0] // 8

    def same(a, b):
        return all(torch.equal(P.sview(x), P.sview(y)) for x, y in zip(a, b))

    def dense(planes, counts, first, L, cap):
        c = counts.tolist()
        return [P.cat([p[i * cap:i * cap + c[first + i]] for i in range(L)]) for p in planes]

    if not same(dense(one_planes, one_counts, 0, 8, cap), want):  # all 8 shards
        raise AssertionError("the one-process make_mesh(8) result differs from torch.sort")
    tables = dist_table_refs(torch, par, dev, world, rank) if mode != "nccl2" else None

    par.init_distributed(backend=backend, device="cuda", init_method=init, rank=rank,
                         world_size=world, timeout=datetime.timedelta(seconds=60))
    print(f"rank {rank} of {world}, {backend}, card {torch.cuda.get_device_name(0)}")
    if mode == "nccl2":
        print(NCCL_PROBE, flush=True)
        try:
            x = torch.full((4,), rank + 1, dtype=torch.int64, device=dev)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            print(f"finding: NCCL ran an all_reduce over two ranks on one card: "
                  f"{x.tolist()}")
        except Exception as e:  # the finding is what NCCL says
            print(f"finding: NCCL refused two ranks on one card: "
                  f"{type(e).__name__}: {' '.join(str(e).split())[:600]}")
            print(json.dumps({"launches": {}}), flush=True)
            os._exit(0)  # no teardown of a communicator NCCL refused
    L = 8 // world
    first = rank * L
    rows = slice(first * (n // 8), (first + L) * (n // 8))
    on = dict(devices=entries) if entries else {}
    if world == 1:
        variants = [("make_mesh(8)", par.make_mesh(8), {}),
                    ("make_mesh_2d(1, 8)", par.make_mesh_2d(1, 8), {})]
    else:
        variants = [("make_mesh(8)", par.make_mesh(8, **on), {}),
                    ("make_mesh_2d(2, 4)", par.make_mesh_2d(2, 4, **on), {}),
                    ("make_mesh(8), overlap_exchange", par.make_mesh(8, **on),
                     dict(overlap_exchange=True))]
    launches = {name: 0 for name in KERNEL_INFO}
    seen = {}  # B2-B5 and B8: the counted calls' launches by shape
    b6_cases = {}  # B6: (senders, receivers, planes, capacity) -> a copy of its inputs
    shapes = set()  # B6's shapes in the current variant's counted call
    cards_sent = []  # B6's multi-card calls: as cards_calls records them
    b6 = keep_b6_inputs(torch, rd, b6_cases, shapes)
    b6_cards = keep_b6_cards_inputs(torch, sh, cards_sent)

    def joined(planes):  # an output plane of K > 1 entries: its blocks in order
        return [torch.cat(x) if isinstance(x, list) else x for x in planes]

    for label, mesh, kw in variants:
        if len(mesh.axis_names) == 2:
            kw = dict(kw, axis=mesh.axis_names)

        def call():
            return par.distributed_sort([hi[rows], lo[rows]], [pay[rows]], mesh=mesh,
                                        stable=True, **kw)

        for k in _build.KERNELS.values():
            k.launches = 0
        for k in M.TRANSPORT:
            M.TRANSPORT[k] = 0
        shapes.clear()
        calls_before = len(cards_sent)
        if world > 1:
            dist.barrier()
        torch.cuda.synchronize()
        with patched(rd, "remote_dma_exchange_cuda", b6), \
                patched(sh, "remote_dma_exchange_cards", b6_cards(label)), \
                record_shapes(fs, fm, seen):
            t0 = time.perf_counter()
            w, p, c = call()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        counted = {name: _build.KERNELS[name].launches for name in KERNEL_INFO}
        for name, v in counted.items():
            launches[name] += v
        moved = dict(M.TRANSPORT)
        if entries and any(not isinstance(x, list) or [b.device for b in x] != entries
                           for x in w + p):
            raise AssertionError(f"{label}: outputs are not one block an entry")
        w, p = joined(w), joined(p)
        got = dense(w + p, c, first, L, int(w[0].shape[0]) // L)
        start = sum(c.tolist()[:first])
        if not same(got, [x[start:start + got[0].shape[0]] for x in want]):
            raise AssertionError(f"{label} differs from torch.sort")
        if "axis" not in kw:  # the flat mesh: the one-process result's own shards
            mine = [x[first * cap:(first + L) * cap] for x in one_planes]
            if not (torch.equal(c, one_counts)
                    and same(got, dense(mine, one_counts, first, L, cap))):
                raise AssertionError(f"{label}: counts or rows differ from the "
                                     "one-process mesh")
            if not kw and not same(w + p, mine):
                raise AssertionError(f"{label}: planes differ from the one-process mesh")
        if counted["remote_exchange"] <= 0:
            raise AssertionError(f"{label} exchanged without B6")
        landed = cards_landed(cards_sent[calls_before:])
        if entries and not landed:
            raise AssertionError(f"{label}: no B6 call read remote senders on card 0 "
                                 "into receivers on card 1")
        if world > 1 and not entries and not any(s != r for s, r, _, _ in shapes):
            raise AssertionError(f"{label}: B6 never launched in its rectangular form")
        del w, p, c, got
        # warm time, then the split with a synchronize around each piece
        if world > 1:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        split = _timed_split(torch, sh, M, rd, call) if world > 1 else {}
        print(f"path {label} (rank {rank}): first {first_s:.4f} s, warm {warm:.4f} s, "
              f"{n / warm:,.0f} rows/s over {world} rank(s)"
              + (f" of {K} card entries" if entries else "")
              + f"; bit-exact vs torch.sort and the one-process make_mesh(8); launches "
              f"{counted}; B6 shapes (senders, receivers, planes, capacity) "
              f"{sorted(shapes)}" + (f"; multi-card B6 calls (send cards, receive "
                                     f"cards, planes, capacity) "
                                     f"{cards_shapes(cards_sent[calls_before:])}, "
                                     f"{landed} with remote senders on card 0 and "
                                     "receivers on card 1" if entries else "")
              + f"; transport {moved}" + (f"; split (synchronized run, s): {split}"
                                          if split else ""))
    del hi, lo, pay, want, one_planes, one_counts
    torch.cuda.empty_cache()
    dist_table_paths(torch, par, M, sh, rd, fs, fm, dev, world, rank, tables, launches,
                     seen, b6, shapes, b6_cards, cards_sent, entries)
    del tables
    torch.cuda.empty_cache()

    # every B6 shape of the counted calls, then every B2-B5 and B8 shape
    for key in sorted(b6_cases):
        _b6_case(torch, rd, b6_cases.pop(key), key, f"rank {rank}")
    torch.cuda.empty_cache()
    planes_of, check = child_checks(torch, P, gen, dev, f"rank {rank}")
    if entries:  # each multi-card shape, timed, against the plain per-card form
        check_b6_cards(torch, par, rd, dev, entries, cards_sent, planes_of,
                       child_checks(torch, P, gen, dev, f"rank {rank}", timed=True)[1])
        del cards_sent[:]
        torch.cuda.empty_cache()
    check_recorded(fs, fm, seen, planes_of, check, main=False)
    print(json.dumps({"launches": launches}))
    dist.destroy_process_group()
    return 0


def _table_calls(par, li, od, mask, mesh):
    """The table paths of the multi-process phase, as the table phase runs
    them: name -> (rows, call, kind, the oracle count its count must sum
    to).  ``kind`` "static": the whole static-length output, L * capacity
    rows a rank; "dense": densified rows."""
    aggs = {"sum_qty": ("quantity", "sum"), "n": ("quantity", "count"),
            "avg_qty": ("quantity", "mean"), "max_price": ("extendedprice", "max")}
    n_l, n_o = li.n_rows, od.n_rows
    return {
        "distributed_filter lineitem, Q1's shipdate cut": (
            n_l, lambda: par.distributed_filter(li, mask, mesh=mesh), "static", "kept"),
        "distributed_group_aggregate lineitem by orderkey (Q18), hash": (
            n_l, lambda: par.distributed_group_aggregate(
                li, "orderkey", aggs, mesh=mesh, partition="hash"), "dense", "groups"),
        "distributed_group_aggregate lineitem by orderkey (Q18), range": (
            n_l, lambda: par.distributed_group_aggregate(
                li, "orderkey", aggs, mesh=mesh, partition="range"), "dense", "groups"),
        "distributed_join lineitem x orders on orderkey, inner, hash": (
            n_l + n_o, lambda: par.distributed_join(li, od, "orderkey", mesh=mesh,
                                                    partition="hash"), "dense", "matches"),
        "distributed_sort_table orders by totalprice, stable": (
            n_o, lambda: par.distributed_sort_table(od, "totalprice", mesh=mesh,
                                                    stable=True), "static", "sorted"),
    }


def dist_table_refs(torch, par, dev, world, rank, n_lineitem=1 << 26, n_orders=1 << 24):
    """Before ``init_distributed``: TPC-H lineitem 2^26 and orders 2^24
    (``tpch_tables`` from a seed, the same on every rank), each table path's
    one-process ``make_mesh(8)`` result cut to this rank's shards' share
    (its L * capacity rows of a static output; of a densified one, the rows
    its shards produced, found from the per-shard counts that ``_dense``
    was given), and the torch oracles' counts.  The rows and shares are
    held on the host until the table paths run, so the sort variants before
    them have the card as they had it without them.  Returns (this rank's
    rows of lineitem, orders and Q1's mask, {path: (share, count)}, oracle
    counts)."""
    from rdst_tpu_torch.parallel import dtable
    from rdst_tpu_torch.table import Table

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    lineitem, orders, cutoff, _ = tpch_tables(torch, dev, gen, n_lineitem, n_orders)
    mask = lineitem["shipdate"] <= cutoff
    L = 8 // world
    first = rank * L
    oracle = {"kept": int(mask.sum()),
              "groups": torch.unique(lineitem["orderkey"]).numel(),
              "matches": lineitem["orderkey"].numel(),
              "sorted": orders["orderkey"].numel()}
    calls = _table_calls(par, Table(lineitem), Table(orders), mask,
                         par.make_mesh(8, device=dev))
    given = []
    real = dtable._dense

    def rec(per_shard, counts):
        given.append(list(counts))
        return real(per_shard, counts)

    refs = {}
    dtable._dense = rec
    try:
        for name, (_, call, kind, _) in calls.items():
            table, count = call()
            if kind == "static":
                cap = table.n_rows // 8
                lo, hi = first * cap, (first + L) * cap
            else:
                c = given.pop()
                lo, hi = sum(c[:first]), sum(c[:first + L])
            refs[name] = ({k: table[k][lo:hi].cpu() for k in table.column_names},
                          count.cpu() if isinstance(count, torch.Tensor) else count)
            del table, count
    finally:
        dtable._dense = real
    del calls

    def mine(t):
        k = next(iter(t.values())).numel() // world
        return {c: v[rank * k:(rank + 1) * k].cpu() for c, v in t.items()}

    li, od = mine(lineitem), mine(orders)
    m = mine({"m": mask})["m"]
    del lineitem, orders, mask
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return li, od, m, refs, oracle


def dist_table_paths(torch, par, M, sh, rd, fs, fm, dev, world, rank, tables,
                     launches, seen, b6, shapes, b6_cards, cards_sent, entries):
    """After the sort variants: the four table operators on ``make_mesh(8)``
    over this process group (on the card ``entries`` of each rank where
    given), each rank passing its own rows.  Each path's counted call
    records its B2-B5 and B8 shapes (``record_shapes``) and B6's (``b6``, and the
    multi-card calls with ``b6_cards`` into ``cards_sent``); its rows (one
    Table an entry, concatenated) and counts must be bit-equal to this
    rank's share of the one-process result and its count to the torch
    oracle's.  Then ``WARM_CALLS`` timed calls (the median is the warm time)
    with their peak device memory and, over several ranks, a synchronized
    split."""
    from rdst_tpu_torch import _build
    from rdst_tpu_torch.table import Table

    li, od, mask, refs, oracle = tables
    li, od = ({c: v.to(dev) for c, v in t.items()} for t in (li, od))
    mask = mask.to(dev)
    mesh = par.make_mesh(8, device=dev, devices=entries)
    calls = _table_calls(par, Table(li), Table(od), mask, mesh)
    for name, (rows, call, kind, key) in calls.items():
        for k in _build.KERNELS.values():
            k.launches = 0
        for k in M.TRANSPORT:
            M.TRANSPORT[k] = 0
        shapes.clear()
        calls_before = len(cards_sent)
        if world > 1:
            torch.distributed.barrier()
        torch.cuda.synchronize()
        with patched(rd, "remote_dma_exchange_cuda", b6), \
                patched(sh, "remote_dma_exchange_cards", b6_cards(name)), \
                record_shapes(fs, fm, seen):
            t0 = time.perf_counter()
            table, count = call()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        if entries:
            if not isinstance(table, list) or [t.device for t in table] != entries:
                raise AssertionError(f"{name}: the output is not one Table an entry")
            table = Table({c: torch.cat([t[c] for t in table])
                           for c in table[0].column_names})
        counted = {k: _build.KERNELS[k].launches for k in KERNEL_INFO}
        for k, v in counted.items():
            launches[k] += v
        moved = dict(M.TRANSPORT)
        host, want_count = refs.pop(name)
        want = {c: w.to(dev) for c, w in host.items()}
        if table.column_names != list(want) or any(  # bit for bit
                not torch.equal(table[c].view(torch.uint8), w.view(torch.uint8))
                for c, w in want.items()):
            raise AssertionError(f"{name} (rank {rank}): rows differ from this rank's "
                                 "share of the one-process make_mesh(8) result")
        if isinstance(count, torch.Tensor):
            want_count = want_count.to(dev)
            ok = count.dtype == want_count.dtype and torch.equal(count, want_count)
            total = int(count.sum())
        else:
            ok = count == want_count
            total = count
        if not ok or total != oracle[key]:
            raise AssertionError(f"{name} (rank {rank}): count {total} differs from the "
                                 f"one-process result's or the oracle's {oracle[key]}")
        landed = cards_landed(cards_sent[calls_before:])
        if key != "kept":  # every path but the filter exchanges
            if counted["remote_exchange"] <= 0:
                raise AssertionError(f"{name} exchanged without B6")
            if entries and not landed:
                raise AssertionError(f"{name}: no B6 call read remote senders on card 0 "
                                     "into receivers on card 1")
            if world > 1 and not entries and not any(s != r for s, r, _, _ in shapes):
                raise AssertionError(f"{name}: B6 never launched in its rectangular form")
        del table, count, host, want
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(WARM_CALLS):
            if world > 1:
                torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del again
        peak = torch.cuda.max_memory_allocated()
        warm = statistics.median(times)
        if world > 1:
            torch.distributed.barrier()
        split = _timed_split(torch, sh, M, rd, call) if world > 1 else {}
        print(f"path table: {name} (rank {rank}): first {first_s * 1e3:.3f} ms, warm "
              f"{warm * 1e3:.3f} ms (median of {WARM_CALLS}; {min(times) * 1e3:.3f}-"
              f"{max(times) * 1e3:.3f}), {rows * world / warm:,.0f} rows/s over {world} "
              f"rank(s) ({rows} rows a rank); "
              f"peak device memory {peak} B ({peak / GiB:.2f} GiB), of which {base} B "
              f"({base / GiB:.2f} GiB) held before the calls; bit-exact vs this rank's "
              f"share of the one-process make_mesh(8), count {total} as the oracle's; "
              f"launches B2 {counted['bitonic_tail']}, B3 {counted['bitonic_span']}, "
              f"B4 {counted['merge_stage']}, B5 {counted['merge_tail']}, B6 "
              f"{counted['remote_exchange']}; B6 shapes (senders, receivers, planes, "
              f"capacity) {sorted(shapes)}" + (
                  f"; on {len(entries)} card entries a rank, multi-card B6 calls (send "
                  f"cards, receive cards, planes, capacity) "
                  f"{cards_shapes(cards_sent[calls_before:])}, {landed} with remote "
                  "senders on card 0 and receivers on card 1" if entries else "")
              + f"; transport {moved}"
              + (f"; split (synchronized run, s): {split}" if split else ""))
    del calls, li, od, mask, refs


def _aligned_clone(torch, t):
    """A copy of a u32 plane at the same word offset mod 4 (B6's copies
    take another path at each residue)."""
    r = (t.data_ptr() // 4) % 4
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[(r - buf.data_ptr() // 4) % 4:][:t.numel()]
    out.copy_(t)
    return out


def _timed_split(torch, sh, M, rd, call):
    """One more call with a synchronize around each piece: the size read
    (the sizes' all_gather and the host read of the size matrix), the
    staging of each card's outgoing words to the communicator's device
    (``shuffle._stage``: gloo's copy to the CPU), the transport
    (``Mesh.all_to_all``, its copies back from the CPU included), B6 inside
    the cross-process exchanges and B6 in the exchanges within a process
    (the 2-axis mesh's stage 2), each in either form (one launch, or
    ``remote_dma_exchange_cards``' launch per receiving card), the rest of
    each cross-process exchange (packing, the offset tables), the sorts,
    split at the first exchange (the local sorts before it, the routing
    and finish sorts after), a table operator's body (``dtable._agg_local``,
    ``_agg_combine`` with its gather, ``_join_local``) and densify
    (``_dense``), and the rest of the call (under gloo, every other
    collective's round trip through the CPU among it).  "size read" holds
    every ``Mesh.read_gathered``: the size matrices and the operators'
    gathered counts."""
    from rdst_tpu_torch.parallel import dtable as dt

    acc = collections.Counter()
    state = {"exchanged": False, "across": False}
    saved = (M.Mesh.all_to_all, rd.remote_dma_exchange_cuda, sh._exchange_across,
             sh._local_sort, M.Mesh.read_gathered, sh.remote_dma_exchange_cards,
             sh._stage)
    body = {k: getattr(dt, k) for k in ("_agg_local", "_agg_combine", "_join_local",
                                         "_dense")}

    def timed(key, fn):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[key() if callable(key) else key] += time.perf_counter() - t0
            return out
        return wrap

    def across(*a, **k):
        state["exchanged"] = state["across"] = True
        try:
            return saved[2](*a, **k)
        finally:
            state["across"] = False

    def b6_key():
        return "B6" if state["across"] else "B6 within a process"

    def restore():
        (M.Mesh.all_to_all, rd.remote_dma_exchange_cuda, sh._exchange_across,
         sh._local_sort, M.Mesh.read_gathered, sh.remote_dma_exchange_cards,
         sh._stage) = saved

    M.Mesh.all_to_all = timed("transport", saved[0])
    rd.remote_dma_exchange_cuda = timed(b6_key, saved[1])
    sh._exchange_across = timed("exchange", across)
    sh._local_sort = timed(lambda: "sorts after" if state["exchanged"] else "sorts before",
                           saved[3])
    M.Mesh.read_gathered = timed("size read", saved[4])
    sh.remote_dma_exchange_cards = timed(b6_key, saved[5])
    sh._stage = timed("staging", saved[6])
    for k, fn in body.items():
        setattr(dt, k, timed("densify" if k == "_dense" else "body", fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        restore()
        for k, fn in body.items():
            setattr(dt, k, fn)
    acc["exchange rest"] = (acc["exchange"] - acc["transport"] - acc["B6"]
                            - acc["size read"] - acc["staging"])
    del acc["exchange"]
    acc["rest of the call"] = total - sum(acc.values())
    acc["call"] = total
    return {k: round(v, 4) for k, v in sorted(acc.items())}


def keep_b6_inputs(torch, rd, cases, shapes):
    """A stand-in for B6's launch (``rd.remote_dma_exchange_cuda``) that
    adds each launch's (senders, receivers, planes, capacity) to ``shapes``
    and keeps a copy of the first launch's inputs at each shape in
    ``cases``, for :func:`_b6_case`."""
    real = rd.remote_dma_exchange_cuda

    def b6(planes, offs, sizes, capacity):
        key = (len(planes), int(sizes[0].shape[0]), len(planes[0]), capacity)
        shapes.add(key)
        if key not in cases:
            cases[key] = ([[_aligned_clone(torch, q) for q in ps] for ps in planes],
                          [o.clone() for o in offs], [z.clone() for z in sizes])
        return real(planes, offs, sizes, capacity)
    return b6


def child_checks(torch, P, gen, dev, tag, timed=False):
    """``planes_of`` and ``check`` for :func:`check_recorded` in a child
    process: random planes from ``gen``, and a check that prints the error
    with ``tag`` and raises unless the kernel is bit-equal to its plain
    version; ``timed``: it also prints the kernel's and the plain version's
    times (CUDA events) and the bound from its ``moved`` bytes."""
    def planes_of(n, dtypes):
        return [P.narrow(torch.randint(0, P.all_ones(dt) + 1, (n,), generator=gen,
                                       device=dev, dtype=torch.int64), dt)
                for dt in dtypes]

    def check(name, label, kernel_fn, plain_fn, moved=None, **_):
        got = kernel_fn()
        err = max_err(got, plain_fn())
        times = ""
        if timed:
            ms, plain_ms = cuda_ms(torch, kernel_fn), cuda_ms(torch, plain_fn)
            bound = moved(got) / HBM * 1e3
            times = (f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound:.4f} ms "
                     f"(bytes), kernel at {bound / ms:.1%} of it")
        del got
        print(f"{name} [{label}; {tag}]: max_abs_err={err}{times}")
        if err != 0:
            raise AssertionError(f"{name} [{label}; {tag}] disagrees with its plain "
                                 f"version (max_abs_err {err})")
    return planes_of, check


@contextlib.contextmanager
def record_histograms(H, seen):
    """While a path runs, count B1's launches by their arguments:
    ``seen[(words, n_levels, level0)][n]``."""
    real = H.histogram_cuda

    def fn(words, n_levels, level0=0):
        book = seen.setdefault((len(words), n_levels, level0), {})
        n = int(words[0].shape[0])
        book[n] = book.get(n, 0) + 1
        return real(words, n_levels, level0)

    H.histogram_cuda = fn
    try:
        yield seen
    finally:
        H.histogram_cuda = real


def _b6_case(torch, rd, rec, key, tag):
    """B6 at one shape a counted call gave it, on a copy of that launch's
    inputs, against its plain version: bit-exact, its time alone on
    buffers made beforehand (CUDA events) beside its bound and the plain
    version's."""
    src, offs, sizes = rec
    S, R, k, cap = key
    so, sz = torch.stack(offs), torch.stack(sizes)
    got = rd.remote_dma_exchange_cuda(src, offs, sizes, cap)
    want = rd.remote_dma_exchange_plain(src, offs, sizes, cap)
    err = max_err(got[0] + [got[1], got[2]], want[0] + [want[1], want[2]])
    if err != 0:
        raise AssertionError(f"B6 {S} x {R} differs from its plain version "
                             f"(max_abs_err {err})")
    recv = [torch.empty(R * cap, dtype=torch.uint32, device=src[0][0].device)
            for _ in range(k)]
    arrived = torch.zeros((k, R), dtype=torch.int64, device=src[0][0].device)
    ms = cuda_ms(torch, lambda: rd.launch_all(src, so, sz, recv, arrived, cap))
    plain_ms = cuda_ms(torch, lambda: rd.remote_dma_exchange_plain(src, offs, sizes, cap))
    landed = int(rd.exchange_layout(sz, cap).landed.sum())
    moved = 4 * k * (landed + R * cap)
    bound = moved / HBM * 1e3
    print(f"remote_exchange [{S} senders x {R} receivers, {k} planes, capacity {cap}, "
          f"{tag}]: max_abs_err={err} kernel {ms:.4f} ms (the launch alone), "
          f"plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({moved} B; bytes), kernel at "
          f"{bound / ms:.1%} of it")


# (script, its arguments on the card, the kernels its run must launch): the
# measurement harnesses at a depth that keeps the phase short (bench_suite
# and the consumer at full width); timings calls sort_words, which runs no
# B1.  harness_phase runs every examples/torch_*.py beside them.
_SORTS = ("multi_level_histogram", EXECUTOR)
HARNESSES = [
    ("scripts/torch_bench_suite.py", [], _SORTS + ("merge_stage", "merge_tail")),
    ("scripts/torch_bench_single_algo.py", ["--n", str(1 << 22), "--tuners"], _SORTS),
    ("scripts/torch_timings.py", ["--min-exp", "16", "--max-exp", "22",
                                  "--out", "build/chip_smoke_timings.csv"],
     (EXECUTOR,)),
    ("scripts/torch_capacity_study.py", ["--n", str(1 << 20)], ("remote_exchange",)),
    ("scripts/torch_bench_mesh.py", [], ("remote_exchange",)),
    ("fixtures/torch_consumer.py", [], ("multi_level_histogram",)),
]


def harness_phase(launches):
    """Every ``examples/torch_*.py`` with ``--device cuda`` and every
    harness of ``HARNESSES``, each in a fresh child on the card
    (:func:`harness_child`), all started together; each must exit 0.  Their
    output is printed and their launch counts added to ``launches``; each
    harness must have launched the kernels its entry names."""
    root = os.path.dirname(os.path.abspath(__file__))
    examples = sorted(f for f in os.listdir(os.path.join(root, "examples"))
                      if f.startswith("torch_") and f.endswith(".py"))
    if len(examples) != 7:
        raise AssertionError(f"examples: {examples}")
    runs = [(f"examples/{f}", ["--device", "cuda"], ()) for f in examples] + HARNESSES
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--harness",
                               script, *args], cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for script, args, _ in runs]
    failed = []
    try:
        for (script, args, need), p in zip(runs, procs):
            out, err = p.communicate(timeout=900)
            lines = out.strip().splitlines()
            for line in lines[:-1]:
                print(f"harness {script}: {line}")
            if p.returncode != 0 or not lines:
                failed.append(f"{script} {' '.join(args)}: exit {p.returncode}\n"
                              f"{err[-3000:]}")
                continue
            counted = json.loads(lines[-1])["launches"]
            print(f"harness {script} {' '.join(args)}: exit 0; launches {counted}")
            for name in KERNEL_INFO:
                launches[name] += counted[name]
            if not_launched(counted, need):
                failed.append(f"{script}: did not launch {need}: {counted}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("harnesses failed:\n" + "\n".join(failed))
    print(f"harnesses: {len(examples)} examples and {len(HARNESSES)} harnesses exited 0 "
          f"on the card in {time.perf_counter() - t0:.1f} s (run together)")


def harness_child(argv) -> int:
    """Run one harness or example (``argv``: its path from the checkout root
    and its arguments) as ``__main__`` in this fresh process under
    :func:`recorded_child`."""
    import runpy

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), argv[0])

    def run():
        sys.argv = [script, *argv[1:]]
        runpy.run_path(script, run_name="__main__")
    return recorded_child(os.path.basename(argv[0]), run)


def recorded_child(tag, run, every_length=False) -> int:
    """Call ``run`` in this fresh process, recording the shape of every
    kernel launch it makes (B1 by its words, levels and length, B2-B5 and
    B8 by :func:`record_shapes`, B6 with a copy of its inputs).  Then hold every
    recorded shape against its plain version (B1 at each (words, levels)
    group's shortest and longest length, or with ``every_length`` at each
    length it was launched with), and print the launch counts of
    the run, read before the checks, as the last line, as JSON.  A check
    that disagrees raises, so the child exits non-zero."""
    import torch

    if not torch.cuda.is_available():
        print(f"chip_smoke ({tag}): CUDA is not available", file=sys.stderr)
        return 2
    from rdst_tpu_torch import _build
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch.ops import fused_merge as fm
    from rdst_tpu_torch.ops import fused_sort as fs
    from rdst_tpu_torch.ops import histogram as H
    from rdst_tpu_torch.parallel import remote_dma as rd

    seen, hists, b6_cases = {}, {}, {}
    real_b6 = rd.remote_dma_exchange_cuda
    rd.remote_dma_exchange_cuda = keep_b6_inputs(torch, rd, b6_cases, set())
    try:
        with record_shapes(fs, fm, seen), record_histograms(H, hists):
            run()
    finally:
        rd.remote_dma_exchange_cuda = real_b6
    torch.cuda.synchronize()
    counted = {name: _build.KERNELS[name].launches for name in KERNEL_INFO}

    n_b6 = len(b6_cases)
    for key in sorted(b6_cases):
        _b6_case(torch, rd, b6_cases.pop(key), key, tag)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    planes_of, check = child_checks(torch, P, gen, torch.device("cuda", 0), tag)
    for (k, n_levels, level0), book in sorted(hists.items()):
        for n in sorted(book if every_length else {min(book), max(book)}):
            w = planes_of(n, (torch.uint32,) * k)
            check("multi_level_histogram", f"path shape {n} x {k} words, levels "
                  f"{level0}..{level0 + n_levels - 1}; {book[n]} launches of this length",
                  lambda: H.histogram_cuda(w, n_levels, level0),
                  lambda: H.histogram_plain(w, n_levels, level0))
            del w
    check_recorded(fs, fm, seen, planes_of, check, main=False)
    print(f"{tag}: bit-exact against the plain versions at every recorded shape: "
          f"multi_level_histogram "
          f"{sum(len(b if every_length else {min(b), max(b)}) for b in hists.values())}, "
          + "".join(f"{name} {len({sig[:2] for sig in book})}, "
                    for name, book in seen.items()) + f"remote_exchange {n_b6}")
    print(json.dumps({"launches": counted}))
    return 0


def graft_child() -> int:
    """``torch_graft_entry``'s ``entry()``, its sort held against
    ``torch.sort``, and ``dryrun_multichip(n)`` for n = 1, 2, 4 and 8 on
    the card, each printing its kernel launches and which route each
    shuffle sort took, under :func:`recorded_child`."""
    def run():
        import torch

        import torch_graft_entry as ge
        from rdst_tpu_torch import _build
        from rdst_tpu_torch.parallel import shuffle

        fn, (hi, lo) = ge.entry()
        shi, slo = fn(hi, lo)
        packed = (hi.view(torch.int32).to(torch.int64) << 32) | (
            lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
        want = torch.sort(packed ^ (-1 << 63)).values ^ (-1 << 63)
        got = (shi.view(torch.int32).to(torch.int64) << 32) | (
            slo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
        if not torch.equal(got, want):
            raise AssertionError("entry(): the sort differs from torch.sort")
        print(f"entry(): {hi.shape[0]} two-word keys on {hi.device}, bit-equal to "
              "torch.sort of their packed view")
        for n in (1, 2, 4, 8):
            before = {name: _build.KERNELS[name].launches for name in KERNEL_INFO}
            shuffle.SORT_ROUTES.clear()
            t0 = time.perf_counter()
            ge.dryrun_multichip(n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {name: _build.KERNELS[name].launches - before[name]
                      for name in KERNEL_INFO}
            routes = collections.Counter()
            for (_, _, route), c in shuffle.SORT_ROUTES.items():
                routes[route] += c
            print(f"dryrun_multichip({n}): every step passed in {dt:.3f} s; launches "
                  f"{counts}; shuffle sorts by route {dict(routes)}")
    return recorded_child("torch_graft_entry.py", run)


# torch_bench.py's runs in the entry-points phase: (arguments, the log2 sizes
# it must print, the kernels it must launch); bench.py's flags, with the
# low-memory plan at the default size so that B4/B5 lie on the bench's path
BENCH_RUNS = [
    ([], [25], (EXECUTOR,)),
    (["--plan", "lowmem"], [25], ("merge_stage", "merge_tail")),
    (["--sweep"], [25, 26, 27, 28], (EXECUTOR,)),
    (["--sweep-large", "--try-2e30"], [28, 29, 30], (EXECUTOR,)),
    (["--sweep-large", "--try-2e30", "--planes", "1"], [28, 29, 30], (EXECUTOR,)),
]
_CHECKED = re.compile(r"n=(\d+) words=\d+ plan=\S+: the last step is bit-equal")
_PEAK = re.compile(r"peak device memory n=(\d+) words=\d+: (\d+) B")


def _entry_child(args, label, need, launches):
    """Run ``chip_smoke.py ARGS`` alone in a fresh child; print its lines,
    add its launch counts to ``launches`` and require the kernels ``need``.
    Returns its standard output's and standard error's lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), *args], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                       text=True, timeout=900)
    out, err = p.stdout.strip().splitlines(), p.stderr.splitlines()
    if p.returncode != 0 or not out:
        raise AssertionError(f"{label}: exit {p.returncode}\n{p.stderr[-3000:]}")
    for line in out[:-1]:
        print(f"{label}: {line}")
    for line in err:
        if line.startswith("torch_bench: "):
            print(f"{label}: {line[len('torch_bench: '):]}")
    counted = json.loads(out[-1])["launches"]
    print(f"{label}: exit 0 in {time.perf_counter() - t0:.1f} s; launches {counted}")
    for name in KERNEL_INFO:
        launches[name] += counted[name]
    if not_launched(counted, need):
        raise AssertionError(f"{label}: did not launch {need}: {counted}")
    return out, err


def entry_phase(launches):
    """The root entry points on the card: every run of ``BENCH_RUNS`` and
    :func:`graft_child`, each in a fresh child, one at a time (the 2^30
    sizes hold tens of GiB).  Every size must print a rate above 0 and its
    last step must be bit-equal to ``torch.sort``, except that an
    out-of-memory line at 2^30 is a finding, printed with its peak.  Each
    child holds every kernel shape it launched against its plain version."""
    t0 = time.perf_counter()
    for args, logns, need in BENCH_RUNS:
        label = f"torch_bench.py {' '.join(args)}".strip()
        out, err = _entry_child(["--harness", "torch_bench.py", *args], label, need,
                                launches)
        rows = [json.loads(line) for line in out if line.startswith('{"metric"')]
        sizes = [int(r["metric"].rsplit("_n", 1)[1]) for r in rows]
        if sizes != [1 << e for e in logns]:
            raise AssertionError(f"{label}: sizes {sizes}")
        checked = {int(m.group(1)) for m in map(_CHECKED.search, err) if m}
        peaks = {int(m.group(1)): int(m.group(2)) for m in map(_PEAK.search, err) if m}
        for n, r in zip(sizes, rows):
            if "error" in r:
                if n == 1 << 30 and "OutOfMemoryError" in r["error"]:
                    print(f"finding: {label}: {r['metric']} ran out of device memory "
                          f"at a peak of {peaks[n]} B ({peaks[n] / GiB:.2f} GiB): "
                          f"{r['error']}")
                    continue
                raise AssertionError(f"{label}: {r}")
            if not r["value"] > 0 or n not in checked:
                raise AssertionError(f"{label}: n={n}: {r}; last step checked: "
                                     f"{n in checked}")
    _entry_child(["--graft"], "torch_graft_entry.py", ("remote_exchange",), launches)
    print(f"entry points: {len(BENCH_RUNS)} torch_bench.py runs and torch_graft_entry.py "
          f"exited 0 on the card in {time.perf_counter() - t0:.1f} s (one at a time)")


# the acceptance phase's children, one at a time: (the script and its
# arguments, the kernels its run must launch)
ACCEPTANCE_RUNS = [
    (["scripts/torch_acceptance.py", "--json", "build/ACCEPT_torch_h100.json"],
     _SORTS + ("merge_stage", "merge_tail")),
    (["scripts/torch_floor_table.py"], _SORTS),
]
ACCEPTANCE_CHECKS = 11  # tpu_acceptance.py's checks
_FLOOR_ROW = re.compile(r"^\| (?!shape )(.+?) \| ((?:[0-9.]+ \| ){5})")


def acceptance_phase(launches):
    """``scripts/torch_acceptance.py`` (the JAX package's acceptance checks
    at their sizes, numpy in and out through the default dispatcher) and
    ``scripts/torch_floor_table.py`` (five shapes: the dispatcher, the fused
    executor raw, ``torch.sort`` on the same planes, the bound and the
    executor's floor), each in a fresh child under :func:`recorded_child`,
    one at a time.  Every check must pass, and the floor table must print
    its five rows with every column above 0; each child holds every kernel
    shape it launched against its plain version."""
    t0 = time.perf_counter()
    (args, need), (floor_args, floor_need) = ACCEPTANCE_RUNS
    out, _ = _entry_child(["--harness", *args], "torch_acceptance.py", need, launches)
    passed = [line for line in out if line.startswith("PASS ")]
    if len(passed) != ACCEPTANCE_CHECKS or "ALL OK" not in out:
        raise AssertionError(f"torch_acceptance.py: {len(passed)} checks passed of "
                             f"{ACCEPTANCE_CHECKS}")
    seconds = sum(float(re.search(r"\(([0-9.]+) s e2e\)$", line).group(1))
                  for line in passed)
    print(f"acceptance: {len(passed)} checks passed, {seconds:.3f} s in the port's "
          f"calls (numpy in and out), ALL OK")
    out, _ = _entry_child(["--harness", *floor_args], "torch_floor_table.py", floor_need,
                          launches)
    rows = [m for m in map(_FLOOR_ROW.match, out) if m]
    if len(rows) != 5 or any(float(v) <= 0 for m in rows
                             for v in m.group(2).split(" | ")[:5]):
        raise AssertionError(f"torch_floor_table.py: rows {[m.group(0) for m in rows]}")
    print(f"acceptance phase: both scripts exited 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s (one at a time)")


# -- the device-flow phase ------------------------------------------------------


def flow_cases():
    """``tests/flow_cases.py``: the device-flow case table, its inputs,
    calls and checks, which the CPU tests share."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import flow_cases as fc
    return fc


def device_flow_child() -> int:
    """Every case of ``DEVICE_FLOW_CASES`` on the card through
    ``flow_case``, one line a case, under :func:`recorded_child`, which
    holds B1 at every length the cases launched it with."""
    def run():
        import rdst_tpu_torch as rt
        from rdst_tpu_torch import _build
        from rdst_tpu_torch import config
        from rdst_tpu_torch.native import host

        fc = flow_cases()
        total = {name: 0 for name in KERNEL_INFO}
        t0 = time.perf_counter()
        for name in fc.DEVICE_FLOW_CASES:
            _, counts, line = fc.flow_case(rt, config, host, _build.KERNELS, name)
            print(line)
            for k, c in counts.items():
                total[k] += c
        # recorded_child reads the counts after run(): the phase's total
        for k, c in total.items():
            _build.KERNELS[k].launches = c
        print(f"device flow: {len(fc.DEVICE_FLOW_CASES)} cases in "
              f"{time.perf_counter() - t0:.1f} s, launches {total}")
    return recorded_child("device flow", run, every_length=True)


def device_flow_phase(launches):
    """:func:`device_flow_child` in a fresh child: every case must print its
    line, and the child holds every kernel shape it launched against its
    plain version."""
    t0 = time.perf_counter()
    out, _ = _entry_child(["--device-flow"], "device flow", _SORTS, launches)
    done = [line for line in out if line.startswith("case ")]
    cases = flow_cases().DEVICE_FLOW_CASES
    if len(done) != len(cases):
        raise AssertionError(f"device flow: {len(done)} cases of {len(cases)} printed")
    print(f"device-flow phase: {len(done)} cases exited 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    if sys.argv[1:] == ["--trace"]:
        return trace_child()
    if sys.argv[1:2] == ["--harness"]:
        return harness_child(sys.argv[2:])
    if sys.argv[1:] == ["--graft"]:
        return graft_child()
    if sys.argv[1:] == ["--device-flow"]:
        return device_flow_child()
    if sys.argv[1:2] == ["--dist"]:
        return dist_child(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import rdst_tpu_torch as rt
        from rdst_tpu_torch import _build
        from rdst_tpu_torch import _planes as P
        from rdst_tpu_torch import config
        from rdst_tpu_torch import keys as K
        from rdst_tpu_torch.ops import fused_merge as fm
        from rdst_tpu_torch.ops import fused_sort as fs
        from rdst_tpu_torch.ops import histogram as H
        from rdst_tpu_torch.ops import radix_sort as rs
        from rdst_tpu_torch import parallel as par
        from rdst_tpu_torch.parallel import remote_dma as rd
    except ImportError as e:
        print(f"chip_smoke: rdst_tpu_torch is not importable: {e}",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    _build.library()
    print(f"kernels built and loaded in {_build.build_seconds:.2f} s")

    def planes_u32(n, k, high=1 << 32):
        return [
            P.narrow(torch.randint(0, high, (n,), generator=gen, device=dev,
                                   dtype=torch.int64), torch.uint32)
            for _ in range(k)
        ]

    def planes_of(n, dtypes, high=None):
        out = []
        for dt in dtypes:
            top = P.all_ones(dt) + 1 if high is None else high
            v = torch.randint(0, top, (n,), generator=gen, device=dev,
                              dtype=torch.int64)
            out.append(P.narrow(v, dt))
        return out

    # -- 2. kernels against their plain versions ------------------------------
    results = {name: {"max_abs_err": 0} for name in KERNEL_INFO}

    def check(name, label, kernel_fn, plain_fn, main_shape=False, moved=None,
              ops=0):
        """``name``: a kernel, or a tuple of the kernels a composite runs.
        ``moved``: bytes read and written, a function of the output
        (default: every output plane and its input plane once each)."""
        got = kernel_fn()
        torch.cuda.synchronize()
        want = plain_fn()
        err = max_err(got, want)
        ms = cuda_ms(torch, kernel_fn)
        plain_ms = cuda_ms(torch, plain_fn)
        moved = 2 * nbytes(got) if moved is None else moved(got)
        bound = max(moved / HBM, ops / ALU) * 1e3
        by = "bytes" if moved / HBM >= ops / ALU else "operations"
        names = name if isinstance(name, tuple) else (name,)
        print(f"{'+'.join(names)} [{label}]: max_abs_err={err} kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound:.4f} ms "
              f"({moved} B, {ops} ops; {by}), kernel at {bound / ms:.1%} of it")
        if err != 0:
            raise AssertionError(f"{name} [{label}] disagrees with its plain "
                                 f"version (max_abs_err {err})")
        for nm in names:
            r = results[nm]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if main_shape:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        return got

    n = 1 << 25
    # B1: two u32 planes (a u64 key), all 8 byte levels
    w = planes_u32(n, 2)
    def hist_moved(words):
        return lambda g: nbytes(words) + nbytes(g)

    check("multi_level_histogram", "2^25 x 2 words, uniform",
          lambda: H.histogram_cuda(w, 8), lambda: H.histogram_plain(w, 8),
          main_shape=True, moved=hist_moved(w), ops=2 * n * 8)
    packed = torch.sort(torch.randint(0, 1 << 62, (n,), generator=gen,
                                      device=dev)).values
    ws = [P.narrow(packed >> 32, torch.uint32),
          P.narrow(packed & 0xFFFFFFFF, torch.uint32)]
    got = check("multi_level_histogram", "2^25 x 2 words, presorted",
                lambda: H.histogram_cuda(ws, 8),
                lambda: H.histogram_plain(ws, 8), moved=hist_moved(ws))
    res = H.unpack(got.cpu().numpy(), 8)
    if res.sorted_prefix != n or not res.level_sorted[7]:
        raise AssertionError("presorted input: prefix or top level unsorted")
    we = [P.full(n, 0x01020304, torch.uint32, dev)] * 2
    check("multi_level_histogram", "2^25 x 2 words, all equal",
          lambda: H.histogram_cuda(we, 8), lambda: H.histogram_plain(we, 8),
          moved=hist_moved(we))
    wr = [p[: n - 12345] for p in w]
    check("multi_level_histogram", "2^25-12345 x 2 words, ragged",
          lambda: H.histogram_cuda(wr, 8), lambda: H.histogram_plain(wr, 8),
          moved=hist_moved(wr))
    check("multi_level_histogram", "level_histogram (one level)",
          lambda: H.histogram_cuda([w[1]], 1, 2),
          lambda: H.histogram_plain([w[1]], 1, 2), moved=hist_moved([w[1]]))
    # Zipf(1.1) rank frequencies over 2^20 distinct random u64 keys; one hot
    # key among equal ones; planes 12 bytes past a 16-byte boundary (the
    # carved buckets of sorts/msb.py start at any word); the piece path's
    # 10M keys of one word, 4 levels
    pool = planes_u32(1 << 20, 2)
    rank = torch.arange(1, (1 << 20) + 1, device=dev, dtype=torch.float64) ** -1.1
    wz = [P.take(q, torch.multinomial(rank, n, replacement=True, generator=gen))
          for q in pool]
    del pool, rank
    check("multi_level_histogram", "2^25 x 2 words, Zipf(1.1) over 2^20 keys",
          lambda: H.histogram_cuda(wz, 8), lambda: H.histogram_plain(wz, 8),
          moved=hist_moved(wz))
    wh = [P.full(n, 0x01020304, torch.uint32, dev), P.full(n, 0x05060708, torch.uint32, dev)]
    P.sview(wh[1])[n // 3] = 9
    check("multi_level_histogram", "2^25 x 2 words, one key differs",
          lambda: H.histogram_cuda(wh, 8), lambda: H.histogram_plain(wh, 8),
          moved=hist_moved(wh))
    w3 = [p[3:] for p in w]
    check("multi_level_histogram", "2^25-3 x 2 words at word offset 3",
          lambda: H.histogram_cuda(w3, 8), lambda: H.histogram_plain(w3, 8),
          moved=hist_moved(w3))
    w10 = planes_u32(10_000_000, 1)
    check("multi_level_histogram", "10M x 1 word, 4 levels (the piece path's)",
          lambda: H.histogram_cuda(w10, 4), lambda: H.histogram_plain(w10, 4),
          moved=hist_moved(w10))
    del wz, wh, w3, w10
    # B1' against torch.bincount of the same level's byte plane, made
    # outside the timed region: a yardstick the port never calls
    byte_plane = (P.widen(w[1]) >> 16) & 0xFF
    lib = torch.bincount(byte_plane, minlength=256)
    if not torch.equal(H.level_histogram([w[1]], 2), lib):
        raise AssertionError("level_histogram differs from torch.bincount")
    lvl_ms = cuda_ms(torch, lambda: H.level_histogram([w[1]], 2))
    lib_ms = cuda_ms(torch, lambda: torch.bincount(byte_plane, minlength=256))
    print(f"level_histogram (B1') 2^25 x 1 word, level 2: kernel {lvl_ms:.4f} ms; "
          f"torch.bincount of the byte plane {lib_ms:.4f} ms (library yardstick, "
          f"equal counts); kernel / library {lvl_ms / lib_ms:.3f}")
    del byte_plane, lib

    # B2: the u64 sort's trip 1 (block 16384, rows of 4096: levels 13 and
    # 14 with the un-flip), one level of it, a two-level trip 1, a
    # single-level sweep, narrow planes, eight planes
    blk = fs.pick_blocks(2)[1]
    check("bitonic_tail", f"2^25 x 2, trip 1, block {blk}, un-flip",
          lambda: fs.tail_cuda(w, n, blk, 2, [(13, 4096), (14, 8192)], 12),
          lambda: fs.tail_plain(w, n, blk, 2, [(13, 4096), (14, 8192)], 12))
    check("bitonic_tail", f"2^25 x 2, one level, block {blk}, un-flip",
          lambda: fs.tail_cuda(w, n, blk, 2, [(13, 4096)], 12),
          lambda: fs.tail_plain(w, n, blk, 2, [(13, 4096)], 12))
    check("bitonic_tail", "2^25 x 2, two levels, un-flip",
          lambda: fs.tail_cuda(w, n, blk, 2, [(12, 2048), (13, 4096)], 11),
          lambda: fs.tail_plain(w, n, blk, 2, [(12, 2048), (13, 4096)], 11))
    check("bitonic_tail", "2^25 x 2, single level",
          lambda: fs.tail_cuda(w, n, blk, 2, [(21, blk // 2)], None),
          lambda: fs.tail_plain(w, n, blk, 2, [(21, blk // 2)], None))
    narrow = planes_of(1 << 24, [torch.uint16, torch.uint32, torch.uint8], 7)
    blk3 = fs.pick_blocks(3)[1]
    check("bitonic_tail", "2^24 u16+u32 keys, u8 rider",
          lambda: fs.tail_cuda(narrow, 1 << 24, blk3, 2,
                               [(12, 2048), (13, 4096)], 11),
          lambda: fs.tail_plain(narrow, 1 << 24, blk3, 2,
                                [(12, 2048), (13, 4096)], 11))
    eight = planes_of(1 << 22, [torch.uint32] * 8, 5)
    blk8 = fs.pick_blocks(8)[1]
    check("bitonic_tail", f"2^22 x 8 planes, block {blk8}",
          lambda: fs.tail_cuda(eight, 1 << 22, blk8, 3, [(20, blk8 // 2)], None),
          lambda: fs.tail_plain(eight, 1 << 22, blk8, 3,
                                [(20, blk8 // 2)], None))

    # B3: the u64 sort's span trips at P = 128, 64, 8 and 2, narrow and 8
    # planes
    for s_hi, s_lo, two_r in [(1 << 24, 1 << 18, 1 << 25),
                              (1 << 24, 1 << 19, 1 << 25),
                              (1 << 18, 1 << 13, 1 << 25),
                              (1 << 15, 1 << 13, 1 << 16),
                              (1 << 13, 1 << 13, 1 << 14)]:
        p_dim = 2 * s_hi // s_lo
        check("bitonic_span", f"2^25 x 2, P={p_dim}, s_hi=2^{s_hi.bit_length() - 1}",
              lambda: fs.span_cuda(w, n, s_hi, s_lo, two_r, blk, 2),
              lambda: fs.span_plain(w, n, s_hi, s_lo, two_r, blk, 2))
    check("bitonic_span", "2^24 u16+u32 keys, u8 rider, P=16",
          lambda: fs.span_cuda(narrow, 1 << 24, 1 << 16, 1 << 13, 1 << 18,
                               blk3, 2),
          lambda: fs.span_plain(narrow, 1 << 24, 1 << 16, 1 << 13, 1 << 18,
                                blk3, 2))
    check("bitonic_span", "2^22 x 8 planes, P=16",
          lambda: fs.span_cuda(eight, 1 << 22, 1 << 14, 1 << 11, 1 << 16,
                               blk8, 3),
          lambda: fs.span_plain(eight, 1 << 22, 1 << 14, 1 << 11, 1 << 16,
                                blk8, 3))
    del w, ws, we, wr, narrow, eight, packed
    piece_merge_checks(torch, P, fs, planes_of, check)
    radix_checks(torch, P, rs, H, planes_of, check)

    # B4/B5 at the chunked path's merge shape: two u64 key words, the
    # stable tiebreak plane and a u32 rider; then narrow planes, a float32
    # rider (its bits), eight planes, and merge_level (many pairs per pass)
    z4 = planes_u32(n, 2, 1 << 20) + [P.arange(n, torch.uint32, dev)] + \
        planes_u32(n, 1)
    blk4 = fm.pick_block(4)
    for s_ in (1 << 24, 1 << 13):
        check("merge_stage", f"2^25 x 4, stride 2^{s_.bit_length() - 1}",
              lambda: fm.merge_stage_cuda(z4, n, s_, 3),
              lambda: fm.merge_stage_plain(z4, n, s_, 3))
    want4 = check("merge_tail", f"2^25 x 4, block {blk4}",
                  lambda: fm.merge_tail_cuda(z4, n, blk4, 3),
                  lambda: fm.merge_tail_plain(z4, n, blk4, 3))
    own = [p.clone() for p in z4]
    out = fm.merge_tail_cuda(own, n, blk4, 3, in_place=True)
    torch.cuda.synchronize()
    if max_err(own, want4) or any(o.data_ptr() != p.data_ptr() for o, p in zip(out, own)):
        raise AssertionError("merge_tail in place differs from its plain version")
    print(f"merge_tail [2^25 x 4, block {blk4}, in place]: max_abs_err=0, written "
          "into its input planes")
    del z4, want4, own, out
    m24 = 1 << 24
    narrow = planes_of(m24, [torch.uint16, torch.uint32, torch.uint8], 7)
    blk3 = fm.pick_block(3)
    check("merge_stage", "2^24 u16+u32 keys, u8 rider, stride 2^20",
          lambda: fm.merge_stage_cuda(narrow, m24, 1 << 20, 2),
          lambda: fm.merge_stage_plain(narrow, m24, 1 << 20, 2))
    check("merge_tail", f"2^24 u16+u32 keys, u8 rider, block {blk3}",
          lambda: fm.merge_tail_cuda(narrow, m24, blk3, 2),
          lambda: fm.merge_tail_plain(narrow, m24, blk3, 2))
    f32 = [planes_u32(m24, 1, 1000)[0],
           torch.randn(m24, generator=gen, device=dev).view(torch.uint32)]
    check("merge_stage", "2^24 u32 key, float32 rider, stride 2^16",
          lambda: fm.merge_stage_cuda(f32, m24, 1 << 16, 1),
          lambda: fm.merge_stage_plain(f32, m24, 1 << 16, 1))
    check("merge_tail", "2^24 u32 key, float32 rider",
          lambda: fm.merge_tail_cuda(f32, m24, fm.pick_block(2), 1),
          lambda: fm.merge_tail_plain(f32, m24, fm.pick_block(2), 1))
    eight = planes_of(1 << 22, [torch.uint32] * 8, 5)
    blk8 = fm.pick_block(8)
    check("merge_stage", "2^22 x 8 planes, stride 2^21",
          lambda: fm.merge_stage_cuda(eight, 1 << 22, 1 << 21, 3),
          lambda: fm.merge_stage_plain(eight, 1 << 22, 1 << 21, 3))
    check("merge_tail", f"2^22 x 8 planes, block {blk8}",
          lambda: fm.merge_tail_cuda(eight, 1 << 22, blk8, 3),
          lambda: fm.merge_tail_plain(eight, 1 << 22, blk8, 3))
    del narrow, f32, eight
    # 32 sorted runs of 2^20: 16 pairs merge in every launch
    runs = torch.randint(0, 1 << 30, (n,), generator=gen, device=dev)
    runs = torch.sort(runs.view(-1, 1 << 20), dim=1).values.reshape(-1)
    lvl = [P.narrow(runs, torch.uint32), planes_u32(n, 1)[0]]
    del runs
    check(("merge_stage", "merge_tail"), "merge_level 2^25 x 2, runs of 2^20",
          lambda: fm.merge_level(lvl, 1 << 20, 1),
          lambda: plain_route(fm, lambda: fm.merge_level(lvl, 1 << 20, 1)))
    del lvl
    torch.cuda.empty_cache()

    # -- 3. the paths end to end ---------------------------------------------
    rng = np.random.default_rng(SEED)
    launches = {name: 0 for name in KERNEL_INFO}

    def drive(label, n_keys, fn, merges=False, exchange=False):
        """Run one path with every launch count set to 0 just before it and
        read just after; print its plan trace, time and rate."""
        for k in _build.KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        trace = io.StringIO()
        with config.work_profiles(True), contextlib.redirect_stdout(trace):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = {name: _build.KERNELS[name].launches for name in KERNEL_INFO}
        for name, c in counts.items():
            launches[name] += c
        plans = " | ".join(trace.getvalue().strip().splitlines())
        print(f"path {label}: {dt:.4f} s, {n_keys / dt:,.0f} keys/s; "
              f"plan: {plans}; launches {counts}")
        if merges and not (counts["merge_stage"] > 0 and counts["merge_tail"] > 0):
            raise AssertionError(f"path {label} merged without B4 and B5")
        if exchange and counts["remote_exchange"] <= 0:
            raise AssertionError(f"path {label} exchanged without B6")
        return out, plans

    x64 = rng.integers(0, 2**64, size=1 << 25, dtype=np.uint64)
    k32 = rng.integers(0, 2**32, size=10_000_000, dtype=np.uint32)
    v32 = rng.integers(0, 2**32, size=10_000_000, dtype=np.uint32)
    f64 = rng.standard_normal(1 << 22)
    specials = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf])
    at = rng.choice(f64.size, size=6 * 1000, replace=False)
    f64[at] = np.repeat(specials, 1000)
    f64_bits = f64.view(np.uint64).copy()
    f64_bits[at[:500]] |= np.uint64(0x3)  # NaN payload bits stay exact
    f64 = f64_bits.view(np.float64)

    y64, _ = drive("u64 2^25 (numpy in and out)", x64.size,
                   lambda: rt.radix_sort_unstable(x64))
    (ks, vs), _ = drive("u32 key-value 10M stable", k32.size,
                        lambda: rt.sort_key_value(k32, v32, stable=True))
    yf, _ = drive("f64 2^22 specials", f64.size,
                  lambda: rt.radix_sort_unstable(f64))
    for name in ("multi_level_histogram", "radix_pass"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the sort path")
    if not np.array_equal(y64, np.sort(x64)):
        raise AssertionError("u64 2^25 sort differs from np.sort")
    order = np.argsort(k32, kind="stable")
    if not (np.array_equal(ks, k32[order]) and np.array_equal(vs, v32[order])):
        raise AssertionError("stable key-value sort differs from argsort")
    u = f64.view(np.uint64)
    folded = np.where(u >> np.uint64(63) == 1, ~u, u | np.uint64(1 << 63))
    want = f64[np.argsort(folded, kind="stable")]
    if not np.array_equal(yf.view(np.uint64), want.view(np.uint64)):
        raise AssertionError("f64 sort differs from the total-order oracle")
    print("sorts u64 2^25, u32 key-value 10M, f64 2^22: bit-exact vs numpy")
    dt = cuda_ms(torch, lambda: rt.radix_sort_unstable(x64))
    print(f"sort u64 2^25 warm: {dt:.2f} ms, {x64.size / dt * 1e3:,.0f} keys/s "
          f"(median of {REPS}, numpy in and out)")
    sorter_headline(torch, P, x64, dev)
    del y64, ks, vs, yf, k32, v32, f64, order, folded, want, u
    sorter_sorted(torch, P, K, rng, dev, drive)

    # the low-memory Regions path at the real gate: 2^30 int64 keys (39 bits
    # of entropy, so ~2^20 ties; the low bit set as the sign bit, so both
    # signs) and int32 values, made on the card
    n30 = 1 << 30
    keys = torch.empty(n30, dtype=torch.int64, device=dev).random_(generator=gen)
    keys >>= 24
    keys ^= keys << 63
    vals = torch.empty(n30, dtype=torch.int32, device=dev).random_(generator=gen)
    planes_gib = n30 * 12 / GiB
    print(f"regions 2^30: {planes_gib:.1f} GiB of planes, gate "
          f"{config.low_mem_threshold_bytes / GiB:.1f} GiB")
    # B1 at 2^30 x 2 words on the keys' normalized planes
    w30 = list(K.normalize(keys, device=dev).words)
    check("multi_level_histogram", "2^30 x 2 words (the Regions keys' planes)",
          lambda: H.histogram_cuda(w30, 8), lambda: H.histogram_plain(w30, 8),
          moved=hist_moved(w30))
    del w30
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seen_regions = {}
    with record_shapes(fs, fm, seen_regions):
        (ok_, (ov,)), plans = drive(
            "regions 2^30 int64 + int32, low-mem tuner, stable", n30,
            lambda: rt.radix_sort_builder(keys, [vals]).with_low_mem_tuner()
            .with_stable().sort(), merges=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"regions 2^30 peak device memory: {peak} B ({peak / GiB:.2f} GiB), "
          f"of which inputs {base} B ({base / GiB:.2f} GiB) held by the caller")
    if "PLAN: Regions" not in plans:
        raise AssertionError("the 2^30 low-memory sort did not pick Regions")
    ref_keys, ref_idx = torch.sort(keys, stable=True)
    if not torch.equal(ok_, ref_keys):
        raise AssertionError("regions 2^30 keys differ from torch.sort")
    del ref_keys
    if not torch.equal(ov, vals[ref_idx]):
        raise AssertionError("regions 2^30 values differ from the stable order")
    print("regions 2^30: bit-exact vs torch.sort(stable=True) and its gather")
    del keys, vals, ok_, ov, ref_idx
    torch.cuda.empty_cache()
    # B8 at every shape the chunk sorts gave it
    if "radix_pass" not in seen_regions:
        raise AssertionError(f"the Regions chunk sorts ran {sorted(seen_regions)}")
    check_recorded(fs, fm, {"radix_pass": seen_regions["radix_pass"]}, planes_of, check)
    torch.cuda.empty_cache()

    # the JAX package's acceptance shape: 20M u64, the gate forced open
    klm = rng.integers(0, 2**64, size=20_000_000, dtype=np.uint64)
    old_gate = config.low_mem_threshold_bytes
    config.low_mem_threshold_bytes = 1
    try:
        got, plans = drive(
            "lowmem 20M u64, gate forced", klm.size,
            lambda: rt.radix_sort_builder(klm).with_low_mem_tuner().sort(),
            merges=True)
    finally:
        config.low_mem_threshold_bytes = old_gate
    if "PLAN: Regions" not in plans or not np.array_equal(got, np.sort(klm)):
        raise AssertionError("lowmem 20M u64 differs from np.sort")
    print("lowmem 20M u64: bit-exact vs np.sort")
    del klm, got

    # a presorted merge: the first 15/16 sorted
    xp = rng.integers(0, 2**64, size=1 << 25, dtype=np.uint64)
    xp[: 15 * xp.size // 16] = np.sort(xp[: 15 * xp.size // 16])
    got, plans = drive("presorted 2^25 u64, 15/16 sorted", xp.size,
                       lambda: rt.radix_sort_unstable(xp), merges=True)
    if "PresortedMerge[" not in plans or not np.array_equal(got, np.sort(xp)):
        raise AssertionError("presorted 2^25 u64 differs from np.sort")
    print("presorted 2^25 u64: bit-exact vs np.sort")
    del xp, got

    # the bucketed MtOop plan, uniform and with one key on half the rows
    nb = 1 << 24
    for hot in (False, True):
        kb = rng.integers(0, 2**32, size=nb, dtype=np.uint32)
        if hot:
            kb[(kb >> 24) == 0x55] ^= np.uint32(1 << 24)  # top byte 0x55 pure
            kb[: nb // 2] = np.uint32(0x5555AAAA)
            rng.shuffle(kb)
        vb = rng.integers(0, 2**32, size=nb, dtype=np.uint32)
        (gk, (gv,)), plans = drive(
            f"bucketed MtOop 16M u32 key-value{' hot key' if hot else ''}",
            nb, lambda: rt.radix_sort_builder(kb, [vb])
            .with_algorithm(rt.Algorithm.MT_OOP).with_stable().sort())
        order = np.argsort(kb, kind="stable")
        if not (np.array_equal(gk, kb[order]) and np.array_equal(gv, vb[order])):
            raise AssertionError(f"bucketed (hot={hot}) differs from argsort")
        if "BatchedRows[" not in plans or hot != ("SingleKeySkip" in plans):
            raise AssertionError(f"bucketed (hot={hot}) plan: {plans}")
        print(f"bucketed 16M (hot={hot}): bit-exact vs numpy stable argsort")
    del kb, vb, gk, gv, order
    torch.cuda.empty_cache()

    distributed_paths(torch, P, par, rd, fs, fm, dev, gen, planes_u32, planes_of,
                      drive, check)
    table_paths(torch, par, dev, gen, drive, planes_of, check)
    cards_phase(torch, P, par, rd, dev, gen, planes_u32, planes_of, drive, check)
    host_runtime(rng)
    numpy_calls(rt, config, _build, rng, launches)
    trace_phase(launches)
    multiprocess_phase(launches)
    harness_phase(launches)
    entry_phase(launches)
    acceptance_phase(launches)
    device_flow_phase(launches)
    print(f"launches on the paths: {launches}")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # -- 4. report -------------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
        print(f"kernel {name}: {r['ms']:.4f} ms at its main shape, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} "
              f"of it; plain {r['plain_ms']:.4f} ms; {launches[name]} launches "
              "on the paths")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
