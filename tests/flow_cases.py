"""The device-flow cases: the JAX package's ``tests/test_ci_matrix.py``,
``test_device_flow.py`` and ``test_large_adversarial.py`` at their sizes, as
one table with its inputs, calls, numpy oracle and checks.

``tests/test_torch_{ci_matrix,device_flow,large_adversarial}.py`` run every
case through the port on the CPU (plain versions) and the JAX package and
hold them to each other; ``chip_smoke.py --device-flow`` runs every case
through the port on the card.  So this module imports neither JAX nor
either package: :func:`flow_runs` and :func:`flow_case` take the package and
its config as arguments, and :func:`gen_bimodal` is a copy of
``tests/helpers.gen_bimodal`` (which imports the JAX package), held to it by
``tests/test_torch_large_adversarial.py``.
"""
from __future__ import annotations

import contextlib
import io
import time
import zlib

import numpy as np

# Each case runs numpy in and out through the default entry points with
# config.host_sort_max = 0.  name: (call, keys, payload dtype).  The calls:
# "unstable" radix_sort_unstable(x), "serial"
# radix_sort_builder(x).with_parallel(False).sort(), "kv" / "kv unstable"
# sort_key_value(x, v, stable=...), "stable" radix_sort_builder(x, [v])
# .with_stable(True).sort(), and an Algorithm's name: the same with
# .with_algorithm(...), run three times.  The keys, made by flow_input:
# ("typed", dtype, n, specials) the full range of an integer dtype or normal
# floats (the first 8 +-NaN, +-Inf, +-0, +-1 with specials); ("u32", n, hot)
# uniform u32 (the first half ``hot`` where it is not None); ("below", dtype,
# n, high); ("bimodal", dtype, n, shift) tests/helpers.gen_bimodal's input;
# ("mask", n, mask); ("spike", n): one value with 5 outliers, shuffled.
FLOW_TYPES = ("uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32",
              "int64", "float32", "float64")
DET_ALGOS = ("LSB", "SKA", "REGIONS", "COMPARATIVE")
DET_SIZES = (100_000, (1 << 22) + 3)  # the second above fused_min_elems
DET_RUNS = 3
MASKS = (0xFF000000, 0x000000FF, 0xAAAAAAAA, 0x00FFFF00)
SCANNING = "flow scanning 50000001"
DEVICE_FLOW_CASES = {
    **{f"ci serial {dt}": ("serial", ("typed", dt, 8000, False), None)
       for dt in FLOW_TYPES},
    **{f"ci one tile {n}": ("unstable", ("u32", n, None), None)
       for n in (129, 2048, 2049, 4095)},
    **{f"ci determinism {a} {n}": (a, ("u32", n, None), "uint32")
       for n in DET_SIZES for a in DET_ALGOS},
    "ci f64 payload stable": ("kv", ("typed", "float64", 30_000, True), "uint64"),
    "ci f64 payload unstable": ("kv unstable", ("typed", "float64", 30_000, True),
                                "uint64"),
    "ci u64 payload host": ("stable", ("below", "uint64", 200_000, 1 << 16), "uint32"),
    **{f"flow {dt}": ("unstable", ("typed", dt, 10_000, True), None)
       for dt in FLOW_TYPES},
    "flow stable kv u16": ("kv", ("below", "uint16", 20_000, 64), "uint32"),
    "flow recombinating 1200000": ("unstable", ("u32", 1_200_000, None), None),
    "flow mtlsb 1000000 skewed": ("kv", ("u32", 1_000_000, 0xDEADBEEF), "uint32"),
    "flow regions 4200000 skewed": ("unstable", ("u32", 4_200_000, 12345), None),
    SCANNING: ("unstable", ("u32", 50_000_001, None), None),
    **{f"adv bimodal u32 {n} shift {s}": ("unstable", ("bimodal", "uint32", n, s), None)
       for n in (1_000_000, 2_500_000) for s in (0, 16)},
    **{f"adv bimodal u64 1500000 shift {s}": (
        "unstable", ("bimodal", "uint64", 1_500_000, s), None) for s in (0, 32)},
    **{f"adv mask 0x{m:08X}": ("unstable", ("mask", 2_000_000, m), None) for m in MASKS},
    "adv spike 5000000": ("unstable", ("spike", 5_000_000), None),
    "adv bimodal u64 payload stable": ("kv", ("bimodal", "uint64", 1_000_000, 32),
                                       "uint32"),
}

# Each case's "(level) PLAN: ..." lines, joined by " | ": the port's picks on
# the card must be these; tests/test_torch_{ci_matrix,device_flow,
# large_adversarial}.py hold them against the JAX package's traces on the
# CPU (50M + 1 against both packages' StandardTuner ladder).
DEVICE_FLOW_TRACES = {
    'ci serial uint8': '(0) PLAN: Lsb len=8000',
    'ci serial uint16': '(1) PLAN: Lsb len=8000',
    'ci serial uint32': '(3) PLAN: Lsb len=8000',
    'ci serial uint64': '(7) PLAN: Lsb len=8000',
    'ci serial int8': '(0) PLAN: Lsb len=8000',
    'ci serial int16': '(1) PLAN: Lsb len=8000',
    'ci serial int32': '(3) PLAN: Lsb len=8000',
    'ci serial int64': '(7) PLAN: Lsb len=8000',
    'ci serial float32': '(3) PLAN: LrLsb len=8000',
    'ci serial float64': '(7) PLAN: LrLsb len=8000',
    'ci one tile 129': '(3) PLAN: Lsb len=129',
    'ci one tile 2048': '(3) PLAN: Lsb len=2048',
    'ci one tile 2049': '(3) PLAN: Lsb len=2049',
    'ci one tile 4095': '(3) PLAN: Lsb len=4095',
    'ci determinism LSB 100000': '(3) PLAN: Lsb len=100000',
    'ci determinism SKA 100000': '(3) PLAN: Ska len=100000',
    'ci determinism REGIONS 100000': '(3) PLAN: Regions len=100000',
    'ci determinism COMPARATIVE 100000': '(3) PLAN: Comparative len=100000',
    'ci determinism LSB 4194307': '(3) PLAN: Lsb len=4194307',
    'ci determinism SKA 4194307': '(3) PLAN: Ska len=4194307',
    'ci determinism REGIONS 4194307': '(3) PLAN: Regions len=4194307',
    'ci determinism COMPARATIVE 4194307': '(3) PLAN: Comparative len=4194307',
    'ci f64 payload stable': '(7) PLAN: LrLsb len=30000',
    'ci f64 payload unstable': '(7) PLAN: LrLsb len=30000',
    'ci u64 payload host': '(7) PLAN: LrLsb len=200000',
    'flow uint8': '(0) PLAN: Lsb len=10000',
    'flow uint16': '(1) PLAN: Lsb len=10000',
    'flow uint32': '(3) PLAN: Lsb len=10000',
    'flow uint64': '(7) PLAN: Lsb len=10000',
    'flow int8': '(0) PLAN: Lsb len=10000',
    'flow int16': '(1) PLAN: Lsb len=10000',
    'flow int32': '(3) PLAN: Lsb len=10000',
    'flow int64': '(7) PLAN: Lsb len=10000',
    'flow float32': '(3) PLAN: LrLsb len=10000',
    'flow float64': '(7) PLAN: LrLsb len=10000',
    'flow stable kv u16': '(1) PLAN: LrLsb len=20000',
    'flow recombinating 1200000': '(3) PLAN: Recombinating len=1200000',
    'flow mtlsb 1000000 skewed': '(3) PLAN: MtLsb len=1000000',
    'flow regions 4200000 skewed': '(3) PLAN: Regions len=4200000',
    'flow scanning 50000001': '(3) PLAN: Scanning len=50000001',
    'adv bimodal u32 1000000 shift 0': '(3) PLAN: Recombinating len=1000000',
    'adv bimodal u32 1000000 shift 16': '(3) PLAN: MtLsb len=1000000',
    'adv bimodal u32 2500000 shift 0': '(3) PLAN: Recombinating len=2500000',
    'adv bimodal u32 2500000 shift 16': '(3) PLAN: MtLsb len=2500000',
    'adv bimodal u64 1500000 shift 0': '(7) PLAN: Recombinating len=1500000',
    'adv bimodal u64 1500000 shift 32': '(7) PLAN: MtLsb len=1500000',
    'adv mask 0xFF000000': '(3) PLAN: Recombinating len=2000000',
    'adv mask 0x000000FF': '(3) PLAN: MtLsb len=2000000',
    'adv mask 0xAAAAAAAA': '(3) PLAN: MtLsb len=2000000',
    'adv mask 0x00FFFF00': '(3) PLAN: MtLsb len=2000000',
    'adv spike 5000000': '(3) PLAN: Regions len=5000000',
    'adv bimodal u64 payload stable': '(7) PLAN: MtLsb len=1000000',
}


def gen_bimodal(rng, n, dtype, shift):
    """``tests/helpers.gen_bimodal``: a random pool, half shifted right and
    half shifted left (on the unsigned view)."""
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, size=n, endpoint=True, dtype=dtype)
    if shift:
        u = x.view(f"uint{np.dtype(dtype).itemsize * 8}")
        s = u.dtype.type(shift)
        u[: n // 2] >>= s
        u[n // 2:] <<= s
    return x


def flow_seed(name) -> int:
    return zlib.crc32(name.encode())


def flow_input(name):
    """A case's numpy keys and payload (``np.arange``, or None), made from
    its own seed."""
    _, (kind, *a), vdt = DEVICE_FLOW_CASES[name]
    rng = np.random.default_rng(flow_seed(name))
    if kind == "typed":
        dt, n, specials = a
        if np.dtype(dt).kind == "f":
            x = rng.standard_normal(n).astype(dt)
            if specials:
                x[:8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0]
        else:
            info = np.iinfo(dt)
            x = rng.integers(info.min, info.max, n, endpoint=True, dtype=dt)
    elif kind == "u32":
        n, hot = a
        x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
        if hot is not None:
            x[: n // 2] = hot
    elif kind == "below":
        dt, n, high = a
        x = rng.integers(0, high, size=n, dtype=dt)
    elif kind == "bimodal":
        dt, n, shift = a
        x = gen_bimodal(rng, n, np.dtype(dt), shift)
    elif kind == "mask":
        n, mask = a
        x = rng.integers(0, 2**32, size=n, dtype=np.uint32) & np.uint32(mask)
    else:  # spike
        (n,) = a
        x = np.full(n, 0x0000_0100, dtype=np.uint32)
        x[:5] = [0xFFFFFFFF, 1, 2, 3, 0x80000000]
        x = x[rng.permutation(n)]
    return x, (None if vdt is None else np.arange(x.size, dtype=vdt))


def flow_call(pkg, name, keys, payload, **kw):
    """One call of the case on ``pkg`` (``rdst_tpu_torch``, or the JAX
    package in the tests, with ``kw`` empty): (keys, payload or None)."""
    call = DEVICE_FLOW_CASES[name][0]
    if call == "unstable":
        return pkg.radix_sort_unstable(keys, **kw), None
    if call == "serial":
        return pkg.radix_sort_builder(keys, **kw).with_parallel(False).sort(), None
    if call.startswith("kv"):
        return pkg.sort_key_value(keys, payload, stable=call == "kv", **kw)
    b = pkg.radix_sort_builder(keys, [payload], **kw).with_stable(True)
    if call != "stable":
        b = b.with_algorithm(pkg.Algorithm[call])
    k, (p,) = b.sort()
    return k, p


def flow_runs(pkg, config, name, keys, payload, runs=None, **kw):
    """The case's calls (``runs``; by default ``DET_RUNS`` for a pinned
    Algorithm, else one) with ``config.host_sort_max = 0``: a list of
    (keys, payload, trace), the trace the call's ``(level) PLAN:`` lines
    joined by " | "."""
    if runs is None:
        runs = DET_RUNS if DEVICE_FLOW_CASES[name][0] in DET_ALGOS else 1
    out = []
    saved = config.host_sort_max
    config.host_sort_max = 0
    try:
        for _ in range(runs):
            trace = io.StringIO()
            with config.work_profiles(True), contextlib.redirect_stdout(trace):
                k, p = flow_call(pkg, name, keys, payload, **kw)
            out.append((np.asarray(k), None if p is None else np.asarray(p),
                        " | ".join(trace.getvalue().strip().splitlines())))
    finally:
        config.host_sort_max = saved
    return out


def _bits(a):
    return a.view(f"uint{a.itemsize * 8}") if a.dtype.kind == "f" else a


def flow_oracle(keys):
    """The stable order of ``keys`` in the sort's total order: floats by
    their bits with the sign folded (every negative below every positive,
    -NaN first and NaN last)."""
    if keys.dtype.kind == "f":
        u = _bits(keys)
        top = u.dtype.type(1 << (keys.itemsize * 8 - 1))
        keys = np.where(u & top, ~u, u | top)
    return np.argsort(keys, kind="stable")


def flow_check(name, keys, payload, got_keys, got_payload):
    """Raise unless a case's result is its numpy oracle's: keys bit-equal;
    a stable payload bit-equal, an unstable one the same (key, payload)
    multiset."""
    order = flow_oracle(keys)
    if got_keys.dtype != keys.dtype or not np.array_equal(_bits(got_keys),
                                                          _bits(keys[order])):
        raise AssertionError(f"{name}: keys differ from the numpy oracle")
    if payload is None:
        return
    if DEVICE_FLOW_CASES[name][0] == "kv unstable":
        kb = _bits(got_keys)
        got = np.lexsort((got_payload, kb))
        want = np.lexsort((payload, _bits(keys)))
        same = (np.array_equal(kb[got], _bits(keys)[want])
                and np.array_equal(got_payload[got], payload[want]))
    else:
        same = np.array_equal(got_payload, payload[order])
    if got_payload.dtype != payload.dtype or not same:
        raise AssertionError(f"{name}: payload differs from the numpy oracle")


def flow_case(rt, config, host, kernels, name, **kw):
    """Run one case through ``rt`` (``kw``: its ``device``, on the CPU in
    the tests) with the launch counts of ``kernels`` (the port's registry,
    ``_build.KERNELS``: name -> kernel) set to 0 just before
    and read just after, and hold it: its PLAN trace to
    ``DEVICE_FLOW_TRACES``, its result to its numpy oracle, a pinned
    Algorithm's three runs bit for bit to each other and the u64 payload
    case to ``host.host_radix_sort`` too.  Returns the runs (as
    :func:`flow_runs`), the launch counts and the case's line."""
    keys, payload = flow_input(name)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    runs = flow_runs(rt, config, name, keys, payload, **kw)  # numpy out: synced
    dt = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    for got_keys, got_payload, trace in runs:
        if trace != DEVICE_FLOW_TRACES[name]:
            raise AssertionError(f"{name}: plan {trace!r}, expected "
                                 f"{DEVICE_FLOW_TRACES[name]!r}")
        flow_check(name, keys, payload, got_keys, got_payload)
    first_keys, first_payload, plan = runs[0]
    for got_keys, got_payload, _ in runs[1:]:
        if not (np.array_equal(got_keys, first_keys)
                and np.array_equal(got_payload, first_payload)):
            raise AssertionError(f"{name}: the runs differ from each other")
    if name == "ci u64 payload host":
        hk, hv = host.host_radix_sort(keys.copy(), payload.copy())
        if not (np.array_equal(first_keys, hk) and np.array_equal(first_payload, hv)):
            raise AssertionError(f"{name}: differs from host_radix_sort")
    line = (f"case {name}: {len(runs)} call(s) in {dt:.4f} s (host clock, numpy in "
            f"and out); plan: {plan}; launches {counts}; bit-equal to its oracle")
    return runs, counts, line
