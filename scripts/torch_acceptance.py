"""Large-input acceptance checks of the PyTorch port on the card:
``scripts/tpu_acceptance.py`` on ``rdst_tpu_torch``.

The reference's comparison suites run to 50M elements in release mode
(test_utils.rs:63-95, CI rust.yml:32).  The CPU tests keep sizes small and
run the kernels' plain versions, so this script drives the big sizes, and
with them the production blocks of the fused executor and the merge
kernels, through the default dispatcher (builder -> Sorter -> plan) on the
card, numpy in and out, bit-exact against numpy oracles.  The checks, their
order, names, seed and sizes are those of ``tpu_acceptance.py``; ``SIZES``
holds the sizes in one table.

Each check prints ``PASS`` or ``FAIL``, its name and the seconds of the
port's call (numpy in, numpy out).  Then ``ALL OK`` or ``FAILURES
PRESENT``; the script exits 1 when a check failed.

    python scripts/torch_acceptance.py [--json ACCEPT_torch_h100.json]
    python scripts/torch_acceptance.py --device cpu    # with SIZES cut down

``--json`` writes ``{"device": "<name>, <power limit>", "all_ok": ...,
"checks": [...]}``, the card as nvidia-smi names it.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import rdst_tpu_torch as rt  # noqa: E402
from rdst_tpu_torch import _build  # noqa: E402
from rdst_tpu_torch import _planes as P  # noqa: E402
from rdst_tpu_torch import config as rconfig  # noqa: E402
from rdst_tpu_torch import keys as rkeys  # noqa: E402
from rdst_tpu_torch import parallel  # noqa: E402
from scripts.torch_timings import device_name  # noqa: E402

#: The rows of each check (tpu_acceptance.py's sizes).
SIZES = {
    "u32_50m": 50_000_000,
    "u32_20m": 20_000_000,
    "u64_20m": 20_000_000,  # the stable key-value and the f64 checks
    "zipf": 10_000_000,
    "pow2": 1 << 23,
    "struct": 4_000_000,
    "lowmem": 20_000_000,
    "big": 1 << 27,
    "dist": 1 << 22,
}


def _words(nk):
    return [P.sview(w).cpu().numpy().view(np.uint32) for w in nk.words]


def run_checks(dev):
    """Every check, in tpu_acceptance.py's order; a list of result dicts."""
    results = []

    def check(name, seconds, ok):
        print(f"{'PASS' if ok else 'FAIL'} {name} ({seconds:.3f} s e2e)", flush=True)
        results.append({"check": name, "ok": bool(ok), "seconds": seconds})

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    rng = np.random.default_rng(0)

    # 50M u32/u64 through the default tuner pipeline
    n = SIZES["u32_50m"]
    x = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    got, dt = timed(lambda: rt.radix_sort_unstable(x, device=dev))
    check("u32 50M default pipeline", dt, np.array_equal(got, np.sort(x)))
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    got, dt = timed(lambda: rt.radix_sort_unstable(k, device=dev))
    check("u64 50M default pipeline", dt, np.array_equal(got, np.sort(k)))
    del x, k, got

    # 20M u32 through the default pipeline
    x2 = rng.integers(0, 2**32, SIZES["u32_20m"], dtype=np.int64).astype(np.uint32)
    got, dt = timed(lambda: rt.radix_sort_unstable(x2, device=dev))
    check("u32 20M default/tuner pipeline", dt, np.array_equal(got, np.sort(x2)))
    del x2, got

    # 20M u64 + payload, stable
    m = SIZES["u64_20m"]
    k2 = rng.integers(0, 2**32, m, dtype=np.uint64)  # dup-heavy
    v = np.arange(m, dtype=np.uint32)
    (ks, vs), dt = timed(lambda: rt.sort_key_value(k2, v, stable=True, device=dev))
    order = np.argsort(k2, kind="stable")
    check("u64 20M + payload stable", dt,
          np.array_equal(ks, k2[order]) and np.array_equal(vs, v[order]))
    del k2, v, ks, vs, order

    # 20M f64 total order with specials sprinkled
    f = rng.standard_normal(m)
    f[:: m // 1000] = np.nan
    f[1 :: m // 1000] = -np.inf
    got, dt = timed(lambda: rt.radix_sort_unstable(f, device=dev))
    hi, lo = _words(rkeys.normalize(f, device=dev))
    want = f[np.lexsort((lo, hi))]
    check("f64 20M with NaN/Inf", dt,
          np.array_equal(got.view(np.uint64), want.view(np.uint64)))
    del f, got, hi, lo, want

    # 10M Zipf through the tuner path (the skew regime)
    z = (rng.zipf(1.3, SIZES["zipf"]) % (2**31)).astype(np.uint32)
    got, dt = timed(lambda: rt.radix_sort_unstable(z, device=dev))
    check("zipf 10M tuner path", dt, np.array_equal(got, np.sort(z)))
    del z, got

    # 2^23: the fused executor's power-of-two core, stable + payload
    p = SIZES["pow2"]
    kp = rng.integers(0, 2**64, p, dtype=np.uint64)
    vp = np.arange(p, dtype=np.uint32)
    (ks, vs), dt = timed(lambda: rt.sort_key_value(kp, vp, stable=True, device=dev))
    order = np.argsort(kp, kind="stable")
    check("u64 2^23 pow2 fused core stable+payload", dt,
          np.array_equal(ks, kp[order]) and np.array_equal(vs, vp[order]))
    del kp, vp, ks, vs, order

    # composite struct key (u16, f32) + payload: the c3/c6 shape
    s = SIZES["struct"]
    a16 = rng.integers(0, 2**16, s).astype(np.uint16)
    b32 = rng.standard_normal(s).astype(np.float32)
    vs_in = np.arange(s, dtype=np.uint32)
    builder = rt.radix_sort_builder((a16, b32), [vs_in], device=dev).with_stable(True)
    ((oa, ob), (op,)), dt = timed(builder.sort)
    order = np.lexsort(_words(rkeys.normalize((a16, b32), device=dev))[::-1])
    check("struct (u16,f32) 4M stable+payload", dt,
          np.array_equal(oa, a16[order])
          and np.array_equal(ob.view(np.uint32), b32[order].view(np.uint32))
          and np.array_equal(op, vs_in[order]))
    del a16, b32, vs_in, oa, ob, op, order

    # the low-memory Regions plan with the memory-pressure gate forced, so
    # the tuner's Regions pick runs the chunk sorts and the merge kernels
    klm = rng.integers(0, 2**64, SIZES["lowmem"], dtype=np.uint64)
    old_thresh = rconfig.low_mem_threshold_bytes
    rconfig.low_mem_threshold_bytes = 1  # any working set is "pressure"
    try:
        got, dt = timed(
            lambda: rt.radix_sort_builder(klm, device=dev).with_low_mem_tuner().sort())
    finally:
        rconfig.low_mem_threshold_bytes = old_thresh
    check("u64 20M low-mem chunked plan, gate forced", dt,
          np.array_equal(got, np.sort(klm)))
    del klm, got

    # the dispatcher end to end at 2^27, numpy in and out
    kb = rng.integers(0, 2**64, SIZES["big"], dtype=np.uint64)
    got, dt = timed(lambda: rt.radix_sort_unstable(kb, device=dev))
    check("u64 2^27 (134M) default pipeline e2e", dt, np.array_equal(got, np.sort(kb)))
    del kb, got

    # the distributed pipeline on a 1-shard mesh: the shuffle's code path
    # and its fused local sort on the card
    dn = SIZES["dist"]
    dk = rng.integers(0, 2**64, dn, dtype=np.uint64)
    dpay = np.arange(dn, dtype=np.uint32)
    dhi = (dk >> np.uint64(32)).astype(np.uint32)
    dlo = (dk & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def dist():
        words, pays, counts = parallel.distributed_sort(
            [dhi, dlo], [dpay], mesh=parallel.make_mesh(1, device=dev), stable=True)
        return parallel.gather_valid(list(words) + list(pays), counts)

    dense, dt = timed(dist)
    got = (dense[0].astype(np.uint64) << np.uint64(32)) | dense[1].astype(np.uint64)
    order = np.argsort(dk, kind="stable")
    check("distributed 1-device mesh 2^22 stable+payload (fused local sort)", dt,
          np.array_equal(got, dk[order]) and np.array_equal(dense[2], dpay[order]))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    dev = rkeys.as_device(args.device)
    if dev.type == "cuda":  # build or load the kernels before any check's clock
        _build.library()
        torch.cuda.synchronize(dev)

    results = run_checks(dev)
    all_ok = all(r["ok"] for r in results)
    print("ALL OK" if all_ok else "FAILURES PRESENT", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"device": device_name(dev), "all_ok": all_ok,
                       "checks": results}, fh, indent=1)
            fh.write("\n")
    return 0 if all_ok else 1


if __name__ == "__main__":
    # a success falls through, so that a runner that runs this file as
    # __main__ in its own process (runpy) goes on after it
    if main() != 0:
        sys.exit(1)
