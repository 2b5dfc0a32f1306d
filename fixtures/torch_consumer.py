"""External-consumer smoke of the PyTorch port: import rdst_tpu_torch as a
user would and run one sort per major code path (the counterpart of
``fixtures/consumer.py``; reference analog: fixtures/*/src/main.rs, a bare
external crate that links the library and sorts).

Run with the package importable (installed, or the checkout on PYTHONPATH):

    python fixtures/torch_consumer.py                 # on the card
    python fixtures/torch_consumer.py --device cpu
"""
import argparse

import numpy as np

import rdst_tpu_torch as rt
from rdst_tpu_torch import config


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"consumer smoke: {what} differs from numpy")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    rng = np.random.default_rng(42)

    x = rng.integers(0, 2**32, size=100_000, dtype=np.int64).astype(
        np.uint32
    )
    _check(np.array_equal(rt.radix_sort_unstable(x, device=dev), np.sort(x)),
           "the u32 sort")

    # device dispatcher (histogram -> tuner -> plan), no host fast path
    config.host_sort_max = 0
    f = rng.standard_normal(50_000)
    got = rt.radix_sort_builder(f, device=dev).sort()
    _check(np.array_equal(np.asarray(got).view(np.uint64),
                          np.sort(f).view(np.uint64)), "the f64 sort")

    k = rng.integers(0, 100, size=30_000, dtype=np.uint16)
    v = np.arange(30_000, dtype=np.uint32)
    ks, vs = rt.sort_key_value(k, v, stable=True, device=dev)
    o = np.argsort(k, kind="stable")
    _check(np.array_equal(ks, k[o]) and np.array_equal(vs, v[o]),
           "the stable key-value sort")

    print("consumer smoke: OK")


if __name__ == "__main__":
    main()
