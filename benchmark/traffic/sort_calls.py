"""Closed-loop calls of the public sort, ``radix_sort_unstable``, on a pool
of key arrays made from the seed, and their plain reference.

Traffic parameters (``traffic/<name>.json``):

    input        "tensor" (keys already on the card) or "numpy" (keys in
                 host memory; the call returns numpy)
    pool         how many arrays are rotated, so that no call sorts the
                 previous call's output
    warm_calls   calls of the warm-up
    trace_calls  calls in the traced stretch
    keep         how many answers are judged besides the window's last:
                 calls drawn from the seed over the whole window

Configuration (``configs/<name>.json``): ``n_keys``, ``key_dtype``
("uint64"), ``distribution`` ("uniform": every bit uniform from the seed).

The check sorts the same array with the plain reference
(``reference/sort_calls.py``: ``torch.sort`` on the card) and counts the
positions at which each kept answer differs.  The control puts the
reference in the port's place at the next narrower key, u32: it orders
the keys by their top 32 bits only (stably), as a sort that skipped the
low digits would.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import bench_core

ref = bench_core.module("reference", "sort_calls", Path(__file__).resolve().parent.parent)
OPS = ("sort",)
#: Each compared number and its limit: exact answers, so 0.
LIMITS = {"wrong_keys": 0}


class State:
    pass


def setup(config, traffic, seed, devs) -> State:
    import rdst_tpu_torch as rt

    if config["key_dtype"] != "uint64" or config["distribution"] != "uniform":
        raise ValueError("sort_calls makes uniform uint64 keys only")
    s = State()
    s.rt, s.devs, s.dev = rt, devs, devs.list[0]
    s.n, s.input = int(config["n_keys"]), traffic["input"]
    s.numpy = s.input == "numpy"
    if s.numpy:
        s.pool = ref.host_pool(s.n, traffic["pool"], seed)
    else:
        s.pool = ref.device_pool(s.n, traffic["pool"], seed, s.dev)
    s.next = 0
    s.last = None  # pool index of the last call
    return s


def ops(s):
    return list(OPS)


def rows(s):
    return {"sort": s.n}


def schedule(s, traffic, seed):
    while True:
        yield ["sort"]


def trace_ops(s, traffic):
    return ["sort"] * traffic["trace_calls"]


def call(s, op):
    i = s.next
    s.next = (i + 1) % len(s.pool)
    s.last = i
    if s.numpy:
        return s.rt.radix_sort_unstable(s.pool[i], device=s.dev.type)
    return s.rt.radix_sort_unstable(s.pool[i])


def control_call(s, op):
    i = s.next
    s.next = (i + 1) % len(s.pool)
    s.last = i
    x = s.pool[i]
    keys = torch.from_numpy(x).to(s.dev) if s.numpy else x
    out = ref.top32_order(keys)
    return out.cpu().numpy() if s.numpy else out


def shapes(s, op, out):
    """The call's columns: (rows, bytes a row) of its input and output."""
    n_out = int(out.shape[0])
    return {"in": {"keys": (s.n, 8)}, "out": {"keys": (n_out, 8)}}


def keep(s, op, out):
    """The answer where the call left it, with the pool index it sorted."""
    return (s.last, out)


def setup_note(s):
    return (f"bench: sort_calls: {len(s.pool)} arrays of {s.n} uniform u64 keys "
            f"({'numpy, host' if s.numpy else 'tensor, ' + str(s.dev)})")


def release(s):
    """Drop what the program made; the pool stays for the reference."""
    s.rt = None


def check(s, kept, devs):
    wrong = wrong_answers = 0
    answers = len(kept)
    while kept:
        _, (i, got) = kept.pop(0)
        x = s.pool[i]
        keys = torch.from_numpy(x.view(np.int64)).to(s.dev) if s.numpy else x.view(torch.int64)
        want = ref.reference(keys)
        if isinstance(got, np.ndarray):
            got = torch.from_numpy(got.view(np.int64))
        got = got.to(s.dev).view(torch.int64)
        m = min(got.numel(), want.numel())
        bad = int((got[:m] != want[:m]).sum()) + abs(got.numel() - want.numel())
        wrong += bad
        wrong_answers += bad > 0
        del want, got, keys
    checks = {"wrong_keys": {"value": wrong, "limit": LIMITS["wrong_keys"]}}
    return {"checks": checks, "wrong_answers": wrong_answers, "answers": answers}
