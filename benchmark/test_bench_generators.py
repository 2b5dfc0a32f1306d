"""The generators repeat exactly for a seed and differ across seeds; the
schedule and the sample of answers are drawn from the seed alone."""
import importlib.util
from pathlib import Path

import numpy as np
import torch

import bench_core as core

HERE = Path(__file__).resolve().parent


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", HERE / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SORT = _reference("sort_calls")
SEEDS = (2**31 + 5, 2**31 + 6)


def test_device_pool_repeats_for_a_seed_and_differs_across_seeds():
    a = SORT.device_pool(4096, 3, SEEDS[0], "cpu")
    b = SORT.device_pool(4096, 3, SEEDS[0], "cpu")
    c = SORT.device_pool(4096, 3, SEEDS[1], "cpu")
    assert all(x.dtype == torch.uint64 for x in a)
    assert all(torch.equal(x.view(torch.int64), y.view(torch.int64)) for x, y in zip(a, b))
    assert not torch.equal(a[0].view(torch.int64), c[0].view(torch.int64))
    assert not torch.equal(a[0].view(torch.int64), a[1].view(torch.int64))
    # every bit is drawn: the top and the bottom bit both vary
    v = a[0].view(torch.int64)
    assert (v < 0).any() and (v >= 0).any() and (v & 1).any() and ((v & 1) == 0).any()


def test_host_pool_repeats_for_a_seed_and_differs_across_seeds():
    a = SORT.host_pool(4096, 2, SEEDS[0])
    b = SORT.host_pool(4096, 2, SEEDS[0])
    c = SORT.host_pool(4096, 2, SEEDS[1])
    assert all(x.dtype == np.uint64 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], a[1])
    assert a[0].max() >= np.uint64(1 << 63)


def test_schedule_and_sample_depend_on_the_seed_alone():
    kind = core.module("traffic", "sort_calls")
    g = kind.schedule(None, core.traffic_file("closed_tensor_pool4"), SEEDS[0])
    assert [next(g) for _ in range(3)] == [["sort"]] * 3

    def kept(seed, calls=200, cap=3):
        s = core.Sampler(seed, cap)
        for i in range(calls):
            s.offer("sort", f"answer {i}")
        return [(i, a) for _, i, a in s.kept()]

    a = kept(SEEDS[0])
    assert a == kept(SEEDS[0]) and a != kept(SEEDS[1])
    assert len(a) == 4 and a[-1] == (199, "answer 199")  # three drawn, and the last
    assert all(a_ == f"answer {i}" for i, a_ in a)
    assert kept(SEEDS[0], calls=2) == [(0, "answer 0"), (1, "answer 1")]


def test_the_sample_reaches_the_whole_window():
    drawn = []
    for seed in range(200):
        s = core.Sampler(seed, 3)
        for i in range(1000):
            s.offer("sort", i)
        drawn += [i for _, i, _ in s.kept()[:-1]]
    # a uniform draw: about half of the kept calls come from the second half
    assert 0.4 < sum(i >= 500 for i in drawn) / len(drawn) < 0.6
    assert max(drawn) > 900
