"""``scripts/torch_span_split.py``, the stage scripts' reading of a
profiler trace: spans nested by thread, device records given to the spans
open at their launch by correlation id, the port's kernels named B1-B8 (B5
by its launch outside ``rdst.fused_sort``), and the shuffle's sorts named by
their side of its exchange."""
import json

import numpy as np
import torch

import rdst_tpu_torch as rt
from rdst_tpu_torch.utils.trace import profile_to
from scripts import torch_span_split as tss

torch.set_num_threads(1)

# (name, cat, ts us, dur us, correlation or None), one host thread and one card
_HOST = [
    ("rdst.shuffle", "user_annotation", 0, 100, None),
    ("rdst.shuffle.sort.fused", "user_annotation", 1, 20, None),
    ("rdst.fused_sort", "user_annotation", 2, 18, None),
    ("cudaLaunchKernel", "cuda_runtime", 3, 1, 1),
    ("rdst.shuffle.exchange", "user_annotation", 30, 10, None),
    ("cudaLaunchKernel", "cuda_runtime", 31, 1, 2),
    ("cudaLaunchKernel", "cuda_runtime", 45, 1, 3),  # the shuffle's own work
    ("rdst.shuffle.sort.fused", "user_annotation", 50, 30, None),
    ("rdst.fused_sort", "user_annotation", 51, 28, None),
    ("cudaLaunchKernel", "cuda_runtime", 52, 1, 4),
    ("cudaLaunchKernel", "cuda_runtime", 53, 1, 5),
    ("cudaMemcpyAsync", "cuda_runtime", 150, 1, 6),  # outside every span
]
_DEVICE = [
    ("void (anonymous namespace)::tail_kernel<2, 32>(Planes, Net, Tiles)", "kernel",
     5, 4, 1),
    ("void (anonymous namespace)::exchange_kernel(Exchange)", "kernel", 33, 6, 2),
    ("void (anonymous namespace)::tail_kernel<5, 8>(Planes, Net, Tiles)", "kernel",
     47, 2, 3),
    ("void (anonymous namespace)::merge_tile_kernel<2>(MergePlanes, long long)",
     "kernel", 55, 3, 4),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel", 58, 1, 5),
    ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 152, 2, 6),
]


def _trace(tmp_path):
    events = [{"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": 7, "ts": ts,
               "dur": dur, "args": {} if c is None else {"correlation": c}}
              for name, cat, ts, dur, c in _HOST]
    events += [{"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 9, "ts": ts,
                "dur": dur, "args": {"correlation": c, "device": 0}}
               for name, cat, ts, dur, c in _DEVICE]
    events.append({"ph": "f", "cat": "ac2g", "name": "flow", "pid": 0, "tid": 9,
                   "ts": 5, "id": 1})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tss.read(str(path))


def test_records_go_to_the_spans_open_at_their_launch(tmp_path):
    rows = _trace(tmp_path).by_path()
    sh = "rdst.shuffle"
    local, finish = f"{sh}.sort.fused [local]", f"{sh}.sort.fused [finish]"
    assert list(rows) == [
        (sh,), (sh, local), (sh, local, "rdst.fused_sort"), (sh, f"{sh}.exchange"),
        (sh, finish), (sh, finish, "rdst.fused_sort")]
    # calls, host us, host us in no child, device us, device us in no child
    assert rows[(sh,)] == [1, 100, 100 - 20 - 10 - 30, 4 + 6 + 2 + 3 + 1, 2]
    assert rows[(sh, local)] == [1, 20, 2, 4, 0]
    assert rows[(sh, local, "rdst.fused_sort")] == [1, 18, 18, 4, 4]
    assert rows[(sh, f"{sh}.exchange")] == [1, 10, 10, 6, 6]
    assert rows[(sh, finish, "rdst.fused_sort")] == [1, 28, 28, 4, 4]


def test_port_kernels_are_named_and_b5_is_b2s_kernel_outside_the_executor(tmp_path):
    t = _trace(tmp_path)
    assert [r.kernel for r in t.records] == ["B2", "B6", "B5", "B7", None, None]
    assert [r.kind for r in t.records][-1] == "copy" and t.records[-1].path == ()
    assert t.busy_us() == 4 + 6 + 2 + 3 + 1 + 2


def test_radix_pass_kernel_is_b8():
    """B8's instances (one a digit plane width) by their kernel name."""
    for w in (1, 2, 4):
        rec = tss.Record(f"void (anonymous namespace)::radix_pass_kernel<{w}>(PassPlanes, "
                         "int, int, int, long long const*, unsigned int*, unsigned int*)",
                         "kernel", 0, 1, ("rdst.fused_sort", "rdst.fused_sort.radix"))
        assert rec.kernel == "B8"


def test_a_cpu_sort_call_gives_its_span_tree(tmp_path):
    """A real trace of the port (no card here, so no device records): the
    sort call's spans nest as ``utils/trace.py`` lists them."""
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 2**63, 5000))
    with profile_to(str(tmp_path)) as path:
        out = rt.radix_sort_unstable(x)
    assert torch.equal(out, torch.sort(x).values)
    t = tss.read(path)
    rows = t.by_path()
    assert t.records == []
    assert list(rows)[0] == ("rdst.sort",) and rows[("rdst.sort",)][0] == 1
    assert ("rdst.sort", "rdst.keys.normalize") in rows
    run = ("rdst.sort", "rdst.sorter.run")
    assert rows[run][0] == 1 and any(p[:2] == run and p[2].startswith("rdst.plan.")
                                     for p in rows if len(p) == 3)
    host = {p: v[1] for p, v in rows.items()}
    assert all(host[p] <= host[p[:-1]] for p in rows if len(p) > 1)

