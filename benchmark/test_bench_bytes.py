"""Each operation's byte count (``bytes/<op>.py``) against the columns
the operation reads and writes, at a small shape on the CPU: the input
columns it needs, read once, and its answer's columns, written once."""
import bench_core as core
import bench_testing


def _state(cell):
    _, config, traffic = bench_testing.small(cell, n_keys=1 << 12)
    kind = core.module("traffic", traffic["kind"])
    return kind, kind.setup(config, traffic, 2**31 + 3, core.Devices(["cpu"]))


def _nbytes(cols):
    return sum(v.numel() * v.element_size() for v in cols)


def test_sort_counts_every_key_read_and_written_once():
    kind, s = _state("sort_u64_50m_tensor")
    out = kind.call(s, "sort")
    got = core.module("bytes", "sort").necessary_bytes(kind.shapes(s, "sort", out))
    assert got == s.pool[0].numel() * 8 + out.numel() * out.element_size() == 16 * s.n
