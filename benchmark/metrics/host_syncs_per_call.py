"""Deliberate device-to-host reads per call in the traced stretch: the
program's ``rdst.sync.*`` spans (``bench_spans``), one a read."""
import bench_spans


def read(run):
    return bench_spans.syncs_per_call(run)
