"""Card idle time per call in the traced stretch, ms, while the host was in
the API layer (``rdst.sort``, ``rdst.keys.*``, ``rdst.copy.*``): each idle
gap goes to the innermost program span that is not ``rdst.sync.*`` at its
midpoint (``bench_spans``)."""
import bench_spans


def read(run):
    return bench_spans.idle_ms_per_call(run, "api")
