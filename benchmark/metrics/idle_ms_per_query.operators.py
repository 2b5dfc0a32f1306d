"""Card idle time per query in the traced stretch, ms, while the host was
in the operators (``rdst.table.*``, ``rdst.query.*``, ``rdst.keys.*``)
inside an ``rdst.query.*`` span: each idle gap goes to the innermost
program span that is not ``rdst.sync.*`` at its midpoint
(``bench_query_spans``)."""
import bench_query_spans


def read(run):
    return bench_query_spans.idle_ms_per_query(run, "operators")
