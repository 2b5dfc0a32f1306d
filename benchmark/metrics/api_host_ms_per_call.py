"""Host time of the API layer per call in the traced stretch, ms: each
``rdst.sort`` span's duration less its ``rdst.sorter.run`` child's (the
split of numpy keys, their upload, the inverse transform and the copy back,
first touches of fresh arrays included), from the program's spans
(``bench_spans``)."""
import bench_spans


def read(run):
    return bench_spans.api_host_ms_per_call(run)
