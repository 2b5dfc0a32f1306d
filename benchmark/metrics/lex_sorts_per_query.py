"""Per-shard sorts of the shuffle that took ``lex_sort``'s route, not the
fused executor's (B2/B3), per query in the traced stretch: the program's
``rdst.shuffle.sort.lex`` spans (``bench_query_spans``)."""
import bench_query_spans


def read(run):
    return bench_query_spans.lex_sorts_per_query(run)
