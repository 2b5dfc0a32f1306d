"""Randomized property check of the port's distributed shuffle:
``tests/test_distributed_fuzz.py``'s ten seeded cases through
``rdst_tpu_torch.parallel.distributed_sort_auto`` on CPU meshes of 8 shards
(flat, 2 x 4, 4 x 2), held to the same contract (counts sum to n, the dense
output equal to the numpy lexsort oracle, stable payload order when asked)
and to the JAX package's output on its virtual 8-device mesh: the same
counts, bit-equal planes, and where the sort is unstable with a payload the
same (key, payload) rows.  The cases' draws are the JAX test's own
(``_gen_plane`` and the same seeds)."""
import numpy as np
import pytest

import rdst_tpu.parallel as jp
import rdst_tpu_torch.parallel as tp
from test_distributed_fuzz import D, N, _gen_plane


def _case(case):
    """The JAX test's draws for ``case``: (words, payloads, stable)."""
    rng = np.random.default_rng(1000 + case)
    n_words = int(rng.integers(1, 4))
    words = [_gen_plane(rng, int(rng.integers(0, 5))) for _ in range(n_words)]
    stable = bool(rng.integers(0, 2))
    with_pay = bool(rng.integers(0, 2)) or stable
    pay = [np.arange(N, dtype=np.uint32)] if with_pay else []
    return words, pay, stable


def _mesh(pkg, case, **kw):
    kind = case % 3
    if kind == 0:
        return pkg.make_mesh(D, **kw), "shard"
    m = pkg.make_mesh_2d(*((2, 4) if kind == 1 else (4, 2)), **kw)
    return m, m.axis_names


@pytest.mark.parametrize("case", range(10))
def test_distributed_sort_random(case):
    words, pay, stable = _case(case)
    out = {}
    for name, pkg, kw in (("jax", jp, {}), ("port", tp, {"device": "cpu"})):
        mesh, axis = _mesh(pkg, case, **kw)
        w, p, counts = pkg.distributed_sort_auto(words, pay, mesh=mesh, axis=axis,
                                                 stable=stable, capacity_factor=1.5)
        counts = np.asarray(counts.cpu() if name == "port" else counts)
        out[name] = (counts, pkg.gather_valid(list(w) + list(p), counts))
    counts, dense = out["port"]
    assert int(counts.sum()) == N
    np.testing.assert_array_equal(counts, out["jax"][0])
    keys, k = [np.asarray(w) for w in words], len(words)
    # unstable with a payload: equal keys may carry their payloads in
    # another order (torch.sort's ties against XLA's), so rows as a multiset
    jax_dense = out["jax"][1]
    if pay and not stable:
        jax_dense, dense_rows = (
            [c[np.lexsort(tuple([d[-1]] + d[:k][::-1]))] for c in d]
            for d in (out["jax"][1], dense))
    else:
        dense_rows = dense
    for a, b in zip(jax_dense, dense_rows):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    order = np.lexsort(tuple(([pay[0]] if stable else []) + keys[::-1]))
    for got, src in zip(dense[:k], keys):
        np.testing.assert_array_equal(got, src[order])
    if stable:
        np.testing.assert_array_equal(dense[k], pay[0][order])
    elif pay:  # the same (key, payload) rows in another tie order
        got_rows = np.lexsort(tuple([dense[-1]] + dense[:k][::-1]))
        src_rows = np.lexsort(tuple([pay[0]] + keys[::-1]))
        for got, src in zip(dense, keys + pay):
            np.testing.assert_array_equal(got[got_rows], src[src_rows])
