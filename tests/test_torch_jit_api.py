"""The port's static-plan sort API (rdst_tpu_torch.jit_api) against the
JAX package's (rdst_tpu.jit_api), one counterpart of every case in
``test_jit_api.py`` and more.

Both get the same numpy input, made from a seed; the port runs on CPU
tensors, where its kernel wrappers take their plain versions.  Tolerances:
sorted keys, stable payloads and indices are bit-equal (floats by their
bits); unstable payloads are compared as (key, payload) multisets; the
gradient through a payload equals ``jax.grad``'s within rtol 1e-6 (both are
the same exact permutation of 2v in float32, so they are equal in fact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdst_tpu import jit_api as jj
from rdst_tpu_torch import config
from rdst_tpu_torch import jit_api
from rdst_tpu_torch.ops import fused_sort as fs
from rdst_tpu_torch.ops import radix_sort as rs

torch.set_num_threads(1)


def _bits(x):
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}") if x.dtype.kind == "f" else x


def test_sort_float_keys():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(10_000).astype(np.float32)
    x[:6] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
    got = jit_api.sort(torch.from_numpy(x))
    want = jax.jit(jj.sort)(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("stable", [True, False])
def test_sort_with_payload(stable):
    rng = np.random.default_rng(2)
    k = rng.integers(0, 100, 5_000).astype(np.int32)
    v = np.arange(5_000, dtype=np.uint32)
    f = rng.standard_normal(5_000)
    ks, (vs, fv) = jit_api.sort(k, payloads=[v, f], stable=stable, device="cpu")
    wk, (wv, wf) = jj.sort(jnp.asarray(k), payloads=[jnp.asarray(v), jnp.asarray(f)],
                           stable=stable)
    np.testing.assert_array_equal(_bits(ks), _bits(wk))
    assert vs.dtype == torch.uint32 and fv.dtype == torch.float64
    if stable:
        np.testing.assert_array_equal(_bits(vs), _bits(wv))
        np.testing.assert_array_equal(_bits(fv), _bits(wf))
    else:
        assert sorted(zip(_bits(ks).tolist(), _bits(vs).tolist())) == \
            sorted(zip(_bits(wk).tolist(), _bits(wv).tolist()))


@pytest.mark.parametrize("stable", [True, False])
def test_argsort(stable):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 50, 3_000).astype(np.uint16)
    got = jit_api.argsort(torch.from_numpy(x), stable=stable)
    want = np.asarray(jax.jit(jj.argsort, static_argnames="stable")(
        jnp.asarray(x), stable=stable))
    assert got.dtype == torch.uint32
    if stable:
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), np.argsort(x, kind="stable"))
    else:
        np.testing.assert_array_equal(x[got.numpy()], x[want])
        assert sorted(got.numpy().tolist()) == list(range(x.size))


def test_argsort_composite_and_64bit_keys():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 3, 4_000).astype(np.int8)
    b = rng.integers(0, 2**64, 4_000, dtype=np.uint64)
    b[::7] = b[0]
    got = jit_api.argsort((a, b), device="cpu")
    want = np.asarray(jj.argsort((jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
@pytest.mark.parametrize("stable", [True, False])
def test_grad_through_payload(dtype, stable):
    """Payloads keep differentiability when sorted by detached keys; the
    forward outputs are bit-equal to the call without gradients."""
    rng = np.random.default_rng(5)
    k = rng.integers(0, 100, 1_000).astype(np.int32)
    v = rng.standard_normal(1_000).astype(dtype)
    u = rng.standard_normal(1_000).astype(np.float32)
    tk = torch.from_numpy(k)
    tv = torch.from_numpy(v).requires_grad_()
    tu = torch.from_numpy(u).requires_grad_()
    ks, (vs, us) = jit_api.sort(tk, payloads=[tv, tu], stable=stable)
    plain = jit_api.sort(tk, payloads=[tv.detach(), tu.detach()], stable=stable)
    np.testing.assert_array_equal(_bits(ks), _bits(plain[0]))
    np.testing.assert_array_equal(_bits(vs), _bits(plain[1][0]))
    np.testing.assert_array_equal(_bits(us), _bits(plain[1][1]))
    gv, gu = torch.autograd.grad((vs.float() * vs.float()).sum() + (3 * us).sum(),
                                 [tv, tu])

    def loss(vv):
        _, (vs_,) = jj.sort(jnp.asarray(k), payloads=[vv], stable=True)
        return jnp.sum(vs_.astype(jnp.float32) * vs_.astype(jnp.float32))

    want = jax.grad(loss)(jnp.asarray(v))
    np.testing.assert_allclose(gv.numpy().astype(np.float64),
                               np.asarray(want).astype(np.float64), rtol=1e-6)
    np.testing.assert_array_equal(gu.numpy(), np.full(1_000, 3, np.float32))


def test_fused_executor_at_small_n(monkeypatch):
    """With ``fused_min_elems`` lowered, the sort takes the fused executor
    (its radix passes, B8's plain version on CPU tensors, for a 64-bit key
    and one payload; B2/B3's for the stable argsort's 12-byte key) and still
    matches the JAX package, gradient included."""
    monkeypatch.setattr(config, "fused_min_elems", 2048)
    monkeypatch.setattr(config, "fused_min_piece", 1024)
    monkeypatch.setattr(config, "bitonic_smem_bytes", 18432)
    rng = np.random.default_rng(6)
    x = rng.integers(0, 2**64, 5_000, dtype=np.uint64)
    v = rng.standard_normal(5_000).astype(np.float32)
    before = rs.RADIX_PASS.plain_calls
    tv = torch.from_numpy(v).requires_grad_()
    ks, (vs,) = jit_api.sort(torch.from_numpy(x), payloads=[tv], stable=True)
    assert rs.RADIX_PASS.plain_calls > before
    wk, (wv,) = jj.sort(jnp.asarray(x), payloads=[jnp.asarray(v)], stable=True)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(_bits(vs), _bits(wv))
    (g,) = torch.autograd.grad(vs.sum(), [tv])
    np.testing.assert_array_equal(g.numpy(), np.ones(5_000, np.float32))
    before = fs.TAIL.plain_calls
    idx = jit_api.argsort(torch.from_numpy(x))  # (key, index): 12 key bytes, B2
    assert fs.TAIL.plain_calls > before
    np.testing.assert_array_equal(idx.numpy(), np.argsort(x, kind="stable"))


def test_plans_and_devices():
    x = np.arange(100, dtype=np.uint32)[::-1].copy()
    with pytest.raises(ValueError, match="requires counts"):
        jit_api.sort(x, plan="packed", device="cpu")
    np.testing.assert_array_equal(
        jit_api.sort(x, plan="lowmem", device="cpu").numpy(), np.sort(x))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            jit_api.sort(x)
