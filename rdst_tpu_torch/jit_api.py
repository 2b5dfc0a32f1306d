"""Sort entry points with a static plan and no host synchronisation.

Port of ``rdst_tpu/jit_api.py``.  The builder API mirrors the reference's
host-driven dispatch: it copies histograms to the host to run the tuner.
These entry points run a static plan end to end on the device instead, for
sorts embedded in a larger computation:

    ks, (vs,) = rdst_tpu_torch.jit_api.sort(k, payloads=[v], stable=True)

On a CUDA tensor no step waits for the device (``tests/test_torch_cuda.py``
runs them under ``torch.cuda.set_sync_debug_mode("error")``).  Numpy input
goes to ``device`` (default ``"cuda"``, which raises when CUDA is absent);
a tensor stays on its own device.

Gradients flow through floating-point payloads along the sort permutation,
as through ``lax.sort``'s JVP in the reference: a payload that requires a
gradient rides as an index plane of its own width class, gathers its values
by that index, and scatters ``grad_out`` back through it
(:class:`_Permute`).  The plan sees the same number of planes, so the
forward outputs are bit-equal to the call without gradients.
"""
from __future__ import annotations

from typing import Sequence

import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import keys as _keys
from rdst_tpu_torch.engine import sort_words

__all__ = ["sort", "argsort"]


class _Permute(torch.autograd.Function):
    """``p[idx]`` for a permutation ``idx``; the backward pass scatters the
    output gradient back through it."""

    @staticmethod
    def forward(ctx, idx, p):
        ctx.save_for_backward(idx)
        return p[idx]

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return None, torch.zeros_like(grad_out).index_copy_(0, idx, grad_out)


def _fields(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def sort(
    x,
    payloads: Sequence = (),
    *,
    stable: bool = False,
    plan: str = "auto",
    device="cuda",
):
    """Sorted copy of ``x`` (any supported key dtype or a composite tuple),
    with no host synchronisation.  Returns the keys, or ``(keys,
    payloads_tuple)`` when payloads are given.

    Payloads ride natively (no word encoding); a floating-point payload
    that requires a gradient gets one along the sort permutation."""
    dev = _keys.device_of(_fields(x), device)
    nk = _keys.normalize(x, device=dev)
    pays = [_keys._to_tensor(p, dev) for p in payloads]
    # the first payload that needs a gradient rides as an index plane
    # (int64 for 8-byte payloads, which keeps the plan's plane rules)
    grad = [i for i, p in enumerate(pays) if p.requires_grad]
    riders = [p.detach() for p in pays]
    if grad:
        n = int(nk.words[0].shape[0])
        wide = pays[grad[0]].dtype.itemsize == 8
        riders[grad[0]] = (torch.arange(n, device=dev) if wide
                           else P.arange(n, torch.uint32, dev))
    out_words, out_riders = sort_words(
        list(nk.words), riders, stable=stable, plan=plan
    )
    sorted_keys = _keys.denormalize(
        _keys.NormalizedKeys(tuple(out_words), nk.n_bytes, nk.meta)
    )
    if not payloads:
        return sorted_keys
    out = list(out_riders)
    if grad:
        idx = P.sview(out[grad[0]]).to(torch.int64)
        if out[grad[0]].dtype == torch.uint32:
            idx &= 0xFFFFFFFF
        for i in grad:
            out[i] = _Permute.apply(idx, pays[i])
    return sorted_keys, tuple(out)


def argsort(x, *, stable: bool = True, device="cuda") -> torch.Tensor:
    """uint32 sorting indices, with no host synchronisation (stable by
    default).

    Stable mode sorts unstably on the composite (key, index): the index
    makes the order strict, so the unique result is the stable
    permutation."""
    dev = _keys.device_of(_fields(x), device)
    fields = [_keys._to_tensor(f, dev) for f in _fields(x)]
    idx = P.arange(int(fields[0].shape[0]), torch.uint32, dev)
    if not stable:
        _, (out,) = sort(tuple(fields) if len(fields) > 1 else fields[0],
                         payloads=[idx], stable=False)
        return out
    return sort(tuple(fields + [idx]))[-1]
