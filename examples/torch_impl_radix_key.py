"""Custom key orderings on the PyTorch port (reference:
examples/impl_radix_key.rs: multi-key, partial-key and interleaved-byte
orderings through hand-written RadixKey impls).

Implementing ``RadixKey`` by hand here means building the normalized word
planes yourself: any uint32 planes whose ascending lexicographic order is
the order you want drive the engine directly through
``rdst_tpu_torch.engine.sort_words``.

    python examples/torch_impl_radix_key.py [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

from rdst_tpu_torch.engine import sort_words

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()


def plane(a: np.ndarray) -> torch.Tensor:
    """A uint32 numpy array as a plane on the chosen device."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)).to(args.device)


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


rng = np.random.default_rng(0)
n = 50_000

# --- multi-key ordering: (category ASC, score DESC) --------------------
cat = rng.integers(0, 100, n).astype(np.uint16)
score = rng.integers(0, 10_000, n).astype(np.uint32)
# descending on score = ascending on its bitwise complement
desc_score = np.uint32(0xFFFFFFFF) - score
(s_cat, s_desc), _ = sort_words([plane(cat), plane(desc_score)])
s_score = np.uint32(0xFFFFFFFF) - host(s_desc)
print("multi-key (cat asc, score desc):", host(s_cat)[:3], s_score[:3])

# --- partial-key ordering: sort u64 ids by their low 16 bits only ------
ids = rng.integers(0, 2**64, n, dtype=np.uint64)
partial = (ids & np.uint64(0xFFFF)).astype(np.uint32)
payload_hi = (ids >> np.uint64(32)).astype(np.uint32)
payload_lo = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
_, (p_hi, p_lo) = sort_words(
    [plane(partial)], [plane(payload_hi), plane(payload_lo)], stable=True
)
sorted_ids = (host(p_hi).astype(np.uint64) << np.uint64(32)) | host(p_lo)
low16 = sorted_ids & np.uint64(0xFFFF)
assert np.all(low16[1:] >= low16[:-1])
print("partial-key (low 16 bits):", [hex(int(v)) for v in sorted_ids[:3]])

# --- interleaved-byte ordering: custom byte priority b1, b3, b0, b2 ----
vals = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
b = [(vals >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
custom = (b[1] << np.uint32(24)) | (b[3] << np.uint32(16)) | (
    b[0] << np.uint32(8)
) | b[2]
_, (orig,) = sort_words([plane(custom)], [plane(vals)], stable=True)
print("interleaved-byte order applied; first:", hex(int(host(orig)[0])))
