"""A random packed ICQ index for serving smoke paths (twin of
``repro.data.synthetic.make_synthetic_index``, seeded with numpy)."""
from __future__ import annotations

import numpy as np


def make_synthetic_index(seed: int, n: int, d: int = 16, K: int = 8,
                         m: int = 256, num_fast: int = 2,
                         sigma: float = 0.5):
    """Numpy arrays (codes (n, K) uint8 for m <= 256 else int32,
    C (K, m, d) f32, structure (xi (d,) bool, fast_mask (K,) bool,
    sigma () f32)) made from ``seed``; the first ``num_fast`` codebooks
    form the fast group.  ``make_index``/``build_index`` move them to a
    device (and nibble-pack the codes for ``code_bits=4``)."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((K, m, d), dtype=np.float32)
         * np.float32(1.0 / np.sqrt(K)))
    codes = rng.integers(0, m, size=(n, K)).astype(
        np.uint8 if m <= 256 else np.int32)
    fast = np.zeros((K,), bool)
    fast[:num_fast] = True
    structure = (np.ones((d,), bool), fast, np.asarray(sigma, np.float32))
    return codes, C, structure
