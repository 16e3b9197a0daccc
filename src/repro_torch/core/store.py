"""Key-set helpers of ``repro.core.store``.

For now this holds only :func:`make_uniform_keys`, which the Ludo-paged KV
cache seeds its index with; the sharded store itself is still to be ported.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.hashing import splitmix64


def make_uniform_keys(n: int, seed: int = 1) -> np.ndarray:
    """Deterministic unique 64-bit key set (FB/OSM-style random IDs)."""
    keys = splitmix64(np.arange(1, int(n * 1.05) + 16, dtype=np.uint64)
                      + np.uint64(seed << 32))
    keys = np.unique(keys)[:n]
    if keys.shape[0] != n:
        raise RuntimeError(f"splitmix64 gave fewer than {n} unique keys")
    return keys
