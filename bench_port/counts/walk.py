"""The bytes one frame's walk needs, from the placements it produced.

Frozen from chip_smoke.py's ``walk_bound`` (bytes only), at each level's
true size: for every non-root part, the x-pass columns the walk reads
(every mixture's column at the parent's x to pick the mixture, and the
chosen mixture's column at the child's x for its y) and the score rows
(the chosen mixture's row at the parent's y for its x), each distinct
line read once; plus the root seeds (x, y, mixture) and the placements
written, 4 bytes a value.  A line of a column is h values, of a row w.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def walk_bytes(featsizes: List[tuple], locs: List[np.ndarray],
               parent: Sequence[int], nmix: Sequence[int]) -> int:
    """featsizes[l] = (h, w); locs[l] = (k, P, 3) placements (x, y,
    mixture) of every root seed walked at level l."""
    total = 0
    P = len(parent)
    for (h, w), loc in zip(featsizes, locs):
        k = loc.shape[0]
        if k == 0:
            continue
        X, Y, M = (loc[..., i].astype(np.int64) for i in range(3))
        for p in range(1, P):
            q = parent[p]
            Mp = nmix[p]
            cols = np.concatenate([
                (np.arange(Mp)[:, None] * w + X[None, :, q]).ravel(),
                M[:, p] * w + X[:, p]])
            rows = M[:, p] * h + Y[:, q]
            total += (np.unique(cols).size * h + np.unique(rows).size * w) * 4
        total += 3 * k * 4 + 3 * P * k * 4
    return total
