"""The floating-point work of one frame, counted from the configuration
and the pyramid plan of the frame's size.

For every level of h x w response cells:
  * the filter-bank correlation: F filters of fh x fw x C taps, a
    multiply-add each, counted as 2 operations;
  * the max-transform of each non-root (part, mixture): two passes, each
    a lower-envelope sweep of DT_PASS_FLOPS a cell (a parabola
    intersection and an evaluation; src/DistanceTransform.hpp:152-182);
  * the mixture max of each non-root part: a bias add and a max for each
    (child mixture, parent mixture) pair, and the message add to each
    parent mixture;
  * the root: a bias add and a max per root mixture;
summed over the components.  The HOG and the walk are not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from bench_port.reference.plan import pyramid

DT_PASS_FLOPS = 8


def flops_per_frame(cfg: Dict, imsize,
                    trees: Sequence[Tuple[Sequence[int], Sequence[int]]]
                    ) -> float:
    """Operations of one frame of size imsize for the components'
    trees, (parent, nmix) each (parent[0] is the root's, ignored)."""
    taps = cfg["filter_size"] ** 2 * cfg["flen"]
    levels = pyramid(imsize, cfg["binsize"], cfg["interval"])
    cells = sum(lvl.featsize[0] * lvl.featsize[1] for lvl in levels)
    per_cell = 0.0
    for parent, nmix in trees:
        per_cell += 2.0 * sum(nmix) * taps + 2 * nmix[0]
        for p in range(1, len(parent)):
            mp = nmix[parent[p]]
            per_cell += 2 * DT_PASS_FLOPS * nmix[p] + 2 * nmix[p] * mp + mp
    return cells * per_cell
