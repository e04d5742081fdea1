"""The scale pyramid of a frame: levels, true sizes and scales.

Written from the reference C++ detector's ladder (src/HOGFeatures.cpp:
95-127): nscales = 1 + floor(log(min(h, w) / (5 binsize)) / log(s)),
s = 2^(1/interval); level i < interval is a bilinear resize by 1/s^i,
level i >= interval a pyrDown of level i - interval; a level's scale is
the pixels per HOG cell.  ``octave_first`` is the first level of each
level's octave: the port (as the JAX package) runs an octave's levels in
one buffer of that level's size, which bounds the HOG's gradient grid
(features.hog).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Level:
    index: int
    imsize: Tuple[int, int]       # true (h, w) of the scaled image
    featsize: Tuple[int, int]     # HOG output (oh, ow) = blocks - 2
    scale: float                  # pixels per feature cell
    octave_first: int             # first level of this level's octave


def hog_blocks(h: int, w: int, binsize: int) -> Tuple[int, int]:
    """Cell grid of an image: round(size / binsize), half up."""
    return (int(math.floor(h / binsize + 0.5)),
            int(math.floor(w / binsize + 0.5)))


def pyramid(imsize: Tuple[int, int], binsize: int, interval: int
            ) -> List[Level]:
    h, w = int(imsize[0]), int(imsize[1])
    sfactor = 2.0 ** (1.0 / interval)
    nscales = 1 + int(math.floor(
        math.log(min(h, w) / (5.0 * binsize)) / math.log(sfactor)))
    sizes: List[Tuple[int, int]] = [(0, 0)] * nscales
    scales = [0.0] * nscales
    for i in range(min(interval, nscales)):
        s = np.float32(1.0 / sfactor ** i)
        # cv::Size_<float> -> Size: float32 product, rounded half to even
        sizes[i] = (int(np.rint(np.float32(h) * s)),
                    int(np.rint(np.float32(w) * s)))
        scales[i] = sfactor ** i * binsize
        for j in range(i + interval, nscales, interval):
            ph, pw = sizes[j - interval]
            sizes[j] = ((ph + 1) // 2, (pw + 1) // 2)
            scales[j] = 2.0 * scales[j - interval]
    out = []
    for i in range(nscales):
        bh, bw = hog_blocks(*sizes[i], binsize)
        out.append(Level(index=i, imsize=sizes[i],
                         featsize=(max(bh - 2, 0), max(bw - 2, 0)),
                         scale=scales[i],
                         octave_first=i - i % interval))
    return out
