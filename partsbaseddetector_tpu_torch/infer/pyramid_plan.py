"""Host-side pyramid planning: levels, scales, octave buckets.

Numpy only; the port's own copy of
``partsbaseddetector_tpu/infer/pyramid_plan.py``.  The reference
computes the ladder structure on the fly per image (reference:
src/HOGFeatures.cpp:95-127).  Here the whole structure is precomputed
from the image shape: per-level true sizes, scales (pixel stride per
feature cell), and octave buckets whose levels share a padded buffer,
so the per-bucket ops (ladder, HOG, one filter-bank conv, the DP over
levels) run once per bucket with the levels as a batch axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from partsbaseddetector_tpu_torch.ops.hog import hog_output_shape


def _cv_round_f32(x: float) -> int:
    """cv::Size_<float> -> Size conversion (saturate_cast = round half to
    even), in float32 like the reference arithmetic."""
    return int(np.rint(np.float32(x)))


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    index: int                  # pyramid level index n
    imsize: Tuple[int, int]     # true (h, w) of the scaled image
    featsize: Tuple[int, int]   # true HOG output (oh, ow)
    blocks: Tuple[int, int]     # true HOG cell grid (bh, bw)
    scale: float                # pixels per feature cell
                                # (reference: src/HOGFeatures.cpp:118,124)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    octave: int
    levels: Tuple[LevelPlan, ...]
    img_pad: Tuple[int, int]    # padded image buffer (max level in bucket)
    feat_pad: Tuple[int, int]   # padded feature buffer


@dataclasses.dataclass(frozen=True)
class PyramidPlan:
    imsize: Tuple[int, int]
    binsize: int
    interval: int
    nscales: int
    sfactor: float
    buckets: Tuple[BucketPlan, ...]

    @property
    def levels(self) -> List[LevelPlan]:
        return [lvl for b in self.buckets for lvl in b.levels]


def make_plan(imsize: Tuple[int, int], binsize: int,
              interval: int) -> PyramidPlan:
    """Plan the scale ladder for one image shape.

    nscales = 1 + floor(log(min(h, w) / (5*binsize)) / log(sfactor)),
    sfactor = 2^(1/interval) (reference: src/HOGFeatures.cpp:98-99 with
    include/HOGFeatures.hpp:76-78).  Level i < interval is a bilinear
    resize of the original by 1/sfactor^i; level i >= interval is a
    pyrDown of level i - interval (reference: src/HOGFeatures.cpp:111-127).
    """
    h, w = int(imsize[0]), int(imsize[1])
    sfactor = 2.0 ** (1.0 / interval)
    arg = min(float(h), float(w)) / (5.0 * float(binsize))
    if arg < 1.0:
        raise ValueError(f"image {h}x{w} too small for binsize {binsize}")
    nscales = 1 + int(math.floor(math.log(arg) / math.log(sfactor)))

    sizes: List[Tuple[int, int]] = [None] * nscales  # type: ignore
    scales: List[float] = [0.0] * nscales
    for i in range(min(interval, nscales)):
        s = 1.0 / (sfactor ** i)
        sizes[i] = (_cv_round_f32(h * np.float32(s)),
                    _cv_round_f32(w * np.float32(s)))
        scales[i] = (sfactor ** i) * binsize
        j = i + interval
        while j < nscales:
            ph, pw = sizes[j - interval]
            sizes[j] = ((ph + 1) // 2, (pw + 1) // 2)
            scales[j] = 2.0 * scales[j - interval]
            j += interval

    levels = []
    for i in range(nscales):
        bh, bw, oh, ow = hog_output_shape(sizes[i], binsize)
        levels.append(LevelPlan(index=i, imsize=sizes[i],
                                featsize=(oh, ow), blocks=(bh, bw),
                                scale=scales[i]))

    buckets = []
    noctaves = (nscales + interval - 1) // interval
    for o in range(noctaves):
        lv = tuple(levels[o * interval:min((o + 1) * interval, nscales)])
        img_pad = lv[0].imsize
        feat_pad = lv[0].featsize
        buckets.append(BucketPlan(octave=o, levels=lv,
                                  img_pad=img_pad, feat_pad=feat_pad))
    return PyramidPlan(imsize=(h, w), binsize=binsize, interval=interval,
                       nscales=nscales, sfactor=sfactor,
                       buckets=tuple(buckets))
