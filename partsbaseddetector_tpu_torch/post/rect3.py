"""3-D axis-aligned rectangles (the port's own copy of
``partsbaseddetector_tpu/post/rect3.py``).

NumPy counterpart of the reference's Rect3_ template
(reference: include/Rect3.hpp:49-174): tl/br/volume/contains/centroid,
convex hull and intersection."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Rect3:
    x: float
    y: float
    z: float
    width: float
    height: float
    depth: float

    @classmethod
    def from_corners(cls, tl, br) -> "Rect3":
        tl = np.asarray(tl, float)
        br = np.asarray(br, float)
        return cls(*tl, *(br - tl))

    def tl(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z])

    def br(self) -> np.ndarray:
        return self.tl() + np.array([self.width, self.height, self.depth])

    def volume(self) -> float:
        return float(self.width * self.height * self.depth)

    def centroid(self) -> np.ndarray:
        return self.tl() + 0.5 * np.array(
            [self.width, self.height, self.depth])

    def contains(self, pt) -> bool:
        pt = np.asarray(pt, float)
        return bool(np.all(pt >= self.tl()) and np.all(pt < self.br()))

    def is_valid(self) -> bool:
        return bool(np.isfinite(
            [self.x, self.y, self.z, self.width, self.height,
             self.depth]).all())

    def expand(self, factor: float) -> "Rect3":
        """Grow symmetrically: shift tl by -size*(factor-1)/2 and scale
        the extents (the clusterObjects 20% expansion,
        reference: include/PointCloudClusterer.hpp:200-204)."""
        half = (factor - 1.0) / 2.0
        return Rect3(self.x - self.width * half,
                     self.y - self.height * half,
                     self.z - self.depth * half,
                     self.width * factor, self.height * factor,
                     self.depth * factor)

    @staticmethod
    def convex_hull(a: "Rect3", b: "Rect3") -> "Rect3":
        tl = np.minimum(a.tl(), b.tl())
        br = np.maximum(a.br(), b.br())
        return Rect3.from_corners(tl, br)

    @staticmethod
    def intersection(a: "Rect3", b: "Rect3") -> "Rect3":
        tl = np.maximum(a.tl(), b.tl())
        br = np.maximum(np.minimum(a.br(), b.br()), tl)
        return Rect3.from_corners(tl, br)
