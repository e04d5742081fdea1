"""Depth-based candidate pruning — the RGB-D path (the port's own copy of
``partsbaseddetector_tpu/post/depth.py``).

Functional equivalents of the reference's SearchSpacePruning
(reference: src/SearchSpacePruning.cpp:46-99).  Note the reference wires
neither call site into the pipeline (both commented out at
src/PartsBasedDetector.cpp:86,92) and filterResponseByDepth is
half-implemented (computes Z, then does nothing,
src/SearchSpacePruning.cpp:59-69); here both are complete and usable.

The reference's DepthConsistency and StereoCameraModel classes are empty
stubs (src/DepthConsistency.cpp:41-48, src/StereoCameraModel.cpp:41-48);
CameraModel below is the functional "slim camera model for non-ROS
users" they gesture at.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class CameraModel:
    """Pinhole camera intrinsics (the functional version of the
    reference's StereoCameraModel stub,
    include/StereoCameraModel.hpp:45-49)."""

    fx: float
    fy: float
    cx: float
    cy: float

    def project_px_to_3d(self, x: float, y: float, z: float):
        """Back-project pixel (x, y) at depth z to camera coords."""
        return np.array([(x - self.cx) * z / self.fx,
                         (y - self.cy) * z / self.fy, z])


def _median_in_box(depth: np.ndarray, box) -> float:
    """Upper median of the depth pixels under a box, reproducing
    Math::median's nth_element-at-n/2 (reference: include/Math.hpp:57-80;
    boxes clipped to the image)."""
    H, W = depth.shape
    x1 = int(np.clip(box[0], 0, W))
    y1 = int(np.clip(box[1], 0, H))
    x2 = int(np.clip(box[2], 0, W))
    y2 = int(np.clip(box[3], 0, H))
    if x2 <= x1 or y2 <= y1:
        return 0.0
    vals = depth[y1:y2, x1:x2].ravel()
    n = vals.size
    return float(np.partition(vals, n // 2)[n // 2])


def filter_candidates_by_depth(model, detections: Sequence,
                               depth: np.ndarray,
                               zfactor: float = 0.03) -> List:
    """Reject candidates whose child/parent median depths differ by more
    than ||anchor|| * zfactor (reference: src/SearchSpacePruning.cpp:
    73-95; leaf-to-root walk with early break)."""
    out = []
    for det in detections:
        comp = model.components[det.component]
        nparts = comp.nparts
        ok = True
        for p in range(nparts - 1, 0, -1):
            part = comp.parts[p]
            anchor = np.asarray(model.anchors[part.defid[0]], float)
            child = det.parts[p]
            parent = det.parts[part.parentid]
            cmed = _median_in_box(depth, child)
            pmed = _median_in_box(depth, parent)
            if cmed > 0 and pmed > 0:
                if abs(cmed - pmed) > np.linalg.norm(anchor) * zfactor:
                    ok = False
                    break
        if ok:
            out.append(det)
    return out


def filter_response_by_depth(pdfs: np.ndarray, depth: np.ndarray,
                             scales: Sequence[float], part_width_m: float,
                             fx: float, tol: float = 0.5) -> np.ndarray:
    """Mask response maps to plausible depths: a part whose physical
    width is ``part_width_m`` imaged at pyramid scale s (pixels/cell)
    should appear at depth Z ~ fx * X / (s * cell_extent).  Completes the
    reference's abandoned filterResponseByDepth
    (src/SearchSpacePruning.cpp:47-70).

    pdfs: (L, H, W, F) response maps; depth: (h, w) meters; scales: per
    level pixels-per-cell.  Returns masked copy (implausible cells set
    to -inf)."""
    L, H, W, F = pdfs.shape
    out = np.array(pdfs, copy=True)
    dh, dw = depth.shape
    for n in range(L):
        zexp = fx * part_width_m / float(scales[n])
        ys = np.clip(((np.arange(H) + 0.5) * dh / H).astype(int), 0,
                     dh - 1)
        xs = np.clip(((np.arange(W) + 0.5) * dw / W).astype(int), 0,
                     dw - 1)
        sdepth = depth[ys][:, xs]
        bad = (sdepth > 0) & (np.abs(sdepth - zexp) > tol * zexp)
        out[n][bad] = -np.inf
    return out
