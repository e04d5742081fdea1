"""Detection visualization (the port's own copy of the drawing functions
of ``partsbaseddetector_tpu/utils/viz.py``; its training views wait for
the training slice).

Python equivalent of the reference's Visualize component
(reference: src/Visualize.cpp:54-129): an HSV color ramp over parts,
rectangle overlays per part, confidence text for the root.  Renders with
PIL (no OpenCV dependency), imported inside the functions so that the
module loads without it; returns/writes RGB uint8 arrays.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence

import numpy as np


def part_colors(nparts: int) -> List[tuple]:
    """HSV ramp over parts (reference: src/Visualize.cpp:60-72)."""
    out = []
    for p in range(nparts):
        h = p / max(nparts, 1)
        r, g, b = colorsys.hsv_to_rgb(h, 1.0, 1.0)
        out.append((int(r * 255), int(g * 255), int(b * 255)))
    return out


def draw_detections(image: np.ndarray, detections: Sequence,
                    max_candidates: Optional[int] = None,
                    with_score: bool = True) -> np.ndarray:
    """Overlay part boxes for each detection
    (reference: src/Visualize.cpp:74-117).

    image: (H, W[, 3]) uint8/float; detections: list of Detection.
    Returns an RGB uint8 copy."""
    from PIL import Image, ImageDraw

    img = np.asarray(image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    H, W = img.shape[:2]

    dets = list(detections)
    if max_candidates is not None:
        dets = dets[:max_candidates]
    for det in dets:
        colors = part_colors(len(det.parts))
        for p, box in enumerate(det.parts):
            x1, y1, x2, y2 = (float(v) for v in box)
            x1, x2 = np.clip([x1, x2], 0, W - 1)
            y1, y2 = np.clip([y1, y2], 0, H - 1)
            if x2 <= x1 or y2 <= y1:
                continue
            draw.rectangle([x1, y1, x2, y2], outline=colors[p], width=1)
        if with_score:
            bx = det.parts[0]
            draw.text((float(np.clip(bx[0], 0, W - 40)),
                       float(np.clip(bx[1] - 12, 0, H - 12))),
                      f"{det.score:.2f}", fill=(255, 255, 255))
    return np.asarray(pil)


def save_image(path: str, image: np.ndarray) -> None:
    from PIL import Image
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(path)


def draw_skeleton(image: np.ndarray, detections: Sequence,
                  parents: Sequence[int], width: int = 4) -> np.ndarray:
    """Stick-figure rendering: a line from each part's box center to its
    parent's, colored per part (the Matlab skeleton renderer,
    reference: matlab/visualization/showskeletons.m:1-20)."""
    from PIL import Image, ImageDraw

    img = np.asarray(image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    for det in detections:
        P = len(det.parts)
        colors = part_colors(P)
        cx = (det.parts[:, 0] + det.parts[:, 2]) / 2.0
        cy = (det.parts[:, 1] + det.parts[:, 3]) / 2.0
        for child in range(1, P):
            par = int(parents[child])
            draw.line([(float(cx[par]), float(cy[par])),
                       (float(cx[child]), float(cy[child]))],
                      fill=colors[child], width=width)
    return np.asarray(pil)
