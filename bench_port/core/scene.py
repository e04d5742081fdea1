"""Seeded RGB-D frames of a Kinect-class camera.

Frozen from chip_smoke.py (``kinect_camera``, ``serve_scene``): a
uint8 RGB frame of noise; a depth map in millimetres, a plane at about
2 m (1.8 m at the top row, 0.5 mm farther a row) with a nearer box face
(1.2-1.6 m, 0.5 mm farther a column; a quarter to a half of the frame
each way, placed at random); and the organized (H, W, 3) cloud in metres
back-projected from it.  Depth is handed on in metres, float32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def kinect_camera(shape) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy): fx = fy = 525 at 640 columns, the principal
    point at the centre, scaled to the image."""
    s = shape[1] / 640.0
    return (525.0 * s, 525.0 * s, (shape[1] - 1) / 2, (shape[0] - 1) / 2)


def scenes(n: int, shape, rng: np.random.Generator
           ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """n frames: (rgb uint8 (H, W, 3), depth float32 metres (H, W),
    cloud float64 (H, W, 3))."""
    H, W = shape
    fx, fy, cx, cy = kinect_camera(shape)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    out = []
    for _ in range(n):
        rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        d = (1800 + ys // 2).astype(np.uint16)
        bh, bw = rng.integers(H // 4, H // 2), rng.integers(W // 4, W // 2)
        y0, x0 = rng.integers(0, H - bh), rng.integers(0, W - bw)
        d[y0:y0 + bh, x0:x0 + bw] = rng.integers(1200, 1600) \
            + xs[y0:y0 + bh, x0:x0 + bw] // 2
        z = d / 1000.0
        cloud = np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], -1)
        out.append((rgb, z.astype(np.float32), cloud))
    return out
