"""Dataset loading and generation for training/evaluation.

The reference's datasets (PARSE person, annotated faces) load through
getPositiveData/getNegativeData (reference: matlab/learning/
getPositiveData.m) from image dirs + .mat annotation files.  Here:

  * a portable .npz dataset format: images (N, H, W[, 3]) or object
    array, points (N, P, 2), scales (N,);
  * a PARSE-style loader (image directory + keypoint .mat) when such
    data is present;
  * a synthetic articulated-figure generator, used by tests and demos
    since no datasets ship with this image.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Sample:
    image: np.ndarray
    points: np.ndarray    # (P, 2) keypoints, or empty for negatives
    scale: float          # GT scale for PCK normalization


def save_dataset(path: str, samples: Sequence[Sample]) -> None:
    def obj_array(items):
        out = np.empty(len(items), dtype=object)
        for i, x in enumerate(items):
            out[i] = np.asarray(x)
        return out

    np.savez(path,
             images=obj_array([s.image for s in samples]),
             points=obj_array([s.points for s in samples]),
             scales=np.asarray([s.scale for s in samples]))


def load_dataset(path: str) -> List[Sample]:
    if os.path.isdir(path):
        return _load_parse_dir(path)
    data = np.load(path, allow_pickle=True)
    return [Sample(image=np.asarray(im, dtype=np.float64),
                   points=np.asarray(pt, dtype=np.float64),
                   scale=float(sc))
            for im, pt, sc in zip(data["images"], data["points"],
                                  data["scales"])]


def _load_parse_dir(path: str) -> List[Sample]:
    """PARSE-style directory: images + a labels.mat with (P, 2, N)
    keypoints (the layout matlab/learning/getPositiveData.m reads)."""
    import scipy.io
    from PIL import Image
    labels = None
    for cand in ("labels.mat", "parse.mat"):
        p = os.path.join(path, cand)
        if os.path.exists(p):
            labels = scipy.io.loadmat(p)
            break
    if labels is None:
        raise FileNotFoundError(f"no labels.mat in {path}")
    key = next(k for k in labels if not k.startswith("__"))
    pts = np.asarray(labels[key], dtype=np.float64)
    images = sorted(glob.glob(os.path.join(path, "*.jpg"))
                    + glob.glob(os.path.join(path, "*.png")))
    out = []
    for i, imgpath in enumerate(images):
        im = np.asarray(Image.open(imgpath).convert("RGB"))
        p = pts[..., i] if pts.ndim == 3 else pts[i]
        span = p.max(0) - p.min(0)
        out.append(Sample(image=im, points=p,
                          scale=float(np.sqrt(span[0] * span[1]))))
    return out


# ------------------------------------------------------------ synthetic

def synthetic_figures(n: int = 20, imsize: Tuple[int, int] = (96, 96),
                      nparts: int = 3, seed: int = 0,
                      noise: float = 40.0,
                      blob: int = 10, spacing: int = 14,
                      jitter: int = 2
                      ) -> Tuple[List[Sample], List[np.ndarray]]:
    """Planted articulated chains in noise: returns (positives,
    negative_images).  Part p sits `spacing` px below part p-1 with
    +-jitter px of x articulation."""
    rng = np.random.default_rng(seed)
    H, W = imsize
    pos: List[Sample] = []
    for _ in range(n):
        im = rng.random((H, W)) * noise
        margin = blob + 2
        cx = int(rng.integers(margin, W - margin))
        cy = int(rng.integers(margin, H - margin
                              - spacing * (nparts - 1)))
        pts = []
        x, y = cx, cy
        for p in range(nparts):
            im[max(y - blob // 2, 0):y + blob // 2,
               max(x - blob // 2, 0):x + blob // 2] += 170
            pts.append([x, y])
            x = int(np.clip(x + rng.integers(-jitter, jitter + 1),
                            margin, W - margin))
            y += spacing
        scale = float(np.sqrt((blob * 1.0) * (blob
                                              + spacing * (nparts - 1))))
        pos.append(Sample(image=np.clip(im, 0, 255),
                          points=np.asarray(pts, np.float64),
                          scale=scale))
    neg = [rng.random((H, W)) * noise for _ in range(max(n // 2, 2))]
    return pos, neg


# 26-part person-like skeleton: (parent, (dx, dy)) per part, the scale
# of the reference's Person_26parts flagship (conf/config_person.
# by_parts:30).  Left/right limbs mirror under PERSON26_MIRROR.
PERSON26_TREE = [
    (-1, (0, 0)),      # 0  torso center
    (0, (0, -10)),     # 1  chest
    (1, (0, -8)),      # 2  neck
    (2, (0, -8)),      # 3  head
    (2, (-10, 1)),     # 4  L shoulder
    (4, (-8, 6)),      # 5  L elbow
    (5, (-6, 8)),      # 6  L wrist
    (2, (10, 1)),      # 7  R shoulder
    (7, (8, 6)),       # 8  R elbow
    (8, (6, 8)),       # 9  R wrist
    (0, (0, 10)),      # 10 belly
    (10, (0, 10)),     # 11 pelvis
    (11, (-7, 2)),     # 12 L hip
    (12, (-2, 12)),    # 13 L knee
    (13, (0, 12)),     # 14 L ankle
    (14, (-4, 3)),     # 15 L foot
    (11, (7, 2)),      # 16 R hip
    (16, (2, 12)),     # 17 R knee
    (17, (0, 12)),     # 18 R ankle
    (18, (4, 3)),      # 19 R foot
    (6, (-3, 5)),      # 20 L hand
    (9, (3, 5)),       # 21 R hand
    (3, (-6, 0)),      # 22 L ear
    (3, (6, 0)),       # 23 R ear
    (3, (0, -7)),      # 24 crown
    (3, (0, 6)),       # 25 chin
]
PERSON26_PARENTS = [p for p, _ in PERSON26_TREE]
PERSON26_MIRROR = [0, 1, 2, 3, 7, 8, 9, 4, 5, 6, 10, 11, 16, 17, 18,
                   19, 12, 13, 14, 15, 21, 20, 23, 22, 24, 25]


def synthetic_skeletons(n: int = 16,
                        imsize: Tuple[int, int] = (128, 96),
                        tree: Sequence[Tuple[int, Tuple[int, int]]]
                        = tuple(PERSON26_TREE),
                        seed: int = 0, noise: float = 40.0,
                        blob: int = 6, jitter: int = 2
                        ) -> Tuple[List[Sample], List[np.ndarray]]:
    """Planted articulated SKELETONS in noise: a full part tree with
    per-part 2-D offsets and articulation jitter, the 26-part-scale
    counterpart of synthetic_figures' 1-D chain.  Per-part blob
    intensity/size vary deterministically so parts carry appearance
    cues beyond pure geometry."""
    rng = np.random.default_rng(seed)
    H, W = imsize
    offs = np.asarray([o for _, o in tree], float)
    parents = [p for p, _ in tree]
    P = len(tree)
    # nominal layout to find extents
    nominal = np.zeros((P, 2))
    for p in range(1, P):
        nominal[p] = nominal[parents[p]] + offs[p]
    lo = nominal.min(0) - blob - jitter - 2
    hi = nominal.max(0) + blob + jitter + 2
    pos: List[Sample] = []
    for _ in range(n):
        im = rng.random((H, W)) * noise
        rx = int(rng.integers(int(-lo[0]), int(W - hi[0])))
        ry = int(rng.integers(int(-lo[1]), int(H - hi[1])))
        pts = np.zeros((P, 2))
        pts[0] = (rx, ry)
        for p in range(1, P):
            jit = rng.integers(-jitter, jitter + 1, size=2)
            pts[p] = pts[parents[p]] + offs[p] + jit
        for p in range(P):
            r = blob // 2 + (p % 3)          # size cue per part
            inten = 120 + 18 * (p % 4)       # intensity cue per part
            x, y = int(pts[p, 0]), int(pts[p, 1])
            im[max(y - r, 0):y + r + 1,
               max(x - r, 0):x + r + 1] += inten
        span = pts.max(0) - pts.min(0)
        pos.append(Sample(image=np.clip(im, 0, 255), points=pts,
                          scale=float(np.sqrt(span[0] * span[1]))))
    neg = [rng.random((H, W)) * noise for _ in range(max(n // 3, 2))]
    return pos, neg
