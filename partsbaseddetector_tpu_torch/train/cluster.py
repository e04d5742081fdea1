"""Part-mixture clustering and annotation geometry.

Python counterparts of the reference's data preparation
(reference: matlab/learning/point2box.m, data_def.m, clusterparts.m,
k_means.m):

  * point_to_box: derive per-part boxes from keypoint annotations
    (median limb-length ratios, 75th-percentile box size);
  * data_def: scale-normalized absolute part positions;
  * cluster_parts: per part, k-means (R restarts) on the relative
    displacement to the parent — the mixture-type assignment.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def point_to_box(points: np.ndarray, parents: Sequence[int]
                 ) -> np.ndarray:
    """points: (N, P, 2) keypoints -> (N, P, 4) part boxes
    (reference: matlab/learning/point2box.m)."""
    N, P, _ = points.shape
    lens = np.zeros((N, P - 1))
    for p in range(1, P):
        lens[:, p - 1] = np.linalg.norm(
            points[:, p] - points[:, parents[p]], axis=1)
    ratio = np.log(np.maximum(lens, 1e-9)) \
        - np.log(np.maximum(lens[:, :1], 1e-9))
    r = np.exp(np.median(ratio, axis=0))
    boxsize = np.quantile(lens / r[None, :], 0.75, axis=1)
    half = boxsize[:, None, None] / 2.0
    boxes = np.concatenate([points - half, points + half], axis=2)
    return boxes


def data_def(points: np.ndarray, boxes: np.ndarray,
             maxsize: Sequence[int]) -> np.ndarray:
    """Scale-normalized part positions (N, P, 2)
    (reference: matlab/learning/data_def.m): positions divided by
    sqrt(box area) / sqrt(template area) of the first part."""
    w = boxes[:, 0, 2] - boxes[:, 0, 0] + 1
    h = boxes[:, 0, 3] - boxes[:, 0, 1] + 1
    scale = np.sqrt(w * h) / np.sqrt(maxsize[0] * maxsize[1])
    return points / scale[:, None, None]


def _kmeans_once(X: np.ndarray, k: int, rng) -> tuple:
    n = len(X)
    centers = X[rng.choice(n, size=k, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(100):
        d = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if (new_assign == assign).all() and _ > 0:
            break
        assign = new_assign
        for j in range(k):
            sel = assign == j
            if sel.any():
                centers[j] = X[sel].mean(0)
            else:
                centers[j] = X[rng.integers(n)]
    dist = ((X - centers[assign]) ** 2).sum()
    return assign, centers, dist


def cluster_parts(deffeat: np.ndarray, K: Sequence[int],
                  parents: Sequence[int], restarts: int = 100,
                  seed: int = 0) -> List[np.ndarray]:
    """Mixture assignment per part: k-means over relative displacements
    child - parent (for the root: first child - root), best of
    `restarts` (reference: matlab/learning/clusterparts.m)."""
    rng = np.random.default_rng(seed)
    P = deffeat.shape[1]
    idx: List[np.ndarray] = []
    for p in range(P):
        if parents[p] < 0 or parents[p] == p:
            child = next(i for i in range(P) if parents[i] == p)
            X = deffeat[:, child] - deffeat[:, p]
        else:
            X = deffeat[:, p] - deffeat[:, parents[p]]
        k = int(K[p]) if not np.isscalar(K) else int(K)
        if k <= 1 or len(X) <= k:
            idx.append(np.zeros(len(X), np.int64))
            continue
        best = None
        for _ in range(restarts):
            assign, _c, dist = _kmeans_once(X, k, rng)
            if best is None or dist < best[1]:
                best = (assign, dist)
        idx.append(best[0])
    return idx
