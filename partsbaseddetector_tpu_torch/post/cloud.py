"""Point-cloud post-processing without PCL (the port's own copy of
``partsbaseddetector_tpu/post/cloud.py``).

NumPy re-implementations of the reference's PointCloudClusterer
(reference: include/PointCloudClusterer.hpp:52-335) and the 3-D bounding
box extraction (reference: include/Candidate.hpp:140-216):

  * bounding_box_3d      — depth-median + smoothed-gradient walk z-extent
  * compute_bounding_boxes — per candidate: 3-D box + per-part
    average-depth back-projection through a camera model
  * cluster_objects      — crop-box (expanded 20%) -> Euclidean
    clustering (tolerance 0.010 m) -> biggest cluster + centroid
  * organized_multiplane_segmentation — normal estimation on the
    organized cloud + plane inlier removal (distance threshold 0.02 m)

Euclidean clustering uses a voxel-hash union-find at the cluster
tolerance (PCL's kd-tree radius search replaced by 26-neighborhood voxel
connectivity — an equivalent-up-to-tolerance clustering that can merge
points up to sqrt(3)*tol apart; acceptable for the 1 cm tolerance used
here and orders of magnitude faster in NumPy)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from partsbaseddetector_tpu_torch.post.depth import CameraModel
from partsbaseddetector_tpu_torch.post.rect3 import Rect3


def _resize_linear_1d(v: np.ndarray, n_out: int) -> np.ndarray:
    """cv::resize INTER_LINEAR on a column vector (float path)."""
    n_in = len(v)
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(int)
    fr = f - i0
    fr[i0 < 0] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    fr[i0 >= n_in - 1] = 0.0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return v[i0] * (1 - fr) + v[i1] * fr


def bounding_box_3d(detection, imsize: Tuple[int, int],
                    depth: np.ndarray) -> Rect3:
    """3-D box of a detection: 2-D hull + z-extent found by walking a
    smoothed depth-derivative from the median depth
    (reference: include/Candidate.hpp:140-216), over its component's own
    parts (Detection.own)."""
    H, W = imsize
    dh, dw = depth.shape
    sx, sy = dw / W, dh / H
    detection = detection.own()
    bb = detection.bounding_box()

    # gather valid depth points under all part boxes + the norm box
    boxes = [np.clip(p, [0, 0, 0, 0], [W, H, W, H])
             for p in detection.parts]
    cx = (detection.parts[:, 0] + detection.parts[:, 2]) / 2.0
    cy = (detection.parts[:, 1] + detection.parts[:, 3]) / 2.0
    mx, my = cx.mean(), cy.mean()
    stdx, stdy = cx.std(), cy.std()
    boxes.append(np.clip([mx - 1.5 * stdx, my - 1.5 * stdy,
                          mx + 1.5 * stdx, my + 1.5 * stdy],
                         [0, 0, 0, 0], [W, H, W, H]))
    pts: List[float] = []
    for b in boxes:
        x1, y1 = int(b[0] * sx), int(b[1] * sy)
        x2, y2 = int(b[2] * sx), int(b[3] * sy)
        part = depth[y1:y2, x1:x2].ravel()
        part = part[(part != 0) & ~np.isnan(part)]
        pts.extend(part.tolist())
        if not pts:
            return Rect3(np.nan, np.nan, np.nan, 0, 0, 0)

    points = _resize_linear_1d(np.sort(np.asarray(pts, np.float32)), 400)
    M = len(points)
    midx = M // 2
    median = points[midx]
    del median  # informational in the reference too

    # derivative-of-Gaussian smoothing (kernel 35, sigma 4, diff [-1,0,1];
    # reference: include/Candidate.hpp:194-198)
    t = np.arange(35) - 17
    g = np.exp(-(t ** 2) / (2 * 4.0 ** 2))
    g = g / g.sum()
    dog = np.convolve(g, [-1.0, 0.0, 1.0], mode="same")
    dpoints = np.convolve(points, dog[::-1], mode="same")

    dmin = dmax = midx
    for m in range(midx, M):
        if abs(dpoints[m]) > 0.035:
            break
        dmax = m
    for m in range(midx, -1, -1):
        if abs(dpoints[m]) > 0.035:
            break
        dmin = m

    return Rect3.from_corners((bb[0], bb[1], points[dmin]),
                              (bb[2], bb[3], points[dmax]))


def compute_bounding_boxes(detections: Sequence, imsize: Tuple[int, int],
                           depth: np.ndarray, camera: CameraModel
                           ) -> Tuple[List[Rect3], List[np.ndarray]]:
    """Per candidate: 3-D bounding box (corners back-projected at the
    z-extent) and per-part centers back-projected at the part's average
    depth (reference: include/PointCloudClusterer.hpp:52-154), one a
    part of its component (Detection.own)."""
    H, W = imsize
    boxes3d: List[Rect3] = []
    centers: List[np.ndarray] = []
    for det in detections:
        cube = bounding_box_3d(det, imsize, depth)
        if not cube.is_valid():
            boxes3d.append(Rect3(0, 0, 0, 0, 0, 0))
            centers.append(np.zeros((0, 3)))
            continue
        pc = []
        for box in det.own().parts:
            b = np.clip(box, [0, 0, 0, 0], [W, H, W, H])
            x1, y1, x2, y2 = (int(v) for v in b)
            region = depth[y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)]
            avg = float(region.mean()) if region.size else 0.0
            cx2, cy2 = (x1 + x2) / 2.0, (y1 + y2) / 2.0
            ray = camera.project_px_to_3d(cx2, cy2, 1.0)
            pc.append(ray * avg)
        centers.append(np.asarray(pc))
        tl2 = camera.project_px_to_3d(cube.x, cube.y, 1.0) * cube.z
        br2 = camera.project_px_to_3d(cube.x + cube.width,
                                      cube.y + cube.height, 1.0) \
            * (cube.z + cube.depth)
        boxes3d.append(Rect3.from_corners(tl2, br2))
    return boxes3d, centers


def euclidean_clusters(points: np.ndarray, tol: float) -> List[np.ndarray]:
    """Voxel-hash Euclidean clustering: indices of connected components
    under 26-neighborhood voxel adjacency at cell size tol (the PCL
    EuclideanClusterExtraction analog,
    reference: include/PointCloudClusterer.hpp:225-245)."""
    n = len(points)
    if n == 0:
        return []
    vox = np.floor(points / tol).astype(np.int64)
    # union-find over points sharing or adjacent in voxel space
    order = np.lexsort((vox[:, 2], vox[:, 1], vox[:, 0]))
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj

    voxmap = {}
    for idx in order:
        key = tuple(vox[idx])
        voxmap.setdefault(key, []).append(idx)
    for key, members in voxmap.items():
        for m in members[1:]:
            union(members[0], m)
        kx, ky, kz = key
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    if (dx, dy, dz) <= (0, 0, 0):
                        continue
                    nb = voxmap.get((kx + dx, ky + dy, kz + dz))
                    if nb:
                        union(members[0], nb[0])
    roots = np.array([find(i) for i in range(n)])
    clusters = {}
    for i, r in enumerate(roots):
        clusters.setdefault(r, []).append(i)
    return [np.asarray(v) for v in clusters.values()]


def cluster_objects(cloud: np.ndarray, boxes3d: Sequence[Rect3],
                    tol: float = 0.010
                    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per box: expand by 20%, crop the cloud, cluster, keep the biggest
    cluster; returns (clusters, centers) aligned with boxes3d
    (reference: include/PointCloudClusterer.hpp:156-292).  cloud:
    (N, 3) float (NaNs allowed)."""
    clusters_out: List[np.ndarray] = []
    centers_out: List[np.ndarray] = []
    finite = np.isfinite(cloud).all(axis=1)
    for box in boxes3d:
        if box.volume() < 1e-6:
            clusters_out.append(np.zeros((0, 3)))
            centers_out.append(np.full(3, np.nan))
            continue
        b = box.expand(1.2)
        tl, br = b.tl(), b.br()
        inside = finite & np.all((cloud >= tl) & (cloud <= br), axis=1)
        pts = cloud[inside]
        if len(pts) == 0:
            clusters_out.append(np.zeros((0, 3)))
            centers_out.append(np.full(3, np.nan))
            continue
        cls = euclidean_clusters(pts, tol)
        best = max(cls, key=len)
        cluster = pts[best]
        clusters_out.append(cluster)
        centers_out.append(cluster.mean(axis=0))
    return clusters_out, centers_out


def organized_normals(cloud: np.ndarray) -> np.ndarray:
    """Normals of an organized (H, W, 3) cloud from central differences
    (the IntegralImageNormalEstimation analog,
    reference: include/PointCloudClusterer.hpp:298-302)."""
    dzdx = np.gradient(cloud, axis=1)
    dzdy = np.gradient(cloud, axis=0)
    n = np.cross(dzdx, dzdy)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        return n / np.where(norm > 0, norm, 1.0)


def organized_multiplane_segmentation(cloud: np.ndarray,
                                      dist_thresh: float = 0.02,
                                      min_inliers: int = 500,
                                      max_planes: int = 4) -> np.ndarray:
    """Remove dominant planes from an organized (H, W, 3) cloud;
    returns the remaining (N, 3) points
    (reference: include/PointCloudClusterer.hpp:294-335).

    Planes are found by iterative consensus on the normal field: take
    the modal normal direction (quantized), fit d = median(n . p) over
    supporters, remove inliers within dist_thresh."""
    H, W, _ = cloud.shape
    pts = cloud.reshape(-1, 3)
    normals = organized_normals(cloud).reshape(-1, 3)
    valid = np.isfinite(pts).all(1) & np.isfinite(normals).all(1)
    keep = valid.copy()
    for _ in range(max_planes):
        idx = np.nonzero(keep)[0]
        if len(idx) < min_inliers:
            break
        q = np.round(normals[idx] * 10).astype(np.int64)
        key = (q[:, 0] + 21) * 43 * 43 + (q[:, 1] + 21) * 43 + (q[:, 2]
                                                                + 21)
        vals, counts = np.unique(key, return_counts=True)
        mode = vals[counts.argmax()]
        if counts.max() < min_inliers:
            break
        sel = idx[key == mode]
        nrm = normals[sel].mean(0)
        nrm /= np.linalg.norm(nrm) + 1e-12
        d = np.median(pts[sel] @ nrm)
        dist = np.abs(pts[idx] @ nrm - d)
        inl = idx[dist < dist_thresh]
        if len(inl) < min_inliers:
            break
        keep[inl] = False
    return pts[keep]
