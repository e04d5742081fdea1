"""Point-cloud post-processing without PCL (the port's own copy of
``partsbaseddetector_tpu/post/cloud.py``).

NumPy re-implementations of the reference's PointCloudClusterer
(reference: include/PointCloudClusterer.hpp:52-335) and the 3-D bounding
box extraction (reference: include/Candidate.hpp:140-216); the 3-D
boxes' order statistics come from one torch pass a frame on the
caller's device:

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
import torch

from partsbaseddetector_tpu_torch.post.depth import CameraModel
from partsbaseddetector_tpu_torch.post.rect3 import Rect3
from partsbaseddetector_tpu_torch.utils import profiling


#: points of the reference's linear resize of a detection's sorted depth
#: samples (include/Candidate.hpp:190)
_NPOINTS = 400
#: the largest transient device memory of the batched z-extent: a chunk
#: of detections holds two (chunk, depth pixels) integer maps
_CHUNK_BYTES = 64 << 20


def _derivative_of_gaussian() -> np.ndarray:
    """The derivative-of-Gaussian smoothing kernel (kernel 35, sigma 4,
    diff [-1, 0, 1]; reference: include/Candidate.hpp:194-198)."""
    t = np.arange(35) - 17
    g = np.exp(-(t ** 2) / (2 * 4.0 ** 2))
    g = g / g.sum()
    return np.convolve(g, [-1.0, 0.0, 1.0], mode="same")


_DOG = _derivative_of_gaussian()


def _resize_taps(n_in: int, n_out: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv::resize INTER_LINEAR on a column vector (float path) as taps:
    out = v[i0] * (1 - fr) + v[i1] * fr."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(int)
    fr = f - i0
    fr[i0 < 0] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    fr[i0 >= n_in - 1] = 0.0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return i0, i1, fr


def _sample_boxes(detection, imsize: Tuple[int, int],
                  dshape: Tuple[int, int]) -> np.ndarray:
    """The (P + 1, 4) int64 depth-map boxes x1, y1, x2, y2 whose valid
    samples give a detection's z-extent: its own part boxes, then the
    mean +- 1.5 sigma box of their centres, clipped to the image, scaled
    to the depth map and truncated (reference:
    include/Candidate.hpp:150-175)."""
    H, W = imsize
    dh, dw = dshape
    lim = [W, H, W, H]
    parts = detection.own().parts
    cx = (parts[:, 0] + parts[:, 2]) / 2.0
    cy = (parts[:, 1] + parts[:, 3]) / 2.0
    mx, my = cx.mean(), cy.mean()
    stdx, stdy = cx.std(), cy.std()
    norm = np.clip([mx - 1.5 * stdx, my - 1.5 * stdy,
                    mx + 1.5 * stdx, my + 1.5 * stdy], [0, 0, 0, 0], lim)
    boxes = np.vstack([np.clip(parts, [0, 0, 0, 0], lim), norm])
    return (boxes * [dw / W, dh / H, dw / W, dh / H]).astype(np.int64)


def _chunk_rows(n: int, grid: int, itemsize: int) -> int:
    """Detections a chunk of the batched z-extent: chunks of equal size,
    each under _CHUNK_BYTES in its two (chunk, grid) integer maps."""
    nchunks = -(-n // max(1, _CHUNK_BYTES // (2 * grid * itemsize)))
    return -(-n // nchunks)


def _order_statistics(boxes: np.ndarray, depth: np.ndarray, device
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The samples of each detection's z-extent, in one pass over the
    frame on ``device``.  boxes: (N, B, 4) int64 sample boxes, a
    detection's rows padded with empty boxes.  A detection's samples are
    the valid depth pixels (nonzero, not NaN) under its boxes, each
    counted once a box that covers it: the multiset the reference
    gathers box by box.  The depth map is sorted once; a detection's
    coverage counts (a 2-D difference array of its boxes, two prefix
    sums) are taken in that order and summed, and the value at rank r
    is the first sorted value whose running count passes r.

    Returns n (N,) the samples' count, first (N,) whether the first box
    holds a sample (the reference stops at a first box without one),
    and (N, 2, _NPOINTS) float32 the values at the ranks i0 and i1 of
    the sorted samples' resize (_resize_taps), read back in one copy."""
    dh, dw = depth.shape
    N, B, _ = boxes.shape
    npix, G = dh * dw, (dh + 1) * (dw + 1)
    # the boxes' corners in the (dh + 1, dw + 1) grid, +1 at (y1, x1)
    # and (y2, x2), -1 at the other two; an empty box weighs nothing
    x1, y1, x2, y2 = np.minimum(boxes, [dw, dh, dw, dh]).transpose(2, 0, 1)
    corners = np.stack([y1 * (dw + 1) + x1, y1 * (dw + 1) + x2,
                        y2 * (dw + 1) + x1, y2 * (dw + 1) + x2], -1)
    sign = np.array([1, -1, -1, 1]) * ((x2 > x1) & (y2 > y1))[..., None]
    up = torch.from_numpy(np.stack([corners, sign])).to(device)
    d = torch.from_numpy(np.ascontiguousarray(depth)).to(device)
    cdt = torch.int32 if B * npix < 2 ** 31 else torch.int64
    weight = up[1].to(cdt)

    valid = (d != 0) & ~torch.isnan(d)
    vals, perm = torch.sort(d.float().reshape(-1))
    in_order = valid.reshape(-1)[perm].to(cdt)
    grid_idx = perm // dw * (dw + 1) + perm % dw    # sort order -> grid
    # valid samples under each first box, from the mask's integral image
    integral = torch.zeros((dh + 1, dw + 1), dtype=cdt, device=device)
    integral[1:, 1:] = valid.to(cdt).cumsum(0, dtype=cdt).cumsum(
        1, dtype=cdt)
    first = (integral.reshape(-1)[up[0, :, 0]] * weight[:, 0]).sum(-1)

    C = _chunk_rows(N, G, cdt.itemsize)
    grid = torch.empty((C, G), dtype=cdt, device=device)
    offsets = torch.arange(C, device=device).view(C, 1, 1) * G
    taps = torch.arange(_NPOINTS, dtype=torch.float64, device=device) + 0.5
    out = torch.empty((N, 2 * _NPOINTS + 2), dtype=torch.float64,
                      device=device)
    for c0 in range(0, N, C):
        c = min(C, N - c0)
        cov = grid[:c].zero_()
        cov.view(-1).index_add_(0, (up[0, c0:c0 + c] + offsets[:c])
                                .reshape(-1), weight[c0:c0 + c].reshape(-1))
        cov.view(c, dh + 1, dw + 1).cumsum_(1).cumsum_(2)
        cum = cov.index_select(1, grid_idx).mul_(in_order).cumsum_(1)
        n = cum[:, -1]
        # the resize's ranks as _resize_taps computes them, in float64
        # (divided by a tensor: a CPU scalar divisor is a reciprocal)
        nf = n.double()
        f = taps * (nf / torch.full_like(nf, _NPOINTS))[:, None] - 0.5
        hi = (n.long() - 1).clamp(min=0)[:, None]
        i0 = torch.minimum(torch.floor(f).long().clamp(min=0), hi)
        ranks = torch.cat([i0, torch.minimum(i0 + 1, hi)], 1).to(cdt)
        at = torch.searchsorted(cum, ranks, right=True).clamp_(max=npix - 1)
        out[c0:c0 + c, :-2] = vals[at]
        out[c0:c0 + c, -2] = n
    out[:, -1] = first
    host = out.cpu().numpy()
    profiling.count("readbacks")
    n = host[:, -2].astype(np.int64)
    first = host[:, -1] > 0
    return n, first, host[:, :-2].astype(np.float32).reshape(
        N, 2, _NPOINTS)


def _smoothed_extent(points: np.ndarray, bb: np.ndarray) -> Rect3:
    """The z-extent walked out from the median of the resized samples
    while the smoothed depth-derivative stays within 0.035
    (reference: include/Candidate.hpp:186-216), over the 2-D hull bb."""
    M = len(points)
    midx = M // 2
    steep = np.abs(np.convolve(points, _DOG[::-1], mode="same")) > 0.035
    # the last point before the first steep one on each side (the median
    # itself when it is steep), the end when none is
    up = np.flatnonzero(steep[midx:])
    down = np.flatnonzero(steep[midx::-1])
    dmax = max(midx, midx + int(up[0]) - 1) if up.size else M - 1
    dmin = min(midx, midx - int(down[0]) + 1) if down.size else 0
    return Rect3.from_corners((bb[0], bb[1], points[dmin]),
                              (bb[2], bb[3], points[dmax]))


def _boxes_3d(detections: Sequence, imsize: Tuple[int, int],
              depth: np.ndarray, device) -> List[Rect3]:
    """bounding_box_3d of each detection, the samples of all of them
    found in one pass on ``device`` (_order_statistics); counted in the
    tracer's ``boxes3d.dets`` (the detections) and ``boxes3d.samples``
    (the samples of the valid ones, what the reference gathers)."""
    invalid = Rect3(np.nan, np.nan, np.nan, 0, 0, 0)
    depth = np.asarray(depth)
    if not len(detections) or depth.size == 0:
        return [invalid] * len(detections)
    if not np.issubdtype(depth.dtype, np.floating):
        depth = depth.astype(np.float32)    # integer depths hold no NaN
    rows = [_sample_boxes(d, imsize, depth.shape) for d in detections]
    boxes = np.zeros((len(rows), max(map(len, rows)), 4), np.int64)
    for i, r in enumerate(rows):
        boxes[i, :len(r)] = r
    n, first, samples = _order_statistics(boxes, depth, device)
    profiling.count("boxes3d.dets", len(detections))
    profiling.count("boxes3d.samples", int(n[first].sum()))
    out = []
    for det, k, ok, (v0, v1) in zip(detections, n, first, samples):
        if not ok:
            out.append(invalid)
            continue
        fr = _resize_taps(int(k), _NPOINTS)[2]
        out.append(_smoothed_extent(v0 * (1 - fr) + v1 * fr,
                                    det.bounding_box()))
    return out


def bounding_box_3d(detection, imsize: Tuple[int, int],
                    depth: np.ndarray) -> Rect3:
    """3-D box of a detection: 2-D hull + z-extent found by walking a
    smoothed depth-derivative from the median depth
    (reference: include/Candidate.hpp:140-216), over its component's own
    parts (Detection.own); the batched pass of compute_bounding_boxes on
    the CPU."""
    return _boxes_3d([detection], imsize, depth, "cpu")[0]


def compute_bounding_boxes(detections: Sequence, imsize: Tuple[int, int],
                           depth: np.ndarray, camera: CameraModel,
                           device="cpu"
                           ) -> Tuple[List[Rect3], List[np.ndarray]]:
    """Per candidate: 3-D bounding box (corners back-projected at the
    z-extent) and per-part centers back-projected at the part's average
    depth (reference: include/PointCloudClusterer.hpp:52-154), one a
    part of its component (Detection.own).  The z-extents of all the
    detections come from one pass on ``device`` (the serving path's: the
    detector's); the rest runs on the host."""
    H, W = imsize
    boxes3d: List[Rect3] = []
    centers: List[np.ndarray] = []
    for det, cube in zip(detections,
                         _boxes_3d(detections, imsize, depth, device)):
        if not cube.is_valid():
            boxes3d.append(Rect3(0, 0, 0, 0, 0, 0))
            centers.append(np.zeros((0, 3)))
            continue
        pc = []
        boxes = np.clip(det.own().parts, [0, 0, 0, 0], [W, H, W, H])
        for x1, y1, x2, y2 in boxes.astype(np.int64).tolist():
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
