"""The serving path's post stage, written for the judge: greedy paint
NMS, the instance mask, 3-D boxes and part centres from depth, and PCA
poses of the part centres.

The NMS and the mask follow the reference C++ detector
(include/Candidate.hpp:277-331); the 3-D stage the reference's
Candidate::boundingBox3D and PointCloudClusterer (include/Candidate.hpp:
140-216, include/PointCloudClusterer.hpp:52-154) in the form the port's
numpy post stage gives them (post/cloud.py, frozen here); poses the ROS
node's message builder (ros/Messages.cpp:187-235).  ``dtype`` is the
floating type of the 3-D arithmetic: float64, the configuration's, or
float32 for the control.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def hull(parts: np.ndarray) -> np.ndarray:
    """(P, 4) part boxes -> their covering box x1, y1, x2, y2."""
    return np.array([parts[:, 0].min(), parts[:, 1].min(),
                     parts[:, 2].max(), parts[:, 3].max()])


def paint_nms(boxes: np.ndarray, imsize, overlap: float,
              limit: Optional[int] = None) -> List[int]:
    """Indices kept by the greedy paint NMS over score-sorted candidates:
    a candidate is kept iff the painted share of its covering box (clipped
    to the image, [x1, x2) x [y1, y2)) is at most ``overlap`` (in
    float32), and then painted.  Stops after ``limit`` keeps."""
    H, W = (int(v) for v in imsize)
    scratch = np.zeros((H, W), np.int64)
    kept: List[int] = []
    ov = np.float32(overlap)
    for i in range(len(boxes)):
        bb = hull(boxes[i])
        x1 = int(np.clip(np.floor(bb[0]), 0, W))
        y1 = int(np.clip(np.floor(bb[1]), 0, H))
        x2 = int(np.clip(np.floor(bb[2]), 0, W))
        y2 = int(np.clip(np.floor(bb[3]), 0, H))
        area = max((x2 - x1) * (y2 - y1), 1)
        painted = int(scratch[y1:y2, x1:x2].sum()) if (x2 > x1 and
                                                     y2 > y1) else 0
        if np.float32(painted) / np.float32(area) <= ov:
            kept.append(i)
            scratch[y1:y2, x1:x2] = 1
            if limit is not None and len(kept) >= limit:
                break
    return kept


def instance_mask(imsize, boxes: List[np.ndarray]) -> np.ndarray:
    """uint8 mask: n + 1 under the n-th detection's covering box where
    no earlier one painted."""
    H, W = imsize
    mask = np.zeros((H, W), np.uint8)
    for n, parts in enumerate(boxes):
        bb = hull(parts)
        x1, y1 = int(np.clip(bb[0], 0, W)), int(np.clip(bb[1], 0, H))
        x2, y2 = int(np.clip(bb[2], 0, W)), int(np.clip(bb[3], 0, H))
        region = mask[y1:y2, x1:x2]
        region[region == 0] = n + 1
    return mask


def _resize_1d(v: np.ndarray, n_out: int, dtype) -> np.ndarray:
    n_in = len(v)
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(int)
    fr = (f - i0).astype(dtype)
    fr[i0 < 0] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    fr[i0 >= n_in - 1] = 0.0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return v[i0] * (1 - fr) + v[i1] * fr


def _z_extent(parts: np.ndarray, imsize, depth: np.ndarray, dtype
              ) -> Optional[Tuple[float, float]]:
    """(near, far) depth of a detection: the depth samples under its part
    boxes and its mean +- 1.5 sigma box, sorted and resampled to 400,
    walked out from the median until a derivative-of-Gaussian response
    exceeds 0.035; None when no box holds a valid depth."""
    H, W = imsize
    dh, dw = depth.shape
    sx, sy = dw / W, dh / H
    boxes = [np.clip(p, [0, 0, 0, 0], [W, H, W, H]) for p in parts]
    cx = (parts[:, 0] + parts[:, 2]) / 2.0
    cy = (parts[:, 1] + parts[:, 3]) / 2.0
    mx, my, stdx, stdy = cx.mean(), cy.mean(), cx.std(), cy.std()
    boxes.append(np.clip([mx - 1.5 * stdx, my - 1.5 * stdy,
                          mx + 1.5 * stdx, my + 1.5 * stdy],
                         [0, 0, 0, 0], [W, H, W, H]))
    pts: List[float] = []
    for b in boxes:
        x1, y1 = int(b[0] * sx), int(b[1] * sy)
        x2, y2 = int(b[2] * sx), int(b[3] * sy)
        v = depth[y1:y2, x1:x2].ravel()
        pts.extend(v[(v != 0) & ~np.isnan(v)].tolist())
        if not pts:
            return None
    points = _resize_1d(np.sort(np.asarray(pts, np.float32)), 400, dtype)
    M = len(points)
    mid = M // 2
    t = np.arange(35) - 17
    g = np.exp(-(t ** 2) / (2 * 4.0 ** 2)).astype(dtype)
    g = g / g.sum()
    dog = np.convolve(g, np.array([-1.0, 0.0, 1.0], dtype), mode="same")
    dpoints = np.convolve(points, dog[::-1], mode="same")
    dmin = dmax = mid
    for m in range(mid, M):
        if abs(dpoints[m]) > 0.035:
            break
        dmax = m
    for m in range(mid, -1, -1):
        if abs(dpoints[m]) > 0.035:
            break
        dmin = m
    return points[dmin], points[dmax]


def _ray(cam, x, y, dtype) -> np.ndarray:
    fx, fy, cx, cy = (dtype(v) for v in cam)
    return np.array([(dtype(x) - cx) / fx, (dtype(y) - cy) / fy,
                     dtype(1.0)], dtype)


def boxes_3d(parts_list: List[np.ndarray], imsize, depth: np.ndarray,
             cam, dtype=np.float64):
    """Per detection: (tl, br) of its 3-D box and its (P, 3) part
    centres, back-projected through cam = (fx, fy, cx, cy); a detection
    with no valid depth gives zeros and no centres."""
    H, W = imsize
    out_boxes, out_centres = [], []
    for parts in parts_list:
        ext = _z_extent(parts, imsize, depth, dtype)
        if ext is None:
            out_boxes.append((np.zeros(3), np.zeros(3)))
            out_centres.append(np.zeros((0, 3)))
            continue
        near, far = (dtype(v) for v in ext)
        far = near + (far - near)      # the box's z + depth
        pc = []
        for box in parts:
            b = np.clip(box, [0, 0, 0, 0], [W, H, W, H])
            x1, y1, x2, y2 = (int(v) for v in b)
            region = depth[y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)]
            # the mean in the depth map's own type, as the port takes it
            avg = dtype(float(region.mean())) if region.size \
                else dtype(0.0)
            pc.append(_ray(cam, (x1 + x2) / 2.0, (y1 + y2) / 2.0, dtype)
                      * avg)
        out_centres.append(np.asarray(pc))
        bb = hull(parts)
        tl = _ray(cam, bb[0], bb[1], dtype) * near
        br = _ray(cam, bb[2], bb[3], dtype) * far
        out_boxes.append((tl, br))
    return out_boxes, out_centres


def _quat(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array([0.25 / s, (R[2, 1] - R[1, 2]) * s,
                         (R[0, 2] - R[2, 0]) * s, (R[1, 0] - R[0, 1]) * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12))
    q = np.zeros(4, R.dtype)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def poses(centres: List[np.ndarray], dtype=np.float64):
    """Per object (position (3,), quaternion w, x, y, z) of its finite
    part centres: the centroid and the right-handed eigenvector frame of
    their covariance; None without a finite centre."""
    out = []
    for pc in centres:
        pc = np.asarray(pc, dtype)
        pts = pc[np.isfinite(pc).all(axis=1)] if pc.size else pc
        if len(pts) == 0:
            out.append(None)
            continue
        centroid = pts.mean(axis=0)
        cov = np.cov(pts.T, bias=True) if len(pts) > 1 else np.eye(3)
        cov = np.atleast_2d(cov).astype(dtype)
        if cov.shape != (3, 3):
            cov = np.eye(3, dtype=dtype)
        _, evecs = np.linalg.eigh(cov)
        if np.linalg.det(evecs) < 0:
            evecs[:, 0] = -evecs[:, 0]
        q = _quat(evecs)
        out.append((centroid, q / np.linalg.norm(q)))
    return out


def serve(cands: Dict[str, np.ndarray], imsize, depth: np.ndarray, cam,
          overlap: float, max_dets: int, dtype=np.float64) -> dict:
    """The post stage of one frame from its valid, score-sorted
    candidates: kept indices, mask, 3-D boxes, part centres, poses."""
    kept = paint_nms(cands["boxes"], imsize, overlap, max_dets)
    parts = [cands["boxes"][i] for i in kept]
    b3, centres = boxes_3d(parts, imsize, depth, cam, dtype)
    return dict(kept=kept, mask=instance_mask(imsize, parts), boxes3d=b3,
                centres=centres, poses=poses(centres, dtype))


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return 1e30
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.where(both_nan, 0.0, np.abs(a - b))
    d = np.where(np.isnan(d), 1e30, d)
    return float(d.max()) if d.size else 0.0


def judge_post(cands: Dict[str, np.ndarray], got: dict, imsize, depth,
               cam, overlap: float, max_dets: int) -> Dict[str, float]:
    """The served frame ``got`` (keys kept_level, kept_loc, kept_score,
    mask, boxes3d [(tl, br)], centres, poses [(position, quaternion) or
    None]) against the post stage worked out in float64 from the same
    candidates.  nms_mismatch: kept detections that differ (level,
    placement or score) plus the difference in count; mask_mismatch:
    pixels that differ; geom_gap_m: the largest gap of a 3-D box corner,
    part centre or pose position; quat_gap: of a pose's quaternion,
    up to sign."""
    ref = serve(cands, imsize, depth, cam, overlap, max_dets)
    kept = ref["kept"]
    n = min(len(kept), len(got["kept_level"]))
    mism = abs(len(kept) - len(got["kept_level"]))
    for i in range(n):
        j = kept[i]
        mism += int(cands["level"][j] != got["kept_level"][i]
                    or not np.array_equal(cands["loc"][j],
                                          got["kept_loc"][i])
                    or cands["score"][j] != got["kept_score"][i])
    out = dict(nms_mismatch=float(mism),
               mask_mismatch=float(np.sum(ref["mask"] != got["mask"])
                                   if ref["mask"].shape == got["mask"].shape
                                   else 1e30))
    if (len(ref["boxes3d"]) != len(got["boxes3d"])
            or len(ref["poses"]) != len(got["poses"])):
        out.update(geom_gap_m=1e30, quat_gap=1e30)
        return out
    geom = [_gap(np.stack(a), np.stack(b))
            for a, b in zip(ref["boxes3d"], got["boxes3d"])]
    geom += [_gap(a, b) for a, b in zip(ref["centres"], got["centres"])]
    quat = []
    for a, b in zip(ref["poses"], got["poses"]):
        if (a is None) != (b is None):
            geom.append(1e30)
        elif a is not None:
            geom.append(_gap(a[0], b[0]))
            quat.append(min(_gap(a[1], b[1]), _gap(a[1], -np.asarray(b[1]))))
    out["geom_gap_m"] = max(geom, default=0.0)
    out["quat_gap"] = max(quat, default=0.0)
    return out
