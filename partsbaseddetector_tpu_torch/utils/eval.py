"""Evaluation metrics: PCK and APK.

Library versions of the reference's Matlab evaluation scripts — the
parity metrics of the project (SURVEY.md §6):

  * PCK (Probability of Correct Keypoint): fraction of keypoints whose
    predicted location falls within thresh * gt_scale of the ground
    truth (reference: matlab/evaluation/eval_pck.m:8-13).
  * APK (Average Precision of Keypoints): VOC-style AP over scored
    keypoint detections, greedy one-to-one assignment to ground truths
    within thresh * scale (reference: matlab/evaluation/eval_apk.m:7-46,
    VOC AP integration matlab/evaluation/VOCap.m:1-10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def pck(pred_points: Sequence[np.ndarray],
        gt_points: Sequence[np.ndarray],
        gt_scales: Sequence[float],
        thresh: float = 0.5) -> np.ndarray:
    """Per-keypoint PCK over a set of images.

    pred_points / gt_points: per image (P, 2) arrays of (x, y);
    gt_scales: per image scalar scale.  Returns (P,) per-keypoint
    fractions (mean over images of dist < thresh*scale, reference:
    eval_pck.m:8-13)."""
    assert len(pred_points) == len(gt_points) == len(gt_scales)
    hits = []
    for pr, gt, sc in zip(pred_points, gt_points, gt_scales):
        dist = np.sqrt(((np.asarray(pr) - np.asarray(gt)) ** 2).sum(1))
        hits.append(dist < thresh * float(sc))
    return np.mean(np.stack(hits, axis=1), axis=1)


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC AP integration (reference: matlab/evaluation/VOCap.m:1-10)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


@dataclasses.dataclass
class KeypointDetection:
    frame: int            # image index ("fr" in eval_apk.m)
    score: float
    point: np.ndarray     # (2,) predicted keypoint


@dataclasses.dataclass
class KeypointGT:
    points: np.ndarray    # (G, 2) ground-truth instances of this keypoint
    scale: float


def apk(detections: Sequence[KeypointDetection],
        gts: Sequence[KeypointGT],
        thresh: float = 0.5) -> Tuple[float, np.ndarray, np.ndarray]:
    """AP for one keypoint type across images
    (reference: matlab/evaluation/eval_apk.m:7-46).

    Returns (ap, precision, recall)."""
    order = np.argsort([-d.score for d in detections], kind="stable")
    dets = [detections[i] for i in order]
    ngt = sum(len(g.points) for g in gts)
    used = [np.zeros(len(g.points), bool) for g in gts]
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for n, d in enumerate(dets):
        g = gts[d.frame]
        if len(g.points) == 0:
            fp[n] = 1
            continue
        dist = np.sqrt(((g.points - d.point) ** 2).sum(1)) / g.scale
        j = int(np.argmin(dist))
        if dist[j] <= thresh:
            if not used[d.frame][j]:
                tp[n] = 1
                used[d.frame][j] = True
            else:
                fp[n] = 1
        else:
            fp[n] = 1
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    rec = ctp / max(ngt, 1)
    prec = ctp / np.maximum(ctp + cfp, 1e-12)
    return voc_ap(rec, prec), prec, rec


def detections_to_keypoints(detections, part: int) -> List[np.ndarray]:
    """Helper: per-image lists of part-p box centers from Detection
    lists (the keypoint convention used by testmodel.m: box centers)."""
    out = []
    for dets in detections:
        pts = []
        for d in dets:
            b = d.parts[part]
            pts.append([(b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0])
        out.append(np.asarray(pts))
    return out
