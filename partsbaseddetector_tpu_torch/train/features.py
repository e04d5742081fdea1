"""Training feature extraction.

Two feature paths, mirroring the reference trainer:

  * warped positives (reference: matlab/learning/train.m poswarp +
    warppos.m): crop the annotated box, resize to the template's pixel
    size, HOG -> one dense filter block;

  * latent/detection features (reference: matlab/detection/detect.m
    backtrack + qp_write blocks): for a detection produced by the
    detector, reconstruct the sparse feature vector (root bias 1,
    pairwise-bias indicators, deformation features, per-part HOG
    patches) such that w . x reproduces the root score exactly — the
    invariant the reference asserts at matlab/detection/detect.m:137-142.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.oracle import reference as oracle
from partsbaseddetector_tpu_torch.train.vectorize import BlockLayout


def warped_positive_feature(image: np.ndarray, box: Sequence[float],
                            tsize: Tuple[int, int], binsize: int,
                            norient: int, flen: int) -> np.ndarray:
    """Crop `box` (x1, y1, x2, y2), resize to (tsize + 2 cells) of
    pixels, HOG -> (tsize_h, tsize_w, flen)."""
    x1, y1, x2, y2 = (float(v) for v in box)
    h, w = image.shape[:2]
    pad = binsize  # one cell of context, like warppos' padding
    xs = np.clip([x1 - pad, x2 + pad], 0, w - 1).astype(int)
    ys = np.clip([y1 - pad, y2 + pad], 0, h - 1).astype(int)
    crop = image[ys[0]:ys[1] + 1, xs[0]:xs[1] + 1]
    target = ((tsize[0] + 2) * binsize, (tsize[1] + 2) * binsize)
    resized = oracle.resize_linear(crop, target)
    feat = oracle.hog_features(resized, binsize, norient, flen)
    assert feat.shape[:2] == tsize, (feat.shape, tsize)
    return feat


def _gather_patch(feat: np.ndarray, y: int, x: int,
                  kh: int, kw: int) -> np.ndarray:
    """Feature patch seen by the centered filter at grid (y, x),
    replicating the conv border semantics: outside the map, channels are
    zero except the truncation channel (= 1)
    (reference: src/SpatialConvolutionEngine.cpp:146-157)."""
    H, W, C = feat.shape
    ay, ax = kh // 2, kw // 2
    patch = np.zeros((kh, kw, C))
    patch[..., C - 1] = 1.0
    for i in range(kh):
        sy = y + i - ay
        if not (0 <= sy < H):
            continue
        for j in range(kw):
            sx = x + j - ax
            if 0 <= sx < W:
                patch[i, j] = feat[sy, sx]
    return patch


def detection_feature(model: PartsModel, layout: BlockLayout,
                      detection, feats: Sequence[np.ndarray]
                      ) -> np.ndarray:
    """Dense feature vector of a detection against the feature pyramid
    (w . x == detection.score; see module docstring).

    feats: per-level HOG maps (level index = detection.level for the
    root; a part at scale s reads level detection.level - s*interval —
    multi-resolution models write their features at each part's own
    level, with the strided deformation dx = px*2^ds + ax - x exactly
    like defvector (matlab/detection/detect.m:330-338 with
    part.step = 2^ds)."""
    comp = model.components[detection.component]
    scales = model.part_scales(detection.component)
    vec = np.zeros(layout.length)
    # root bias (reference: src/DynamicProgram.cpp:163-170)
    vec[layout.bias_off[comp.parts[0].biasid[0]]] += 1.0
    for p, part in enumerate(comp.parts):
        x, y, m = (int(v) for v in detection.locations[p])
        feat = feats[detection.level - scales[p] * model.interval]
        fid = part.filterid[m]
        kh, kw, _ = model.filters[fid].shape
        patch = _gather_patch(feat, y, x, kh, kw)
        off = layout.filter_off[fid]
        vec[off:off + patch.size] += patch.ravel()
        if p > 0:
            px, py, pm = (int(v)
                          for v in detection.locations[part.parentid])
            step = 2 ** (scales[p] - scales[part.parentid])
            ax, ay = model.anchors[part.defid[m]][:2]
            dx = (px * step + ax) - x
            dy = (py * step + ay) - y
            doff = layout.def_off[part.defid[m]]
            vec[doff:doff + 4] += [-dx * dx, -dx, -dy * dy, -dy]
            vec[layout.bias_off[part.biasid[m] + pm]] += 1.0
    return vec


def part_overlap_masks(model: PartsModel, component: int,
                       plan, gt_boxes: np.ndarray,
                       overlap: float) -> List[np.ndarray]:
    """Per pyramid level, a (P, fh, fw) bool mask of part placements
    whose box overlaps the ground-truth part box by at least `overlap`
    (intersection / union), the latent-positive search constraint
    (reference: matlab/detection/detect.m:60-101).

    gt_boxes: (P, 4) inclusive pixel boxes.  plan: PyramidPlan."""
    comp = model.components[component]
    P = comp.nparts
    masks: List[np.ndarray] = []
    for bucket in plan.buckets:
        fh, fw = bucket.feat_pad
        for lvl in bucket.levels:
            m = np.zeros((P, fh, fw), bool)
            s = lvl.scale
            oh, ow = lvl.featsize
            ys = np.arange(oh)
            xs = np.arange(ow)
            bx1 = np.rint((xs - 1) * s)
            by1 = np.rint((ys - 1) * s)
            for p, part in enumerate(comp.parts):
                fs = model.filters[part.filterid[0]].shape[0]
                ext = np.rint(fs * s)
                x2 = bx1 + ext - 1
                y2 = by1 + ext - 1
                gx1, gy1, gx2, gy2 = gt_boxes[p]
                iw = np.minimum(x2[None, :], gx2) - \
                    np.maximum(bx1[None, :], gx1) + 1
                ih = np.minimum(y2[:, None], gy2) - \
                    np.maximum(by1[:, None], gy1) + 1
                inter = np.maximum(iw, 0) * np.maximum(ih, 0)
                area = ext * ext
                garea = (gx2 - gx1 + 1) * (gy2 - gy1 + 1)
                union = area + garea - inter
                m[p, :oh, :ow] = (inter / np.maximum(union, 1)) >= overlap
            masks.append(m)
    return masks
