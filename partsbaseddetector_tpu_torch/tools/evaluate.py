"""Evaluation harness CLI — the reference's testmodel.m flow
(reference: matlab/detection/testmodel.m:1-22): run the detector over an
annotated image set, apply per-part NMS, and report PCK (and optionally
APK per part):

    python -m partsbaseddetector_tpu_torch.tools.evaluate MODEL DATASET
        [--thresh T] [--nms 0.3] [--pck-thresh 0.5] [--apk] [--limit N]
        [--device cuda|cpu]

DATASET is a .npz produced by tools/datasets.py (images + keypoints +
scales), or a directory in the same layout.  Detection runs on the CUDA
card unless --device cpu."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PCK/APK evaluation")
    ap.add_argument("model")
    ap.add_argument("dataset")
    ap.add_argument("--thresh", type=float, default=None,
                    help="override the model's detection threshold")
    ap.add_argument("--nms", type=float, default=0.3,
                    help="per-part NMS overlap (testmodel.m uses 0.3)")
    ap.add_argument("--pck-thresh", type=float, default=0.5)
    ap.add_argument("--apk", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--k-per-level", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) | cpu")
    args = ap.parse_args(argv)

    from partsbaseddetector_tpu_torch.models import load_any
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.ops.nms import part_nms
    from partsbaseddetector_tpu_torch.tools.datasets import load_dataset
    from partsbaseddetector_tpu_torch.utils.eval import (
        KeypointDetection, KeypointGT, apk, pck)

    model = load_any(args.model)
    if args.thresh is not None:
        model.thresh = args.thresh
    ds = load_dataset(args.dataset)
    if args.limit:
        ds = ds[:args.limit]

    det = Detector(model, k_per_level=args.k_per_level,
                   device=args.device)
    P = model.components[0].nparts

    pred_pts, gt_pts, gt_scales = [], [], []
    all_dets = []
    for i, sample in enumerate(ds):
        cands = det.detect_raw(sample.image)
        cands = part_nms(cands, args.nms)
        dets = det.candidates_to_detections(cands)
        all_dets.append(dets)
        if dets:
            d = dets[0]
            centers = np.stack([(d.parts[:, 0] + d.parts[:, 2]) / 2,
                                (d.parts[:, 1] + d.parts[:, 3]) / 2],
                               axis=1)
        else:
            centers = np.full((P, 2), 1e6)
        pred_pts.append(centers)
        gt_pts.append(sample.points)
        gt_scales.append(sample.scale)
        print(f"\r{i + 1}/{len(ds)}", end="", file=sys.stderr,
              flush=True)
    print(file=sys.stderr)

    pck_per_part = pck(pred_pts, gt_pts, gt_scales, args.pck_thresh)
    result = {
        "pck_mean": float(pck_per_part.mean()),
        "pck_per_part": [round(float(v), 4) for v in pck_per_part],
        "nimages": len(ds),
    }

    if args.apk:
        apks = []
        for p in range(P):
            dets_p = []
            gts_p = []
            for i, sample in enumerate(ds):
                gts_p.append(KeypointGT(
                    points=sample.points[p:p + 1], scale=sample.scale))
                for d in all_dets[i]:
                    c = np.array([(d.parts[p, 0] + d.parts[p, 2]) / 2,
                                  (d.parts[p, 1] + d.parts[p, 3]) / 2])
                    dets_p.append(KeypointDetection(i, d.score, c))
            ap_val, _, _ = apk(dets_p, gts_p, args.pck_thresh)
            apks.append(ap_val)
        result["apk_mean"] = float(np.mean(apks))
        result["apk_per_part"] = [round(float(v), 4) for v in apks]

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
