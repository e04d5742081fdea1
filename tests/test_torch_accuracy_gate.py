"""The accuracy gates of tests/test_accuracy_gate.py on the port, on the
CPU: train end to end with the port's trainer (device="cpu"), then
held-out PCK@0.5 (and APK) through the port's Detector and part_nms.
Slow: not in tier 1."""

import numpy as np
import pytest

from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.ops.nms import part_nms
from partsbaseddetector_tpu_torch.tools.datasets import (PERSON26_MIRROR,
                                                         PERSON26_PARENTS,
                                                         synthetic_figures,
                                                         synthetic_skeletons)
from partsbaseddetector_tpu_torch.train.trainer import (TrainConfig,
                                                        train_parts_model)
from partsbaseddetector_tpu_torch.utils.eval import (KeypointDetection,
                                                     KeypointGT, apk, pck)

GATE = 0.9


def _heldout(model, held):
    """Mean PCK@0.5 and mean APK on held-out positives, as the JAX gates
    measure them (the top four detections of each image for APK)."""
    model.thresh = -1e9
    det = Detector(model, k_per_level=8, device="cpu")
    P = model.components[0].nparts
    pred, gts, scales, all_dets = [], [], [], []
    for s in held:
        dets = det.candidates_to_detections(
            part_nms(det.detect_raw(s.image), 0.3))
        assert dets, "no detection on a held-out positive"
        all_dets.append(dets)
        d = dets[0]
        pred.append(np.stack([(d.parts[:, 0] + d.parts[:, 2]) / 2,
                              (d.parts[:, 1] + d.parts[:, 3]) / 2], 1))
        gts.append(s.points)
        scales.append(s.scale)
    pck_pp = pck(pred, gts, scales, thresh=0.5)
    apks = []
    for p in range(P):
        dps, gps = [], []
        for i, s in enumerate(held):
            gps.append(KeypointGT(points=s.points[p:p + 1], scale=s.scale))
            for d in all_dets[i][:4]:
                c = np.array([(d.parts[p, 0] + d.parts[p, 2]) / 2,
                              (d.parts[p, 1] + d.parts[p, 3]) / 2])
                dps.append(KeypointDetection(i, d.score, c))
        apks.append(apk(dps, gps, thresh=0.5)[0])
    return float(pck_pp.mean()), float(np.mean(apks)), pck_pp, apks


@pytest.mark.slow
def test_trained_model_heldout_pck(tmp_path):
    pos, neg = synthetic_figures(n=16, imsize=(64, 64), nparts=3, seed=7)
    train_pos, held = pos[:12], pos[12:]
    cfg = TrainConfig(nmix=1, binsize=4, interval=3, latent_iters=2,
                      nmax=800, k_per_level=8, neg_per_image=10, C=0.05)
    model = train_parts_model(
        "pckgate", [s.image for s in train_pos],
        np.stack([s.points for s in train_pos]), neg[:4], [-1, 0, 1], cfg,
        cache_dir=str(tmp_path), verbose=False, device="cpu")
    mean_pck, mean_apk, pck_pp, _ = _heldout(model, held)
    print(f"\n[port accuracy gate] PCK={mean_pck:.3f} APK={mean_apk:.3f}")
    assert mean_pck >= GATE, f"PCK regression: {pck_pp.tolist()}"


@pytest.mark.slow
def test_trained_person26_scale_pck_apk(tmp_path):
    pos, neg = synthetic_skeletons(n=14, seed=7)
    train_pos, held = pos[:10], pos[10:]
    cfg = TrainConfig(nmix=4, binsize=4, interval=3, latent_iters=2,
                      nmax=1200, k_per_level=8, neg_per_image=8, C=0.05,
                      overlap=0.35)
    model = train_parts_model(
        "person26gate", [s.image for s in train_pos],
        np.stack([s.points for s in train_pos]), neg[:3], PERSON26_PARENTS,
        cfg, cache_dir=str(tmp_path), verbose=False,
        mirror_map=PERSON26_MIRROR, device="cpu")
    assert model.components[0].nparts == 26
    assert model.nfilters == 26 * cfg.nmix
    mean_pck, mean_apk, pck_pp, apks = _heldout(model, held)
    print(f"\n[port person26 gate] PCK={mean_pck:.3f} APK={mean_apk:.3f}")
    assert mean_pck >= GATE, f"PCK regression: {pck_pp.tolist()}"
    assert mean_apk >= GATE, f"APK regression: {apks}"
