"""Training orchestration: the reference's trainmodel pipeline
(reference: matlab/learning/trainmodel.m):

  1. annotation geometry + part-mixture clustering
     (point2box / data_def / clusterparts);
  2. per-part per-mixture SVMs on warped positives (train with warp=1);
  3. tree assembly (buildmodel);
  4. joint latent SSVM rounds (train with warp=0): latent positive
     extraction under GT-overlap masks, QP optimization, hard-negative
     mining at interval=2 (train.m:95-105), final threshold at the 5th
     percentile of positive scores (train.m:117).

Every stage checkpoints to ``cache_dir`` (trainmodel.m's try/load/catch
pattern, SURVEY.md §5).  Detection-side work (pyramids, HOG, masked
latent search, mining) runs on the device through the port's Detector,
so on a CUDA card every detect ends in the walk kernel; the QP cache is
host-side numpy, like the reference's.  The entry points take
``device`` (CUDA when None, an error without a card; "cpu" on request).

Fidelity notes vs the reference:
  * left/right flip augmentation: pass ``mirror_map`` (the part
    permutation under mirroring) to train_parts_model — every positive
    is doubled with its mirrored virtual example (train.m:130,165
    "we create virtual examples by flipping each image left to right";
    the flip itself happens in the reference's data prep, globals.m:22
    imflip cache);
  * stage-1 negatives are MINED with the part's own single-filter model
    at interval 2 (train.m:100-107 applies to warp=1 training too); a
    few random crops seed the cache first (a conditioning choice, not a
    gap — the reference starts from positives only);
  * mining PRUNES the example cache and continues when full
    (detect.m:319-321 optimize -> qp_opt + qp_prune; train.m:105-107
    stops only once the cache is full of support vectors);
  * k-means restarts use a shared RNG stream (deterministic).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.models.npzio import load_npz, save_npz
from partsbaseddetector_tpu_torch.ops.common import resolve_device
from partsbaseddetector_tpu_torch.oracle import reference as oracle
from partsbaseddetector_tpu_torch.train import build as build_mod
from partsbaseddetector_tpu_torch.train import cluster as cluster_mod
from partsbaseddetector_tpu_torch.train import features as feat_mod
from partsbaseddetector_tpu_torch.train.qp import QPCache
from partsbaseddetector_tpu_torch.train.vectorize import (BlockLayout,
                                                          model_to_vec,
                                                          vec_to_model)


@dataclasses.dataclass
class TrainConfig:
    nmix: int = 2                 # mixtures per part (K)
    binsize: int = 4
    interval: int = 5
    norient: int = 18
    flen: int = 32
    C: float = 0.002              # slack scale (train.m:21)
    wpos: float = 2.0             # positive error weight (train.m:25)
    latent_iters: int = 2         # joint SSVM rounds (trainmodel.m
                                  # final1 + final)
    overlap: float = 0.6          # latent search overlap (train.m:41)
    nmax: int = 1500              # QP cache capacity
    neg_per_image: int = 10       # stage-1 random negative crops
    mining_thresh: float = -1.0   # hard-negative threshold (train.m:102)
    thresh_pct: float = 0.05      # model.thresh percentile (train.m:117)
    k_per_level: int = 8
    seed: int = 0
    #: optional directory for the cluster-assignment debug montages
    #: (utils/viz.show_part_clusters — the showpartclusters.m view
    #: used while choosing nmix); None = no dump
    cluster_debug_dir: Optional[str] = None


def _stage_cache(cache_dir: Optional[str], name: str):
    if cache_dir is None:
        return None
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, name + ".npz")


def _train_filter_svm(pos_feats: List[np.ndarray],
                      neg_feats: List[np.ndarray],
                      C: float, wpos: float, seed: int,
                      neg_images: Sequence[np.ndarray] = (),
                      cfg: Optional["TrainConfig"] = None,
                      det_holder: Optional[dict] = None,
                      device=None) -> np.ndarray:
    """Binary linear SVM (bias + one filter block) via the dual CD QP —
    stage 1's train(warp=1) on one part mixture, with hard-negative
    MINING on the negative images using the part's own single-filter
    model (reference: train.m:95-107 — the warp=1 call runs the same
    detect-based mining loop), prune-and-continue when the cache fills
    (detect.m:319-321).

    det_holder: shared dict carrying the mining Detector across
    (part, mixture) calls — filters share a shape, so one detector
    serves them all via update_model."""
    fshape = pos_feats[0].shape
    length = 1 + int(np.prod(fshape))
    nmax = (cfg.nmax if cfg is not None
            else 4 * (len(pos_feats) + len(neg_feats) + 1))
    nmax = max(nmax, len(pos_feats) + len(neg_feats) + 8)
    qp = QPCache(length, nmax=nmax,
                 wreg=np.ones(length), w0=np.zeros(length),
                 noneg=np.zeros(0, np.int64),
                 c_pos=C * wpos, c_neg=C, seed=seed)
    for i, f in enumerate(pos_feats):
        qp.write(np.concatenate([[1.0], f.ravel()]), (1, i, 0, 0, 0), 1)
    for i, f in enumerate(neg_feats):
        qp.write(np.concatenate([[1.0], f.ravel()]),
                 (-1, i, 0, 0, 0), -1)
    qp.svfix = len(pos_feats)
    qp.optimize(tol=0.05, max_iter=300)

    if cfg is not None and len(neg_images):
        # -- mining round: detect with the current filter on the
        # negative set, harvest every above-threshold window
        w = qp.final_w()
        model1 = _single_filter_model(
            w[1:].reshape(fshape), w[0], cfg.binsize, cfg.norient,
            cfg.flen, cfg.mining_thresh)
        if det_holder is not None and "det" in det_holder:
            det = det_holder["det"]
            det.update_model(model1)
        else:
            det = Detector(model1, k_per_level=cfg.k_per_level,
                           compose="correct", device=device)
            if det_holder is not None:
                det_holder["det"] = det
        saturated = False
        for i, im in enumerate(neg_images):
            dets = det.candidates_to_detections(det.detect_raw(im))
            feats = None
            for d in dets:
                if qp.n >= qp.nmax:
                    qp.optimize(tol=0.05, max_iter=300)
                    qp.prune()           # prune-and-continue
                    if qp.n >= qp.nmax:  # cache full of support vectors
                        saturated = True
                        break
                if feats is None:
                    feats = det.pyramid_features(im)
                x, y, _m = (int(v) for v in d.locations[0])
                patch = feat_mod._gather_patch(
                    feats[d.level], y, x, fshape[0], fshape[1])
                qp.write(np.concatenate([[1.0], patch.ravel()]),
                         (-1, i, d.level, y, x), -1)
            if saturated:
                break
        qp.optimize(tol=0.05, max_iter=300)

    w = qp.final_w()
    return w[1:].reshape(fshape)


def _random_negative_feats(neg_images: Sequence[np.ndarray],
                           tsize, binsize, norient, flen, count, rng
                           ) -> List[np.ndarray]:
    out = []
    ph = (tsize[0] + 2) * binsize
    pw = (tsize[1] + 2) * binsize
    while len(out) < count and neg_images:
        im = neg_images[rng.integers(len(neg_images))]
        h, w = im.shape[:2]
        if h <= ph or w <= pw:
            continue
        y = rng.integers(0, h - ph)
        x = rng.integers(0, w - pw)
        out.append(oracle.hog_features(im[y:y + ph, x:x + pw],
                                       binsize, norient, flen))
    return out


def flip_positives(images: Sequence[np.ndarray], points: np.ndarray,
                   mirror_map: Sequence[int]
                   ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Left/right flip augmentation: every positive gains a mirrored
    virtual example (reference: train.m:130,165; the flipping lives in
    the data-prep layer there, globals.m:22).  mirror_map[p] = the part
    index p maps to under mirroring (e.g. left wrist <-> right wrist;
    identity for symmetric parts)."""
    mirror_map = [int(m) for m in mirror_map]
    P = points.shape[1]
    assert sorted(mirror_map) == list(range(P)), mirror_map
    out_imgs = list(images)
    out_pts = [points]
    flipped = []
    for im, pts in zip(images, points):
        w = im.shape[1]
        out_imgs.append(np.ascontiguousarray(im[:, ::-1]))
        fp = pts[mirror_map].copy()
        fp[:, 0] = (w - 1) - fp[:, 0]
        flipped.append(fp)
    out_pts.append(np.stack(flipped))
    return out_imgs, np.concatenate(out_pts, axis=0)


def _single_filter_model(filt: np.ndarray, bias: float, binsize: int,
                         norient: int, flen: int,
                         thresh: float) -> PartsModel:
    """One-part one-mixture model wrapping a stage-1 filter, so
    hard-negative mining for the part SVM runs through the SAME
    device detector as stage-3 mining (the reference mines stage-1
    negatives with detect() on the part model, train.m:100-107)."""
    from partsbaseddetector_tpu_torch.models.schema import (ComponentSpec,
                                                            PartSpec)

    part = PartSpec(parentid=-1, filterid=[0], biasid=[0], defid=[0])
    m = PartsModel(
        name="stage1_mining", interval=2, thresh=thresh,
        binsize=binsize, norient=norient, flen=flen,
        filters=[np.asarray(filt, np.float64)],
        defw=[np.zeros(4)], anchors=[np.zeros(2, np.int64)],
        biasw=np.asarray([float(bias)]),
        components=[ComponentSpec(parts=[part])])
    m.validate()
    return m


def train_parts_model(name: str,
                      pos_images: Sequence[np.ndarray],
                      pos_points: np.ndarray,
                      neg_images: Sequence[np.ndarray],
                      parents: Sequence[int],
                      cfg: TrainConfig = TrainConfig(),
                      cache_dir: Optional[str] = None,
                      verbose: bool = True,
                      mirror_map: Optional[Sequence[int]] = None,
                      device=None) -> PartsModel:
    """Full training pipeline.  pos_points: (N, P, 2) keypoints.

    mirror_map: optional part permutation under left/right mirroring
    (e.g. left elbow <-> right elbow; identity for symmetric parts).
    When given, every positive is doubled with its flipped virtual
    example (reference: train.m:130,165).  device: where the detectors
    run (None: CUDA, an error without a card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    P = pos_points.shape[1]
    parents = [int(x) for x in parents]

    def log(msg):
        if verbose:
            print(f"[train {name}] {msg}", flush=True)

    if mirror_map is not None:
        pos_images, pos_points = flip_positives(pos_images, pos_points,
                                                mirror_map)
        log(f"flip augmentation: {len(pos_images)} positives "
            "(originals + mirrored)")

    # ---- stage 0: geometry + clustering (trainmodel.m:9-16)
    boxes = cluster_mod.point_to_box(pos_points, parents)
    tsize = build_mod.template_size(boxes, cfg.binsize)
    deffeat = cluster_mod.data_def(pos_points, boxes, tsize)
    idx = cluster_mod.cluster_parts(deffeat, cfg.nmix, parents,
                                    restarts=20, seed=cfg.seed)
    log(f"template {tsize} cells, {cfg.nmix} mixtures/part")
    if cfg.cluster_debug_dir is not None:
        # per-(part, mixture) patch montages for eyeballing K
        # (matlab/visualization/showpartclusters.m)
        from partsbaseddetector_tpu_torch.utils.viz import \
            show_part_clusters
        show_part_clusters(pos_images, boxes, idx,
                           out_dir=cfg.cluster_debug_dir)
        log(f"cluster montages -> {cfg.cluster_debug_dir}/cluster/")

    # ---- stage 1: per-part per-mixture filters (trainmodel.m:18-38)
    path = _stage_cache(cache_dir, f"{name}_parts")
    if path and os.path.exists(path):
        data = np.load(path, allow_pickle=True)
        filters_per_part = data["filters"].tolist()
        log("stage 1 loaded from cache")
    else:
        neg_feats = _random_negative_feats(
            neg_images, tsize, cfg.binsize, cfg.norient, cfg.flen,
            cfg.neg_per_image * max(len(neg_images), 1), rng)
        filters_per_part = []
        det_holder: dict = {}     # one mining detector for all parts
        for p in range(P):
            mix_filters = []
            for k in range(cfg.nmix):
                members = np.nonzero(idx[p] == k)[0]
                feats = [feat_mod.warped_positive_feature(
                    pos_images[n], boxes[n, p], tsize, cfg.binsize,
                    cfg.norient, cfg.flen) for n in members]
                if not feats:   # empty cluster: neutral filter
                    mix_filters.append(
                        np.zeros(tsize + (cfg.flen,)))
                    continue
                filt = _train_filter_svm(feats, neg_feats, cfg.C,
                                         cfg.wpos, cfg.seed,
                                         neg_images=neg_images,
                                         cfg=cfg,
                                         det_holder=det_holder,
                                         device=device)
                mix_filters.append(filt)
            filters_per_part.append(mix_filters)
            log(f"stage 1: part {p + 1}/{P} trained (mined negatives)")
        if path:
            np.savez(path, filters=np.asarray(
                filters_per_part, dtype=object))

    # ---- stage 2: tree assembly (trainmodel.m:44)
    model = build_mod.build_model(
        name, filters_per_part, idx, deffeat, parents,
        cfg.binsize, cfg.interval, cfg.norient, cfg.flen)

    # ---- stage 3: joint latent SSVM rounds (trainmodel.m:41-64)
    path = _stage_cache(cache_dir, f"{name}_final")
    if path and os.path.exists(path):
        log("final model loaded from cache")
        return load_npz(path)
    model = latent_train(model, pos_images, boxes, neg_images, cfg,
                         log, device)
    if path:
        save_npz(path, model)
    return model


def train_multi_component(name: str,
                          groups: Sequence[dict],
                          cfg: TrainConfig = TrainConfig(),
                          cache_dir: Optional[str] = None,
                          verbose: bool = True,
                          device=None) -> PartsModel:
    """Train one component per annotation group and merge them into a
    single multi-component mixture model — the reference's multi-model
    flow: trainmodel per pose/view cluster, then mergemodels
    (matlab/learning/mergemodels.m:1-46; the VOC lineage's standard
    recipe).  The merged model's DP searches every component at every
    scale (src/DynamicProgram.cpp:80-87).

    groups: one dict per component with keys ``pos_images``,
    ``pos_points``, ``neg_images``, ``parents`` and optionally
    ``mirror_map`` — the train_parts_model signature, per component.
    Components may have different part counts/trees but must share the
    feature hyperparameters (enforced by merge_models).
    """
    device = resolve_device(device)
    models = []
    for i, g in enumerate(groups):
        models.append(train_parts_model(
            f"{name}_c{i}", g["pos_images"], g["pos_points"],
            g["neg_images"], g["parents"], cfg, cache_dir=cache_dir,
            verbose=verbose, mirror_map=g.get("mirror_map"),
            device=device))
    return build_mod.merge_models(models, name=name)


def _latent_detector(model: PartsModel, k_per_level: int, device=None):
    """Detector for latent search: multi-resolution models route to
    MultiResDetector (whose walk already uses the Matlab composition
    training needs — shiftdt.cc:97-111; plain torch on every device);
    single-resolution models use Detector(compose="correct") (rationale
    in latent_train), whose walk is the CUDA kernel on a card."""
    if model.max_scale() > 0:
        from partsbaseddetector_tpu_torch.infer.multires import \
            MultiResDetector
        return MultiResDetector(model, k_per_level=k_per_level,
                                device=device)
    return Detector(model, k_per_level=k_per_level, compose="correct",
                    device=device)


def latent_train(model: PartsModel,
                 pos_images: Sequence[np.ndarray],
                 gt_boxes: np.ndarray,
                 neg_images: Sequence[np.ndarray],
                 cfg: TrainConfig, log, device=None) -> PartsModel:
    """Joint latent-SSVM rounds (reference: train.m:72-121 with
    warp=0).  device: where the detectors run (None: CUDA)."""
    device = resolve_device(device)
    layout = BlockLayout.for_model(model)
    _w, wreg, w0, noneg = model_to_vec(model, layout)

    model.thresh = -1e9
    # compose="correct" (the Matlab trainer's shiftdt semantics, not the
    # C++ inference quirk): under the latent-search masks, the
    # "reference" composition reads the child's x-argmax row at the
    # PARENT's y (include/DistanceTransform.hpp:233-244) — a row the
    # mask makes all-NEG, collapsing child x to 0 and poisoning the
    # written deformation features.  The quirk mode exists for C++
    # inference parity; the C++ engine has no masked search, so
    # training correctly follows matlab/detection/detect.m instead.
    # It also keeps w . detection_feature == score exact for the QP.
    det = _latent_detector(model, cfg.k_per_level, device)
    for t in range(cfg.latent_iters):
        qp = QPCache(layout.length, cfg.nmax, wreg, w0, noneg,
                     c_pos=cfg.C * cfg.wpos, c_neg=cfg.C,
                     seed=cfg.seed + t)
        # -- latent positives under GT-overlap masks
        npos = 0
        for i, im in enumerate(pos_images):
            plan = det.plan_for(im.shape[:2])
            masks_by_level = feat_mod.part_overlap_masks(
                model, 0, plan, gt_boxes[i], cfg.overlap)
            # group per bucket
            part_masks, li = [], 0
            for bucket in plan.buckets:
                part_masks.append(np.stack(
                    masks_by_level[li:li + len(bucket.levels)]))
                li += len(bucket.levels)
            cands = det.detect_masked_raw(im, part_masks)
            dets = det.candidates_to_detections(cands, 1)
            if not dets or dets[0].score <= -1e29:
                continue
            feats = det.pyramid_features(im)
            vec = feat_mod.detection_feature(model, layout, dets[0],
                                             feats)
            qp.write(vec, (1, i, 0, 0, 0), 1)
            npos += 1
        log(f"iter {t + 1}: {npos} latent positives")
        if npos == 0:
            log("no latent positives found; stopping early")
            break
        qp.svfix = qp.n
        qp.optimize()
        model = vec_to_model(qp.final_w(), model, layout)
        model.thresh = -1e9
        det.update_model(model)

        # -- hard-negative mining at interval=2 (train.m:95-105)
        mining_model = dataclasses.replace(model)
        mining_model.interval = 2
        mining_model.thresh = cfg.mining_thresh
        mdet = _latent_detector(mining_model, cfg.k_per_level, device)
        saturated = False
        pruned = 0
        for i, im in enumerate(neg_images):
            cands = mdet.detect_raw(im)
            dets = mdet.candidates_to_detections(cands)
            if not dets:
                continue
            feats = mdet.pyramid_features(im)
            for d in dets:
                if qp.n >= qp.nmax:
                    # prune-and-continue (detect.m:319-321: when the
                    # cache fills, qp_opt + qp_prune drop non-support
                    # examples and mining resumes; train.m:105-107
                    # stops only when the cache is ALL support vectors)
                    qp.optimize()
                    qp.prune()
                    pruned += 1
                    if qp.n >= qp.nmax:
                        saturated = True
                        break
                    # mid-mining model refresh, like the reference's
                    # optimize() -> vec2model inside detect
                    mining_model = vec_to_model(
                        qp.final_w(), mining_model, layout)
                    mining_model.thresh = cfg.mining_thresh
                    mdet.update_model(mining_model)
                vec = feat_mod.detection_feature(mining_model, layout,
                                                 d, feats)
                qp.write(vec, (-1, i, d.level, d.locations[0, 1],
                               d.locations[0, 0]), -1)
            if saturated:
                log(f"iter {t + 1}: cache saturated with support "
                    f"vectors after image {i + 1}/{len(neg_images)}")
                break
        log(f"iter {t + 1}: cache {qp.n}/{cfg.nmax} after mining "
            f"({pruned} prune-and-continue passes)")
        qp.optimize()
        model = vec_to_model(qp.final_w(), model, layout)

        # -- detection threshold: percentile of positive scores
        scores = qp.score_positives()
        if len(scores):
            model.thresh = float(np.sort(scores)[
                int(np.ceil(len(scores) * cfg.thresh_pct)) - 1])
        log(f"iter {t + 1}: LB={qp.lb:.4f} UB={qp.ub:.4f} "
            f"thresh={model.thresh:.3f}")
        # the latent search of the next round must see every candidate:
        # keep the working detector at -inf threshold (the real
        # threshold lives on the returned model)
        search_model = dataclasses.replace(model)
        search_model.thresh = -1e9
        det.update_model(search_model)
    return model
