"""Detector facade: the PyTorch counterpart of partsbaseddetector_tpu's
Detector (single-resolution models; multi-resolution ones go to
infer/multires.py).

Mirrors the reference's 4-stage pipeline (reference:
src/PartsBasedDetector.cpp:69-95), run eagerly on one device with the
frames of a batch folded into the level axis:

  stage 1  resize ladder + HOG per octave bucket (levels of a bucket
           share one padded buffer and run as one batch)
  stage 2  one filter-bank conv per bucket (cuDNN, TF32 off; or the FFT
           engine, conv_engine="fft"), then optional depth pruning
  stage 3  the part-tree DP per (level group, component), levels as a
           batch axis, with optional part placement masks
  stage 4  top-K root seeds per level, the fused walk kernel
           (ops/walk.py), then one stable sort
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import (Callable, ContextManager, Dict, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from partsbaseddetector_tpu_torch.infer.pyramid_plan import (PyramidPlan,
                                                             make_plan)
from partsbaseddetector_tpu_torch.models.part_tree import (PackedModel,
                                                           pack_model)
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops import argmax as argmax_ops
from partsbaseddetector_tpu_torch.ops.common import NEG, resolve_device
# CONV_ENGINES is re-exported: the engines by name, as the JAX package's
# infer/detector exports them
from partsbaseddetector_tpu_torch.ops.conv import CONV_ENGINES  # noqa: F401
from partsbaseddetector_tpu_torch.ops.dp import dp_min_levels
from partsbaseddetector_tpu_torch.ops.hog import hog_features
from partsbaseddetector_tpu_torch.ops.imageops import pyr_down, resize_linear

#: a stage timer: stage(name) is a context manager around that stage's
#: work (chip_smoke.py records CUDA events with it)
StageTimer = Callable[[str], ContextManager]


def _no_stage(name: str) -> ContextManager:
    return contextlib.nullcontext()


@dataclasses.dataclass
class Detection:
    """Host-side detection result (the reference's Candidate,
    include/Candidate.hpp:56-101)."""

    score: float
    component: int
    level: int
    parts: np.ndarray      # (P, 4) float boxes x1, y1, x2, y2
    locations: np.ndarray  # (P, 3) int x, y, mixture (feature-grid coords)

    def bounding_box(self) -> np.ndarray:
        """Hull over part boxes (reference: include/Candidate.hpp:105-111).
        """
        return np.array([self.parts[:, 0].min(), self.parts[:, 1].min(),
                         self.parts[:, 2].max(), self.parts[:, 3].max()])

    def bounding_box_norm(self) -> np.ndarray:
        """mean +- 1.5 sigma box over part centroids
        (reference: include/Candidate.hpp:117-130)."""
        cx = (self.parts[:, 0] + self.parts[:, 2]) / 2.0
        cy = (self.parts[:, 1] + self.parts[:, 3]) / 2.0
        return np.array([cx.mean() - 1.5 * cx.std(),
                         cy.mean() - 1.5 * cy.std(),
                         cx.mean() + 1.5 * cx.std(),
                         cy.mean() + 1.5 * cy.std()])

    def resized(self, factor: float) -> "Detection":
        """Scale all part boxes (reference: include/Candidate.hpp:82-89).
        """
        return dataclasses.replace(self, parts=self.parts * factor)


@dataclasses.dataclass(frozen=True)
class DepthPrune:
    """Depth-based response pruning: the completed form of the
    reference's abandoned filterResponseByDepth
    (src/SearchSpacePruning.cpp:47-70; its call site is commented out
    at src/PartsBasedDetector.cpp:86).  A part of physical width
    ``part_width_m`` detected at pyramid scale s (pixels per cell) is
    plausible only at depths within ``tol`` (relative) of
    fx * part_width_m / s; response cells at implausible depths are
    masked to NEG before the DP.  Depth 0 means unknown: never pruned.
    """

    part_width_m: float
    fx: float
    tol: float = 0.5


def _depth_bad_mask(depth: torch.Tensor, bucket, cfg: DepthPrune
                    ) -> torch.Tensor:
    """(B, L, fh, fw) bool: True where the response cell's observed
    depth is implausible for its level's scale.  depth: (B, dh, dw)
    float32 maps in meters, sampled at cell centers with host-computed
    indices (partsbaseddetector_tpu/infer/detector.py:99-117).  The
    comparison runs in float32 against the float32 image of each level's
    plausible depth and tolerance, as the JAX package's does."""
    dh, dw = depth.shape[-2:]
    fh, fw = bucket.feat_pad
    ys, xs, zexp, lim = [], [], [], []
    for lvl in bucket.levels:
        th, tw = lvl.featsize
        ys.append(np.clip(((np.arange(fh) + 0.5) * dh
                           / max(th, 1)).astype(np.int32), 0, dh - 1))
        xs.append(np.clip(((np.arange(fw) + 0.5) * dw
                           / max(tw, 1)).astype(np.int32), 0, dw - 1))
        z = cfg.fx * cfg.part_width_m / float(lvl.scale)
        zexp.append(z)
        lim.append(cfg.tol * z)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=depth.device)
    ys, xs = dev(ys, np.int64), dev(xs, np.int64)
    sdepth = depth[:, ys[:, :, None], xs[:, None, :]]   # (B, L, fh, fw)
    zexp = dev(zexp, np.float32)[:, None, None]
    lim = dev(lim, np.float32)[:, None, None]
    return (sdepth > 0) & ((sdepth - zexp).abs() > lim)


def _dp_groups(bucket, dp_split: int):
    """Split a bucket's levels into <= dp_split groups for stages 3-4,
    each padded only to ITS largest level (level sizes decay within an
    octave, so the DT on the octave-padded buffer would waste ~2x on the
    upper levels).  Returns (lo, hi, fh, fw) per group."""
    L = len(bucket.levels)
    n = max(1, min(dp_split, L))
    size = (L + n - 1) // n
    groups = []
    for lo in range(0, L, size):
        hi = min(lo + size, L)
        fh, fw = bucket.levels[lo].featsize   # largest level in group
        groups.append((lo, hi, fh, fw))
    return groups


def _ladder_hog(images: torch.Tensor, plan: PyramidPlan, norient: int,
                flen: int, stage: StageTimer = _no_stage
                ) -> Iterator[Tuple[object, torch.Tensor, torch.Tensor]]:
    """Stage 1 per bucket: the resize ladder into the bucket's padded
    buffer, then HOG.  images: (B, H, W, C).  Yields (bucket, imsizes
    (L, 2) int32, feats (B*L, fh, fw, flen)), frames b-major."""
    dev = images.device
    B = images.shape[0]
    img = images.to(torch.float32)
    prev_buf = prev_levels = None
    for bucket in plan.buckets:
        L = len(bucket.levels)
        with stage("ladder+hog"):
            imsizes = torch.tensor([lvl.imsize for lvl in bucket.levels],
                                   dtype=torch.int32, device=dev)
            if bucket.octave == 0:
                buf = resize_linear(img[:, None], bucket.img_pad, imsizes)
            else:
                prev_sizes = torch.tensor(
                    [lvl.imsize for lvl in prev_levels[:L]],
                    dtype=torch.int32, device=dev)
                buf = pyr_down(prev_buf[:, :L], bucket.img_pad, prev_sizes)
            prev_buf, prev_levels = buf, bucket.levels      # (B, L, ...)
            feats = hog_features(
                buf.flatten(0, 1), plan.binsize, norient, flen,
                true_size=imsizes.repeat(B, 1), feat_pad=bucket.feat_pad)
        yield bucket, imsizes, feats


def pyramid_pdfs(images: torch.Tensor, packed: PackedModel,
                 plan: PyramidPlan, conv_engine: str = "spatial",
                 stage: StageTimer = _no_stage,
                 pdfs_transform: Optional[Callable] = None):
    """Stages 1-2 for every bucket (ladder + HOG + filter-bank conv).

    images: (B, H, W, C) frames on the model's device, any real dtype
    (uint8 frames are cast to float32 here, on the device).
    Returns a list of (bucket, pdfs, tsizes, scales): pdfs (B, L, fh, fw,
    F) responses; tsizes (L, 2) int32 true feature sizes; scales (L,)
    f32 pixels per cell.  Cells of pdfs beyond a level's true size hold
    garbage: the DP masks them to NEG for both engines
    (dp_min_levels(true_sizes=...)), value-identical to the JAX
    package's masking of the FFT responses
    (partsbaseddetector_tpu/infer/detector.py:191-199).  conv_engine:
    "spatial" or "fft" (ops/conv.CONV_ENGINES).  pdfs_transform:
    optional fn(pdfs) applied to each bucket's responses after the conv
    (the filter-sharded paths all-gather their bank's output channels
    with it, parallel/mesh.Mesh.gather_filters)."""
    conv = CONV_ENGINES[conv_engine]
    dev = images.device
    B = images.shape[0]
    out = []
    for bucket, _, feats in _ladder_hog(images, plan, packed.norient,
                                        packed.flen, stage):
        L = len(bucket.levels)
        with stage("conv"):
            tsizes = torch.tensor([lvl.featsize for lvl in bucket.levels],
                                  dtype=torch.int32, device=dev)
            pdfs = conv(feats, packed.bank,
                        true_size=tsizes.repeat(B, 1)).unflatten(0, (B, L))
            if pdfs_transform is not None:
                pdfs = pdfs_transform(pdfs)
        scales = torch.tensor([lvl.scale for lvl in bucket.levels],
                              dtype=torch.float32, device=dev)
        out.append((bucket, pdfs, tsizes, scales))
    return out


def pyramid_features_program(plan: PyramidPlan, norient: int, flen: int):
    """Stage 1 alone: fn(image (H, W, C) tensor) -> per-level padded HOG
    maps (fh, fw, flen) for the whole pyramid, the trainer's feature
    write-back path (partsbaseddetector_tpu/infer/detector.py:207-237),
    shared by the single- and multi-resolution facades."""
    def fn(image: torch.Tensor) -> List[torch.Tensor]:
        out: List[torch.Tensor] = []
        for _, _, feats in _ladder_hog(image[None], plan, norient, flen):
            out.extend(feats.unbind(0))
        return out
    return fn


def features_to_numpy(feats: Sequence[torch.Tensor], plan: PyramidPlan
                      ) -> List[np.ndarray]:
    """pyramid_features_program's maps cut to each level's true size,
    as host numpy arrays."""
    return [f[:lvl.featsize[0], :lvl.featsize[1]].cpu().numpy()
            for f, lvl in zip(feats, plan.levels)]


def dp_backtrack_bucket(bucket, pdfs, tsizes, scales,
                        packed: PackedModel, k_per_level: int,
                        compose: str, dp_split: int = 1,
                        walk_impl: str = "cuda", bmask=None,
                        stage: StageTimer = _no_stage
                        ) -> List[argmax_ops.Candidates]:
    """Stages 3-4 for one octave bucket of a batch of frames: per (level
    group, component) DP + backtracking, with the batch folded into the
    level axis (every level is independent).  pdfs: (B, L, fh, fw, F);
    bmask: optional (L, P, fh, fw) bool part placement masks, the same
    for every frame, or (B, L, P, fh, fw), one set per frame (the
    batched masked search, parallel/sharded.py), sliced per group as the
    JAX package does (partsbaseddetector_tpu/infer/detector.py:301).
    Returns per group a Candidates with fields (B, Lg*k, ...)."""
    B = pdfs.shape[0]
    dev = pdfs.device
    walk = argmax_ops.WALKS[walk_impl]
    out: List[argmax_ops.Candidates] = []
    for lo, hi, gfh, gfw in _dp_groups(bucket, dp_split):
        Lg = hi - lo
        gpdfs = pdfs[:, lo:hi, :gfh, :gfw].flatten(0, 1)   # (B*Lg, ...)
        gsizes = tsizes[lo:hi].repeat(B, 1)
        gscales = scales[lo:hi].repeat(B)
        if bmask is None:
            gmask = None
        elif bmask.ndim == 5:
            gmask = bmask[:, lo:hi, :, :gfh, :gfw].flatten(0, 1)
        else:
            gmask = bmask[lo:hi, :, :gfh, :gfw].repeat(B, 1, 1, 1)
        # levels run b-major; each frame's level indices restart
        levels = (torch.arange(lo, hi, dtype=torch.int32, device=dev)
                  + bucket.levels[0].index).repeat(B)
        for c, comp in enumerate(packed.components):
            with stage("dp"):
                res = dp_min_levels(gpdfs, comp, compose, gmask,
                                    true_sizes=gsizes)
            with stage("seeds+sort"):
                topv, valid, xs, ys, mv = argmax_ops._root_seeds(
                    res.rootv, res.rooti, packed.thresh, k_per_level,
                    gsizes)
            with stage("walk"):
                X, Y, Mm = walk(
                    res.scores, res.tmp, xs, ys, mv, comp.defw,
                    comp.anchor.to(torch.float32), comp.bias,
                    # on the host: the walk reads the tree without a sync
                    torch.tensor(packed.parent_static[c],
                                 dtype=torch.int32),
                    compose)
            with stage("seeds+sort"):
                cands = argmax_ops._walked_candidates(
                    X, Y, Mm, topv, valid, comp, gscales, k_per_level, c,
                    levels)
                out.append(cands.map(
                    lambda x: x.unflatten(0, (B, Lg * k_per_level))))
    return out


def _stage12(images: torch.Tensor, packed: PackedModel, plan: PyramidPlan,
             conv_engine: str = "spatial", stage: StageTimer = _no_stage,
             depth=None, depth_cfg: Optional[DepthPrune] = None,
             pdfs_transform: Optional[Callable] = None):
    """Stages 1-2 of the detection program: pyramid_pdfs, then the
    optional depth pruning (responses at implausible depths become NEG).
    Returns pyramid_pdfs' list of (bucket, pdfs, tsizes, scales)."""
    out = pyramid_pdfs(images, packed, plan, conv_engine, stage=stage,
                       pdfs_transform=pdfs_transform)
    if depth is not None and depth_cfg is not None:
        for bucket, pdfs, _, _ in out:
            bad = _depth_bad_mask(depth, bucket, depth_cfg)
            pdfs.masked_fill_(bad[..., None], NEG)
    return out


def _stage34(per_bucket, packed: PackedModel, k_per_level: int,
             compose: str, dp_split: int = 1, walk_impl: str = "cuda",
             stage: StageTimer = _no_stage, part_masks=None
             ) -> argmax_ops.Candidates:
    """Stages 3-4 of the detection program on _stage12's output: the DP
    and the walk per (bucket, dp group, component), then one stable
    sort per frame.  part_masks: optional per-bucket masks
    (dp_backtrack_bucket's bmask)."""
    all_cands: List[argmax_ops.Candidates] = []
    # padded cells are masked in the DP (dp_min_levels(true_sizes=...))
    # for both conv engines
    for bucket, pdfs, tsizes, scales in per_bucket:
        bmask = None if part_masks is None else part_masks[bucket.octave]
        all_cands.extend(dp_backtrack_bucket(
            bucket, pdfs, tsizes, scales, packed, k_per_level, compose,
            dp_split, walk_impl, bmask, stage))
    with stage("seeds+sort"):
        return argmax_ops.sort_candidates(
            argmax_ops.concat_candidates(all_cands))


def _detect_program(images: torch.Tensor, packed: PackedModel,
                    plan: PyramidPlan, k_per_level: int, compose: str,
                    dp_split: int = 1, walk_impl: str = "cuda",
                    stage: StageTimer = _no_stage, depth=None,
                    depth_cfg: Optional[DepthPrune] = None,
                    part_masks=None, conv_engine: str = "spatial",
                    pdfs_transform: Optional[Callable] = None
                    ) -> argmax_ops.Candidates:
    """The full detection program for a (B, H, W, C) batch of frames;
    returns Candidates with fields (B, nlevels*k, ...), each frame's
    sorted by score, invalid last.

    depth + depth_cfg: optional (B, dh, dw) float32 depth maps and the
    pruning config: responses at implausible depths become NEG before
    the DP.  part_masks: optional per-bucket (L, P, fh, fw) bool masks of
    allowed part placements (the latent-positive search), or
    (B, L, P, fh, fw) ones per frame.  pdfs_transform: see
    pyramid_pdfs."""
    per_bucket = _stage12(images, packed, plan, conv_engine, stage, depth,
                          depth_cfg, pdfs_transform)
    return _stage34(per_bucket, packed, k_per_level, compose, dp_split,
                    walk_impl, stage, part_masks)


def check_conv_engine(conv_engine: str) -> str:
    if conv_engine not in CONV_ENGINES:
        raise ValueError(f"conv_engine {conv_engine!r}; one of "
                         f"{sorted(CONV_ENGINES)}")
    return conv_engine


def device_frames(images, ndim: int, device: torch.device) -> torch.Tensor:
    """Frames onto the device as they are (uint8 stays uint8; the cast
    to float32 happens there), with a channel axis."""
    images = torch.as_tensor(images).to(device)
    if images.ndim == ndim - 1:
        images = images[..., None]          # grayscale
    return images


def device_depths(depths, device: torch.device) -> torch.Tensor:
    """Depth maps (meters) as float32 on the device."""
    return torch.as_tensor(depths, dtype=torch.float32, device=device)


def device_masks(part_masks, device: torch.device) -> List[torch.Tensor]:
    """Per-bucket part placement masks as bool tensors on the device."""
    return [torch.as_tensor(m, dtype=torch.bool, device=device)
            for m in part_masks]


class Detector:
    """User-facing facade.

    >>> det = Detector(model)                # CUDA; device="cpu" for CPU
    >>> detections = det.detect(image)       # (H, W[, 3]) RGB array

    depth_prune: optional DepthPrune config, used when a depth map is
    passed.  conv_engine: "spatial" or "fft".  walk_impl: "cuda" (the
    walk kernel; its plain version on CPU tensors), "torch" (the plain
    walk) or "auto" ("cuda" on a CUDA device, "torch" on the CPU)."""

    def __init__(self, model: PartsModel, k_per_level: int = 64,
                 compose: str = "reference",
                 dp_split: Optional[int] = None,
                 depth_prune: Optional[DepthPrune] = None,
                 conv_engine: str = "spatial",
                 walk_impl: str = "auto",
                 device=None):
        if model.max_scale() > 0:
            raise ValueError(
                "model has parts at multiple resolutions (anchor ds > "
                "0); use infer.multires.MultiResDetector")
        if compose not in ("reference", "correct"):
            raise ValueError(f"compose {compose!r}")
        if walk_impl not in ("auto", "cuda", "torch"):
            raise ValueError(f"walk_impl {walk_impl!r}; one of 'auto', "
                             "'cuda', 'torch'")
        self.conv_engine = check_conv_engine(conv_engine)
        self.device = resolve_device(device)
        self.model = model
        self.packed = pack_model(model, self.device)
        self.k_per_level = int(k_per_level)
        self.compose = compose
        if dp_split is None:
            # the JAX package's default: groups of about two levels
            # (partsbaseddetector_tpu/infer/detector.py:346-351)
            dp_split = max(1, (model.interval + 1) // 2)
        self.dp_split = int(dp_split)
        self.depth_prune = depth_prune
        if walk_impl == "auto":
            walk_impl = "cuda" if self.device.type == "cuda" else "torch"
        self.walk_impl = walk_impl
        self._plans: Dict[Tuple[int, int], PyramidPlan] = {}

    @classmethod
    def from_config(cls, model: PartsModel, cfg) -> "Detector":
        """Build from a config.RuntimeConfig (the unified typed config;
        partsbaseddetector_tpu/infer/detector.py:403-411), its
        ``device`` included."""
        return cls(model, k_per_level=cfg.k_per_level,
                   compose=cfg.compose, dp_split=cfg.dp_split,
                   conv_engine=cfg.conv_engine, walk_impl=cfg.walk_impl,
                   device=cfg.device)

    def plan_for(self, imshape: Tuple[int, int]) -> PyramidPlan:
        key = (int(imshape[0]), int(imshape[1]))
        if key not in self._plans:
            self._plans[key] = make_plan(key, self.model.binsize,
                                         self.model.interval)
        return self._plans[key]

    def _run(self, frames: torch.Tensor, stage: StageTimer = _no_stage,
             depths=None, part_masks=None) -> argmax_ops.Candidates:
        if depths is not None and self.depth_prune is None:
            raise ValueError(
                "depth map passed but this Detector has no depth_prune "
                "config; construct Detector(..., depth_prune="
                "DepthPrune(...))")
        if depths is not None:
            depths = device_depths(depths, self.device)
            depths = depths.reshape(frames.shape[:1] + depths.shape[-2:])
        plan = self.plan_for(frames.shape[1:3])
        return _detect_program(
            frames, self.packed, plan, self.k_per_level, self.compose,
            self.dp_split, self.walk_impl, stage, depth=depths,
            depth_cfg=self.depth_prune,
            part_masks=None if part_masks is None else
            device_masks(part_masks, self.device),
            conv_engine=self.conv_engine)

    def detect_raw(self, image, depth=None) -> argmax_ops.Candidates:
        """Detect in one (H, W[, 3]) frame; returns the fixed-capacity
        Candidates (scores sorted descending, invalid entries last).
        depth: optional (dh, dw) depth map in meters; with a
        ``depth_prune`` config, responses at implausible depths are
        masked before the DP (the reference's detect(im, depth,
        candidates), include/PartsBasedDetector.hpp:172-174)."""
        frames = device_frames(image, 3, self.device)[None]
        return self._run(frames, depths=depth).map(lambda x: x[0])

    def detect_batch_raw(self, images, depths=None,
                         stage: StageTimer = _no_stage
                         ) -> argmax_ops.Candidates:
        """Detect in a (B, H, W[, 3]) stack of frames in one pass: the
        batch is folded into the level axis of the DP and the walk.
        Returns Candidates with a leading (B, ...) axis; each frame's
        equal to its detect_raw.  depths: optional (B, dh, dw) depth
        maps, one per frame (needs ``depth_prune``).  stage: optional
        stage timer."""
        frames = device_frames(images, 4, self.device)
        if frames.ndim != 4:
            raise ValueError("detect_batch_raw expects (B, H, W, 3) "
                             f"images, got shape {tuple(frames.shape)}")
        return self._run(frames, stage, depths=depths)

    def detect_masked_raw(self, image, part_masks) -> argmax_ops.Candidates:
        """Detection with per-part placement masks (latent-positive
        search).  part_masks: per-bucket list of (L, P, fh, fw) bool
        arrays (train/features.part_overlap_masks stacked per plan
        bucket)."""
        frames = device_frames(image, 3, self.device)[None]
        return self._run(frames, part_masks=part_masks).map(
            lambda x: x[0])

    def pyramid_features(self, image) -> List[np.ndarray]:
        """Per-level HOG feature maps at their true sizes, as host numpy
        arrays: the trainer's feature write-back (train/features.py)."""
        frame = device_frames(image, 3, self.device)
        plan = self.plan_for(frame.shape[:2])
        fn = pyramid_features_program(plan, self.packed.norient,
                                      self.packed.flen)
        return features_to_numpy(fn(frame), plan)

    def detect(self, image, *, depth=None,
               max_detections: Optional[int] = None) -> List[Detection]:
        """Detect and return host-side Detections above the model
        threshold, sorted by score descending."""
        return self.candidates_to_detections(
            self.detect_raw(image, depth=depth), max_detections)

    def update_model(self, model: PartsModel) -> None:
        """Swap in updated weights of the same binsize and interval."""
        if (model.binsize != self.model.binsize
                or model.interval != self.model.interval):
            raise ValueError("update_model needs the same binsize and "
                             "interval")
        packed = pack_model(model, self.device)
        self.model = model
        self.packed = packed

    @staticmethod
    def candidates_to_detections(cands: argmax_ops.Candidates,
                                 max_detections: Optional[int] = None
                                 ) -> List[Detection]:
        """Convert one frame's Candidates to host Detections (valid
        entries only, preserving order)."""
        score = cands.score.cpu().numpy()
        valid = cands.valid.cpu().numpy()
        comp = cands.component.cpu().numpy()
        level = cands.level.cpu().numpy()
        boxes = cands.boxes.cpu().numpy()
        locs = cands.loc.cpu().numpy()
        out: List[Detection] = []
        for i in range(len(score)):
            if not valid[i]:
                continue
            out.append(Detection(score=float(score[i]),
                                 component=int(comp[i]),
                                 level=int(level[i]),
                                 parts=boxes[i], locations=locs[i]))
            if max_detections is not None and len(out) >= max_detections:
                break
        return out
