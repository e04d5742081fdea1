"""Detector facade: the PyTorch counterpart of partsbaseddetector_tpu's
Detector (single-resolution models).

Mirrors the reference's 4-stage pipeline (reference:
src/PartsBasedDetector.cpp:69-95), run eagerly on one device with the
frames of a batch folded into the level axis:

  stage 1  resize ladder + HOG per octave bucket (levels of a bucket
           share one padded buffer and run as one batch)
  stage 2  one filter-bank conv per bucket (cuDNN, TF32 off)
  stage 3  the part-tree DP per (level group, component), levels as a
           batch axis
  stage 4  top-K root seeds per level, the fused walk kernel
           (ops/walk.py), then one stable sort

Not supported yet, each raising NotImplementedError that names
its ROADMAP.md item: the FFT conv engine, depth pruning, masked latent
search (part masks), components with shared filter ids, and
multi-resolution models.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

import numpy as np
import torch

from partsbaseddetector_tpu_torch.infer.pyramid_plan import (PyramidPlan,
                                                             make_plan)
from partsbaseddetector_tpu_torch.models.part_tree import (PackedModel,
                                                           pack_model)
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops import argmax as argmax_ops
from partsbaseddetector_tpu_torch.ops.common import resolve_device
from partsbaseddetector_tpu_torch.ops.conv import conv_bank
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

    def resized(self, factor: float) -> "Detection":
        """Scale all part boxes (reference: include/Candidate.hpp:82-89).
        """
        return dataclasses.replace(self, parts=self.parts * factor)


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


def pyramid_pdfs(images: torch.Tensor, packed: PackedModel,
                 plan: PyramidPlan, stage: StageTimer = _no_stage):
    """Stages 1-2 for every bucket (ladder + HOG + filter-bank conv).

    images: (B, H, W, C) frames on the model's device, any real dtype
    (uint8 frames are cast to float32 here, on the device).
    Returns a list of (bucket, pdfs, tsizes, scales): pdfs (B, L, fh, fw,
    F) responses, garbage beyond each level's true size (the DP masks
    padded cells, dp_min_levels(true_sizes=...)); tsizes (L, 2) int32
    true feature sizes; scales (L,) f32 pixels per cell."""
    dev = images.device
    B = images.shape[0]
    img = images.to(torch.float32)
    prev_buf = prev_levels = None
    out = []
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
                buf.flatten(0, 1), packed.binsize, packed.norient,
                packed.flen, true_size=imsizes.repeat(B, 1),
                feat_pad=bucket.feat_pad)                   # (B*L, ...)
        with stage("conv"):
            tsizes = torch.tensor([lvl.featsize for lvl in bucket.levels],
                                  dtype=torch.int32, device=dev)
            pdfs = conv_bank(feats, packed.bank,
                             true_size=tsizes.repeat(B, 1))
        scales = torch.tensor([lvl.scale for lvl in bucket.levels],
                              dtype=torch.float32, device=dev)
        out.append((bucket, pdfs.unflatten(0, (B, L)), tsizes, scales))
    return out


def dp_backtrack_bucket(bucket, pdfs, tsizes, scales,
                        packed: PackedModel, k_per_level: int,
                        compose: str, dp_split: int = 1,
                        walk_impl: str = "cuda",
                        stage: StageTimer = _no_stage
                        ) -> List[argmax_ops.Candidates]:
    """Stages 3-4 for one octave bucket of a batch of frames: per (level
    group, component) DP + backtracking, with the batch folded into the
    level axis (every level is independent).  pdfs: (B, L, fh, fw, F).
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
        # levels run b-major; each frame's level indices restart
        levels = (torch.arange(lo, hi, dtype=torch.int32, device=dev)
                  + bucket.levels[0].index).repeat(B)
        for c, comp in enumerate(packed.components):
            with stage("dp"):
                res = dp_min_levels(gpdfs, comp, compose,
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


def _detect_program(images: torch.Tensor, packed: PackedModel,
                    plan: PyramidPlan, k_per_level: int, compose: str,
                    dp_split: int = 1, walk_impl: str = "cuda",
                    stage: StageTimer = _no_stage
                    ) -> argmax_ops.Candidates:
    """The full detection program for a (B, H, W, C) batch of frames;
    returns Candidates with fields (B, nlevels*k, ...), each frame's
    sorted by score, invalid last."""
    all_cands: List[argmax_ops.Candidates] = []
    for bucket, pdfs, tsizes, scales in pyramid_pdfs(images, packed, plan,
                                                     stage):
        all_cands.extend(dp_backtrack_bucket(
            bucket, pdfs, tsizes, scales, packed, k_per_level, compose,
            dp_split, walk_impl, stage))
    with stage("seeds+sort"):
        return argmax_ops.sort_candidates(
            argmax_ops.concat_candidates(all_cands))


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to partsbaseddetector_tpu_torch yet "
        f"(ROADMAP.md queue 1 item {item}); use partsbaseddetector_tpu")


class Detector:
    """User-facing facade.

    >>> det = Detector(model)                # CUDA; device="cpu" for CPU
    >>> detections = det.detect(image)       # (H, W[, 3]) RGB array
    """

    def __init__(self, model: PartsModel, k_per_level: int = 64,
                 compose: str = "reference",
                 dp_split: Optional[int] = None,
                 depth_prune=None,
                 conv_engine: str = "spatial",
                 walk_impl: str = "auto",
                 device=None):
        if depth_prune is not None:
            raise _not_ported("depth pruning (depth_prune)", 10)
        if conv_engine == "fft":
            raise _not_ported("conv_engine='fft' (conv_bank_fft)", 13)
        if conv_engine != "spatial":
            raise ValueError(f"conv_engine {conv_engine!r}")
        if compose not in ("reference", "correct"):
            raise ValueError(f"compose {compose!r}")
        if walk_impl not in ("auto", "cuda", "torch"):
            raise ValueError(f"walk_impl {walk_impl!r}; one of 'auto', "
                             "'cuda', 'torch'")
        self.device = resolve_device(device)
        self.model = model
        self.packed = self._pack(model)
        self.k_per_level = int(k_per_level)
        self.compose = compose
        if dp_split is None:
            # the JAX package's default: groups of about two levels
            # (partsbaseddetector_tpu/infer/detector.py:346-351)
            dp_split = max(1, (model.interval + 1) // 2)
        self.dp_split = int(dp_split)
        self.conv_engine = conv_engine
        if walk_impl == "auto":
            walk_impl = "cuda" if self.device.type == "cuda" else "torch"
        self.walk_impl = walk_impl
        self._plans: Dict[Tuple[int, int], PyramidPlan] = {}

    def _pack(self, model: PartsModel) -> PackedModel:
        """pack_model onto this detector's device, refusing the model
        kinds this package does not support yet."""
        if model.max_scale() > 0:
            raise _not_ported("a multi-resolution model (anchor ds > 0, "
                              "MultiResDetector)", 14)
        packed = pack_model(model, self.device)
        if any(c.aliased for c in packed.components):
            raise _not_ported("a component with shared filter ids (the "
                              "aliased DP)", 9)
        return packed

    def plan_for(self, imshape: Tuple[int, int]) -> PyramidPlan:
        key = (int(imshape[0]), int(imshape[1]))
        if key not in self._plans:
            self._plans[key] = make_plan(key, self.model.binsize,
                                         self.model.interval)
        return self._plans[key]

    def _frames(self, images, ndim: int) -> torch.Tensor:
        """Frames onto the device as they are (uint8 stays uint8; the
        cast to float32 happens there), with a channel axis."""
        images = torch.as_tensor(images).to(self.device)
        if images.ndim == ndim - 1:
            images = images[..., None]          # grayscale
        return images

    def _run(self, images: torch.Tensor,
             stage: StageTimer = _no_stage) -> argmax_ops.Candidates:
        plan = self.plan_for(images.shape[1:3])
        return _detect_program(images, self.packed, plan, self.k_per_level,
                               self.compose, self.dp_split, self.walk_impl,
                               stage)

    def detect_raw(self, image, depth=None) -> argmax_ops.Candidates:
        """Detect in one (H, W[, 3]) frame; returns the fixed-capacity
        Candidates (scores sorted descending, invalid entries last)."""
        if depth is not None:
            raise _not_ported("depth pruning (a depth map)", 10)
        frames = self._frames(image, 3)[None]
        return self._run(frames).map(lambda x: x[0])

    def detect_batch_raw(self, images, depths=None,
                         stage: StageTimer = _no_stage
                         ) -> argmax_ops.Candidates:
        """Detect in a (B, H, W[, 3]) stack of frames in one pass: the
        batch is folded into the level axis of the DP and the walk.
        Returns Candidates with a leading (B, ...) axis; each frame's
        equal to its detect_raw.  stage: optional stage timer."""
        if depths is not None:
            raise _not_ported("depth pruning (depth maps)", 10)
        frames = self._frames(images, 4)
        if frames.ndim != 4:
            raise ValueError("detect_batch_raw expects (B, H, W, 3) "
                             f"images, got shape {tuple(frames.shape)}")
        return self._run(frames, stage)

    def detect_masked_raw(self, image, part_masks):
        raise _not_ported("masked latent search (detect_masked_raw)", 10)

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
        packed = self._pack(model)
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
