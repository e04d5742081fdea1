"""Scale-axis sharding: one frame's pyramid levels split over ranks (port
of partsbaseddetector_tpu/parallel/scale_sharded.py).

The reference parallelizes its scale loop with OpenMP
(src/DynamicProgram.cpp:80-83, src/HOGFeatures.cpp:111-114).  Here each
octave bucket's levels split over the ``scale`` axis of a
(scale, filter) mesh: unlike data parallelism (parallel/sharded.py)
this cuts one frame's LATENCY.  Every rank builds the resize ladder and
HOG of the whole pyramid (each bucket's ladder starts from the one
before), then convolves its own levels with its filter shard,
all-gathers its filter group's responses, and runs the DP and the walk
for its levels.  At the end the Candidates are all-gathered over
``scale`` and one stable sort makes the merge deterministic.

Single-resolution models split each bucket by its own length: a
bucket's L levels are padded to a multiple of the scale size with NEG
response maps of true size zero, which give only invalid candidates,
and the padding is dropped after the gather; the result equals
Detector(dp_split=1)'s, capacity included.

Multi-resolution models split every bucket by ONE slot range.  A slot
is a level's index inside its octave bucket, and a root at slot i of
bucket o reads a part at scale s from bucket o - s at the same slot i
(infer/multires.py).  With C = ceil(max_b L_b / nscale), rank r owns
slots [r*C, (r+1)*C) of every bucket, clipped to the bucket's length,
so every cross-octave read is local and nothing is exchanged between
the DP and the walk; this needs bucket lengths that never grow with
the octave, which make_plan gives.  Every stage runs on the real slots
only (no padded levels are convolved); each rank pads its
(root bucket, component) candidate segments to C*k before the gather,
and the merge keeps each rank's real slots in (bucket, component,
rank) order before the sort.  The result equals
MultiResDetector.detect_raw's on all fields, capacity included.  The
JAX package instead splits each bucket by its own length and lets the
SPMD partitioner reshard the cross-octave reads; the layouts differ,
the result is the same.
"""

from __future__ import annotations

import dataclasses
import types
from typing import List, Optional, Tuple

import torch

from partsbaseddetector_tpu_torch.infer.detector import (
    Detector, _depth_bad_mask, _ladder_hog, device_depths, device_frames,
    device_masks, dp_backtrack_bucket)
from partsbaseddetector_tpu_torch.infer.multires import _multires_walks
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops import argmax as argmax_ops
from partsbaseddetector_tpu_torch.ops.common import NEG
from partsbaseddetector_tpu_torch.ops.conv import CONV_ENGINES
from partsbaseddetector_tpu_torch.parallel.mesh import Mesh, make_mesh
from partsbaseddetector_tpu_torch.parallel.sharded import (
    _facade, check_mesh, gather_candidates, sharded_packed)


def make_scale_mesh(shape=None, device=None) -> Mesh:
    """(scale, filter) mesh over the job's ranks; defaults to all of
    them on the scale axis (parallel/mesh.make_mesh)."""
    return make_mesh(shape, ("scale", "filter"), device)


def _pad_levels(t: torch.Tensor, n: int, value) -> torch.Tensor:
    """t with n more entries along dim 0, filled with value."""
    if n == 0:
        return t
    return torch.cat([t, t.new_full((n,) + t.shape[1:], value)])


def _invalid_candidates(n: int, nparts: int, device
                        ) -> argmax_ops.Candidates:
    """n invalid candidates of nparts part rows: the padding of a rank's
    segments before the scale all-gather, dropped after it."""
    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return argmax_ops.Candidates(
        score=zeros(n, dtype=torch.float32),
        valid=zeros(n, dtype=torch.bool), component=zeros(n),
        level=zeros(n), boxes=zeros(n, nparts, 4, dtype=torch.float32),
        loc=zeros(n, nparts, 3))


class ScaleShardedDetector:
    """Single-image detector with pyramid levels sharded over ranks.

    >>> mesh = make_scale_mesh((4, 2))      # 8 ranks, one card each
    >>> det = ScaleShardedDetector(model, mesh)
    >>> cands = det.detect_raw(image)       # the same on every rank

    A single-resolution model splits each octave bucket's levels by the
    bucket's own length, and gives Detector(dp_split=1)'s Candidates; a
    multi-resolution one (max_scale() > 0) splits the slots of every
    bucket by one common range (local_slot_range), and gives
    MultiResDetector's.  Either way each rank convolves, runs the DP and
    walks only its own levels.
    """

    def __init__(self, model: PartsModel, mesh: Mesh,
                 k_per_level: int = 64, compose: str = "reference",
                 conv_engine: str = "spatial", depth_prune=None,
                 walk_impl: str = "auto"):
        self.model = model
        self.mesh = check_mesh(mesh, ("scale", "filter"))
        self.multires = model.max_scale() > 0
        # one dp group per bucket: a rank's levels are one batch
        self._det = _facade(model, mesh.device, k_per_level=k_per_level,
                            compose=compose, dp_split=1,
                            conv_engine=conv_engine,
                            depth_prune=depth_prune, walk_impl=walk_impl)
        self.device = self._det.device
        self.k_per_level = self._det.k_per_level
        self.compose = compose
        self.conv_engine = self._det.conv_engine
        self.depth_prune = depth_prune
        self.walk_impl = getattr(self._det, "walk_impl", "torch")
        self.packed = sharded_packed(self._det.packed, mesh)
        self._gather = (mesh.gather_filters if mesh.shape["filter"] > 1
                        else None)

    def plan_for(self, imshape):
        return self._det.plan_for(imshape)

    def _slots_per_rank(self, plan) -> int:
        """C = ceil(max_b L_b / nscale), the slots a rank owns of every
        bucket of a multi-resolution plan."""
        lens = [len(b.levels) for b in plan.buckets]
        if any(n > m for m, n in zip(lens, lens[1:])):
            raise ValueError(
                f"bucket lengths {lens} grow with the octave: the "
                "multi-resolution slot split needs every root's finer "
                "buckets to hold its slots")
        return -(-lens[0] // self.mesh.shape["scale"])

    def local_slot_range(self, imshape) -> Tuple[int, int]:
        """(start, stop): the slots of every octave bucket this rank
        convolves, runs the DP on and walks for a multi-resolution model
        on an (H, W) frame, clipped to the longest bucket (each bucket
        then clips it to its own length).  Ranks that share a scale
        coordinate (a filter group) own the same range."""
        if not self.multires:
            raise ValueError("local_slot_range: single-resolution models "
                             "split each bucket by its own length")
        plan = self.plan_for(imshape)
        C, n = self._slots_per_rank(plan), len(plan.buckets[0].levels)
        r = self.mesh.index("scale")
        return min(r * C, n), min((r + 1) * C, n)

    def _multires_local(self, frame: torch.Tensor, depth=None,
                        part_masks=None) -> argmax_ops.Candidates:
        """This rank's part of a multi-resolution (H, W, C) frame: its
        slot range of every bucket through stages 1-4, each (root
        bucket, component) segment padded to C*k with invalid
        candidates.  depth (dh, dw) or None; part_masks per bucket
        (L, P, fh, fw) or None."""
        packed = self.packed
        plan = self.plan_for(frame.shape[:2])
        a, b = self.local_slot_range(frame.shape[:2])
        conv = CONV_ENGINES[self.conv_engine]
        dev = frame.device
        per_bucket = []
        masks = None if part_masks is None else []
        for bucket, _, feats in _ladder_hog(frame[None], plan,
                                            packed.norient, packed.flen):
            L = len(bucket.levels)
            lo, hi = min(a, L), min(b, L)
            mine = bucket.levels[lo:hi]
            tsizes = torch.tensor([lv.featsize for lv in mine],
                                  dtype=torch.int32,
                                  device=dev).reshape(-1, 2)
            scales = torch.tensor([lv.scale for lv in mine],
                                  dtype=torch.float32, device=dev)
            pdfs = None
            if mine:        # the same on every rank of a filter group
                pdfs = conv(feats[lo:hi], packed.bank, true_size=tsizes)
                if self._gather is not None:
                    pdfs = self._gather(pdfs)
                if depth is not None and self.depth_prune is not None:
                    bad = _depth_bad_mask(depth[None], bucket,
                                          self.depth_prune)[0, lo:hi]
                    pdfs.masked_fill_(bad[..., None], NEG)
            per_bucket.append((bucket, pdfs, tsizes, scales))
            if masks is not None:
                masks.append(part_masks[bucket.octave][lo:hi])
        n = self._slots_per_rank(plan) * self.k_per_level
        segments = []
        for c, cands in _multires_walks(per_bucket, packed,
                                        self.k_per_level, masks, slot0=a):
            have = 0 if cands is None else cands.capacity
            pad = _invalid_candidates(n - have, packed.maxparts, dev)
            segments.append(pad if cands is None else
                            argmax_ops.concat_candidates([cands, pad]))
        return argmax_ops.concat_candidates(segments)

    def _multires_merge(self, gathered: argmax_ops.Candidates, plan
                        ) -> argmax_ops.Candidates:
        """The ranks' _multires_local results, concatenated in scale
        order, to MultiResDetector's Candidates: each rank's real slots
        of each (root bucket, component) segment, in (bucket,
        component, rank) order — level order within a segment — then
        one stable sort."""
        packed, k = self.packed, self.k_per_level
        nscale = self.mesh.shape["scale"]
        C = self._slots_per_rank(plan)
        smax = max((max(sc) for sc in packed.scale_static), default=0)
        roots = [len(bkt.levels) for bkt in plan.buckets[smax:]]
        ncomp = len(packed.components)
        per_rank = len(roots) * ncomp * C * k
        idx = []
        for j, L in enumerate(n for n in roots for _ in range(ncomp)):
            for r in range(nscale):
                start = r * per_rank + j * C * k
                keep = min(max(L - r * C, 0), C) * k
                idx.append(torch.arange(start, start + keep))
        order = torch.cat(idx).to(gathered.score.device)
        return argmax_ops.sort_candidates(
            gathered.map(lambda x: x.index_select(0, order)))

    def _multires_program(self, frame: torch.Tensor, depth=None,
                          part_masks=None) -> argmax_ops.Candidates:
        """One multi-resolution (H, W, C) frame, slots split over
        ``scale``; the same Candidates on every rank."""
        return self._multires_merge(
            gather_candidates(self._multires_local(frame, depth,
                                                   part_masks),
                              self.mesh, "scale", 0),
            self.plan_for(frame.shape[:2]))

    def _program(self, frame: torch.Tensor, depth=None, part_masks=None
                 ) -> argmax_ops.Candidates:
        """One (1, H, W, C) frame; depth (1, dh, dw) or None; part_masks
        per bucket (L, P, fh, fw) or None."""
        packed, k = self.packed, self.k_per_level
        plan = self.plan_for(frame.shape[1:3])
        nscale, s = self.mesh.shape["scale"], self.mesh.index("scale")
        conv = CONV_ENGINES[self.conv_engine]
        dev = frame.device
        local: List[argmax_ops.Candidates] = []
        counts = []                 # (levels, padded levels) per bucket
        for bucket, _, feats in _ladder_hog(frame, plan, packed.norient,
                                            packed.flen):
            L = len(bucket.levels)
            Ll = -(-L // nscale)
            pad = Ll * nscale - L
            counts.append((L, Ll * nscale))
            lo, hi = s * Ll, (s + 1) * Ll
            levels = list(bucket.levels) + [
                dataclasses.replace(bucket.levels[-1],
                                    index=bucket.levels[0].index + L + i)
                for i in range(pad)]
            tsizes = torch.tensor(
                [lv.featsize for lv in bucket.levels] + [(0, 0)] * pad,
                dtype=torch.int32, device=dev)[lo:hi]
            scales = torch.tensor(
                [lv.scale for lv in bucket.levels] + [1.0] * pad,
                dtype=torch.float32, device=dev)[lo:hi]
            pdfs = conv(_pad_levels(feats, pad, 0.0)[lo:hi], packed.bank,
                        true_size=tsizes)
            if self._gather is not None:
                pdfs = self._gather(pdfs)
            nreal = min(max(L - lo, 0), Ll)
            pdfs[nreal:] = NEG                      # the padded levels
            if depth is not None and self.depth_prune is not None:
                bad = _depth_bad_mask(depth, bucket, self.depth_prune)[0]
                bad = _pad_levels(bad, pad, False)[lo:hi]
                pdfs.masked_fill_(bad[..., None], NEG)
            bmask = None
            if part_masks is not None:
                bmask = _pad_levels(part_masks[bucket.octave], pad,
                                    False)[lo:hi]
            local.extend(dp_backtrack_bucket(
                types.SimpleNamespace(levels=levels[lo:hi]), pdfs[None],
                tsizes, scales, packed, k, self.compose, 1,
                self.walk_impl, bmask))
        ncomp = len(packed.components)
        # gathered: rank-major blocks of this rank's (bucket, component)
        # segments; reorder them bucket-major, levels ascending, and
        # drop the padding
        merged = gather_candidates(
            argmax_ops.concat_candidates(local), self.mesh, "scale", 1)
        per_rank = sum(Lp // nscale for _, Lp in counts) * k * ncomp
        idx, off = [], 0
        for L, Lp in counts:
            seg = Lp // nscale * k
            for c in range(ncomp):
                for r in range(nscale):
                    start = r * per_rank + off + c * seg
                    keep = min(max(L * k - r * seg, 0), seg)
                    idx.append(torch.arange(start, start + keep))
            off += seg * ncomp
        order = torch.cat(idx).to(dev)
        return argmax_ops.sort_candidates(
            merged.map(lambda x: x.index_select(1, order)))

    def detect_raw(self, image, depth=None) -> argmax_ops.Candidates:
        """Detect in one (H, W[, 3]) frame.  depth: optional (dh, dw)
        metric depth map — with a ``depth_prune`` config, responses at
        implausible depths are masked before the DP (Detector.detect_raw's
        semantics)."""
        if depth is not None and self.depth_prune is None:
            raise ValueError(
                "depth map passed but this detector has no depth_prune "
                "config (matches Detector behavior)")
        return self._run(image, depth=depth)

    def detect_masked_raw(self, image, part_masks
                          ) -> argmax_ops.Candidates:
        """Latent-positive masked search, levels sharded (the mask
        format of Detector.detect_masked_raw)."""
        return self._run(image, part_masks=part_masks)

    def _run(self, image, depth=None, part_masks=None):
        frame = device_frames(image, 3, self.device)
        if depth is not None:
            depth = device_depths(depth, self.device)
        if part_masks is not None:
            part_masks = device_masks(part_masks, self.device)
        if self.multires:
            return self._multires_program(frame, depth, part_masks)
        out = self._program(frame[None],
                            None if depth is None else depth[None],
                            part_masks)
        return out.map(lambda x: x[0])

    def detect(self, image, max_detections: Optional[int] = None):
        return Detector.candidates_to_detections(
            self.detect_raw(image), max_detections)
