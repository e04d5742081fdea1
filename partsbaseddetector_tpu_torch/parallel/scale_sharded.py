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
response maps of true size zero (only the real levels are convolved),
which give only invalid candidates, and the padding is dropped after
the gather; the result equals Detector(dp_split=1)'s, capacity
included.

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
from typing import List, Tuple

import torch

from partsbaseddetector_tpu_torch.infer.detector import (
    StageTimer, dp_backtrack_bucket, frame_by_frame, pyramid_pdfs)
from partsbaseddetector_tpu_torch.infer.multires import (_multires_walks,
                                                         detector_for)
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops import argmax as argmax_ops
from partsbaseddetector_tpu_torch.ops.common import NEG
from partsbaseddetector_tpu_torch.parallel.mesh import Mesh, make_mesh
from partsbaseddetector_tpu_torch.parallel.sharded import (
    ParallelFacade, check_mesh, gather_candidates, sharded_packed)
from partsbaseddetector_tpu_torch.utils import profiling


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


class ScaleShardedDetector(ParallelFacade):
    """Single-image detector with pyramid levels sharded over ranks.

    >>> mesh = make_scale_mesh((4, 2))      # 8 ranks, one card each
    >>> det = ScaleShardedDetector(model, mesh)
    >>> cands = det.detect_raw(image)       # the same on every rank

    A single-resolution model splits each octave bucket's levels by the
    bucket's own length, and gives Detector(dp_split=1)'s Candidates; a
    multi-resolution one splits the slots of every bucket by one common
    range (local_slot_range), and gives MultiResDetector's.  Either way
    each rank convolves, runs the DP and walks only its own levels.  A
    batch's frames run one at a time.
    """

    def __init__(self, model: PartsModel, mesh: Mesh,
                 k_per_level: int = 64, compose: str = "reference",
                 conv_engine: str = "spatial", depth_prune=None,
                 walk_impl: str = "auto"):
        self.model = model
        self.mesh = check_mesh(mesh, ("scale", "filter"))
        # one dp group per bucket: a rank's levels are one batch
        self._det = detector_for(
            model, k_per_level=k_per_level, compose=compose, dp_split=1,
            depth_prune=depth_prune, conv_engine=conv_engine,
            walk_impl=walk_impl, device=mesh.device)
        self.packed = sharded_packed(self._det.packed, mesh)
        self._gather = (mesh.gather_filters if mesh.shape["filter"] > 1
                        else None)
        # the facade's program decides the split rule
        self._split = (self._slot_split if self._det.multires
                       else self._level_split)

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

    def _slot_split(self, frames: torch.Tensor, depths=None,
                    part_masks=None, stage: StageTimer = profiling.stage
                    ) -> argmax_ops.Candidates:
        """One multi-resolution (1, H, W, C) frame, slots split over
        ``scale``: this rank's slot range of every bucket through stages
        1-4, each (root bucket, component) segment padded to C*k with
        invalid candidates, then the all-gather over ``scale`` and the
        merge; the same Candidates (1, ...) on every rank.  depths
        (1, dh, dw) or None; part_masks per bucket (L, P, fh, fw) or
        None."""
        packed, k = self.packed, self.k_per_level
        plan = self.plan_for(frames.shape[1:3])
        a, b = self.local_slot_range(frames.shape[1:3])
        # the same on every rank of a filter group
        slots = [(min(a, len(bk.levels)), min(b, len(bk.levels)))
                 for bk in plan.buckets]
        per_bucket = [(bk, None if p is None else p[0], t, s)
                      for bk, p, t, s in pyramid_pdfs(
                          frames, packed, plan, self.conv_engine, stage,
                          self._gather, depths, self.depth_prune, slots)]
        masks = None if part_masks is None else [
            part_masks[bk.octave][lo:hi]
            for bk, (lo, hi) in zip(plan.buckets, slots)]
        n = self._slots_per_rank(plan) * k
        segments = []
        for c, cands in _multires_walks(per_bucket, packed, k, masks,
                                        slot0=a):
            have = 0 if cands is None else cands.capacity
            pad = _invalid_candidates(n - have, packed.maxparts,
                                      frames.device)
            segments.append(pad if cands is None else
                            argmax_ops.concat_candidates([cands, pad]))
        local = argmax_ops.concat_candidates(segments)
        return self._multires_merge(gather_candidates(
            local.map(lambda x: x[None]), self.mesh, "scale", 1), plan)

    def _multires_merge(self, gathered: argmax_ops.Candidates, plan
                        ) -> argmax_ops.Candidates:
        """The ranks' _slot_split segments (1, ...), concatenated in
        scale order, to MultiResDetector's Candidates: each rank's real
        slots of each (root bucket, component) segment, in (bucket,
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
            gathered.map(lambda x: x.index_select(1, order)))

    def _level_split(self, frames: torch.Tensor, depths=None,
                     part_masks=None, stage: StageTimer = profiling.stage
                     ) -> argmax_ops.Candidates:
        """One single-resolution (1, H, W, C) frame, each bucket's levels
        split over ``scale``; depths (1, dh, dw) or None; part_masks per
        bucket (L, P, fh, fw) or None."""
        packed, k = self.packed, self.k_per_level
        plan = self.plan_for(frames.shape[1:3])
        nscale, s = self.mesh.shape["scale"], self.mesh.index("scale")
        shares = [-(-len(bk.levels) // nscale) for bk in plan.buckets]
        real = [(min(s * n, len(bk.levels)),
                 min((s + 1) * n, len(bk.levels)))
                for bk, n in zip(plan.buckets, shares)]
        nfilters = packed.nfilters * self.mesh.shape["filter"]
        local: List[argmax_ops.Candidates] = []
        for (bucket, pdfs, tsizes, scales), (lo, hi), n in zip(
                pyramid_pdfs(frames, packed, plan, self.conv_engine, stage,
                             self._gather, depths, self.depth_prune, real),
                real, shares):
            L = len(bucket.levels)
            pad = n - (hi - lo)         # padded levels of this rank's share
            if pad:
                neg = torch.full((1, pad) + tuple(bucket.feat_pad)
                                 + (nfilters,), NEG, device=frames.device)
                pdfs = neg if pdfs is None else torch.cat([pdfs, neg], 1)
            levels = list(bucket.levels) + [
                dataclasses.replace(bucket.levels[-1],
                                    index=bucket.levels[0].index + L + i)
                for i in range(n * nscale - L)]
            bmask = None
            if part_masks is not None:
                bmask = _pad_levels(part_masks[bucket.octave][lo:hi], pad,
                                    False)
            local.extend(dp_backtrack_bucket(
                types.SimpleNamespace(levels=levels[s * n:(s + 1) * n]),
                pdfs, _pad_levels(tsizes, pad, 0),
                _pad_levels(scales, pad, 1.0), packed, k, self.compose, 1,
                self.walk_impl, bmask, stage))
        ncomp = len(packed.components)
        # gathered: rank-major blocks of this rank's (bucket, component)
        # segments; reorder them bucket-major, levels ascending, and
        # drop the padding
        merged = gather_candidates(
            argmax_ops.concat_candidates(local), self.mesh, "scale", 1)
        per_rank = sum(shares) * k * ncomp
        idx, off = [], 0
        for bucket, n in zip(plan.buckets, shares):
            seg = n * k
            for c in range(ncomp):
                for r in range(nscale):
                    start = r * per_rank + off + c * seg
                    keep = min(max(len(bucket.levels) * k - r * seg, 0), seg)
                    idx.append(torch.arange(start, start + keep))
            off += seg * ncomp
        order = torch.cat(idx).to(frames.device)
        return argmax_ops.sort_candidates(
            merged.map(lambda x: x.index_select(1, order)))

    def _program(self, frames, depths=None, part_masks=None,
                 stage: StageTimer = profiling.stage
                 ) -> argmax_ops.Candidates:
        return frame_by_frame(self._split, frames, depths, part_masks,
                              stage)

    def detect_raw(self, image, depth=None) -> argmax_ops.Candidates:
        """Detect in one (H, W[, 3]) frame.  depth: optional (dh, dw)
        metric depth map — with a ``depth_prune`` config, responses at
        implausible depths are masked before the DP (Detector.detect_raw's
        semantics)."""
        return self._det._run(image, 3, depths=depth,
                              program=self._program).map(lambda x: x[0])

    def detect_batch_raw(self, images, depths=None
                         ) -> argmax_ops.Candidates:
        """Detect in a (B, H, W[, 3]) stack of frames, one at a time."""
        return self._det._run(images, 4, depths=depths,
                              program=self._program)

    def detect_masked_raw(self, image, part_masks
                          ) -> argmax_ops.Candidates:
        """Latent-positive masked search, levels sharded (the mask
        format of Detector.detect_masked_raw)."""
        return self._det._run(image, 3, part_masks=part_masks,
                              program=self._program).map(lambda x: x[0])
