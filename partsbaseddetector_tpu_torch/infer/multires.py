"""Multi-resolution mixtures-of-parts detection.

Port of partsbaseddetector_tpu/infer/multires.py.  Parts may live at a
FINER pyramid level than their parent (anchor ds > 0), the Matlab
detector's multi-resolution capability (reference:
matlab/detection/detect.m:184-212 with passmsg :230-255 and the strided
DT matlab/oct/shiftdt.cc) that the C++ port dropped.

  * stages 1-2 are the single-resolution detector's
    (infer/detector.pyramid_pdfs), on one frame;
  * for root octave o, a part at absolute scale s reads its responses
    from bucket o - s at the SAME slot index, sliced to the root
    bucket's level count: the cross-resolution wiring is indexing, no
    resampling;
  * the leaf-to-root pass is a loop over parts with every level and
    mixture as batch axes; each edge message is the strided max-only DT
    (ops/dt.shiftdt_max);
  * backtracking recomputes argmaxes at the K candidate points only,
    for all levels of a bucket at once, with positions mapped through
    the edge stride: child position = parent position * 2^ds + anchor.
    The JAX package walks here with XLA gathers, no Pallas kernel, so
    this walk is plain PyTorch on every device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from partsbaseddetector_tpu_torch.infer.detector import (
    DepthPrune, Detector, DetectorFacade, StageTimer, frame_by_frame)
from partsbaseddetector_tpu_torch.models.part_tree import (PackedComponent,
                                                           PackedModel)
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops import argmax as argmax_ops
from partsbaseddetector_tpu_torch.ops.common import NEG
from partsbaseddetector_tpu_torch.ops.dp import (_argmax_first, _dt_vals_at,
                                                 _inbounds)
from partsbaseddetector_tpu_torch.ops.dt import shiftdt_max
from partsbaseddetector_tpu_torch.utils import profiling


def _dp_multires(per_bucket, o: int, L: int, comp: PackedComponent,
                 pscales: Sequence[int], parents: Sequence[int],
                 part_masks=None):
    """Leaf-to-root pass for root bucket o over its L levels.

    per_bucket: (bucket, pdfs (L_b, fh_b, fw_b, F), tsizes (L_b, 2),
    scales (L_b,)) per bucket.  part_masks: optional per-bucket
    (L_b, P, fh_b, fw_b) bool masks; each part's mask is read from its
    OWN slot bucket (o - pscales[p]), the overlap constraint at the
    part's own resolution (as the JAX package's _dp_multires).

    Returns (rootv (L, H, W), rooti (L, H, W) int32, scores per part
    (L, M, H_p, W_p), y-pass maxima per part (L, M, H_parent, W_p),
    None for the root)."""
    P = comp.nparts
    scores: List[torch.Tensor] = []
    for p in range(P):
        b = o - pscales[p]
        _, pdfs_s, ts_s, _ = per_bucket[b]
        sp = pdfs_s[:L].movedim(-1, 1)[:, comp.filterid[p].long()]
        Hs, Ws = sp.shape[-2:]
        # padded mixtures and cells beyond the slot's OWN true size are
        # NEG (value-identical to masking the responses)
        keep = (comp.mix_valid[p][None, :, None, None]
                & _inbounds(Hs, Ws, ts_s[:L])[:, None])
        if part_masks is not None:
            keep = keep & part_masks[b][:L, p][:, None]
        scores.append(torch.where(keep, sp, NEG))      # (L, M, Hs, Ws)

    tmps: List[Optional[torch.Tensor]] = [None] * P
    for p in range(P - 1, 0, -1):
        par = parents[p]
        step = 2 ** (pscales[p] - pscales[par])
        Hp, Wp = scores[par].shape[-2:]
        anc = comp.anchor[p].to(torch.float32)         # (M, 2)
        out, tmps[p] = shiftdt_max(scores[p], comp.defw[p], anc[:, 0],
                                   anc[:, 1], Wp, Hp, step)
        weighted = out[:, None] + comp.bias[p].T[None, :, :, None, None]
        scores[par] = scores[par] + weighted.amax(dim=2)

    rootw = scores[0] + comp.root_bias
    rootw = torch.where(comp.mix_valid[0][None, :, None, None], rootw, NEG)
    return rootw.amax(dim=1), _argmax_first(rootw, 1), scores, tmps


def _walk_levels(rootv, rooti, scores, tmps, comp: PackedComponent,
                 pscales, parents, thresh, true_sizes, part_scales,
                 k: int, component_index: int, width: int, levels
                 ) -> argmax_ops.Candidates:
    """Backtracking for all L root levels of a bucket at once: top-k
    roots per level (ops/argmax._root_seeds, the JAX package's lax.top_k
    order), then the strided K-point argmax recomputation down the tree
    (the JAX package's _walk_slot, batched over levels).  part_scales:
    (L, P) pixels per cell of each part's own slot; width: the model's
    most parts, to which the candidates' part rows are padded.  Returns
    a flat Candidates of capacity L*k."""
    L = rootv.shape[0]
    P = comp.nparts
    topv, valid, xs, ys, mv = argmax_ops._root_seeds(rootv, rooti, thresh,
                                                     k, true_sizes)
    li = torch.arange(L, device=rootv.device)[:, None]
    xv = [xs] + [None] * (P - 1)
    yv = [ys] + [None] * (P - 1)
    mvv = [mv] + [None] * (P - 1)
    for p in range(1, P):
        par = parents[p]
        step = float(2 ** (pscales[p] - pscales[par]))
        w = comp.defw[p]                               # (M, 4)
        anc = comp.anchor[p].to(torch.float32)         # (M, 2)
        pxf = xv[par].to(torch.float32) * step         # (L, K)
        pyf = yv[par].to(torch.float32) * step
        py = yv[par].long()

        # winning child mixture: the strided DT value at (py, px) per
        # mc, from the y-pass maxima row at parent y
        line = tmps[p][li, :, py].transpose(1, 2)      # (L, M, K, Wc)
        sdt_at, _ = _dt_vals_at(
            line, w[:, 0][None, :, None], w[:, 1][None, :, None],
            pxf[:, None, :], anc[:, 0][None, :, None])  # (L, M, K)
        weighted = sdt_at + comp.bias[p][:, mvv[par].long()].transpose(0, 1)
        mc = _argmax_first(weighted, 1)                # (L, K)
        mcl = mc.long()
        wm, am = w[mcl], anc[mcl]                      # (L, K, 4), (L, K, 2)

        # x from the y-pass row at (mc, parent y)
        row = tmps[p][li, mcl, py]                     # (L, K, Wc)
        _, cx = _dt_vals_at(row, wm[..., 0], wm[..., 1], pxf, am[..., 0])
        # y from the accumulated child-score column at cx
        col = scores[p][li, mcl, :, cx.long()]         # (L, K, Hc)
        _, cy = _dt_vals_at(col, wm[..., 2], wm[..., 3], pyf, am[..., 1])
        xv[p], yv[p], mvv[p] = cx, cy, mc

    X, Y, Mm = (torch.stack(v, dim=1) for v in (xv, yv, mvv))  # (L, P, K)
    return argmax_ops._walked_candidates(X, Y, Mm, topv, valid, comp,
                                         part_scales, k, component_index,
                                         levels, width)


def _multires_walks(per_bucket, packed: PackedModel, k_per_level: int,
                    part_masks=None, slot0: int = 0
                    ) -> List[Tuple[int, Optional[argmax_ops.Candidates]]]:
    """The cross-octave DP and walk of every root bucket o >= smax and
    component c, in (o, c) order: [(c, Candidates of capacity L_o * k)].

    per_bucket entries may hold a slot range of their bucket: every
    entry's slots start at slot ``slot0`` of its bucket, and entry b
    holds L_b of them (tsizes' length; parallel/scale_sharded splits
    the slots so).  A root bucket with L_o = 0 gives None in place of
    Candidates, and its responses (None there) are never read: bucket
    lengths never grow with the octave, so a root's finer buckets hold
    at least its slots."""
    smax = max((max(sc) for sc in packed.scale_static), default=0)
    out = []
    for o in range(smax, len(per_bucket)):
        bkt, _, tsizes_o, _ = per_bucket[o]
        L = tsizes_o.shape[0]
        levels = (torch.arange(L, dtype=torch.int32, device=tsizes_o.device)
                  + bkt.levels[0].index + slot0)
        for c, comp in enumerate(packed.components):
            if L == 0:
                out.append((c, None))
                continue
            pscales = packed.scale_static[c]
            parents = packed.parent_static[c]
            rootv, rooti, scores, tmps = _dp_multires(
                per_bucket, o, L, comp, pscales, parents, part_masks)
            # per-part pixel stride at each slot: the scales of the
            # part's own bucket, sliced to this bucket's levels
            pscl = torch.stack([per_bucket[o - pscales[p]][3][:L]
                                for p in range(comp.nparts)], dim=1)
            out.append((c, _walk_levels(
                rootv, rooti, scores, tmps, comp, pscales, parents,
                packed.thresh, tsizes_o, pscl, k_per_level, c,
                packed.maxparts, levels)))
    return out


class MultiResDetector(DetectorFacade):
    """Facade for multi-resolution models (parts at a finer octave than
    their parent, anchor ds > 0); also valid for single-resolution
    models, where it gives the Matlab-mode semantics (the same values as
    Detector; argmax ties may differ).  Its program takes one frame at a
    time: a batch's frames run in turn.

    >>> det = MultiResDetector(model)         # CUDA; device="cpu" for CPU
    >>> detections = det.detect(image)
    """

    multires = True

    def _pack(self, model: PartsModel) -> PackedModel:
        packed = super()._pack(model)
        if any(c.aliased for c in packed.components):
            # the multi-resolution DP keys accumulation by (part, level);
            # filter-id buffer aliasing (ncscores,
            # include/Parts.hpp:165-168) with cross-octave slots has no
            # reference semantics to match (the C++ port dropped
            # multires, the Matlab path never shares filters within a
            # component)
            raise NotImplementedError(
                "multi-resolution models with shared filter ids within "
                "a component are not supported")
        return packed

    def _program(self, frames: torch.Tensor, depths=None, part_masks=None,
                 stage: StageTimer = profiling.stage, packed=None,
                 pdfs_transform=None) -> argmax_ops.Candidates:
        """DetectorFacade._program, one frame at a time."""
        return frame_by_frame(super()._program, frames, depths, part_masks,
                              stage, packed, pdfs_transform)

    def _stage34(self, per_bucket, part_masks=None,
                 stage: StageTimer = profiling.stage
                 ) -> argmax_ops.Candidates:
        """Stages 3-4 on one frame's pyramid_pdfs entries (B = 1): per
        root bucket and component the cross-octave DP and walk, then one
        stable sort; Candidates (1, nlevels*k, ...).  part_masks:
        optional per-bucket (L_b, P, fh_b, fw_b) bool masks (see
        _dp_multires).  The walk is plain torch and has no stage hooks."""
        walks = _multires_walks([(b, p[0], t, s) for b, p, t, s in per_bucket],
                                self.packed, self.k_per_level, part_masks)
        return argmax_ops.sort_candidates(argmax_ops.concat_candidates(
            [c for _, c in walks])).map(lambda x: x[None])


def detector_for(model: PartsModel, *, k_per_level: int = 64,
                 compose: str = "reference", dp_split: Optional[int] = None,
                 depth_prune: Optional[DepthPrune] = None,
                 conv_engine: str = "spatial", walk_impl: str = "auto",
                 device=None) -> DetectorFacade:
    """The one-device facade for a model and its knobs: MultiResDetector
    for a multi-resolution model, whose walk is plain torch in the
    Matlab composition, so ``compose``, ``dp_split`` and ``walk_impl``
    do not apply to it; else Detector."""
    if model.max_scale() > 0:
        return MultiResDetector(model, k_per_level=k_per_level,
                                depth_prune=depth_prune,
                                conv_engine=conv_engine, device=device)
    return Detector(model, k_per_level=k_per_level, compose=compose,
                    dp_split=dp_split, depth_prune=depth_prune,
                    conv_engine=conv_engine, walk_impl=walk_impl,
                    device=device)
