"""Candidate extraction and backtracking.

Port of partsbaseddetector_tpu/ops/argmax.py: a deterministic fixed-K
top-K of root positions per (level, component) replaces the
reference's unbounded ``Math::find`` + push_back (reference:
src/DynamicProgram.cpp:189-255), followed by the root-to-leaf walk.

Ties follow the JAX package: its ``lax.top_k`` lists the lower index
first among equal values and its ``argsort`` is stable, so both become
``torch.sort(..., stable=True)`` (``torch.topk`` orders ties
differently).  Indices come back int32, as under JAX's default 32-bit
mode.

Box arithmetic replicates the reference exactly:
  xy1 = round((pt - 1) * scale),  xy2 = xy1 + round(size * scale) - 1
(reference: src/DynamicProgram.cpp:238-244; cvRound = half-to-even),
with xsize == ysize == filter rows (include/Parts.hpp:185-187).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from partsbaseddetector_tpu_torch.models.part_tree import PackedComponent
from partsbaseddetector_tpu_torch.ops.common import cv_round
from partsbaseddetector_tpu_torch.ops.dp import DPResult, _inbounds
from partsbaseddetector_tpu_torch.ops.walk import walk_tree, walk_tree_plain
from partsbaseddetector_tpu_torch.utils import profiling

_FIELDS = ("score", "valid", "component", "level", "boxes", "loc")

#: walk_impl -> walk; "cuda" is the kernel's wrapper, which runs the
#: plain version for CPU tensors
WALKS = {"cuda": walk_tree, "torch": walk_tree_plain}


@dataclasses.dataclass(frozen=True)
class Candidates:
    """A fixed-capacity batch of detection candidates (SoA); every field
    shares the leading (..., N) axes.  P is the most parts of a
    component (PackedModel.maxparts): a component of fewer parts fills
    its rows past them with padding, loc -1 and boxes 0, and sets
    ``padded``, a host flag that tells the part-walking consumers
    (ops/nms.py) to skip such rows."""

    score: torch.Tensor      # (..., N) f32 root confidence
    valid: torch.Tensor      # (..., N) bool (score > thresh, in-bounds)
    component: torch.Tensor  # (..., N) int32
    level: torch.Tensor      # (..., N) int32 pyramid level index
    boxes: torch.Tensor      # (..., N, P, 4) f32: x1, y1, x2, y2 (pixels)
    loc: torch.Tensor        # (..., N, P, 3) int32: x, y, mixture (cells)
    padded: bool = False     # some candidate has padded part rows

    @property
    def capacity(self) -> int:
        return self.score.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(-1)

    def map(self, fn) -> "Candidates":
        """Apply fn to every field."""
        return Candidates(**{f: fn(getattr(self, f)) for f in _FIELDS},
                          padded=self.padded)

    def own_rows(self) -> Optional[torch.Tensor]:
        """(..., N, P) bool, the rows that hold a part and not padding;
        None when every row does (not ``padded``)."""
        return self.loc[..., 0] >= 0 if self.padded else None


def _root_seeds(rootv: torch.Tensor, rooti: torch.Tensor, thresh, k: int,
                true_size=None):
    """Top-k root positions per level: rootv/rooti (L, H, W);
    true_size: optional (L, 2).  Returns (topv, valid, xs, ys, mv), each
    (L, k); xs/ys/mv int32."""
    L, H, W = rootv.shape
    dev = rootv.device
    if true_size is not None:
        rootv = torch.where(
            _inbounds(H, W, torch.as_tensor(true_size, device=dev)), rootv,
            -torch.inf)
    k_eff = min(k, H * W)
    flat = rootv.reshape(L, H * W)
    # lax.top_k ranks floats in their total order (-0.0 below +0.0):
    # sort the order-preserving int32 image of the bits instead
    bits = flat.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    topi = torch.sort(key, dim=1, descending=True, stable=True)[1]
    topi = topi[:, :k_eff]
    topv = torch.gather(flat, 1, topi)
    if k_eff < k:   # pad to fixed capacity with invalid entries
        topv = torch.cat([topv, topv.new_full((L, k - k_eff), -torch.inf)],
                         dim=1)
        topi = torch.cat([topi, topi.new_zeros((L, k - k_eff))], dim=1)
    ys = topi // W
    xs = topi % W
    mv = rooti[torch.arange(L, device=dev)[:, None], ys, xs]
    return (topv, topv > thresh, xs.to(torch.int32), ys.to(torch.int32),
            mv.to(torch.int32))


def _walked_candidates(X, Y, Mm, topv, valid, comp: PackedComponent,
                       scales, k: int, component_index: int,
                       levels, width: int) -> Candidates:
    """Assemble the flat Candidates from walked positions.
    X/Y/Mm: (L, P, K); topv/valid: (L, K); levels: (L,); scales: pixels
    per cell, (L,) or per part (L, P) (multi-resolution models); width:
    the part rows of the model's candidates (PackedModel.maxparts), the
    rows past P padded with loc -1 and boxes 0 and counted in the
    tracer's ``parts.padded``.  Returns capacity L*k."""
    L, P, K = X.shape
    pad = width - P
    profiling.count("parts.padded", L * K * pad)
    X = X.transpose(1, 2)               # (L, K, P)
    Y = Y.transpose(1, 2)
    Mm = Mm.transpose(1, 2)
    scale = torch.as_tensor(scales, dtype=torch.float32,
                            device=X.device).reshape(L, 1, -1)
    parts = torch.arange(P, device=X.device)[None, None, :]
    sizes = comp.fsize[parts, Mm.long()]                  # (L, K, P)
    x1 = cv_round((X - 1) * scale)
    y1 = cv_round((Y - 1) * scale)
    ext = cv_round(sizes * scale)
    boxes = torch.stack([x1, y1, x1 + ext - 1, y1 + ext - 1], dim=-1)
    loc = torch.stack([X, Y, Mm], dim=-1).to(torch.int32)
    boxes = boxes.to(torch.float32)
    if pad:
        loc = F.pad(loc, (0, 0, 0, pad), value=-1)
        boxes = F.pad(boxes, (0, 0, 0, pad))
    levels = torch.as_tensor(levels, dtype=torch.int32, device=X.device)
    out = Candidates(
        score=topv.to(torch.float32),
        valid=valid,
        component=torch.full((L, K), component_index, dtype=torch.int32,
                             device=X.device),
        level=levels[:, None].expand(L, K),
        boxes=boxes, loc=loc, padded=pad > 0)
    return out.map(lambda x: x.reshape((L * k,) + x.shape[2:]))


def backtrack_levels(res: DPResult, comp: PackedComponent,
                     parent_static: Sequence[int], thresh,
                     scales, k: int, true_sizes=None,
                     component_index: int = 0, level_offset: int = 0,
                     compose: str = "reference",
                     walk_impl: str = "auto") -> Candidates:
    """Backtracking over a leading levels axis, returning a flat
    Candidates of capacity L*k.

    parent_static: the component's tree, comp.parent_static (the JAX
    package's signature; the walk reads comp.parent_host).
    walk_impl: "cuda" (the fused walk kernel, ops/walk.walk_tree — on a
    CPU tensor it runs its plain version), "torch" (the plain walk,
    ops/walk.walk_tree_plain) or "auto" ("cuda" on a CUDA device,
    "torch" on the CPU).  The two are bit-identical."""
    if walk_impl == "auto":
        walk_impl = "cuda" if res.rootv.is_cuda else "torch"
    if walk_impl not in WALKS:
        raise ValueError(f"walk_impl {walk_impl!r}; one of "
                         f"{sorted(WALKS)} or 'auto'")
    L = res.rootv.shape[0]
    dev = res.rootv.device
    levels = torch.arange(L, dtype=torch.int32, device=dev) + level_offset
    topv, valid, xs, ys, mv = _root_seeds(res.rootv, res.rooti, thresh, k,
                                          true_sizes)
    X, Y, Mm = WALKS[walk_impl](
        res.scores, res.tmp, xs, ys, mv, comp.defw,
        comp.anchor.to(torch.float32), comp.bias, comp.parent_host,
        compose)
    return _walked_candidates(X, Y, Mm, topv, valid, comp, scales, k,
                              component_index, levels, comp.nparts)


def backtrack(res: DPResult, comp: PackedComponent,
              parent_static: Sequence[int], thresh, scale, k: int,
              true_size=None, component_index: int = 0,
              level_index: int = 0,
              compose: str = "reference") -> Candidates:
    """Top-k root locations above thresh for ONE level (DPResult fields
    without the level axis), walked with the plain walk."""
    res1 = DPResult(*(f[None] for f in res))
    ts = None if true_size is None else \
        torch.as_tensor(true_size, device=res.rootv.device).reshape(1, 2)
    return backtrack_levels(res1, comp, parent_static, thresh, [scale], k,
                            ts, component_index, level_index, compose,
                            walk_impl="torch")


def concat_candidates(cands: Sequence[Candidates]) -> Candidates:
    """Concatenate along the candidate axis (the last of the leading
    axes)."""
    return Candidates(**{
        f: torch.cat([getattr(c, f) for c in cands],
                     dim=getattr(cands[0], "score").ndim - 1)
        for f in _FIELDS}, padded=any(c.padded for c in cands))


def stack_candidates(outs: Sequence[Candidates]) -> Candidates:
    """Per-frame Candidates stacked into one with a leading (B, ...)
    axis, field by field."""
    return Candidates(**{f: torch.stack([getattr(o, f) for o in outs])
                         for f in _FIELDS},
                      padded=any(o.padded for o in outs))


def sort_candidates(c: Candidates) -> Candidates:
    """Descending by score, invalid last (score of invalid forced to
    -inf for ordering), stable — the deterministic replacement for
    Candidate::sort (reference: include/Candidate.hpp:97-99)."""
    key = torch.where(c.valid, c.score, -torch.inf)
    order = torch.argsort(-key, dim=-1, stable=True)
    axis = order.ndim - 1

    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.ndim - order.ndim))
        return torch.take_along_dim(x, idx, dim=axis)
    return c.map(take)
