"""Stages 3-4 of the reference and the judge of a detector's output.

The model is a tree of parts, each with mixtures; a (part, mixture) has
a filter, a quadratic deformation (w0 dx^2 + w1 dx + w2 dy^2 + w3 dy
about an anchor) and a bias per parent mixture (Yang & Ramanan, CVPR
2011).  For every level, and the part's children already folded in,

  S[p]   = filter responses of p's mixtures + its children's messages
  tmp[p] = the x pass of S[p]'s max-transform, sdt[p] its y pass
  msg    = max over p's mixtures of sdt[p] + bias[p][mc, mp], added to
           S[parent] for each parent mixture mp

and a root position's score is max over root mixtures of S[0] + the root
bias.  The transform is the dense maximum over all source cells, as in
the reference C++ detector's generalized distance transform
(include/DistanceTransform.hpp:152-244), one level at its true size.

``judge`` holds a detector's candidates against these maps: each score
against the root map at its root cell, each step of the walk against the
best choice given the candidate's own parent placement, each level's
valid scores against the level's top-K, and each box against its
placement.  Every gap is how far the candidate's choice lies below the
reference's best, in score units.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port.reference import features
from bench_port.reference.plan import Level, pyramid

F32 = torch.float32


class Tree:
    """One component's part tree over the model's shared arrays.

    Filter, deformation and bias ids run part by part, mixture by
    mixture from f0 and b0: part p's mixture m has filter and
    deformation fid[p][m]; its biases over the parent's mixtures start
    at bid[p][m].  The root's mixtures have a bias each, but only the
    first counts: it is added to every root mixture
    (src/DynamicProgram.cpp:162-171)."""

    def __init__(self, parent: List[int], nmix: List[int], f0: int,
                 b0: int, defw: torch.Tensor, anchors: torch.Tensor,
                 biasw: torch.Tensor):
        self.parent, self.nmix = list(parent), list(nmix)
        self.fid, self.bid = [], []
        f, b = f0, b0
        for p, n in enumerate(self.nmix):
            self.fid.append(list(range(f, f + n)))
            f += n
            step = 1 if p == 0 else self.nmix[self.parent[p]]
            self.bid.append([b + i * step for i in range(n)])
            b += n * step
        self.f_end, self.b_end = f, b
        self.root_bias = biasw[self.bid[0][0]]
        dev = defw.device
        self.fid_t = [torch.tensor(ids, device=dev) for ids in self.fid]
        self._parts = []
        for p, ids in enumerate(self.fid_t):
            bias = None if p == 0 else torch.stack(
                [biasw[o:o + self.nmix[self.parent[p]]]
                 for o in self.bid[p]])
            self._parts.append((defw[ids], anchors[ids].to(F32), bias))

    @property
    def nparts(self) -> int:
        return len(self.parent)

    def part(self, p: int):
        """(w (M, 4), anchor (M, 2) float32, bias (M, Mparent) or None)
        of part p."""
        return self._parts[p]


@dataclasses.dataclass
class Model:
    """The arrays the benchmark makes from the seed, on one device.

    trees: (parent (P,), nmix (P,)) of each component; filters (F, fh,
    fw, C); defw (F, 4); anchors (F, 2); biasw (nb,).  Ids run
    component by component (``Tree``)."""

    trees: List[Tuple[List[int], List[int]]]
    filters: torch.Tensor
    defw: torch.Tensor
    anchors: torch.Tensor
    biasw: torch.Tensor
    binsize: int
    interval: int
    norient: int
    flen: int
    thresh: float

    def __post_init__(self):
        self.components: List[Tree] = []
        f = b = 0
        for parent, nmix in self.trees:
            t = Tree(parent, nmix, f, b, self.defw, self.anchors,
                     self.biasw)
            self.components.append(t)
            f, b = t.f_end, t.b_end
        assert f == self.filters.shape[0] and b == self.biasw.shape[0]

    @property
    def maxparts(self) -> int:
        return max(t.nparts for t in self.components)


def _pen(d: torch.Tensor, a, b) -> torch.Tensor:
    """The deformation reward -a d^2 - b d."""
    return -a * d * d - b * d


def _xpass(s: torch.Tensor, w0, w1, ax) -> torch.Tensor:
    """out[m, y, q] = max_c s[m, y, c] - w0 d^2 - w1 d, d = q + ax - c."""
    n = s.shape[-1]
    q = torch.arange(n, dtype=F32, device=s.device)[None, :]
    c = torch.arange(n, dtype=F32, device=s.device)[:, None]
    d = q + ax[:, None, None] - c                      # (M, c, q)
    pen = _pen(d, w0[:, None, None], w1[:, None, None])
    return (s[..., :, :, None] + pen[:, None]).amax(dim=-2)


def _ypass(s: torch.Tensor, w2, w3, ay) -> torch.Tensor:
    """out[m, p, x] = max_c s[m, c, x] - w2 d^2 - w3 d, d = p + ay - c."""
    h = s.shape[-2]
    p = torch.arange(h, dtype=F32, device=s.device)[:, None]
    c = torch.arange(h, dtype=F32, device=s.device)[None, :]
    d = p + ay[:, None, None] - c                      # (M, p, c)
    pen = _pen(d, w2[:, None, None], w3[:, None, None])
    return (s[:, None, :, :] + pen[..., None]).amax(dim=-2)


@dataclasses.dataclass
class LevelMaps:
    S: List[torch.Tensor]       # per part (M_p, h, w)
    tmp: List[Optional[torch.Tensor]]   # per part (M_p, h, w); root None
    rootw: torch.Tensor         # (M_0, h, w) root scores per mixture
    rootv: torch.Tensor         # (h, w)


def dp_level(resp: torch.Tensor, tree: Tree) -> LevelMaps:
    """One component's DP of one level from its (F, h, w) responses."""
    P = tree.nparts
    S = [resp[tree.fid_t[p]] for p in range(P)]
    tmp: List[Optional[torch.Tensor]] = [None] * P
    for p in range(P - 1, 0, -1):
        w, anc, bias = tree.part(p)
        tmp[p] = _xpass(S[p], w[:, 0], w[:, 1], anc[:, 0])
        sdt = _ypass(tmp[p], w[:, 2], w[:, 3], anc[:, 1])
        q = tree.parent[p]
        msg = (sdt[:, None] + bias[:, :, None, None]).amax(dim=0)
        S[q] = S[q] + msg
    rootw = S[0] + tree.root_bias
    return LevelMaps(S, tmp, rootw, rootw.amax(dim=0))


def depth_prune(maps_resp: torch.Tensor, depth: torch.Tensor, lvl: Level,
                part_width_m: float, fx: float, tol: float) -> torch.Tensor:
    """Responses (F, h, w) with every cell whose depth (metres, 0 =
    unknown) lies more than tol * z from z = fx * part_width / scale set
    to -1e30: a part of that width is not that size at that depth."""
    dh, dw = depth.shape
    h, w = lvl.featsize
    ys = np.clip(((np.arange(h) + 0.5) * dh / max(h, 1)).astype(np.int64),
                 0, dh - 1)
    xs = np.clip(((np.arange(w) + 0.5) * dw / max(w, 1)).astype(np.int64),
                 0, dw - 1)
    dev = maps_resp.device
    d = depth[torch.as_tensor(ys, device=dev)][:, torch.as_tensor(
        xs, device=dev)]
    z = fx * part_width_m / float(lvl.scale)
    z32 = torch.tensor(z, dtype=F32, device=dev)
    lim = torch.tensor(tol * z, dtype=F32, device=dev)
    bad = (d > 0) & ((d - z32).abs() > lim)
    return torch.where(bad, torch.tensor(-1e30, dtype=F32, device=dev),
                       maps_resp)


def frame_maps(frame: torch.Tensor, model: Model, tf32: bool = False,
               depth: Optional[torch.Tensor] = None, prune=None):
    """(levels, maps) of one (H, W, C) frame, maps[c][l] the LevelMaps
    of component c at level l; depth + prune = (part_width_m, fx, tol)
    masks implausible cells first."""
    levels = pyramid(tuple(frame.shape[:2]), model.binsize, model.interval)
    resp = features.level_responses(frame, levels, model.filters,
                                    model.binsize, model.interval,
                                    model.norient, model.flen, tf32)
    if depth is not None and prune is not None:
        resp = [depth_prune(r, depth, lvl, *prune)
                for r, lvl in zip(resp, levels)]
    return levels, [[dp_level(r, t) for r in resp]
                    for t in model.components]


# ------------------------------------------------------------ candidates
def boxes_of(loc: np.ndarray, scale: float, fsize: np.ndarray
             ) -> np.ndarray:
    """(n, P, 4) float32 part boxes of (n, P, 3) placements (x, y, m) at
    one level: x1 = round((x - 1) * scale), x2 = x1 + round(size *
    scale) - 1, half to even (src/DynamicProgram.cpp:238-244)."""
    s = np.float32(scale)
    x1 = np.rint((loc[..., 0] - 1).astype(np.float32) * s)
    y1 = np.rint((loc[..., 1] - 1).astype(np.float32) * s)
    ext = np.rint(fsize.astype(np.float32) * s)
    return np.stack([x1, y1, x1 + ext - 1, y1 + ext - 1],
                    axis=-1).astype(np.float32)


def part_sizes(model: Model, loc: np.ndarray) -> np.ndarray:
    """(n, P) filter rows of each part's chosen mixture (every filter
    has the same size)."""
    rows = model.filters.shape[1]
    return np.full(loc.shape[:-1], rows, np.int64)


def walk(maps: LevelMaps, tree: Tree, k: int):
    """The top-k root cells of one level and the walk from each: loc
    (k_eff, P, 3) int64 and scores (k_eff,), best first, ties in cell
    order.  The child's mixture is the best given the parent's cell;
    its x is the best on the row of S at the parent's y, its y the best
    on the x pass's column at that x (the C++ detector's composition of
    the two passes' argmax tables, include/DistanceTransform.hpp:
    233-244)."""
    w = maps.rootv.shape[1]
    ke = min(k, maps.rootv.numel())
    order = torch.sort(maps.rootv.reshape(-1), descending=True,
                       stable=True)[1][:ke]
    score = maps.rootv.reshape(-1)[order]
    X = [order % w]
    Y = [order // w]
    Mx = [torch.argmax(maps.rootw[:, Y[0], X[0]], dim=0)]
    for p in range(1, tree.nparts):
        q = tree.parent[p]
        mc, x, y = _best_child(maps, tree, p, X[q], Y[q], Mx[q])
        X.append(x)
        Y.append(y)
        Mx.append(mc)
    loc = torch.stack([torch.stack(X, 1), torch.stack(Y, 1),
                       torch.stack(Mx, 1)], dim=-1)
    return loc, score


def _line_vals(line: torch.Tensor, a, b, pos) -> torch.Tensor:
    """line[..., c] - a d^2 - b d with d = pos - c, over the last axis."""
    c = torch.arange(line.shape[-1], dtype=F32, device=line.device)
    d = pos.to(F32)[..., None] - c
    return line + _pen(d, a[..., None], b[..., None])


def _child_terms(maps: LevelMaps, tree: Tree, p: int, xq, yq, mq):
    """For parents at (xq, yq, mq) (n,): the child mixture values
    (M, n) and the part's deformation and tables."""
    w, anc, bias = tree.part(p)
    tmp = maps.tmp[p]
    col = tmp[:, :, xq].permute(0, 2, 1)              # (M, n, h)
    sdt = _line_vals(col, w[:, 2, None], w[:, 3, None],
                     yq[None] + anc[:, 1, None]).amax(-1)
    return sdt + bias[:, mq], w, anc


def _best_child(maps, tree, p, xq, yq, mq):
    weighted, w, anc = _child_terms(maps, tree, p, xq, yq, mq)
    mc = torch.argmax(weighted, dim=0)
    row = maps.S[p][mc, yq]                            # (n, w)
    x = torch.argmax(_line_vals(row, w[mc, 0], w[mc, 1],
                                xq + anc[mc, 0]), dim=-1)
    col = maps.tmp[p][mc, :, x]                        # (n, h)
    y = torch.argmax(_line_vals(col, w[mc, 2], w[mc, 3],
                                yq + anc[mc, 1]), dim=-1)
    return mc, x, y


def _padded(a: np.ndarray, P: int, fill) -> np.ndarray:
    """(n, p, ...) -> (n, P, ...), parts past p set to fill."""
    if a.shape[1] == P:
        return a
    out = np.full((a.shape[0], P) + a.shape[2:], fill, a.dtype)
    out[:, :a.shape[1]] = a
    return out


def candidates(levels, maps, model: Model, k: int,
               thresh: float) -> Dict[str, np.ndarray]:
    """One frame's valid candidates, best first: score (n,), level (n,),
    component (n,), boxes (n, P, 4), loc (n, P, 3), P the most parts of
    a component (a smaller tree's rows padded: loc -1, boxes 0)."""
    out = {"score": [], "level": [], "component": [], "loc": [],
           "boxes": []}
    P = model.maxparts
    for c, tree in enumerate(model.components):
        for lvl, m in zip(levels, maps[c]):
            loc, score = walk(m, tree, k)
            keep = score > thresh
            loc = loc[keep].cpu().numpy()
            out["score"].append(score[keep].cpu().numpy())
            out["level"].append(np.full(len(loc), lvl.index))
            out["component"].append(np.full(len(loc), c, np.int64))
            out["loc"].append(_padded(loc, P, -1))
            out["boxes"].append(_padded(
                boxes_of(loc, lvl.scale, part_sizes(model, loc)), P, 0))
    cat = {key: np.concatenate(v) for key, v in out.items()}
    order = np.argsort(-cat["score"], kind="stable")
    return {key: v[order] for key, v in cat.items()}


# ------------------------------------------------------------------ judge
BIG = 1e30
#: a score gap above this is more than float32 rounding: a feature cell
#: whose orientation bin flipped on a one-ulp change of the resized
#: image, or a lower precision
OFF = 1e-4


def judge(levels: List[Level], maps, model: Model,
          dets: Dict[str, np.ndarray], k: int, thresh: float
          ) -> Dict[str, float]:
    """Gaps of one frame's valid candidates (``candidates``' layout)
    against the reference maps (``frame_maps``').  score_gap: |score -
    the root map at its root cell|; off_scores: how many of those exceed
    OFF (the share is taken over the frames judged); walk_gap: the
    largest amount by which a chosen root mixture, child mixture, x or y
    lies below the best choice given the candidate's own parent
    placement; topk_gap: per level and component, the valid scores
    against the top-k root values above thresh, in order, an unmatched
    value counting its distance to thresh; box_mismatch: candidates
    whose boxes are not those of their placements; order_mismatch:
    neighbours out of score order or a component the model lacks."""
    score = np.asarray(dets["score"], np.float64)
    level = np.asarray(dets["level"], np.int64)
    comp = np.asarray(dets["component"], np.int64)
    loc = np.asarray(dets["loc"], np.int64)
    boxes = np.asarray(dets["boxes"], np.float32)
    C = len(model.components)
    out = dict(score_gap=0.0, off_scores=0.0, scores=float(len(score)),
               walk_gap=0.0, topk_gap=0.0, box_mismatch=0.0,
               order_mismatch=float(np.sum(score[1:] > score[:-1])
                                    + np.sum((comp < 0) | (comp >= C))))
    if len(score) and (level.min() < 0 or level.max() >= len(levels)):
        out["score_gap"] = BIG
        return out
    for c, tree in enumerate(model.components):
        _judge_tree(out, levels, maps[c], model, tree, score[comp == c],
                    level[comp == c], loc[comp == c], boxes[comp == c], k,
                    thresh)
    return out


def _judge_tree(out, levels, maps, model, tree, score, level, loc, boxes,
                k, thresh) -> None:
    P = tree.nparts
    if len(loc) and loc.shape[1] < P:
        out["walk_gap"] = BIG
        return
    loc, boxes = loc[:, :P], boxes[:, :P]
    for li, (lvl, m) in enumerate(zip(levels, maps)):
        sel = np.nonzero(level == li)[0]
        h, w = m.rootv.shape
        ref = torch.sort(m.rootv.reshape(-1), descending=True)[0][:k]
        ref = ref[ref > thresh].double().cpu().numpy()
        mine = np.sort(score[sel])[::-1]
        n = min(len(ref), len(mine))
        gaps = [np.abs(ref[:n] - mine[:n]),
                np.abs(ref[n:] - thresh), np.abs(mine[n:] - thresh)]
        out["topk_gap"] = max(out["topk_gap"],
                              max((g.max() for g in gaps if len(g)),
                                  default=0.0))
        if not len(sel):
            continue
        L = loc[sel]
        if (L[..., 0].min() < 0 or L[..., 0].max() >= w
                or L[..., 1].min() < 0 or L[..., 1].max() >= h
                or L[..., 2].min() < 0
                or any(L[:, p, 2].max() >= tree.nmix[p]
                       for p in range(P))):
            out["walk_gap"] = BIG
            continue
        expect = boxes_of(L, lvl.scale, part_sizes(model, L))
        out["box_mismatch"] += float(np.sum(
            np.any(expect != boxes[sel], axis=(1, 2))))
        t = torch.as_tensor(L, device=m.rootv.device)
        X, Y, Mx = t[..., 0], t[..., 1], t[..., 2]
        rv = m.rootv[Y[:, 0], X[:, 0]]
        sg = (rv.double() - torch.as_tensor(score[sel], device=rv.device)
              ).abs()
        out["score_gap"] = max(out["score_gap"], float(sg.max()))
        out["off_scores"] += float((sg > OFF).sum())
        gaps = [(rv - m.rootw[Mx[:, 0], Y[:, 0], X[:, 0]]).max()]
        ar = torch.arange(len(sel), device=rv.device)
        for p in range(1, P):
            q = tree.parent[p]
            weighted, wp, anc = _child_terms(m, tree, p, X[:, q], Y[:, q],
                                             Mx[:, q])
            mc = Mx[:, p]
            gaps.append((weighted.amax(0) - weighted[mc, ar]).max())
            vx = _line_vals(m.S[p][mc, Y[:, q]], wp[mc, 0], wp[mc, 1],
                            X[:, q] + anc[mc, 0])
            gaps.append((vx.amax(-1) - vx[ar, X[:, p]]).max())
            vy = _line_vals(m.tmp[p][mc, :, X[:, p]], wp[mc, 2], wp[mc, 3],
                            Y[:, q] + anc[mc, 1])
            gaps.append((vy.amax(-1) - vy[ar, Y[:, p]]).max())
        worst = float(torch.stack(gaps).max())
        out["walk_gap"] = max(out["walk_gap"], worst)
