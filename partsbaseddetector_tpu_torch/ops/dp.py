"""Min-sum dynamic program over the part tree, levels as a batch axis.

Port of partsbaseddetector_tpu/ops/dp.py: the DP keyed by part slot,
and the filter-keyed DP for components with shared filter ids
(``_dp_min_aliased``).  The reference's per-(scale, component) loop
(reference: src/DynamicProgram.cpp:66-173) becomes a Python loop over
parts in reverse topological order, P-1 down to 1 — the order of the JAX
package's ``lax.scan`` — with every level of a group as one batch axis.
Parts are stored root-first with parent < child, so the loop visits
children before parents.

As in the JAX package, the forward pass computes only maxima:
  scores[p] — each part's fully accumulated DT input, and
  tmp[p]    — the x-pass row maxima,
and backtracking recomputes the argmaxes at the K visited positions
(``walk_children`` below; the fused form is the CUDA kernel in
ops/walk.py).  Padded mixture slots carry NEG so they never win.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partsbaseddetector_tpu_torch.models.part_tree import PackedComponent
from partsbaseddetector_tpu_torch.ops.common import NEG
from partsbaseddetector_tpu_torch.ops.dt import dt_max_x, dt_max_y


class DPResult(NamedTuple):
    rootv: torch.Tensor    # (L, H, W) root score map (bias added, maxed)
    rooti: torch.Tensor    # (L, H, W) int32 best root mixture
    scores: torch.Tensor   # (L, P, M, H, W) accumulated DT inputs per part
    tmp: torch.Tensor      # (L, P, M, H, W) x-pass maxima (part 0: zero),
    #                        stored W-minor: tmp.transpose(-1, -2) is
    #                        contiguous


def _inbounds(H: int, W: int, true_size: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool: True inside each (h, w) valid extent;
    true_size (..., 2)."""
    dev = true_size.device
    h = true_size[..., 0, None, None]
    w = true_size[..., 1, None, None]
    return ((torch.arange(H, device=dev)[:, None] < h)
            & (torch.arange(W, device=dev)[None, :] < w))


def dp_min_levels(pdfs: torch.Tensor, comp: PackedComponent,
                  compose: str = "reference", part_masks=None,
                  true_sizes=None) -> DPResult:
    """The DP for one component over a batch of levels.

    pdfs: (L, H, W, F) filter responses for ALL model filters (the
    output of ops.conv.conv_bank), keyed by filter id like the reference
    (include/Parts.hpp:165-168).  true_sizes: optional (L, 2) valid
    (h, w) extents; cells beyond them are masked to NEG in the scores0
    construction, value-identical to pre-masked pdfs.  part_masks:
    optional (L, P, H, W) bool allowed part placements (the masked
    latent search; the reference's overlap masking,
    matlab/detection/detect.m:60-101): every other placement is NEG.
    Components with shared filter ids run the filter-keyed DP
    (``_dp_min_aliased``)."""
    if compose not in ("reference", "correct"):
        raise ValueError(compose)
    P, M = comp.filterid.shape
    L, H, W = pdfs.shape[:3]
    pdfs_f = pdfs.movedim(-1, 1)                       # (L, F, H, W)
    # where a cell may hold a part placement, per (level, part)
    allowed = None
    if true_sizes is not None:
        ts = torch.as_tensor(true_sizes, dtype=torch.int32,
                             device=pdfs.device)
        allowed = _inbounds(H, W, ts)[:, None]         # (L, 1, H, W)
    if part_masks is not None:
        pm = torch.as_tensor(part_masks, dtype=torch.bool,
                             device=pdfs.device)
        allowed = pm if allowed is None else allowed & pm
    if comp.aliased:
        scores, tmp, root_s = _dp_min_aliased(pdfs_f, comp, allowed)
        # as the JAX package's aliased scan: the root bias added to every
        # root slot, padded ones included
        rootw = root_s + comp.root_bias
    else:
        scores, tmp = _dp_min_part_keyed(pdfs_f, comp, allowed)
        # root: add the scalar root bias to every root mixture and max
        # (reference: src/DynamicProgram.cpp:162-171)
        rootw = scores[:, 0] + comp.root_bias          # (L, M, H, W)
        rootw = torch.where(comp.mix_valid[0][:, None, None], rootw, NEG)
    # stored W-minor, so that a column tmp[l, p, m, :, x] is contiguous
    # for the walk kernel (ops/walk.py): one permuted copy, which costs
    # the card less than x passes storing W-minor themselves
    tmp = tmp.transpose(-1, -2).contiguous().transpose(-1, -2)
    return DPResult(rootw.amax(dim=1), _argmax_first(rootw, 1), scores, tmp)


def _dp_min_part_keyed(pdfs_f: torch.Tensor, comp: PackedComponent,
                       allowed):
    """The DP keyed by part slot, for components whose filter ids are
    all distinct.  pdfs_f (L, F, H, W); allowed: None or a bool mask
    broadcasting to (L, P, H, W).  Returns (scores, tmp), each
    (L, P, M, H, W), tmp H-minor."""
    P = comp.filterid.shape[0]
    scores = pdfs_f[:, comp.filterid.long()]           # (L, P, M, H, W)
    # invalid mixture slots must never win any max
    keep = comp.mix_valid[None, :, :, None, None]
    if allowed is not None:
        keep = keep & allowed[:, :, None]
    scores = torch.where(keep, scores, NEG)

    parent = comp.parent.long()
    # every part's x-pass maxima, written in place; part 0 has none
    tmp = torch.empty_like(scores)
    tmp[:, 0].zero_()
    for p in range(P - 1, 0, -1):
        maxv = _part_message(scores[:, p], comp, p, tmp[:, p])
        scores.index_add_(1, parent[p:p + 1], maxv[:, None])
    return scores, tmp


def _part_message(s: torch.Tensor, comp: PackedComponent, p: int,
                  tmp_p: torch.Tensor) -> torch.Tensor:
    """Part p's message to its parent, shared by both DP branches: the
    DT of its scores s (L, M, H, W), x pass written into tmp_p, plus the
    child->parent mixture-pair bias, maxed over child mixtures.
    Returns (L, Mp, H, W)."""
    w = comp.defw[p]                                   # (M, 4)
    anc = comp.anchor[p]                               # (M, 2)
    dt_max_x(s, w[:, 0], w[:, 1], anc[:, 0], out=tmp_p)
    sdt = dt_max_y(tmp_p, w[:, 2], w[:, 3], anc[:, 1])
    weighted = sdt[:, None] + comp.bias[p].T[None, :, :, None, None]
    return weighted.amax(dim=2)


def _dp_min_aliased(pdfs_f: torch.Tensor, comp: PackedComponent, allowed):
    """The DP for components with shared filter ids (port of
    partsbaseddetector_tpu/ops/dp.py:_dp_min_aliased).

    The reference keys its scratch scores by FILTER ID (``ncscores``,
    src/DynamicProgram.cpp:93 with reads and writes at :115-118 and
    :152-155 through include/Parts.hpp:165-168), so (part, mixture)
    slots that share an id share one accumulation buffer.  A
    per-filter accumulator ``acc`` (L, F, H, W) reproduces it: part p
    reads pdf[fid] + acc[fid] when it is visited, and writes
    acc[fid[parent][mp]] += maxv[mp].  Each part's scores are its
    visit-time values, so the walk recomputes argmaxes against what the
    forward pass used.  Returns (scores, tmp, root scores (L, M, H, W))."""
    P, M = comp.filterid.shape
    L, F, H, W = pdfs_f.shape
    fid = comp.filterid.long()
    acc = torch.zeros_like(pdfs_f, memory_format=torch.contiguous_format)
    keep = comp.mix_valid[None, :, :, None, None]      # (1, P, M, 1, 1)
    if allowed is not None:
        keep = keep & allowed[:, :, None]              # (L, P|1, M, H, W)

    scores = torch.empty((L, P, M, H, W), dtype=pdfs_f.dtype,
                         device=pdfs_f.device)

    def read(p):
        """Part p's visit-time scores, written to scores[:, p]."""
        s = pdfs_f[:, fid[p]] + acc[:, fid[p]]         # (L, M, H, W)
        scores[:, p] = torch.where(keep[:, p], s, NEG)
        return scores[:, p]

    tmp = torch.empty_like(scores)
    tmp[:, 0].zero_()
    for p in range(P - 1, 0, -1):
        maxv = _part_message(read(p), comp, p, tmp[:, p])
        # one add per valid parent mixture, in mixture order, as the JAX
        # package's scatter-add applies shared ids; padded parent
        # mixtures repeat mixture 0's id and hold garbage: they are left
        # out, which equals the JAX package's add of zeros (acc starts at
        # +0.0 and never becomes -0.0)
        for mp, f in enumerate(comp.message_fids[p]):
            acc[:, f] += maxv[:, mp]
    return scores, tmp, read(0)


def dp_min(pdfs: torch.Tensor, comp: PackedComponent,
           compose: str = "reference", part_mask=None,
           true_size=None) -> DPResult:
    """The DP for one component on one (H, W, F) response map; fields
    come back without the level axis."""
    res = dp_min_levels(
        pdfs[None], comp, compose,
        None if part_mask is None else part_mask[None],
        None if true_size is None else
        torch.as_tensor(true_size, device=pdfs.device).reshape(1, 2))
    return DPResult(*(f[0] for f in res))


# ---------------------------------------------------------------------
# candidate-position argmax recomputation (used by ops/argmax.py and
# ops/walk.py's plain version)
# ---------------------------------------------------------------------

def _argmax_first(vals: torch.Tensor, dim: int) -> torch.Tensor:
    """First-index argmax (ties -> smallest index, like numpy)."""
    return torch.argmax(vals, dim=dim).to(torch.int32)


def _dt_vals_at(line: torch.Tensor, w2, w3, pos, off):
    """max/argmax over the last axis of line[c] - w2*d^2 - w3*d with
    d = pos + off - c.  line: (..., N); w2/w3/pos/off: line.shape[:-1]
    (or broadcastable).  Returns (max, argmax)."""
    n = line.shape[-1]
    c = torch.arange(n, dtype=torch.float32, device=line.device)
    d = (pos + off)[..., None] - c
    w2b = torch.as_tensor(w2, dtype=torch.float32)[..., None]
    w3b = torch.as_tensor(w3, dtype=torch.float32)[..., None]
    vals = line + (-w2b) * d * d + (-w3b) * d
    return vals.amax(dim=-1), _argmax_first(vals, -1)


def walk_children(scores_p: torch.Tensor, tmp_p: torch.Tensor,
                  w: torch.Tensor, anc: torch.Tensor, bias_p: torch.Tensor,
                  mp: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                  compose: str):
    """Backtracking step for one part p over a batch of levels: the
    child (x, y, mixture) given the parent's (mixture mp, y, x).

    Part p's slices are passed in: scores_p/tmp_p (L, M, H, W) are
    DPResult.scores[:, p] and .tmp[:, p]; w (M, 4), anc (M, 2) float and
    bias_p (Mc, Mp) are the component's defw[p], anchor[p] and bias[p];
    mp/py/px (L, K) int32.  Returns ((L, K) x, y, mc), int32.

    Recomputes, at the K positions only, the argmaxes the reference
    stored as full tables (src/DynamicProgram.cpp:110-151 +
    include/DistanceTransform.hpp:233-244): the child mixture, then the
    two 1-D DT argmaxes in the order of the compose mode."""
    L, K = px.shape
    M, H = tmp_p.shape[1:3]
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    li = torch.arange(L, device=px.device)[:, None]

    # -- winning child mixture: sdt(mc, py, px) for all mc.
    # tmp column at px: (L, M, H, K) -> (L, M, K, H)
    idx = px.long()[:, None, None, :].expand(L, M, H, K)
    line = torch.gather(tmp_p, 3, idx).transpose(-1, -2)
    sdt_at, _ = _dt_vals_at(
        line, w[:, 2][None, :, None], w[:, 3][None, :, None],
        pyf[:, None, :], anc[:, 1][None, :, None])     # (L, M, K)
    weighted = sdt_at + bias_p[:, mp.long()].permute(1, 0, 2)
    mc = _argmax_first(weighted, 1)                    # (L, K)
    mcl = mc.long()
    wm = w[mcl]                                        # (L, K, 4)
    am = anc[mcl]                                      # (L, K, 2)

    if compose == "reference":
        # x from the accumulated-score row at PARENT y (the reference's
        # DT compose quirk, include/DistanceTransform.hpp:233-244)
        row = scores_p[li, mcl, py.long()]             # (L, K, W)
        _, x = _dt_vals_at(row, wm[..., 0], wm[..., 1], pxf, am[..., 0])
        # y from the x-pass column at the composed x
        col = tmp_p[li, mcl, :, x.long()]              # (L, K, H)
        _, y = _dt_vals_at(col, wm[..., 2], wm[..., 3], pyf, am[..., 1])
    else:
        # y from the x-pass column at px, then x from the row at that y
        col = tmp_p[li, mcl, :, px.long()]
        _, y = _dt_vals_at(col, wm[..., 2], wm[..., 3], pyf, am[..., 1])
        row = scores_p[li, mcl, y.long()]
        _, x = _dt_vals_at(row, wm[..., 0], wm[..., 1], pxf, am[..., 0])
    return x, y, mc


def composed_tables(res: DPResult, comp: PackedComponent,
                    compose: str = "reference"):
    """Full (P, M, H, W) int32 Ix/Iy/Ik tables for one level's DPResult
    (dp_min's, fields without the level axis): for every part p > 0,
    parent mixture m and parent cell (y, x), the child's x, y and
    mixture as walk_children recomputes them (the port of
    partsbaseddetector_tpu/ops/dp.py:326-344; a test and debug helper,
    the reference a DP kernel's argmaxes are held to — no hot path
    builds these).  Part 0's rows stay zero."""
    P, M = comp.filterid.shape
    H, W = res.rootv.shape
    dev = res.rootv.device
    yy = torch.arange(H, dtype=torch.int32,
                      device=dev).repeat_interleave(W)[None]
    xx = torch.arange(W, dtype=torch.int32, device=dev).repeat(H)[None]
    anchor = comp.anchor.to(torch.float32)
    tables = torch.zeros((3, P, M, H, W), dtype=torch.int32, device=dev)
    for p in range(1, P):
        for m in range(M):
            x, y, mc = walk_children(
                res.scores[p][None], res.tmp[p][None], comp.defw[p],
                anchor[p], comp.bias[p], torch.full_like(yy, m), yy, xx,
                compose)
            for t, v in enumerate((x, y, mc)):
                tables[t, p, m] = v.reshape(H, W)
    return tables[0], tables[1], tables[2]
