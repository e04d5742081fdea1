"""Non-maximum suppression: the three mechanisms of the reference.

Port of partsbaseddetector_tpu/ops/nms.py:

  * grid_nms  — the local-maxima mask of a score map, the Neubeck & Van
                Gool block NMS (reference: src/nms.cpp:84-129): the
                elements strictly greater than every other element of
                their (2*sz+1)^2 window;
  * paint_nms — greedy candidate "paint" NMS over score-sorted
                candidates (reference: include/Candidate.hpp:277-304);
  * part_nms  — the Matlab per-part-box greedy suppression with the
                covering box appended (matlab/detection/nms.m:24-68).

The JAX package runs the two greedy passes as a ``fori_loop`` over all
K candidates.  Eager torch pays launches per step, so both loops here
step from one KEPT candidate to the next instead: a candidate's
decision depends only on the candidates kept before it, so between two
keeps every decision is read off one vectorized test against the state
the last keep left.  The answer is the sequential one, bit for bit; the
loop runs (kept + 1) times, each step reading one index back to the
host.  part_nms builds its pairwise overlaps in row blocks, so memory
stays O(K^2) bools rather than JAX's fused (K, K, P+1) floats.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from partsbaseddetector_tpu_torch.ops.argmax import Candidates

#: rows of part_nms's pairwise overlap computed at once: the block's
#: (rows, K, P+1) floats stay at ~40 MB for K = 2944, P+1 = 27
PART_NMS_ROWS = 128


def grid_nms(src: torch.Tensor, sz: int, mask=None) -> torch.Tensor:
    """Local-maxima mask of a 2-D score map.

    src: (H, W); sz: window radius (maxima end up at least sz+1 apart,
    as in the reference); mask: optional (H, W) bool of eligible
    elements.  Returns (H, W) bool; a constant map has no maxima
    (src/nms.cpp:55-56)."""
    if mask is not None:
        src = torch.where(mask, src, -torch.inf)
    win = 2 * sz + 1
    # max_pool2d pads with -inf, as reduce_window's -inf init value does
    neigh_max = F.max_pool2d(src[None, None], win, stride=1, padding=sz)[0, 0]
    is_max = (src >= neigh_max) & torch.isfinite(src)
    # strictness: the max must be unique in its window
    cnt = F.avg_pool2d(is_max[None, None].to(src.dtype), win, stride=1,
                       padding=sz, count_include_pad=True,
                       divisor_override=1)[0, 0]
    return is_max & (cnt == 1)


def _bbox_of(boxes: torch.Tensor) -> torch.Tensor:
    """(.., P, 4) part boxes -> (.., 4) covering box (hull)
    (reference: include/Candidate.hpp:105-111)."""
    return torch.stack([boxes[..., 0].amin(-1), boxes[..., 1].amin(-1),
                        boxes[..., 2].amax(-1), boxes[..., 3].amax(-1)],
                       dim=-1)


def _with_valid(c: Candidates, valid: torch.Tensor) -> Candidates:
    return Candidates(score=c.score, valid=valid, component=c.component,
                      level=c.level, boxes=c.boxes, loc=c.loc)


def _first_true(flags: torch.Tensor, start: int) -> int:
    """Index of the first True at or after start, or -1 (one read-back
    to the host)."""
    hit = flags[start:]
    i = int(torch.argmax(hit.to(torch.uint8)))
    return start + i if bool(hit[i]) else -1


def paint_nms(cands: Candidates, imsize, overlap: float = 0.0
              ) -> Candidates:
    """Greedy paint NMS over one frame's score-sorted candidates.

    Walks the candidates in order (the caller passes them sorted, as
    the reference does after Candidate::sort), keeps a candidate iff
    the painted fraction of its covering box is <= overlap, then paints
    it.  imsize: (H, W) of the painted scratch image.  Returns the
    candidates with .valid updated.

    The painted count of a box is read from the integral image of the
    scratch.  Between two keeps the scratch does not change, so every
    candidate up to the next keep is decided by one vectorized test;
    the scratch is repainted and integrated once per kept box."""
    H, W = (int(v) for v in imsize)
    dev = cands.score.device
    bb = _bbox_of(cands.boxes)                         # (K, 4)
    # clip to the image (reference: box & bounds); cv::Rect from two
    # points is exclusive at the bottom right: the region is
    # [x1, x2) x [y1, y2)
    x1 = bb[:, 0].floor().clamp(0, W).to(torch.int64)
    y1 = bb[:, 1].floor().clamp(0, H).to(torch.int64)
    x2 = bb[:, 2].floor().clamp(0, W).to(torch.int64)
    y2 = bb[:, 3].floor().clamp(0, H).to(torch.int64)
    # the JAX package's area, int32 products included
    area = torch.clamp(((x2 - x1) * (y2 - y1)).to(torch.int32), min=1)
    # an empty region (x2 <= x1 or y2 <= y1) holds no painted cell
    xe, ye = torch.maximum(x2, x1), torch.maximum(y2, y1)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    scratch = torch.zeros((H, W), dtype=torch.bool, device=dev)
    keep = torch.zeros_like(cands.valid)
    integral = torch.zeros((H + 1, W + 1), dtype=torch.int64, device=dev)
    start = 0
    while start < cands.capacity:
        integral[1:, 1:] = scratch.cumsum(0).cumsum(1)
        painted = (integral[ye, xe] - integral[y1, xe]
                   - integral[ye, x1] + integral[y1, x1])
        ok = ((painted.to(torch.float32) / area.to(torch.float32)
               <= overlap) & cands.valid)
        i = _first_true(ok, start)
        if i < 0:
            break
        keep[i] = True
        scratch |= ((yy >= y1[i]) & (yy < y2[i]) & (xx >= x1[i])
                    & (xx < x2[i]))
        start = i + 1
    return _with_valid(cands, keep)


def _overlaps_above(boxes: torch.Tensor, overlap: float) -> torch.Tensor:
    """(K, K) bool: o[i, j] > overlap, where o[i, j] is the largest over
    box columns of intersection(i, j) / area(i) (nms.m:50-68), computed
    PART_NMS_ROWS rows at a time."""
    x1, y1, x2, y2 = boxes.unbind(-1)                   # (K, P+1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    K = boxes.shape[0]
    out = torch.empty((K, K), dtype=torch.bool, device=boxes.device)
    for lo in range(0, K, PART_NMS_ROWS):
        hi = min(lo + PART_NMS_ROWS, K)
        w = (torch.minimum(x2[lo:hi, None], x2[None])
             - torch.maximum(x1[lo:hi, None], x1[None]) + 1).clamp_(min=0)
        h = (torch.minimum(y2[lo:hi, None], y2[None])
             - torch.maximum(y1[lo:hi, None], y1[None]) + 1).clamp_(min=0)
        o = (w * h / area[lo:hi, None]).amax(-1)       # (rows, K)
        out[lo:hi] = o > overlap
    return out


def part_nms(cands: Candidates, overlap: float = 0.5) -> Candidates:
    """Greedy per-part-box suppression (Matlab nms.m semantics) over one
    frame's score-sorted candidates.

    For each kept i, best first, every j > i whose overlap o[i, j] (the
    largest over the part boxes and the covering box of
    intersection(i, j) / area(i)) exceeds ``overlap`` is suppressed.
    Returns the candidates with .valid updated.

    keep[i] is final once every candidate before i is decided, so the
    loop jumps from one kept candidate to the next."""
    boxes = torch.cat([cands.boxes, _bbox_of(cands.boxes)[:, None, :]],
                      dim=1)                            # (K, P+1, 4)
    K = cands.capacity
    later = torch.ones((K, K), dtype=torch.bool,
                       device=boxes.device).triu_(1)    # j > i
    sup = _overlaps_above(boxes, overlap) & later
    keep = cands.valid.clone()
    start = 0
    while start < K:
        i = _first_true(keep, start)
        if i < 0:
            break
        keep &= ~sup[i]
        start = i + 1
    return _with_valid(cands, keep)
