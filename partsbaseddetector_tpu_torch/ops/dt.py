"""Generalized (quadratic) distance transform, max-only dense form.

Port of ``dt_max_x`` and ``dt_max_y`` from
partsbaseddetector_tpu/ops/dt.py.  The reference computes, per part
mixture, the separable max-transform
  out[py, px] = max_{cy, cx} score[cy, cx] - w0 dx^2 - w1 dx - w2 dy^2
                                            - w3 dy,
  dx = (px + ax) - cx,  dy = (py + ay) - cy
with the O(N) lower-envelope algorithm (reference:
include/DistanceTransform.hpp:152-182).  The dense form broadcasts an
(N_out, N_in) penalty matrix against the rows and max-reduces, with the
penalty expression ``-w0*d*d - w1*d`` kept in the JAX package's order so
the maxima are the same floats.  Eager torch materializes the
(..., N, N) candidate tensor that XLA fuses away: about 0.75 GB at the
largest person-26 group with B=8.  So these two passes are the DP's
plain version (ops/dp.py's CPU path and the reference on the card); on
CUDA tensors the DP runs them in the kernel csrc/dp.cu.
"""

from __future__ import annotations

import torch


def _param(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or a tensor over src's leading dims, as (..., 1, 1)."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v[..., None, None]


def dt_max_x(src: torch.Tensor, w0, w1, ax, out=None) -> torch.Tensor:
    """Max-only x pass over (..., H, W) maps:
    out[..., h, q] = max_cx src[..., h, cx] - w0 d^2 - w1 d,
    d = q + ax - cx.  w0, w1, ax: scalars or tensors broadcasting over
    src's leading dims (e.g. one value per mixture).  out: optional
    tensor of src's shape to write the result into."""
    n = src.shape[-1]
    q = torch.arange(n, dtype=src.dtype, device=src.device)[None, :]
    cx = torch.arange(n, dtype=src.dtype, device=src.device)[:, None]
    d = q + _param(ax, src) - cx                          # (..., Cx, Q)
    pen = -_param(w0, src) * d * d - _param(w1, src) * d
    cand = src[..., :, :, None] + pen[..., None, :, :]    # (..., H, Cx, Q)
    return torch.amax(cand, dim=-2, out=out)


def dt_max_y(src: torch.Tensor, w2, w3, ay) -> torch.Tensor:
    """Max-only y pass over (..., H, W) maps:
    out[..., py, px] = max_cy src[..., cy, px] - w2 d^2 - w3 d,
    d = py + ay - cy."""
    h = src.shape[-2]
    py = torch.arange(h, dtype=src.dtype, device=src.device)[:, None]
    cy = torch.arange(h, dtype=src.dtype, device=src.device)[None, :]
    d = py + _param(ay, src) - cy                         # (..., Py, Cy)
    pen = -_param(w2, src) * d * d - _param(w3, src) * d
    cand = src[..., None, :, :] + pen[..., :, :, None]    # (..., Py, Cy, Px)
    return cand.amax(dim=-2)


# ---------------------------------------------------------------------
# the DT with argmax tables (partsbaseddetector_tpu/ops/dt.py:46-54,
# :117-161): the plain reference for the DP's argmaxes, held against the
# JAX package's tables; no hot path calls them (the walk recomputes
# argmaxes at its K points, ops/dp.walk_children)
# ---------------------------------------------------------------------

def dt_max_1d_last(src: torch.Tensor, w0, w1, offset) -> torch.Tensor:
    """Max-only 1-D DT pass along the last axis:
    dst[.., q] = max_x src[.., x] - w0 d^2 - w1 d, d = q + offset - x.
    w0, w1, offset: scalars."""
    return _shiftdt_pass(src, w0, w1, offset, src.shape[-1], 1)[0]


def distance_transform_raw(score: torch.Tensor, w, anchor):
    """2-D generalized distance transform, raw pass tables.

    score: (M, N); w: (4,); anchor: (2,) (ax, ay).
    Returns (out, ix_row, iy_col), each (M, N):
      out[py, px]    - the max-transformed score
      ix_row[cy, px] - x-pass argmax (rows indexed by CHILD y)
      iy_col[py, px] - y-pass argmax
    Argmaxes are int32 and resolve ties to the smallest index."""
    w = torch.as_tensor(w, dtype=score.dtype, device=score.device)
    anchor = torch.as_tensor(anchor, device=score.device)
    M, N = score.shape
    tmp, ix_row = _shiftdt_pass(score, w[0], w[1], anchor[0], N, 1)
    out_t, iy_col_t = _shiftdt_pass(tmp.T, w[2], w[3], anchor[1], M, 1)
    return out_t.T, ix_row, iy_col_t.T


def distance_transform(score: torch.Tensor, w, anchor,
                       compose: str = "reference"):
    """Full DT with composed argmax tables (the reference's
    include/DistanceTransform.hpp:233-244): compose="reference" keeps
    the row-pass table indexed by child-y rows and gathers Iy through
    it; "correct" is the textbook composition.

    Returns (out, Ix, Iy) each (M, N) indexed [parent_y, parent_x]."""
    out, ix_row, iy_col = distance_transform_raw(score, w, anchor)
    if compose == "reference":
        ix = ix_row
        iy = torch.gather(iy_col, 1, ix_row.long())
    elif compose == "correct":
        iy = iy_col
        ix = torch.gather(ix_row, 0, iy_col.long())
    else:
        raise ValueError(compose)
    return out, ix, iy


def dt_mixtures_raw(scores: torch.Tensor, defw, anchors):
    """distance_transform_raw over the mixture axis: scores
    (M_mix, H, W), defw (M_mix, 4), anchors (M_mix, 2).  Returns the
    three tables stacked, each (M_mix, H, W)."""
    outs = [distance_transform_raw(s, w, a)
            for s, w, a in zip(scores, defw, anchors)]
    return tuple(torch.stack(t) for t in zip(*outs))


# ---------------------------------------------------------------------
# shifted / strided DT: the multi-resolution message op
# (partsbaseddetector_tpu/ops/dt.py:168-267; the Matlab detector's
# matlab/oct/shiftdt.cc)
# ---------------------------------------------------------------------

def _shiftdt_pass(src: torch.Tensor, a, b, shift, dlen: int, step):
    """One shifted/strided 1-D max-transform pass along the last axis:
    dst[..., i] = max_x src[..., x] - a d^2 - b d, d = shift + i*step - x.
    a, b, shift, step: scalars.  Returns (dst, argmax), each (..., dlen);
    the argmax resolves ties to the smallest source index."""
    n = src.shape[-1]
    dev, dtype = src.device, src.dtype

    def s(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)
    q = s(shift) + torch.arange(dlen, dtype=dtype, device=dev) * s(step)
    d = q[:, None] - torch.arange(n, dtype=dtype, device=dev)[None, :]
    pen = -s(a) * d * d - s(b) * d                        # (dlen, n)
    cand = src[..., None, :] + pen                        # (..., dlen, n)
    dst = cand.amax(dim=-1)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    rev = torch.where(cand >= dst[..., None], n - 1 - iota,
                      torch.tensor(-1, dtype=torch.int32, device=dev))
    idx = (n - 1) - rev.amax(dim=-1)
    return dst, idx.to(torch.int32)


def shiftdt_max_y(src: torch.Tensor, w2, w3, starty, leny: int, step
                  ) -> torch.Tensor:
    """Max-only strided y pass: src (..., H, W) ->
    out[..., i, px] = max_cy src[..., cy, px] - w2 d^2 - w3 d,
    d = starty + i*step - cy.  w2, w3, starty: scalars or tensors over
    src's leading dims; step: a scalar."""
    h = src.shape[-2]
    py = torch.arange(leny, dtype=src.dtype, device=src.device)[:, None]
    cy = torch.arange(h, dtype=src.dtype, device=src.device)[None, :]
    d = _param(starty, src) + py * float(step) - cy       # (..., Py, Cy)
    pen = -_param(w2, src) * d * d - _param(w3, src) * d
    cand = src[..., None, :, :] + pen[..., :, :, None]    # (..., Py, Cy, Px)
    return cand.amax(dim=-2)


def shiftdt_max_x(src: torch.Tensor, w0, w1, startx, lenx: int, step
                  ) -> torch.Tensor:
    """Max-only strided x pass: src (..., H, W) ->
    out[..., h, j] = max_cx src[..., h, cx] - w0 d^2 - w1 d,
    d = startx + j*step - cx."""
    n = src.shape[-1]
    q = torch.arange(lenx, dtype=src.dtype, device=src.device)[None, :]
    cx = torch.arange(n, dtype=src.dtype, device=src.device)[:, None]
    d = _param(startx, src) + q * float(step) - cx        # (..., Cx, Q)
    pen = -_param(w0, src) * d * d - _param(w1, src) * d
    cand = src[..., :, :, None] + pen[..., None, :, :]    # (..., H, Cx, Q)
    return cand.amax(dim=-2)


def shiftdt_max(src: torch.Tensor, w, startx, starty, lenx: int,
                leny: int, step=1):
    """Max-only forward pass of :func:`shiftdt` (the multi-resolution
    DP's message op): the y pass first (the Matlab kernel's order,
    matlab/oct/shiftdt.cc:97-102), then x.  w: (..., 4).

    Returns (out, tmp): out (..., leny, lenx) is the message on the
    parent grid; tmp (..., leny, W) the y-pass maxima, which the walk
    reads to recompute argmaxes at its K points (infer/multires.py)."""
    w = torch.as_tensor(w, dtype=src.dtype, device=src.device)
    tmp = shiftdt_max_y(src, w[..., 2], w[..., 3], starty, leny, step)
    out = shiftdt_max_x(tmp, w[..., 0], w[..., 1], startx, lenx, step)
    return out, tmp


def shiftdt(score: torch.Tensor, w, startx, starty, lenx: int, leny: int,
            step=1):
    """Generalized DT on a shifted, subsampled output grid, with argmax
    tables: child position (starty + i*step, startx + j*step) for parent
    cell (i, j), i < leny, j < lenx.  score (H, W); w = (w0, w1, w2, w3).
    The y pass first, then x; the tables composed like the mex kernel
    (shiftdt.cc:105-111): Iy[i, j] = IyCol[i, Ix[i, j]].

    Returns (out, Ix, Iy), each (leny, lenx); Ix/Iy are child-grid
    coordinates."""
    w = torch.as_tensor(w, dtype=score.dtype, device=score.device)
    tmp_t, iy_t = _shiftdt_pass(score.T, w[2], w[3], starty, leny, step)
    tmp, iy_col = tmp_t.T, iy_t.T                         # (leny, W)
    out, ix = _shiftdt_pass(tmp, w[0], w[1], startx, lenx, step)
    iy = torch.gather(iy_col, 1, ix.long())
    return out, ix, iy
