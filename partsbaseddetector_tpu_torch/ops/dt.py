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
largest person-26 group with B=8.
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
