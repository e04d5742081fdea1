"""NumPy oracle, the part the trainer needs: OpenCV-faithful bilinear
resizing and Felzenszwalb HOG in float64 on the host.

A copy of cv_round, resize_linear and hog_features from
partsbaseddetector_tpu/oracle/reference.py.  The trainer computes its
warped positives (train/features.py) and random negative crops
(train/trainer.py) with them, and utils/viz.show_part_clusters resizes
with resize_linear.  The port's float32 ops/hog.py is not a stand-in:
its features differ from these in the sixth digit, which changes the
stage-1 SVMs.

The functions re-implement the documented algorithms (Felzenszwalb HOG,
OpenCV INTER_LINEAR) from their definitions with the reference's
observable quirks reproduced and cited; no reference code is copied.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


# --------------------------------------------------------------------------
# image resizing (OpenCV semantics, float path)
# --------------------------------------------------------------------------

def cv_round(x):
    """OpenCV cvRound: round half to even (IEEE rint)."""
    return np.rint(x).astype(np.int64)


def resize_linear(im: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize with OpenCV INTER_LINEAR float semantics:
    src coordinate of dst x is (x + 0.5) * (sw / dw) - 0.5, edge-clamped.
    Used by the pyramid ladder (reference: src/HOGFeatures.cpp:116).

    im: (h, w) or (h, w, c); dsize: (out_h, out_w)."""
    oh, ow = dsize
    h, w = im.shape[:2]
    if (oh, ow) == (h, w):
        return im.astype(np.float64, copy=True)
    im = im.astype(np.float64)

    def axis_coords(n_out, n_in):
        scale = n_in / n_out
        f = (np.arange(n_out) + 0.5) * scale - 0.5
        i0 = np.floor(f).astype(np.int64)
        frac = f - i0
        # OpenCV clamps the *interpolation*: beyond edges the nearest pixel
        frac = np.where(i0 < 0, 0.0, frac)
        i0 = np.clip(i0, 0, n_in - 1)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        frac = np.where(i0 == n_in - 1, 0.0, frac)
        return i0, i1, frac

    y0, y1, fy = axis_coords(oh, h)
    x0, x1, fx = axis_coords(ow, w)
    fy = fy[:, None] if im.ndim == 2 else fy[:, None, None]
    fxb = fx[None, :] if im.ndim == 2 else fx[None, :, None]
    top = im[y0][:, x0] * (1 - fxb) + im[y0][:, x1] * fxb
    bot = im[y1][:, x0] * (1 - fxb) + im[y1][:, x1] * fxb
    return top * (1 - fy) + bot * fy



def hog_features(im: np.ndarray, binsize: int, norient: int = 18,
                 flen: int = 32) -> np.ndarray:
    """Felzenszwalb 31(+1)-channel HOG
    (reference: src/HOGFeatures.cpp:167-341).  Returns (oh, ow, flen).

    Channel layout: [0, norient) contrast-sensitive, [norient,
    3*norient/2) contrast-insensitive, then 4 texture-energy channels and a
    zero truncation channel (reference: src/HOGFeatures.cpp:303-338).
    """
    assert flen == 3 * norient // 2 + 5, (flen, norient)
    im = np.atleast_3d(im).astype(np.float64)
    h, w, nchan = im.shape
    half = norient // 2

    blocks_w = int(math.floor(w / binsize + 0.5))
    blocks_h = int(math.floor(h / binsize + 0.5))
    out_w = max(blocks_w - 2, 0)
    out_h = max(blocks_h - 2, 0)
    vis_w = blocks_w * binsize
    vis_h = blocks_h * binsize

    # unit vectors for orientation snapping
    # (reference: src/HOGFeatures.cpp:192-193)
    uu = np.array([1.000, 0.9397, 0.7660, 0.5000, 0.1736,
                   -0.1736, -0.5000, -0.7660, -0.9397])[:half]
    vv = np.array([0.000, 0.3420, 0.6428, 0.8660, 0.9848,
                   0.9848, 0.8660, 0.6428, 0.3420])[:half]

    ys = np.arange(1, vis_h - 1)
    xs = np.arange(1, vis_w - 1)
    if len(ys) == 0 or len(xs) == 0 or out_w == 0 or out_h == 0:
        return np.zeros((out_h, out_w, flen))
    # clamped source coords (reference: src/HOGFeatures.cpp:208,218)
    sy = np.minimum(ys, h - 2)[:, None]
    sx = np.minimum(xs, w - 2)[None, :]

    dy = im[sy + 1, sx, :] - im[sy - 1, sx, :]
    dx = im[sy, sx + 1, :] - im[sy, sx - 1, :]
    v2 = dx * dx + dy * dy
    if nchan == 3:
        # strongest gradient; ties prefer ch2 then ch1 then ch0
        # (reference: src/HOGFeatures.cpp:217-239, strict > updates)
        order = [2, 1, 0]
        v2o = v2[..., order]
        sel = np.argmax(v2o, axis=-1)
        v2b = np.take_along_axis(v2o, sel[..., None], -1)[..., 0]
        dxb = np.take_along_axis(dx[..., order], sel[..., None], -1)[..., 0]
        dyb = np.take_along_axis(dy[..., order], sel[..., None], -1)[..., 0]
    else:
        v2b, dxb, dyb = v2[..., 0], dx[..., 0], dy[..., 0]

    # orientation snapping with the reference's exact tie order:
    # candidates evaluated as d0, -d0, d1, -d1, ... with strict >
    # (reference: src/HOGFeatures.cpp:242-249)
    dots = uu[None, None, :] * dxb[..., None] + \
        vv[None, None, :] * dyb[..., None]
    cand = np.empty(dots.shape[:-1] + (norient,))
    cand[..., 0::2] = dots
    cand[..., 1::2] = -dots
    kidx = np.argmax(cand, axis=-1)
    best = np.take_along_axis(cand, kidx[..., None], -1)[..., 0]
    orient = np.where(best > 0, kidx // 2 + half * (kidx % 2), 0)
    mag = np.sqrt(v2b)

    # bilinear scatter into cell histograms
    # (reference: src/HOGFeatures.cpp:251-265)
    yp = (ys.astype(np.float64) + 0.5) / binsize - 0.5
    xp = (xs.astype(np.float64) + 0.5) / binsize - 0.5
    iyp = np.floor(yp).astype(np.int64)
    ixp = np.floor(xp).astype(np.int64)
    vy0 = (yp - iyp)[:, None]
    vx0 = (xp - ixp)[None, :]
    vy1, vx1 = 1.0 - vy0, 1.0 - vx0
    iy = iyp[:, None] + np.zeros_like(ixp)[None, :]
    ix = ixp[None, :] + np.zeros_like(iyp)[:, None]

    hist = np.zeros((blocks_h, blocks_w, norient))
    for (oy, ox, wgt) in ((0, 0, vy1 * vx1), (0, 1, vy1 * vx0),
                          (1, 0, vy0 * vx1), (1, 1, vy0 * vx0)):
        yy, xx = iy + oy, ix + ox
        m = (yy >= 0) & (yy < blocks_h) & (xx >= 0) & (xx < blocks_w)
        np.add.at(hist, (yy[m], xx[m], orient[m]),
                  (np.broadcast_to(wgt, mag.shape)[m] * mag[m]))

    # block energy (reference: src/HOGFeatures.cpp:270-283)
    norm = np.sum((hist[..., :half] + hist[..., half:norient]) ** 2, axis=-1)

    # normalized features (reference: src/HOGFeatures.cpp:286-339)
    eps = 0.0001
    nsum = (norm[:-1, :-1] + norm[:-1, 1:] + norm[1:, :-1] + norm[1:, 1:])
    ninv = 1.0 / np.sqrt(nsum + eps)      # (blocks_h-1, blocks_w-1)
    # n1 window starts at (y+1, x+1); n2 at (y, x+1); n3 at (y+1, x);
    # n4 at (y, x) -- for output pixel (y, x)
    n1 = ninv[1:1 + out_h, 1:1 + out_w]
    n2 = ninv[0:out_h, 1:1 + out_w]
    n3 = ninv[1:1 + out_h, 0:out_w]
    n4 = ninv[0:out_h, 0:out_w]

    hsrc = hist[1:1 + out_h, 1:1 + out_w, :]          # (oh, ow, norient)
    feat = np.zeros((out_h, out_w, flen))
    h1 = np.minimum(hsrc * n1[..., None], 0.2)
    h2 = np.minimum(hsrc * n2[..., None], 0.2)
    h3 = np.minimum(hsrc * n3[..., None], 0.2)
    h4 = np.minimum(hsrc * n4[..., None], 0.2)
    feat[..., :norient] = 0.5 * (h1 + h2 + h3 + h4)
    t1, t2, t3, t4 = (h.sum(-1) for h in (h1, h2, h3, h4))

    ssum = hsrc[..., :half] + hsrc[..., half:norient]
    i1 = np.minimum(ssum * n1[..., None], 0.2)
    i2 = np.minimum(ssum * n2[..., None], 0.2)
    i3 = np.minimum(ssum * n3[..., None], 0.2)
    i4 = np.minimum(ssum * n4[..., None], 0.2)
    feat[..., norient:norient + half] = 0.5 * (i1 + i2 + i3 + i4)

    feat[..., norient + half + 0] = 0.2357 * t1
    feat[..., norient + half + 1] = 0.2357 * t2
    feat[..., norient + half + 2] = 0.2357 * t3
    feat[..., norient + half + 3] = 0.2357 * t4
    # truncation channel stays zero (reference: src/HOGFeatures.cpp:338)
    return feat
