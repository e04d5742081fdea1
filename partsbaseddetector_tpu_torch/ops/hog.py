"""Felzenszwalb HOG features as batched tensor ops.

Port of partsbaseddetector_tpu/ops/hog.py (reference:
src/HOGFeatures.cpp:167-341).  Where the JAX package vmaps one traced
body over the levels of a shape bucket, this module takes a leading
batch of padded images with one true (h, w) per image:

  * gradients / channel pick / orientation snap: elementwise, with the
    reference's tie-break order and the JAX package's expression order
    (a one-ulp change in the orientation dot products flips bins);
  * bilinear cell binning as two sampling-matrix products
    ``hist = By @ mag_o @ Bx^T`` (contracted over y first, then x, as
    XLA orders the JAX einsum);
  * block-energy normalization and feature assembly: elementwise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from partsbaseddetector_tpu_torch.ops.common import DEFAULT_DTYPE

# unit vectors for the 18-way orientation snap
# (reference: src/HOGFeatures.cpp:192-193)
_UU = np.array([1.000, 0.9397, 0.7660, 0.5000, 0.1736,
                -0.1736, -0.5000, -0.7660, -0.9397])
_VV = np.array([0.000, 0.3420, 0.6428, 0.8660, 0.9848,
                0.9848, 0.8660, 0.6428, 0.3420])


@functools.lru_cache(maxsize=16)
def _orientation_units(half: int, device: torch.device):
    """The first ``half`` unit vectors' (uu, vv) as float32 tensors on
    ``device``, built once per device."""
    return (torch.as_tensor(_UU[:half], dtype=DEFAULT_DTYPE, device=device),
            torch.as_tensor(_VV[:half], dtype=DEFAULT_DTYPE, device=device))


def hog_output_shape(imsize, binsize: int):
    """(blocks_h, blocks_w, out_h, out_w) for a true image size; mirrors
    round(size/binsize) and max(blocks-2, 0)
    (reference: src/HOGFeatures.cpp:174-175)."""
    h, w = imsize
    bh = int(np.floor(h / binsize + 0.5))
    bw = int(np.floor(w / binsize + 0.5))
    return bh, bw, max(bh - 2, 0), max(bw - 2, 0)


def _blocks(n: torch.Tensor, binsize: int) -> torch.Tensor:
    """round(n / binsize) with round-half-up, in float32."""
    return torch.floor(n.to(DEFAULT_DTYPE) / binsize + 0.5).to(torch.int32)


def _tent_matrix(nblocks_pad: int, npix_pad: int, binsize: int,
                 nblocks: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """(N, nblocks_pad, npix_pad) matrices B with
    B[c, y] = max(0, 1 - |(y+0.5)/binsize - 0.5 - c|) for pixels y in the
    reference's loop range [1, vis-1) and cells c < nblocks; zero
    elsewhere — the bilinear scatter (reference:
    src/HOGFeatures.cpp:251-265) as a gather.  nblocks, vis: (N,)."""
    dev = nblocks.device
    c = torch.arange(nblocks_pad, dtype=DEFAULT_DTYPE, device=dev)[:, None]
    y = torch.arange(npix_pad, dtype=DEFAULT_DTYPE, device=dev)[None, :]
    t = (y + 0.5) / binsize - 0.5 - c
    w = torch.clamp_min(1.0 - torch.abs(t), 0.0)
    nb = nblocks.to(DEFAULT_DTYPE)[:, None, None]
    vf = vis.to(DEFAULT_DTYPE)[:, None, None]
    w = w * (c < nb)
    return w * ((y >= 1) & (y <= vf - 2))


def hog_features(im: torch.Tensor, binsize: int, norient: int, flen: int,
                 true_size=None, feat_pad=None) -> torch.Tensor:
    """HOG features of padded images.

    im: (H, W) grayscale, (H, W, C) or a batch (N, H, W, C), C in {1, 3},
        any real dtype.
    true_size: true (h, w) — (2,) or, for a batch, (N, 2); defaults to
        the buffer size.
    feat_pad: padded output spatial shape (fh, fw); defaults to the
        exact output size of the (first) true size.

    Returns (fh, fw, flen) (or (N, fh, fw, flen)); entries beyond the
    true output size are zero, the truncation channel (flen-1) is zero
    everywhere (reference: src/HOGFeatures.cpp:338).
    """
    if flen != 3 * norient // 2 + 5:
        raise ValueError(f"flen {flen} does not fit norient {norient}")
    half = norient // 2
    single = im.ndim < 4
    if im.ndim == 2:
        im = im[..., None]
    x = (im[None] if single else im).to(DEFAULT_DTYPE)
    N, H, W, nchan = x.shape
    dev = x.device
    if true_size is None:
        true_size = (H, W)
    ts = torch.as_tensor(true_size, dtype=torch.int32, device=dev)
    ts = ts.reshape(-1, 2).expand(N, 2)
    h, w = ts[:, 0], ts[:, 1]

    if feat_pad is None:
        feat_pad = hog_output_shape(tuple(ts[0].tolist()), binsize)[2:]
    oh_pad, ow_pad = feat_pad
    bh_pad, bw_pad = oh_pad + 2, ow_pad + 2

    bh = _blocks(h, binsize)
    bw = _blocks(w, binsize)
    vis_h = bh * binsize
    vis_w = bw * binsize
    n_idx = torch.arange(N, device=dev)
    yy = torch.arange(H, device=dev)
    xx = torch.arange(W, device=dev)

    def row_at(img, i):
        """img[n, i[n]] as (N, 1, W, C)."""
        return img[n_idx, torch.clamp(i, 0, H - 1).long()][:, None]

    def col_at(img, i):
        """img[n, :, i[n]] as (N, H, 1, C)."""
        return img[n_idx, :, torch.clamp(i, 0, W - 1).long()][:, :, None]

    def rows(cond):          # (N,) per-image bound -> (N, H, 1, 1) mask
        return cond[..., None, None]

    # ---- gradients at clamped source coords
    # (reference: src/HOGFeatures.cpp:202-239; the loop runs y, x in
    # [1, visible-1) with source reads clamped to <= size-2)
    ymask = rows(yy[None, :] <= (h - 3)[:, None])
    xmask = (xx[None, :] <= (w - 3)[:, None])[:, None, :, None]
    # column-clamped image: xc[:, x'] = x[:, min(x', w-2)]
    xc = torch.where((xx[None, :] <= (w - 2)[:, None])[:, None, :, None],
                     x, col_at(x, w - 2))
    # row-clamped image
    xr = torch.where(rows(yy[None, :] <= (h - 2)[:, None]), x,
                     row_at(x, h - 2))
    xc_pad = F.pad(xc, (0, 0, 0, 0, 1, 1))
    xr_pad = F.pad(xr, (0, 0, 1, 1))
    dy = torch.where(ymask, xc_pad[:, 2:] - xc_pad[:, :-2],
                     row_at(xc, h - 1) - row_at(xc, h - 3))
    dx = torch.where(xmask, xr_pad[:, :, 2:] - xr_pad[:, :, :-2],
                     col_at(xr, w - 1) - col_at(xr, w - 3))
    v2 = dx * dx + dy * dy
    v2b, dxb, dyb = v2[..., 0], dx[..., 0], dy[..., 0]
    if nchan == 3:
        # strongest channel with strict > updates, priority ch0 > ch1 >
        # ch2 on ties (reference: src/HOGFeatures.cpp:217-239)
        for ch in (1, 2):
            upd = v2[..., ch] > v2b
            v2b = torch.where(upd, v2[..., ch], v2b)
            dxb = torch.where(upd, dx[..., ch], dxb)
            dyb = torch.where(upd, dy[..., ch], dyb)

    # ---- orientation snap, tie order d0, -d0, d1, -d1, ... strict >
    # (reference: src/HOGFeatures.cpp:242-249): a first-wins equality
    # mask in that slot order, via the reversed-iota max
    uu, vv = _orientation_units(half, dev)
    dots = dxb[..., None] * uu + dyb[..., None] * vv       # (N, H, W, half)
    cand = torch.stack([dots, -dots], dim=-1).reshape(
        dots.shape[:3] + (norient,))
    bestv = cand.amax(dim=-1, keepdim=True)
    iota = torch.arange(norient, dtype=torch.int32, device=dev)
    rev = torch.where(cand == bestv, norient - 1 - iota, -1)
    winner = (norient - 1) - rev.amax(dim=-1, keepdim=True)
    # zero/negative best -> orientation 0 == slot 0 (+d0)
    winner = torch.where(bestv > 0, winner, torch.zeros_like(winner))
    first = iota == winner
    mag = torch.sqrt(v2b)

    # mask out pixels outside the reference loop range [1, vis-1)
    valid = (((yy[None, :] >= 1) & (yy[None, :] <= (vis_h - 2)[:, None])
              )[:, :, None]
             & ((xx[None, :] >= 1) & (xx[None, :] <= (vis_w - 2)[:, None])
                )[:, None, :])
    mag = torch.where(valid, mag, torch.zeros_like(mag))
    mag_o = mag[..., None] * first.to(DEFAULT_DTYPE)       # (N, H, W, O)
    By = _tent_matrix(bh_pad, H, binsize, bh, vis_h)       # (N, C, H)
    Bx = _tent_matrix(bw_pad, W, binsize, bw, vis_w)       # (N, D, W)
    t = torch.bmm(By, mag_o.reshape(N, H, W * norient))    # (N, C, W*O)
    t = t.reshape(N, bh_pad, W, norient).transpose(1, 2).reshape(
        N, W, bh_pad * norient)                            # (N, W, C*O)
    hist_slots = torch.bmm(Bx, t).reshape(
        N, bw_pad, bh_pad, norient).transpose(1, 2)        # (N, C, D, O)
    # slots -> orientation channels: orientation o reads slot 2o
    # (o < half) or 2(o-half)+1
    hist = hist_slots.unflatten(-1, (half, 2)).transpose(-1, -2).flatten(-2)

    # ---- block energy (reference: src/HOGFeatures.cpp:270-283)
    s = hist[..., :half] + hist[..., half:norient]
    norm = torch.sum(s * s, dim=-1)

    # ---- normalized features (reference: src/HOGFeatures.cpp:286-339)
    eps = 0.0001
    nsum = (norm[:, :-1, :-1] + norm[:, :-1, 1:] + norm[:, 1:, :-1]
            + norm[:, 1:, 1:])
    ninv = 1.0 / torch.sqrt(nsum + eps)
    n1 = ninv[:, 1:1 + oh_pad, 1:1 + ow_pad, None]
    n2 = ninv[:, 0:oh_pad, 1:1 + ow_pad, None]
    n3 = ninv[:, 1:1 + oh_pad, 0:ow_pad, None]
    n4 = ninv[:, 0:oh_pad, 0:ow_pad, None]

    hsrc = hist[:, 1:1 + oh_pad, 1:1 + ow_pad, :]
    hs = [torch.clamp_max(hsrc * n, 0.2) for n in (n1, n2, n3, n4)]
    sens = 0.5 * (hs[0] + hs[1] + hs[2] + hs[3])
    t_feats = torch.stack([hh.sum(-1) for hh in hs], dim=-1) * 0.2357

    ssum = hsrc[..., :half] + hsrc[..., half:norient]
    ins = [torch.clamp_max(ssum * n, 0.2) for n in (n1, n2, n3, n4)]
    insens = 0.5 * (ins[0] + ins[1] + ins[2] + ins[3])

    trunc = torch.zeros(sens.shape[:3] + (1,), dtype=DEFAULT_DTYPE,
                        device=dev)
    feat = torch.cat([sens, insens, t_feats, trunc], dim=-1)

    # zero outside the true output extent (out = max(blocks-2, 0))
    oy = torch.arange(oh_pad, device=dev)
    ox = torch.arange(ow_pad, device=dev)
    fvalid = ((oy[None, :] < (bh - 2)[:, None])[:, :, None]
              & (ox[None, :] < (bw - 2)[:, None])[:, None, :])
    feat = feat * fvalid[..., None]
    return feat[0] if single else feat
