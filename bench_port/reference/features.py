"""Stages 1-2 of the reference: the resize ladder, HOG and the
filter-bank correlation, one frame and one level at a time, in float32.

The arithmetic is the reference C++ detector's (OpenCV INTER_LINEAR and
pyrDown, Felzenszwalb HOG: src/HOGFeatures.cpp:95-341; correlation with
an occlusion border: src/SpatialConvolutionEngine.cpp:70-157), written
in the operation order of the port's float32 path so that sound runs
agree to rounding: the orientation snap is a comparison of dot
products, and a one-ulp change there moves a pixel to another bin.

``tf32=True`` rounds every operand of the matrix products and the
correlation to TF32 (10 mantissa bits) before a float32 product: the
arithmetic of a card with TF32 switched on, the precision below the
configuration's float32.  It is the benchmark's control.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from bench_port.reference.plan import Level, hog_blocks

F32 = torch.float32

# unit vectors of the 9 contrast-insensitive orientations
# (src/HOGFeatures.cpp:192-193)
_UU = (1.000, 0.9397, 0.7660, 0.5000, 0.1736, -0.1736, -0.5000, -0.7660,
       -0.9397)
_VV = (0.000, 0.3420, 0.6428, 0.8660, 0.9848, 0.9848, 0.8660, 0.6428,
       0.3420)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(F32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    return torch.matmul(a, b)


def _bilinear(n_out: int, n_in: int, dev) -> torch.Tensor:
    """(n_out, n_in) INTER_LINEAR sampling matrix: source coordinate
    (i + 0.5) * n_in / n_out - 0.5, clamped at both edges."""
    i = torch.arange(n_out, dtype=F32, device=dev)
    n_in_f = torch.tensor(float(n_in), dtype=F32, device=dev)
    f = (i + 0.5) * (n_in_f / torch.tensor(float(n_out), dtype=F32,
                                           device=dev)) - 0.5
    i0 = torch.floor(f)
    frac = torch.where(i0 < 0, 0.0, f - i0)
    i0 = torch.clamp(i0, 0.0, n_in - 1.0)
    frac = torch.where(i0 >= n_in - 1.0, 0.0, frac)
    i1 = torch.clamp(i0 + 1.0, 0.0, n_in - 1.0)
    j = torch.arange(n_in, dtype=F32, device=dev)
    return ((j == i0[:, None]) * (1.0 - frac[:, None])
            + (j == i1[:, None]) * frac[:, None])


def _pyrdown(n_in: int, dev) -> torch.Tensor:
    """(ceil(n_in / 2), n_in) pyrDown matrix: the 5-tap [1 4 6 4 1] / 16
    blur with BORDER_REFLECT_101, then every second sample."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=F32, device=dev) / 16
    y = torch.arange((n_in + 1) // 2, device=dev)
    j = torch.arange(n_in, device=dev)
    m = torch.zeros(((n_in + 1) // 2, n_in), dtype=F32, device=dev)
    period = 2 * (n_in - 1)
    for t in range(5):
        src = torch.abs(2 * y + t - 2) % period
        src = torch.where(src >= n_in, period - src, src)
        m = m + k[t] * (j == src[:, None]).to(F32)
    return m


def _separable(rows: torch.Tensor, im: torch.Tensor, cols: torch.Tensor,
               tf32: bool) -> torch.Tensor:
    """rows @ im @ cols^T over an (H, W, C) image, rows first."""
    H, W, C = im.shape
    t = _mm(rows, im.reshape(H, W * C), tf32)
    oh = t.shape[0]
    t = t.reshape(oh, W, C).transpose(0, 1).reshape(W, oh * C)
    out = _mm(cols, t, tf32)
    return out.reshape(-1, oh, C).transpose(0, 1)


def ladder(frame: torch.Tensor, levels: List[Level], interval: int,
           tf32: bool = False) -> List[torch.Tensor]:
    """The scaled images (h, w, C) float32 of every level of a
    (H, W, C) frame."""
    img = frame.to(F32)
    dev = img.device
    H, W = img.shape[:2]
    out: List[torch.Tensor] = []
    for lvl in levels:
        h, w = lvl.imsize
        if lvl.index < interval:
            out.append(_separable(_bilinear(h, H, dev), img,
                                  _bilinear(w, W, dev), tf32))
        else:
            prev = out[lvl.index - interval]
            out.append(_separable(_pyrdown(prev.shape[0], dev), prev,
                                  _pyrdown(prev.shape[1], dev), tf32))
    return out


def _tent(nblocks: int, npix: int, binsize: int, vis: int, dev):
    """(nblocks, npix) bilinear cell weights of the pixels the C++ loop
    visits, y in [1, vis - 1) (src/HOGFeatures.cpp:251-265)."""
    c = torch.arange(nblocks, dtype=F32, device=dev)[:, None]
    y = torch.arange(npix, dtype=F32, device=dev)[None, :]
    t = (y + 0.5) / binsize - 0.5 - c
    wgt = torch.clamp_min(1.0 - torch.abs(t), 0.0)
    return wgt * ((y >= 1) & (y <= vis - 2))


def hog(im: torch.Tensor, buf: tuple, binsize: int, norient: int,
        flen: int, tf32: bool = False) -> torch.Tensor:
    """Felzenszwalb HOG of one (h, w, C) image: (oh, ow, flen).

    buf: the (Hb, Wb) grid the gradients are taken on, at least (h, w):
    pixels the C++ loop visits beyond the image (y up to vis - 2) read
    the clamped edge gradients there, and only inside buf."""
    h, w, nchan = im.shape
    Hb, Wb = buf
    dev = im.device
    half = norient // 2
    x = F.pad(im, (0, 0, 0, Wb - w, 0, Hb - h))
    yy = torch.arange(Hb, device=dev)[:, None, None]
    xx = torch.arange(Wb, device=dev)[None, :, None]
    # reads clamped to rows / columns <= size - 2
    xc = torch.where(xx <= w - 2, x, x[:, w - 2:w - 1])
    xr = torch.where(yy <= h - 2, x, x[h - 2:h - 1])
    xc_pad = F.pad(xc, (0, 0, 0, 0, 1, 1))
    xr_pad = F.pad(xr, (0, 0, 1, 1))
    dy = torch.where(yy <= h - 3, xc_pad[2:] - xc_pad[:-2],
                     xc[h - 1:h] - xc[h - 3:h - 2])
    dx = torch.where(xx <= w - 3, xr_pad[:, 2:] - xr_pad[:, :-2],
                     xr[:, w - 1:w] - xr[:, w - 3:w - 2])
    v2 = dx * dx + dy * dy
    v2b, dxb, dyb = v2[..., 0], dx[..., 0], dy[..., 0]
    for ch in range(1, nchan):
        # the strongest channel, strict >: ties keep the earlier one
        upd = v2[..., ch] > v2b
        v2b = torch.where(upd, v2[..., ch], v2b)
        dxb = torch.where(upd, dx[..., ch], dxb)
        dyb = torch.where(upd, dy[..., ch], dyb)
    uu = torch.tensor(_UU[:half], dtype=F32, device=dev)
    vv = torch.tensor(_VV[:half], dtype=F32, device=dev)
    dots = dxb[..., None] * uu + dyb[..., None] * vv
    # candidates d0, -d0, d1, -d1, ...: the first largest wins; a
    # best <= 0 snaps to orientation 0 (src/HOGFeatures.cpp:242-249)
    cand = torch.stack([dots, -dots], dim=-1).reshape(Hb, Wb, norient)
    best = cand.amax(dim=-1)
    slot = torch.argmax((cand == best[..., None]).to(torch.uint8), dim=-1)
    slot = torch.where(best > 0, slot, torch.zeros_like(slot))
    bh, bw = hog_blocks(h, w, binsize)
    vis_h, vis_w = bh * binsize, bw * binsize
    inside = (((yy[..., 0] >= 1) & (yy[..., 0] <= vis_h - 2))
              & ((xx[..., 0] >= 1) & (xx[..., 0] <= vis_w - 2)))
    mag = torch.where(inside, torch.sqrt(v2b), 0.0)
    onehot = F.one_hot(slot, norient).to(F32)
    mag_o = mag[..., None] * onehot                        # (Hb, Wb, O)
    By = _tent(bh, Hb, binsize, vis_h, dev)
    Bx = _tent(bw, Wb, binsize, vis_w, dev)
    t = _mm(By, mag_o.reshape(Hb, Wb * norient), tf32)
    t = t.reshape(bh, Wb, norient).transpose(0, 1).reshape(Wb, bh * norient)
    slots = _mm(Bx, t, tf32).reshape(bw, bh, norient).transpose(0, 1)
    # slot 2o is orientation o, slot 2o + 1 orientation o + half
    hist = torch.cat([slots[..., 0::2], slots[..., 1::2]], dim=-1)
    s = hist[..., :half] + hist[..., half:]
    norm = torch.sum(s * s, dim=-1)
    oh, ow = bh - 2, bw - 2
    nsum = norm[:-1, :-1] + norm[:-1, 1:] + norm[1:, :-1] + norm[1:, 1:]
    ninv = 1.0 / torch.sqrt(nsum + 0.0001)
    ns = (ninv[1:1 + oh, 1:1 + ow, None], ninv[0:oh, 1:1 + ow, None],
          ninv[1:1 + oh, 0:ow, None], ninv[0:oh, 0:ow, None])
    hsrc = hist[1:1 + oh, 1:1 + ow]
    hs = [torch.clamp_max(hsrc * n, 0.2) for n in ns]
    sens = 0.5 * (hs[0] + hs[1] + hs[2] + hs[3])
    texture = torch.stack([t_.sum(-1) for t_ in hs], dim=-1) * 0.2357
    ssum = hsrc[..., :half] + hsrc[..., half:]
    ins = [torch.clamp_max(ssum * n, 0.2) for n in ns]
    insens = 0.5 * (ins[0] + ins[1] + ins[2] + ins[3])
    trunc = torch.zeros((oh, ow, 1), dtype=F32, device=dev)
    feat = torch.cat([sens, insens, texture, trunc], dim=-1)
    assert feat.shape[-1] == flen
    return feat


def responses(feat: torch.Tensor, filters: torch.Tensor,
              tf32: bool = False) -> torch.Tensor:
    """(F, oh, ow) correlation of (oh, ow, C) features with (F, fh, fw,
    C) filters of one size, anchored at (fh // 2, fw // 2); beyond the
    map every channel reads 0 but the last, the occlusion feature, which
    reads 1."""
    oh, ow, C = feat.shape
    fh, fw = filters.shape[1:3]
    ay, ax = fh // 2, fw // 2
    padded = torch.zeros((oh + fh - 1, ow + fw - 1, C), dtype=F32,
                         device=feat.device)
    padded[..., C - 1] = 1.0
    padded[ay:ay + oh, ax:ax + ow] = feat
    inp = padded.permute(2, 0, 1)[None]
    wgt = filters.permute(0, 3, 1, 2)
    if tf32:
        inp, wgt = to_tf32(inp), to_tf32(wgt)
    return F.conv2d(inp, wgt)[0]


def level_responses(frame: torch.Tensor, levels: List[Level],
                    filters: torch.Tensor, binsize: int, interval: int,
                    norient: int, flen: int, tf32: bool = False
                    ) -> List[torch.Tensor]:
    """Stages 1-2 for every level of one frame: [(F, oh, ow)]."""
    ims = ladder(frame, levels, interval, tf32)
    out = []
    for lvl, im in zip(levels, ims):
        buf = levels[lvl.octave_first].imsize
        feat = hog(im, buf, binsize, norient, flen, tf32)
        out.append(responses(feat, filters, tf32))
    return out
