"""Mixture filter-bank scoring as one convolution per shape bucket.

Port of partsbaseddetector_tpu/ops/conv.py.  The reference's triple
loop of per-filter correlations (reference:
src/SpatialConvolutionEngine.cpp:85-123) is one ``F.conv2d`` per bucket:
feature channels are the input channels and all F mixture filters the
output channels.  The JAX package leaves this conv to XLA outside any
Pallas kernel; here it goes to cuDNN, with TF32 off (ops/common.py).
``conv_bank_fft`` is the frequency-domain engine.

Border semantics: "same"-size responses with the kernel anchored at its
center (kh//2, kw//2); features beyond the image border read as zero in
channels 0..C-2 and one in the truncation channel C-1 — the
boundary-occlusion feature (reference:
src/SpatialConvolutionEngine.cpp:146-157) — realized by padding with the
occlusion pattern and running a VALID conv.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pack_filter_bank(filters: Sequence[np.ndarray],
                     dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variably-sized (kh, kw, C) filters into one (FH, FW, C, F)
    bank (HWIO layout).  Each filter is placed so that its OpenCV center
    anchor (kh//2, kw//2) lands on the bank's anchor (FH//2, FW//2).

    Returns (bank, sizes) with sizes (F, 2) = per-filter (kh, kw)."""
    FH = max(f.shape[0] for f in filters)
    FW = max(f.shape[1] for f in filters)
    C = filters[0].shape[2]
    nf = len(filters)
    bank = np.zeros((FH, FW, C, nf), dtype=dtype)
    sizes = np.zeros((nf, 2), dtype=np.int32)
    for n, f in enumerate(filters):
        kh, kw, c = f.shape
        if c != C:
            raise ValueError("all filters must share the feature length")
        oy = FH // 2 - kh // 2
        ox = FW // 2 - kw // 2
        bank[oy:oy + kh, ox:ox + kw, :, n] = f
        sizes[n] = (kh, kw)
    return bank, sizes


def occlusion_pad(features: torch.Tensor,
                  pads: Tuple[int, int, int, int],
                  true_size=None) -> torch.Tensor:
    """Pad (..., H, W, C) features with the occlusion border pattern:
    zeros in channels 0..C-2, ones in channel C-1.  pads = (top, bottom,
    left, right).  true_size: optional (..., 2) valid (h, w) per map,
    broadcast against the leading dims; the pattern is then also written
    inside the buffer beyond each map's true extent, so every pyramid
    level in a padded bucket sees its own occlusion border."""
    t, b, l, r = pads
    H, W, C = features.shape[-3:]
    dev = features.device
    if true_size is not None:
        ts = torch.as_tensor(true_size, device=dev)
        yy = torch.arange(H, device=dev)[:, None]
        xx = torch.arange(W, device=dev)[None, :]
        inside = ((yy < ts[..., 0, None, None])
                  & (xx < ts[..., 1, None, None]))[..., None]
        occl = torch.zeros(C, dtype=features.dtype, device=dev)
        occl[C - 1] = 1.0
        features = torch.where(inside, features, occl)
    padded = F.pad(features, (0, 0, l, r, t, b))
    # the truncation channel reads one in the halo
    Hp, Wp = H + t + b, W + l + r
    padded[..., :t, :, C - 1] = 1.0
    padded[..., t + H:Hp, :, C - 1] = 1.0
    padded[..., :, :l, C - 1] = 1.0
    padded[..., :, l + W:Wp, C - 1] = 1.0
    return padded


def conv_bank(features: torch.Tensor, bank: torch.Tensor,
              true_size=None) -> torch.Tensor:
    """Correlate features with the packed filter bank.

    features: (L, H, W, C) (or (H, W, C)); bank: (FH, FW, C, F).
    true_size: per-level true feature sizes (L, 2) or (2,).
    Returns (L, H, W, F) same-size responses (garbage beyond each
    level's true size — masked downstream), the JAX package's layout.
    It is a permuted view of the conv's (L, F, H, W) output, so the DP's
    move of the filter axis to the front (ops/dp.py) copies nothing."""
    squeeze = features.ndim == 3
    if squeeze:
        features = features[None]
    FH, FW = bank.shape[:2]
    ay, ax = FH // 2, FW // 2
    padded = occlusion_pad(features, (ay, FH - 1 - ay, ax, FW - 1 - ax),
                           true_size)
    out = F.conv2d(padded.permute(0, 3, 1, 2),
                   bank.permute(3, 2, 0, 1).contiguous())
    out = out.permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def conv_bank_fft(features: torch.Tensor, bank: torch.Tensor,
                  true_size=None) -> torch.Tensor:
    """Frequency-domain variant of conv_bank (port of
    partsbaseddetector_tpu/ops/conv.py:conv_bank_fft): rfft2 of the
    occlusion-padded features and of the filter bank, a per-frequency
    multiply-accumulate over channels against the conjugate kernel
    spectrum (a correlation), the inverse transform, and the VALID crop.
    It realizes the intent of the reference's dead
    FourierConvolutionEngine (src/FourierConvolutionEngine.cpp:118-138).
    The JAX package computes these FFTs outside any Pallas kernel; here
    they are torch.fft.

    Same signature and layout as conv_bank.  The channel contraction is
    one batched complex matmul over the frequencies, (Hp*Wf, L, C) @
    (Hp*Wf, C, F), so no (L, F, C, Hp, Wf) product is ever formed."""
    squeeze = features.ndim == 3
    if squeeze:
        features = features[None]
    FH, FW = bank.shape[:2]
    ay, ax = FH // 2, FW // 2
    padded = occlusion_pad(features, (ay, FH - 1 - ay, ax, FW - 1 - ax),
                           true_size)
    L, Hp, Wp, C = padded.shape
    s = (Hp, Wp)
    feat_f = torch.fft.rfft2(padded.permute(0, 3, 1, 2), s=s)   # (L,C,Hp,Wf)
    bank_f = torch.fft.rfft2(bank.permute(3, 2, 0, 1), s=s)     # (F,C,Hp,Wf)
    resp_f = torch.matmul(feat_f.permute(2, 3, 0, 1),
                          bank_f.conj().permute(2, 3, 1, 0))    # (Hp,Wf,L,F)
    resp = torch.fft.irfft2(resp_f.permute(2, 3, 0, 1), s=s)    # (L,F,Hp,Wp)
    # output (y, x) is the kernel's top-left at padded (y, x): the
    # centered-anchor response after the VALID crop
    out = resp[:, :, :Hp - (FH - 1), :Wp - (FW - 1)].permute(0, 2, 3, 1)
    return out[0] if squeeze else out


#: stage-2 engines by name (partsbaseddetector_tpu/infer/detector.py:42;
#: the reference wires only the spatial one,
#: src/PartsBasedDetector.cpp:108-118)
CONV_ENGINES = {"spatial": conv_bank, "fft": conv_bank_fft}
