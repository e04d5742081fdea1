"""Image resampling with OpenCV semantics, into padded buffers with
per-image valid sizes.

Port of partsbaseddetector_tpu/ops/imageops.py.  The reference's
pyramid ladder uses cv::resize (INTER_LINEAR) and cv::pyrDown
(reference: src/HOGFeatures.cpp:111-127); both are separable
sampling-matrix products ``out = Ry @ im @ Rx^T`` in float32, contracted
over rows first, then columns, as XLA orders the JAX package's einsum
for landscape frames.  The matrices are built from true sizes held in
tensors: a leading batch of sizes gives a batch of matrices, which
broadcast against the image's leading dims.
"""

from __future__ import annotations

import torch

from partsbaseddetector_tpu_torch.ops.common import DEFAULT_DTYPE


def _bilinear_matrix(n_out_pad: int, n_in_pad: int, n_out, n_in
                     ) -> torch.Tensor:
    """(..., n_out_pad, n_in_pad) bilinear sampling matrices for OpenCV
    INTER_LINEAR: src coord of dst i is (i + 0.5) * (n_in / n_out) - 0.5,
    edge-clamped.  n_out / n_in: (...,) tensors; rows >= n_out and
    cols >= n_in are zeroed."""
    n_out_f = n_out.to(DEFAULT_DTYPE)[..., None]
    n_in_f = n_in.to(DEFAULT_DTYPE)[..., None]
    dev = n_out_f.device
    i = torch.arange(n_out_pad, dtype=DEFAULT_DTYPE, device=dev)
    f = (i + 0.5) * (n_in_f / n_out_f) - 0.5
    i0 = torch.floor(f)
    frac = f - i0
    frac = torch.where(i0 < 0, 0.0, frac)
    i0c = torch.minimum(torch.clamp_min(i0, 0.0), n_in_f - 1.0)
    frac = torch.where(i0c >= n_in_f - 1.0, 0.0, frac)
    i1c = torch.minimum(torch.clamp_min(i0c + 1.0, 0.0), n_in_f - 1.0)

    j = torch.arange(n_in_pad, dtype=DEFAULT_DTYPE, device=dev)
    m = ((j == i0c[..., None]) * (1.0 - frac[..., None])
         + (j == i1c[..., None]) * frac[..., None])
    # when i0c == i1c (edge), both terms hit the same j: weights sum to 1
    row_valid = (i < n_out_f)[..., None]
    col_valid = (j < n_in_f[..., None])
    return m * row_valid * col_valid


def _separable(rows: torch.Tensor, im: torch.Tensor, cols: torch.Tensor
               ) -> torch.Tensor:
    """out[..., o, p, c] = sum_{h, w} rows[..., o, h] im[..., h, w, c]
    cols[..., p, w], contracted over h first."""
    H, W, C = im.shape[-3:]
    t = torch.matmul(rows, im.reshape(im.shape[:-3] + (H, W * C)))
    Oh = t.shape[-2]
    lead = t.shape[:-2]
    t = t.reshape(lead + (Oh, W, C)).transpose(-3, -2).reshape(
        lead + (W, Oh * C))
    out = torch.matmul(cols, t)                       # (..., Ow, Oh*C)
    Ow = out.shape[-2]
    return out.reshape(lead + (Ow, Oh, C)).transpose(-3, -2)


def _sizes(size, im: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(size, dtype=torch.int32, device=im.device)


def resize_linear(im: torch.Tensor, out_pad: tuple, out_size,
                  in_size=None) -> torch.Tensor:
    """OpenCV INTER_LINEAR resize into a padded buffer.

    im: (..., H_pad, W_pad, C) with valid region in_size = (h, w)
    (defaults to the full buffer); out_pad: padded output shape
    (Oh, Ow); out_size: true output size (oh, ow), (2,) or a batch
    (L, 2).  The matrices' batch dims broadcast against im's leading
    dims.  Region beyond (oh, ow) is zero."""
    H, W = im.shape[-3:-1]
    out_size = _sizes(out_size, im)
    in_size = _sizes((H, W) if in_size is None else in_size, im)
    Ry = _bilinear_matrix(out_pad[0], H, out_size[..., 0], in_size[..., 0])
    Rx = _bilinear_matrix(out_pad[1], W, out_size[..., 1], in_size[..., 1])
    return _separable(Ry, im.to(DEFAULT_DTYPE), Rx)


def _reflect101(idx: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """BORDER_REFLECT_101 folding with per-image size n (n >= 2)."""
    period = 2 * (n - 1)
    idx = torch.abs(idx) % period
    return torch.where(idx >= n, period - idx, idx)


def _pyrdown_matrix(n_out_pad: int, n_in_pad: int, n_in) -> torch.Tensor:
    """(..., n_out_pad, n_in_pad) matrices implementing the 1-D 5-tap
    binomial [1,4,6,4,1]/16 blur + decimate-by-2 with BORDER_REFLECT_101,
    output size ceil(n_in / 2) (reference pyrDown semantics).
    n_in: (...,) int tensor."""
    dev = n_in.device
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=DEFAULT_DTYPE,
                     device=dev) / 16.0
    n_in_i = n_in.to(torch.int32)[..., None]
    n_out = (n_in_i + 1) // 2
    y = torch.arange(n_out_pad, dtype=torch.int32, device=dev)
    j = torch.arange(n_in_pad, dtype=torch.int32, device=dev)
    m = torch.zeros(n_in_i.shape[:-1] + (n_out_pad, n_in_pad),
                    dtype=DEFAULT_DTYPE, device=dev)
    for t in range(5):
        src = _reflect101(2 * y + t - 2, n_in_i)
        m = m + k[t] * (j == src[..., None]).to(DEFAULT_DTYPE)
    row_valid = (y < n_out)[..., None]
    col_valid = (j < n_in_i[..., None])
    return m * row_valid * col_valid


def pyr_down(im: torch.Tensor, out_pad: tuple, in_size) -> torch.Tensor:
    """OpenCV pyrDown into a padded buffer.  im: (..., H_pad, W_pad, C)
    with valid region in_size = (h, w), (2,) or a batch (L, 2)
    broadcasting against im's leading dims; output valid region is
    (ceil(h/2), ceil(w/2)), zeros beyond."""
    H, W = im.shape[-3:-1]
    in_size = _sizes(in_size, im)
    Py = _pyrdown_matrix(out_pad[0], H, in_size[..., 0])
    Px = _pyrdown_matrix(out_pad[1], W, in_size[..., 1])
    return _separable(Py, im.to(DEFAULT_DTYPE), Px)
