"""Port vs JAX: the scale ladder's resampling ops on padded buffers with
per-level true sizes.

Tolerance rtol 1e-5, atol 1e-3 on the 0-255 scale: both sides are
float32 sampling-matrix products, and the two libraries' matmul kernels
may sum (and fuse multiply-adds) in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops import imageops as io_jax
from partsbaseddetector_tpu_torch.ops import imageops as io_t

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-3)


def _image(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(
        np.float32)


@pytest.mark.parametrize("in_hw,out_pad,sizes", [
    ((48, 64), (48, 64), [(48, 64), (41, 55), (36, 48), (30, 40)]),
    ((37, 53), (40, 56), [(37, 53), (29, 41), (18, 26)]),
])
def test_resize_linear_levels(in_hw, out_pad, sizes):
    im = _image(in_hw + (3,), 1)
    ref = jax.jit(jax.vmap(lambda ts: io_jax.resize_linear(
        jnp.asarray(im), out_pad, (ts[0], ts[1]))))(
            jnp.asarray(sizes, jnp.int32))
    got = io_t.resize_linear(torch.from_numpy(im), out_pad,
                             torch.tensor(sizes, dtype=torch.int32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # beyond each true size the buffer is zero
    for j, (h, w) in enumerate(sizes):
        assert not got[j, h:].any() and not got[j, :, w:].any()


def test_resize_linear_valid_region_and_batch():
    """A valid region smaller than the buffer, and a leading batch of
    frames broadcasting against a batch of sizes."""
    buf = _image((2, 40, 50, 3), 2)
    in_size = (33, 47)
    sizes = [(30, 40), (20, 25)]
    got = io_t.resize_linear(torch.from_numpy(buf)[:, None], (30, 40),
                             torch.tensor(sizes, dtype=torch.int32),
                             in_size=in_size)
    assert got.shape == (2, 2, 30, 40, 3)
    ref = jax.jit(jax.vmap(jax.vmap(
        lambda im, ts: io_jax.resize_linear(im, (30, 40), (ts[0], ts[1]),
                                            in_size=in_size),
        (None, 0)), (0, None)))(jnp.asarray(buf),
                                jnp.asarray(sizes, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("pad,sizes", [
    ((48, 64), [(48, 64), (41, 55), (35, 47)]),
    ((30, 41), [(30, 41), (23, 29), (17, 22)]),
])
def test_pyr_down_levels(pad, sizes):
    bufs = _image((len(sizes),) + pad + (3,), 3)
    for j, (h, w) in enumerate(sizes):      # zeros beyond the valid size
        bufs[j, h:] = 0
        bufs[j, :, w:] = 0
    out_pad = ((pad[0] + 1) // 2, (pad[1] + 1) // 2)
    ref = jax.jit(jax.vmap(lambda b, ts: io_jax.pyr_down(
        b, out_pad, (ts[0], ts[1]))))(jnp.asarray(bufs),
                                      jnp.asarray(sizes, jnp.int32))
    got = io_t.pyr_down(torch.from_numpy(bufs), out_pad,
                        torch.tensor(sizes, dtype=torch.int32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_matrices_match():
    n_out = torch.tensor([17, 9], dtype=torch.int32)
    n_in = torch.tensor([23, 23], dtype=torch.int32)
    got = io_t._bilinear_matrix(20, 25, n_out, n_in).numpy()
    ref = jax.jit(jax.vmap(lambda o, i: io_jax._bilinear_matrix(
        20, 25, o, i)))(jnp.asarray(n_out.numpy()), jnp.asarray(n_in.numpy()))
    np.testing.assert_array_equal(got, np.asarray(ref))
    got = io_t._pyrdown_matrix(13, 25, n_in).numpy()
    ref = jax.jit(lambda n: io_jax._pyrdown_matrix(13, 25, n))(23)
    np.testing.assert_array_equal(got[0], np.asarray(ref))
