"""Port vs JAX: HOG features of padded buffers whose true size is smaller
than the buffer, one true size per image of a batch.

Tolerance atol 1e-5: the tent-binning products and the block sums may
add in another order.  The orientation bins themselves must match — a
flipped bin moves a whole pixel's magnitude between channels, far
beyond that tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops import hog as hog_jax
from partsbaseddetector_tpu_torch.ops import hog as hog_t

torch.set_num_threads(1)


@pytest.mark.parametrize("norient,flen,buf,sizes,feat_pad", [
    (6, 14, (40, 52), [(40, 52), (33, 47), (26, 35)], (8, 11)),
    (18, 32, (48, 64), [(48, 64), (43, 58), (37, 49)], (10, 14)),
])
def test_hog_features_per_level_sizes(norient, flen, buf, sizes, feat_pad):
    rng = np.random.default_rng(norient)
    ims = (rng.random((len(sizes),) + buf + (3,)) * 255).astype(np.float32)
    for j, (h, w) in enumerate(sizes):
        ims[j, h:] = 0
        ims[j, :, w:] = 0
    ref = jax.jit(jax.vmap(lambda im, ts: hog_jax.hog_features(
        im, 4, norient, flen, true_size=(ts[0], ts[1]),
        feat_pad=feat_pad)))(jnp.asarray(ims), jnp.asarray(sizes, jnp.int32))
    got = hog_t.hog_features(torch.from_numpy(ims), 4, norient, flen,
                             true_size=torch.tensor(sizes,
                                                    dtype=torch.int32),
                             feat_pad=feat_pad)
    assert got.shape == ref.shape == (len(sizes),) + feat_pad + (flen,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_hog_single_gray_image():
    im = (np.random.default_rng(3).random((36, 44)) * 255).astype(
        np.float32)
    ref = jax.jit(lambda x: hog_jax.hog_features(x, 4, 18, 32))(
        jnp.asarray(im))
    got = hog_t.hog_features(torch.from_numpy(im), 4, 18, 32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert hog_t.hog_output_shape((36, 44), 4) == \
        hog_jax.hog_output_shape((36, 44), 4)
    # a true size smaller than the buffer sets the default output size
    ref = jax.jit(lambda x: hog_jax.hog_features(
        x, 4, 18, 32, true_size=(29, 41)))(jnp.asarray(im))
    got = hog_t.hog_features(torch.from_numpy(im), 4, 18, 32,
                             true_size=(29, 41))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
