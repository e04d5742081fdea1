"""Port vs JAX: the occlusion padding (exact) and the filter-bank conv
with per-level true sizes.

Conv tolerance rtol 1e-5, atol 1e-4: a 5x5x32 correlation summed in
another order by the two libraries' float32 conv kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops import conv as conv_jax
from partsbaseddetector_tpu_torch.ops import conv as conv_t

torch.set_num_threads(1)


def _feats(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("pads", [(2, 2, 2, 2), (1, 2, 0, 3), (0, 0, 0, 0)])
def test_occlusion_pad_exact(pads):
    f = _feats((3, 7, 9, 14), 1)
    sizes = [(7, 9), (5, 6), (2, 8)]
    ref = jax.jit(jax.vmap(lambda x, ts: conv_jax.occlusion_pad(
        x, pads, ts)))(jnp.asarray(f), jnp.asarray(sizes, jnp.int32))
    got = conv_t.occlusion_pad(torch.from_numpy(f), pads,
                               torch.tensor(sizes, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        conv_t.occlusion_pad(torch.from_numpy(f), pads).numpy(),
        np.asarray(jax.jit(lambda x: conv_jax.occlusion_pad(x, pads))(
            jnp.asarray(f))))


@pytest.mark.parametrize("ksizes,C", [((5, 5, 5), 32), ((3, 5, 2), 14)])
def test_conv_bank_per_level_sizes(ksizes, C):
    rng = np.random.default_rng(C)
    filters = [(rng.standard_normal((k, k, C)) * 0.05).astype(np.float32)
               for k in ksizes]
    bank_np, sizes_np = conv_t.pack_filter_bank(filters)
    bank_ref, sizes_ref = conv_jax.pack_filter_bank(filters)
    np.testing.assert_array_equal(bank_np, bank_ref)
    np.testing.assert_array_equal(sizes_np, sizes_ref)
    f = _feats((3, 12, 15, C), 2)
    tsizes = [(12, 15), (9, 11), (6, 7)]
    ref = jax.jit(conv_jax.conv_bank)(jnp.asarray(f), jnp.asarray(bank_ref),
                                      jnp.asarray(tsizes, jnp.int32))
    got = conv_t.conv_bank(torch.from_numpy(f), torch.from_numpy(bank_np),
                           true_size=torch.tensor(tsizes,
                                                  dtype=torch.int32))
    assert got.shape == ref.shape == (3, 12, 15, len(ksizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)
    # one map, no true size
    ref1 = jax.jit(conv_jax.conv_bank)(jnp.asarray(f[0]),
                                       jnp.asarray(bank_ref))
    got1 = conv_t.conv_bank(torch.from_numpy(f[0]),
                            torch.from_numpy(bank_np))
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("ksizes,C", [((5, 5, 5), 6), ((3, 5, 2), 14)])
def test_conv_bank_fft_matches_jax(ksizes, C):
    """The FFT engine against the JAX package's, on the shapes of
    tests/test_ops_vs_oracle.py:229-243: atol 2e-4, as there.  The
    port's FFT also agrees with its own spatial engine to that bound."""
    rng = np.random.default_rng(len(ksizes) + C)
    filters = [rng.standard_normal((k, k, C)) for k in ksizes]
    bank, _ = conv_t.pack_filter_bank(filters)
    f = rng.standard_normal((2, 21, 17, C)).astype(np.float32)
    ts = [[21, 17], [15, 11]]
    ref = jax.jit(conv_jax.conv_bank_fft)(
        jnp.asarray(f), jnp.asarray(bank), jnp.asarray(ts, jnp.int32))
    args = (torch.from_numpy(f), torch.from_numpy(bank))
    tst = torch.tensor(ts, dtype=torch.int32)
    got = conv_t.conv_bank_fft(*args, true_size=tst)
    assert got.shape == ref.shape == (2, 21, 17, len(ksizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    np.testing.assert_allclose(
        got.numpy(), conv_t.conv_bank(*args, true_size=tst).numpy(),
        atol=2e-4)
    one = conv_t.conv_bank_fft(args[0][0], args[1])
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jax.jit(conv_jax.conv_bank_fft)(
            jnp.asarray(f[0]), jnp.asarray(bank))), atol=2e-4)
    assert conv_t.CONV_ENGINES == {"spatial": conv_t.conv_bank,
                                   "fft": conv_t.conv_bank_fft}
