"""Port vs JAX: the shifted/strided distance transform and the
multi-resolution detector (synthetic.tiny_multires: part 1 one octave
finer than the root), on the same numpy inputs, on the CPU.

Tolerances: shiftdt maxima rtol 1e-6, atol 1e-5 (the penalty expression
in the JAX package's order) and argmax tables exact;
MultiResDetector ``loc``/``valid``/``level``/``component`` exact and
``score`` rtol 1e-5 with the spatial engine; with the FFT engine the
cross-engine tolerance of tests/test_detector.py:125-148 (``valid``
exact, ``score`` atol 2e-3, the top four valid ``loc`` equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.infer.detector import DepthPrune as DepthPruneJax
from partsbaseddetector_tpu.infer.multires import \
    MultiResDetector as MultiResJax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.ops import dt as dt_jax
from partsbaseddetector_tpu_torch.infer.detector import DepthPrune
from partsbaseddetector_tpu_torch.infer.multires import MultiResDetector
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from partsbaseddetector_tpu_torch.ops import dt as dt_t
from test_multires_masked import _mask_fixtures

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-5)
W4 = np.array([0.1, -0.02, 0.07, 0.01], np.float32)
EXACT = ("valid", "component", "level", "loc")


def _np(c, f):
    v = getattr(c, f)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same(got, ref, rtol=1e-5):
    for f in EXACT:
        np.testing.assert_array_equal(_np(got, f), _np(ref, f), err_msg=f)
    np.testing.assert_allclose(_np(got, "score"), _np(ref, "score"),
                               rtol=rtol, atol=0)


# the parameters of test_ops_vs_oracle.py::test_shiftdt_matches_oracle
@pytest.mark.parametrize("step,start,out_shape", [
    (1, (0, 0), (13, 13)), (2, (3, 1), (6, 7)), (2, (-2, -4), (8, 6)),
    (4, (5, 2), (4, 4))])
def test_shiftdt(step, start, out_shape):
    rng = np.random.default_rng(step + out_shape[0])
    score = rng.standard_normal((13, 15)).astype(np.float32) * 3
    startx, starty = start
    leny, lenx = out_shape
    ref = jax.jit(dt_jax.shiftdt, static_argnums=(2, 3, 4, 5, 6))(
        jnp.asarray(score), jnp.asarray(W4), startx, starty, lenx, leny,
        step)
    got = dt_t.shiftdt(torch.from_numpy(score), torch.from_numpy(W4),
                       startx, starty, lenx, leny, step)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    # the max-only pair the multi-resolution DP runs, one parameter set
    # per mixture over a leading axis (the JAX package vmaps scalars)
    src = rng.standard_normal((2, 3, 13, 15)).astype(np.float32)
    w = (W4[None] * rng.uniform(0.5, 1.5, (3, 1))).astype(np.float32)
    anc = rng.integers(-3, 4, (3, 2)).astype(np.float32)
    ref_out, ref_tmp = jax.jit(jax.vmap(jax.vmap(
        lambda s, wm, am: dt_jax.shiftdt_max(s, wm, am[0], am[1], lenx,
                                             leny, step)),
        (0, None, None)))(jnp.asarray(src), jnp.asarray(w),
                          jnp.asarray(anc))
    out, tmp = dt_t.shiftdt_max(torch.from_numpy(src), torch.from_numpy(w),
                                torch.from_numpy(anc[:, 0]),
                                torch.from_numpy(anc[:, 1]), lenx, leny,
                                step)
    assert out.shape == (2, 3, leny, lenx) and tmp.shape == (2, 3, leny, 15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(tmp.numpy(), np.asarray(ref_tmp), **TOL)


@pytest.fixture(scope="module")
def models():
    mj, mt = syn_jax.tiny_multires(seed=5), syn_t.tiny_multires(seed=5)
    mj.thresh = mt.thresh = -1e9
    return mj, mt


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(11).random((80, 96)) * 255


def test_multires_plain_and_depth_match_jax(models, image):
    mj, mt = models
    cfg = dict(part_width_m=0.2, fx=400.0, tol=0.3)
    rng = np.random.default_rng(3)
    # plausible for a few levels, unknown (0) in places
    depth = rng.uniform(1.0, 6.0, image.shape).astype(np.float32)
    depth[rng.random(image.shape) < 0.2] = 0.0
    dj = MultiResJax(mj, k_per_level=8, depth_prune=DepthPruneJax(**cfg))
    dt = MultiResDetector(mt, k_per_level=8, depth_prune=DepthPrune(**cfg),
                          device="cpu")
    plain = dt.detect_raw(image)
    nlev = len(dt.plan_for(image.shape).levels)
    smax = mt.max_scale()
    assert plain.capacity == (nlev - smax * mt.interval) * 8
    _assert_same(plain, dj.detect_raw(image))
    pruned = dt.detect_raw(image, depth=depth)
    _assert_same(pruned, dj.detect_raw(image, depth=depth))
    assert 0 < int(pruned.count()) < int(plain.count())
    with pytest.raises(ValueError, match="depth_prune"):
        MultiResDetector(mt, device="cpu").detect_raw(image, depth=depth)


def test_multires_fft_matches_jax(models, image):
    mj, mt = models
    ref = MultiResJax(mj, k_per_level=8, conv_engine="fft").detect_raw(image)
    got = MultiResDetector(mt, k_per_level=8, conv_engine="fft",
                           device="cpu").detect_raw(image)
    np.testing.assert_array_equal(_np(got, "valid"), _np(ref, "valid"))
    np.testing.assert_allclose(_np(got, "score"), _np(ref, "score"),
                               atol=2e-3)
    v = _np(ref, "valid")
    np.testing.assert_array_equal(_np(got, "loc")[v][:4],
                                  _np(ref, "loc")[v][:4])
    with pytest.raises(ValueError, match="conv_engine"):
        MultiResDetector(mt, conv_engine="wavelet", device="cpu")


def test_multires_masked_matches_jax(models, image):
    mj, mt = models
    dt = MultiResDetector(mt, k_per_level=8, device="cpu")
    part_masks, _ = _mask_fixtures(mj, dt.plan_for(image.shape),
                                   image.shape)
    ref = MultiResJax(mj, k_per_level=8).detect_masked_raw(image,
                                                           part_masks)
    got = dt.detect_masked_raw(image, part_masks)
    _assert_same(got, ref)
    assert int(got.count()) > 0
    # the masks bind: the masked search differs from the plain one
    assert not torch.equal(got.loc, dt.detect_raw(image).loc)


def test_multires_facade(models, image):
    _, mt = models
    det = MultiResDetector(mt, k_per_level=4, device="cpu")
    dets = det.detect(image, max_detections=3)
    assert len(dets) == 3
    assert [d.score for d in dets] == sorted((d.score for d in dets),
                                             reverse=True)
    feats = det.pyramid_features(image)
    plan = det.plan_for(image.shape)
    assert [f.shape[:2] for f in feats] == [lv.featsize
                                            for lv in plan.levels]
    before = det.detect_raw(image)
    det.update_model(syn_t.tiny_multires(seed=6))
    after = det.detect_raw(image)
    assert after.capacity == before.capacity
    assert not torch.equal(after.score, before.score)
    shared = syn_t.tiny_multires(seed=5)
    comp = shared.components[0]
    comp.parts[2].filterid[0] = comp.parts[1].filterid[0]
    with pytest.raises(NotImplementedError, match="shared filter"):
        MultiResDetector(shared, device="cpu")
