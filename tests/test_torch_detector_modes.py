"""End to end on the CPU, the port's Detector against the JAX Detector in
the modes beyond the plain path: a model with shared filter ids (the
aliased DP, tests/test_aliasing.py's ``aliased_chain``) with depth
pruning, the masked latent search, the feature write-back, and the FFT
conv engine.

Tolerances: ``loc``, ``valid``, ``level`` and ``component`` exact,
``score`` rtol 1e-5 with atol 1e-6 (conv and resampling sums in
another order; a score near zero is a sum of terms near 0.1, whose
rounding the rtol alone would not admit);
features atol 1e-5 (tests/test_torch_hog.py); the FFT engine by the
cross-engine tolerance of tests/test_detector.py:125-148 (``valid``
exact, ``score`` atol 2e-3, the top four valid ``loc`` equal)."""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.infer.detector import DepthPrune as DepthPruneJax
from partsbaseddetector_tpu.infer.detector import Detector as DetectorJax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.train import features as feat_mod
from partsbaseddetector_tpu_torch.infer.detector import DepthPrune, Detector
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from test_aliasing import aliased_chain

torch.set_num_threads(1)

# tests/test_depth_prune.py's config
CFG = dict(part_width_m=0.2, fx=400.0, tol=0.3)
EXACT = ("valid", "component", "level", "loc")


def _np(c, f):
    v = getattr(c, f)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same(got, ref):
    for f in EXACT:
        np.testing.assert_array_equal(_np(got, f), _np(ref, f), err_msg=f)
    np.testing.assert_allclose(_np(got, "score"), _np(ref, "score"),
                               rtol=1e-5, atol=1e-6)


def aliased_chain_t(seed: int = 13):
    """tests/test_aliasing.py's aliased_chain, built by the port's
    synthetic module: parent/child and within-part filter sharing."""
    model = syn_t.make_model(
        name="aliased_chain", nparts=4, nmixtures=2, root_nmixtures=2,
        filter_size=3, norient=6, flen=14, binsize=4, interval=3,
        parent=[-1, 0, 1, 2], seed=seed)
    comp = model.components[0]
    comp.parts[2].filterid[0] = comp.parts[1].filterid[0]
    comp.parts[1].filterid[1] = comp.parts[1].filterid[0]
    model.validate()
    return model


@pytest.fixture(scope="module")
def aliased():
    mj, mt = aliased_chain(13), aliased_chain_t(13)
    mj.thresh = mt.thresh = -1e9
    for a, b in zip(mj.filters, mt.filters):
        np.testing.assert_array_equal(a, b)
    im = np.random.default_rng(17).random((64, 80, 3)) * 255
    dj = DetectorJax(mj, k_per_level=8, depth_prune=DepthPruneJax(**CFG))
    dt = Detector(mt, k_per_level=8, depth_prune=DepthPrune(**CFG),
                  device="cpu")
    assert dt.packed.components[0].aliased
    return dj, dt, im


def _keys(c):
    v = _np(c, "valid")
    return {(int(lv), int(x[0, 0]), int(x[0, 1]))
            for lv, x in zip(_np(c, "level")[v], _np(c, "loc")[v])}


def test_aliased_depth_matches_jax(aliased):
    """tests/test_depth_prune.py's four cases on the aliased model, each
    run against the JAX Detector."""
    dj, dt, im = aliased
    shape = im.shape[:2]
    base = dt.detect_raw(im)
    _assert_same(base, dj.detect_raw(im))
    plan = dt.plan_for(shape)
    scales = [lv.scale for lv in plan.levels]
    z = CFG["fx"] * CFG["part_width_m"]
    ztarget = z / scales[len(scales) // 2]
    depths = {"zero": np.zeros(shape, np.float32),
              "far": np.full(shape, 500.0, np.float32),
              "plausible": np.full(shape, ztarget, np.float32)}
    got = {}
    for name, d in depths.items():
        got[name] = dt.detect_raw(im, depth=d)
        _assert_same(got[name], dj.detect_raw(im, depth=d))
    # depth 0 means unknown: never pruned
    for f in EXACT + ("score",):
        assert torch.equal(getattr(got["zero"], f), getattr(base, f)), f
    # a depth implausible at every level prunes every response
    assert not got["far"].valid.any()
    # a depth plausible at some levels keeps exactly the unpruned
    # candidates of those levels
    plausible = {i for i, s in enumerate(scales)
                 if abs(ztarget - z / s) <= CFG["tol"] * z / s}
    assert {k[0] for k in _keys(got["plausible"])} <= plausible
    assert _keys(got["plausible"]) == {k for k in _keys(base)
                                       if k[0] in plausible}
    # without a depth map the depth-configured detector is the plain one
    plain = Detector(dt.model, k_per_level=8, device="cpu")
    assert _keys(plain.detect_raw(im)) == _keys(base)
    with pytest.raises(ValueError, match="depth_prune"):
        plain.detect_raw(im, depth=depths["zero"])


def test_aliased_depth_batch_equals_frames(aliased):
    """detect_batch_raw with one depth map per frame equals each frame's
    detect_raw with its own map."""
    _, dt, im = aliased
    rng = np.random.default_rng(5)
    ims = np.stack([im, im[::-1], im[:, ::-1]]).astype(np.float32)
    depths = rng.uniform(1.0, 6.0, (3,) + im.shape[:2]).astype(np.float32)
    depths[rng.random(depths.shape) < 0.3] = 0.0
    batch = dt.detect_batch_raw(ims, depths=depths)
    for b in range(3):
        one = dt.detect_raw(ims[b], depth=depths[b])
        for f in EXACT + ("score", "boxes"):
            assert torch.equal(getattr(batch, f)[b], getattr(one, f)), f
    assert 0 < int(batch.count().min())


def _bucket_masks(model, plan, gt, overlap):
    """train/features.part_overlap_masks stacked per plan bucket, as
    train/trainer.py:390-397 does."""
    by_level = feat_mod.part_overlap_masks(model, 0, plan, gt, overlap)
    out, li = [], 0
    for bucket in plan.buckets:
        out.append(np.stack(by_level[li:li + len(bucket.levels)]))
        li += len(bucket.levels)
    return out


def test_aliased_masked_matches_jax(aliased):
    dj, dt, im = aliased
    P = dt.model.components[0].nparts
    gt = np.asarray([[6, 6, 44, 44]] * P, float)
    masks = _bucket_masks(aliased_chain(13), dt.plan_for(im.shape[:2]), gt,
                          0.05)
    got = dt.detect_masked_raw(im, masks)
    _assert_same(got, dj.detect_masked_raw(im, masks))
    assert int(got.count()) > 0
    # the masks bind: the masked search differs from the plain one
    assert not torch.equal(got.loc, dt.detect_raw(im).loc)


def test_pyramid_features_match_jax(aliased):
    dj, dt, im = aliased
    got = dt.pyramid_features(im)
    ref = dj.pyramid_features(im)
    assert len(got) == len(ref) == len(dt.plan_for(im.shape[:2]).levels)
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray) and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)


def test_fft_detector_matches_jax():
    mj, mt = syn_jax.tiny(seed=3), syn_t.tiny(seed=3)
    mj.thresh = mt.thresh = -1e9
    im = np.random.default_rng(9).random((64, 64, 3)) * 255
    ref = DetectorJax(mj, k_per_level=8, conv_engine="fft").detect_raw(im)
    got = Detector(mt, k_per_level=8, conv_engine="fft",
                   device="cpu").detect_raw(im)
    np.testing.assert_array_equal(_np(got, "valid"), _np(ref, "valid"))
    np.testing.assert_allclose(_np(got, "score"), _np(ref, "score"),
                               atol=2e-3)
    v = _np(ref, "valid")
    np.testing.assert_array_equal(_np(got, "loc")[v][:4],
                                  _np(ref, "loc")[v][:4])
    with pytest.raises(ValueError, match="conv_engine"):
        Detector(mt, conv_engine="wavelet", device="cpu")


def aliased_person_jax():
    """chip_smoke.py's aliased person-26 fixture, built by the JAX
    package: in every non-root part mixtures 1-3 take mixture 0's filter
    id, then parts 1-8 take their parent's mixture-0 id for mixture 0."""
    m = syn_jax.person_like()
    parts = m.components[0].parts
    own = [p.filterid[0] for p in parts]
    for part in parts[1:]:
        for j in range(1, part.nmixtures):
            part.filterid[j] = part.filterid[0]
    for q in range(1, 9):
        parts[q].filterid[0] = own[parts[q].parentid]
    m.validate()
    return m


def test_chip_smoke_fixtures_pack_as_jax():
    """The card's fixtures: the aliased person-26 packs as aliased and
    equal to the JAX package's packing of the same model (exact), and
    the multi-resolution person-26 has its root one octave coarser than
    its 25 other parts."""
    import chip_smoke
    from partsbaseddetector_tpu.models import part_tree as tree_jax
    from partsbaseddetector_tpu_torch.models.part_tree import pack_model
    from test_torch_models import port_packed
    jp = tree_jax.pack_model(aliased_person_jax())
    assert jp.components[0].aliased
    ref = port_packed(jp).components[0]
    got = pack_model(chip_smoke.aliased_person(), "cpu").components[0]
    assert got.aliased
    assert got.message_fids == ref.message_fids
    for f in ("filterid", "defw", "anchor", "bias", "parent", "nmix",
              "mix_valid", "fsize"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    mr = chip_smoke.multires_person()
    assert mr.part_scales(0) == [0] + [1] * 25
