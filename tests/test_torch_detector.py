"""End to end: the port's Detector against the JAX Detector on the same
model and image, on the CPU.

* tiny model at 64x80, k_per_level=8: ``loc``, ``valid``, ``level``,
  ``component`` and ``boxes`` exact, ``score`` rtol 1e-5 (conv and
  resampling sums in another order);
* person-26 at 120x160 on test_native_parity's structured image: the
  cross-engine contract of tests/test_native_parity.py:118-139 (root
  top-K keys >= 0.9, PCK(1 cell) >= 0.99, exact parts >= 0.9, median
  score difference < 1e-4), plus ``valid`` and ``level`` exact;
* a batch of frames equals each frame's detect_raw.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.infer.detector import Detector as DetectorJax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu_torch.infer.detector import Detection, Detector
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from test_native_parity import structured_image

torch.set_num_threads(1)

FIELDS = ("score", "valid", "component", "level", "boxes", "loc")


def _np(c, f):
    v = getattr(c, f)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("compose", ["reference", "correct"])
def test_tiny_matches_jax(compose):
    mj, mt = syn_jax.tiny(seed=3), syn_t.tiny(seed=3)
    mj.thresh = mt.thresh = -1e9
    im = np.random.default_rng(7).random((64, 80, 3)) * 255
    ref = DetectorJax(mj, k_per_level=8, compose=compose).detect_raw(im)
    det = Detector(mt, k_per_level=8, compose=compose, device="cpu")
    assert det.dp_split == 2 and det.walk_impl == "torch"
    got = det.detect_raw(im)
    assert got.capacity == 6 * 8
    for f in ("valid", "component", "level", "boxes", "loc"):
        np.testing.assert_array_equal(_np(got, f), _np(ref, f), err_msg=f)
        assert _np(got, f).dtype == _np(ref, f).dtype, f
    np.testing.assert_allclose(_np(got, "score"), _np(ref, "score"),
                               rtol=1e-5, atol=0)


def test_person26_contract_vs_jax():
    mj, mt = syn_jax.person_like(), syn_t.person_like()
    mj.thresh = mt.thresh = -1e9
    k = 8
    img = structured_image(101, 120, 160)
    # dp_split=1 keeps the JAX program's compile time small; the port's
    # default grouping is covered by the tiny cases
    ref = DetectorJax(mj, k_per_level=k, dp_split=1).detect_raw(img)
    got = Detector(mt, k_per_level=k, dp_split=1,
                   device="cpu").detect_raw(img)
    for f in ("valid", "level"):
        np.testing.assert_array_equal(_np(got, f), _np(ref, f), err_msg=f)
    gl, rl = _np(got, "loc"), _np(ref, "loc")
    gs, rs = _np(got, "score"), _np(ref, "score")
    glev = _np(got, "level")
    total = matched = exact = close = nparts = 0
    diffs = []
    for lvl in np.unique(glev):
        sel = np.nonzero(glev == lvl)[0]
        g = {(int(gl[i, 0, 0]), int(gl[i, 0, 1])): i for i in sel}
        r = {(int(rl[i, 0, 0]), int(rl[i, 0, 1])): i for i in sel}
        total += k
        for key in set(g) & set(r):
            matched += 1
            i, j = g[key], r[key]
            diffs.append(abs(gs[i] - rs[j]))
            dd = np.abs(gl[i, :, :2] - rl[j, :, :2])
            nparts += gl.shape[1]
            exact += int(((dd == 0).all(1) & (gl[i, :, 2] == rl[j, :, 2]))
                         .sum())
            close += int((dd.max(1) <= 1).sum())
    assert matched >= 0.9 * total, (matched, total)
    assert np.median(diffs) < 1e-4
    assert close >= 0.99 * nparts, (close, nparts)
    assert exact >= 0.9 * nparts, (exact, nparts)


@pytest.mark.parametrize("maker,shape", [("tiny", (64, 80)),
                                         ("person_like", (60, 84))])
def test_batch_equals_single_frames(maker, shape):
    m = getattr(syn_t, maker)(seed=5)
    m.thresh = -1e9
    det = Detector(m, k_per_level=8, device="cpu")
    ims = (np.random.default_rng(9).random((2,) + shape + (3,)) * 255
           ).astype(np.uint8)
    batch = det.detect_batch_raw(ims)
    nlev = len(det.plan_for(shape).levels)
    assert batch.score.shape == (2, nlev * 8)
    assert batch.loc.shape == (2, nlev * 8, m.components[0].nparts, 3)
    for b in range(2):
        one = det.detect_raw(ims[b])
        for f in FIELDS:
            assert torch.equal(getattr(batch, f)[b], getattr(one, f)), f
        s = one.score[one.valid]
        assert torch.all(s[:-1] >= s[1:])


def test_detect_returns_host_detections():
    m = syn_t.tiny(seed=1)
    m.thresh = -1e9
    det = Detector(m, k_per_level=4, device="cpu")
    im = np.random.default_rng(2).random((48, 56)) * 255    # grayscale
    dets = det.detect(im, max_detections=5)
    assert len(dets) == 5 and all(isinstance(d, Detection) for d in dets)
    assert [d.score for d in dets] == sorted((d.score for d in dets),
                                             reverse=True)
    assert dets[0].parts.shape == (4, 4)
    assert dets[0].bounding_box().shape == (4,)
    det.update_model(syn_t.tiny(seed=2))
    assert len(det.detect(im)) == det.detect_raw(im).count()


def test_fetch_builds_detections_with_the_collector_off(monkeypatch):
    """The fetch's Detections are built with the cyclic collector held
    off, and it is on again after; the detections are those built with it
    on."""
    import gc

    import partsbaseddetector_tpu_torch.infer.detector as detector
    m = syn_t.tiny(seed=1)
    m.thresh = -1e9
    cands = Detector(m, k_per_level=4, device="cpu").detect_raw(
        np.random.default_rng(2).random((48, 56)) * 255)
    want = Detector.candidates_to_detections(cands)
    states = []

    def built(**kw):
        states.append(gc.isenabled())
        return Detection(**kw)

    monkeypatch.setattr(detector, "Detection", built)
    assert gc.isenabled()
    got = Detector.candidates_to_detections(cands)
    assert gc.isenabled()
    assert states == [False] * cands.count() and len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.score, a.component, a.level) == (b.score, b.component,
                                                   b.level)
        np.testing.assert_array_equal(a.parts, b.parts)
        np.testing.assert_array_equal(a.locations, b.locations)


def test_out_of_scope_options_raise():
    """What the port leaves to other entry points or removed (ROADMAP.md
    queue 1 item 20) raises; the options it carries are accepted."""
    m = syn_t.tiny()
    with pytest.raises(ValueError, match="MultiResDetector"):
        Detector(syn_t.tiny_multires(), device="cpu")
    with pytest.raises(ValueError, match="walk_impl"):
        Detector(m, walk_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="conv_engine"):
        Detector(m, conv_engine="wavelet", device="cpu")
    with pytest.raises(TypeError):
        Detector(m, dt_impl="xla", device="cpu")
    det = Detector(m, device="cpu")
    im = np.zeros((40, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="depth_prune"):
        det.detect_raw(im, depth=np.ones((40, 40)))
    shared = syn_t.tiny()
    shared.components[0].parts[2].filterid[0] = \
        shared.components[0].parts[1].filterid[0]
    assert Detector(shared, device="cpu").packed.components[0].aliased
    assert Detector(m, conv_engine="fft", device="cpu").conv_engine == "fft"


def test_bounding_box_norm_matches_jax():
    """Detection.bounding_box_norm (include/Candidate.hpp:117-130) on one
    detection, against the JAX package's method: exact."""
    from partsbaseddetector_tpu.infer.detector import Detection as DetJax
    parts = np.random.default_rng(4).uniform(0, 90, (26, 4))
    parts[:, 2:] += parts[:, :2]
    locs = np.zeros((26, 3), np.int32)
    got = Detection(1.0, 0, 3, parts, locs).bounding_box_norm()
    ref = DetJax(1.0, 0, 3, parts, locs).bounding_box_norm()
    assert got.shape == (4,)
    np.testing.assert_array_equal(got, ref)
