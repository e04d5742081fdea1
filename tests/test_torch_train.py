"""Port vs JAX: the training subsystem on the CPU.

The numpy modules the port copies (QP cache, vectorization, clustering,
model assembly, training features) give bitwise-equal results on the
same inputs.  The trainer, which runs its detects through the port's
Detector (device="cpu" here), gives the JAX trainer's log lines,
weights within 1e-6 of max|w| and thresholds within 1e-6 (float32
detector scores summed in another order decide nothing differently at
this size).  The invariant |w . detection_feature - score| < 5e-3 is
the one of tests/test_train.py:72-91."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.infer.detector import Detector as DetectorJax
from partsbaseddetector_tpu.infer.pyramid_plan import make_plan as plan_jax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.tools import datasets as ds_jax
from partsbaseddetector_tpu.train import build as build_jax
from partsbaseddetector_tpu.train import cluster as cluster_jax
from partsbaseddetector_tpu.train import features as feat_jax
from partsbaseddetector_tpu.train import qp as qp_jax
from partsbaseddetector_tpu.train import trainer as trainer_jax
from partsbaseddetector_tpu.train import vectorize as vec_jax
from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.infer.multires import MultiResDetector
from partsbaseddetector_tpu_torch.infer.pyramid_plan import make_plan
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from partsbaseddetector_tpu_torch.tools import datasets as ds_t
from partsbaseddetector_tpu_torch.train import build as build_t
from partsbaseddetector_tpu_torch.train import cluster as cluster_t
from partsbaseddetector_tpu_torch.train import features as feat_t
from partsbaseddetector_tpu_torch.train import qp as qp_t
from partsbaseddetector_tpu_torch.train import trainer as trainer_t
from partsbaseddetector_tpu_torch.train import vectorize as vec_t
from test_torch_model_io import assert_same_model

torch.set_num_threads(1)

#: the prune-and-continue config of tests/test_train.py:202-227
SMALL = dict(nmix=1, binsize=4, interval=3, latent_iters=1, nmax=24,
             k_per_level=8, neg_per_image=4, C=0.05, overlap=0.35)
#: weights and threshold of the port's trainer vs the JAX trainer,
#: relative to max|w|
E2E_TOL = 1e-6


def _vec(vec_mod, model):
    return vec_mod.model_to_vec(model, vec_mod.BlockLayout.for_model(model))


def assert_close_weights(a, b, tol=E2E_TOL):
    """Two trained models: the same structure, weights within tol of
    max|w| and thresholds within tol."""
    wa, wb = _vec(vec_t, a)[0], _vec(vec_jax, b)[0]
    assert wa.shape == wb.shape
    assert np.abs(wa - wb).max() <= tol * np.abs(wb).max()
    assert abs(a.thresh - b.thresh) <= tol
    for ca, cb in zip(a.components, b.components):
        assert [vars(p) for p in ca.parts] == [vars(p) for p in cb.parts]
    for xa, xb in zip(a.anchors, b.anchors):
        np.testing.assert_array_equal(xa, xb)


# ------------------------------------------------------------------ QP

def _seeded_cache(mod, seed):
    rng = np.random.default_rng(seed)
    L = 40
    wreg = rng.uniform(0.5, 2.0, L)
    wreg[0] = 0.01
    w0 = np.zeros(L)
    w0[[3, 5]] = 0.01
    qp = mod.QPCache(L, 64, wreg, w0, np.asarray([3, 5], np.int64),
                     c_pos=0.1, c_neg=0.05, seed=seed)
    for i in range(12):
        qp.write(np.concatenate([[1.0], rng.normal(1.0, 1.0, L - 1)]),
                 (1, i, 0, 0, 0), 1)
    qp.svfix = 12
    for i in range(40):
        qp.write(np.concatenate([[1.0], rng.normal(-0.5, 1.0, L - 1)]),
                 (-1, i // 3, i % 3, 0, 0), -1)
    return qp, rng


def _qp_trace(mod, seed):
    qp, rng = _seeded_cache(mod, seed)
    out = []
    qp.optimize()
    out += [qp.w.copy(), qp.a.copy(), qp.lb, qp.ub, qp.sv.copy()]
    qp.prune()
    out += [qp.n, qp.x[:qp.n].copy(), qp.ids[:qp.n].copy()]
    for i in range(10):
        qp.write(np.concatenate([[1.0], rng.normal(0.0, 1.0, qp.len - 1)]),
                 (-1, 50 + i, 0, 0, 0), -1)
    qp.one_pass()
    out += [qp.w.copy(), qp.lb, qp.ub]
    qp.optimize(tol=0.01, max_iter=50)
    out += [qp.final_w(), qp.score_positives(), qp.lb, qp.ub]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_qpcache_bitwise_equal(seed):
    for got, ref in zip(_qp_trace(qp_t, seed), _qp_trace(qp_jax, seed)):
        assert np.array_equal(got, ref)


def _qp_separable_2d():
    rng = np.random.default_rng(0)
    n = 40
    X = np.vstack([rng.normal([2, 2], 0.3, (n, 2)),
                   rng.normal([-2, -2], 0.3, (n, 2))])
    y = np.hstack([np.ones(n), -np.ones(n)])
    qp = qp_t.QPCache(3, 2 * n, np.ones(3), np.zeros(3),
                      np.zeros(0, np.int64), c_pos=1.0, c_neg=1.0)
    for i in range(2 * n):
        qp.write(np.concatenate([[1.0], X[i]]), (int(y[i]), i, 0, 0, 0),
                 int(y[i]))
    qp.optimize(tol=0.01)
    margins = y * (np.hstack([np.ones((2 * n, 1)), X]) @ qp.final_w())
    assert (margins > 0).mean() == 1.0
    assert 1.0 - qp.lb / qp.ub < 0.02


def _qp_group_constraint():
    qp = qp_t.QPCache(2, 8, np.ones(2), np.zeros(2), np.zeros(0, np.int64),
                      c_pos=1.0, c_neg=1.0)
    rng = np.random.default_rng(1)
    for _ in range(4):   # 4 constraints, same id -> one group
        qp.write(rng.normal(0, 1, 2), (1, 7, 0, 0, 0), 1)
    qp.optimize()
    assert qp._group_keys().max() == 0
    assert qp.a[:qp.n].sum() <= 1.0 + 1e-6


def _qp_noneg_projection():
    qp = qp_t.QPCache(2, 4, np.ones(2), np.zeros(2),
                      np.asarray([1], np.int64), c_pos=1.0, c_neg=1.0)
    qp.write(np.array([1.0, -5.0]), (1, 0, 0, 0, 0), 1)
    qp.optimize()
    assert qp.w[1] >= 0.0


@pytest.mark.parametrize("case", [_qp_separable_2d, _qp_group_constraint,
                                  _qp_noneg_projection],
                         ids=lambda f: f.__name__[4:])
def test_qp_units(case):
    """The QP unit tests of tests/test_train.py:16-55 on the port."""
    case()


# --------------------------------------------------- vectorize, cluster

@pytest.mark.parametrize("maker", ["tiny", "person_like"])
def test_vectorize_bitwise_equal(maker):
    mt, mj = getattr(syn_t, maker)(seed=2), getattr(syn_jax, maker)(seed=2)
    lt = vec_t.BlockLayout.for_model(mt)
    lj = vec_jax.BlockLayout.for_model(mj)
    assert dataclasses.astuple(lt).__repr__() == \
        dataclasses.astuple(lj).__repr__()
    for got, ref in zip(vec_t.model_to_vec(mt, lt),
                        vec_jax.model_to_vec(mj, lj)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    w = np.random.default_rng(3).normal(size=lt.length)
    back_t = vec_t.vec_to_model(w, mt, lt)
    back_j = vec_jax.vec_to_model(w, mj, lj)
    assert_same_model(back_t, back_j)
    assert np.array_equal(vec_t.model_to_vec(back_t, lt)[0], w)


@pytest.fixture(scope="module")
def skeletons():
    pos, _ = ds_t.synthetic_skeletons(n=12, seed=7)
    return np.stack([s.points for s in pos])


def test_cluster_bitwise_equal(skeletons):
    parents = ds_t.PERSON26_PARENTS
    bt = cluster_t.point_to_box(skeletons, parents)
    bj = cluster_jax.point_to_box(skeletons, parents)
    assert np.array_equal(bt, bj)
    tsize = build_t.template_size(bt, 4)
    assert tsize == build_jax.template_size(bj, 4)
    dt_ = cluster_t.data_def(skeletons, bt, tsize)
    assert np.array_equal(dt_, cluster_jax.data_def(skeletons, bj, tsize))
    it = cluster_t.cluster_parts(dt_, 4, parents, restarts=5, seed=3)
    ij = cluster_jax.cluster_parts(dt_, 4, parents, restarts=5, seed=3)
    assert len(it) == 26
    for a, b in zip(it, ij):
        assert np.array_equal(a, b)


def test_build_and_merge_bitwise_equal(skeletons):
    parents = ds_t.PERSON26_PARENTS
    boxes = cluster_t.point_to_box(skeletons, parents)
    tsize = build_t.template_size(boxes, 4)
    deffeat = cluster_t.data_def(skeletons, boxes, tsize)
    idx = cluster_t.cluster_parts(deffeat, 2, parents, restarts=3)
    rng = np.random.default_rng(4)
    filters = [[rng.normal(size=tsize + (32,)) for _ in range(2)]
               for _ in parents]
    args = ("b", filters, idx, deffeat, parents, 4, 10, 18, 32)
    mt, mj = build_t.build_model(*args), build_jax.build_model(*args)
    assert_same_model(mt, mj)
    merged_t = build_t.merge_models([mt, syn_t.person_like(seed=1)], "mm")
    merged_j = build_jax.merge_models([mj, syn_jax.person_like(seed=1)],
                                      "mm")
    assert merged_t.ncomponents == 2
    assert_same_model(merged_t, merged_j)


# ------------------------------------------------------ training features

def test_training_features_bitwise_equal():
    rng = np.random.default_rng(5)
    im = rng.random((70, 90)) * 255
    for box in ([10.0, 12.0, 30.0, 33.0], [-3.0, 50.0, 20.0, 75.0]):
        got = feat_t.warped_positive_feature(im, box, (3, 3), 4, 18, 32)
        ref = feat_jax.warped_positive_feature(im, box, (3, 3), 4, 18, 32)
        assert got.shape == (3, 3, 32) and np.array_equal(got, ref)

    ims = [rng.random((10, 20)), rng.random((8, 16))]
    pts = rng.uniform(0, 8, (2, 3, 2))
    ft = trainer_t.flip_positives(ims, pts, [0, 2, 1])
    fj = trainer_jax.flip_positives(ims, pts, [0, 2, 1])
    assert len(ft[0]) == 4
    for a, b in zip(ft[0], fj[0]):
        assert np.array_equal(a, b)
    assert np.array_equal(ft[1], fj[1])

    mt, mj = syn_t.tiny(seed=3), syn_jax.tiny(seed=3)
    P = mt.components[0].nparts
    gt = np.asarray([[6, 6, 40, 44]] * P, float)
    got = feat_t.part_overlap_masks(mt, 0, make_plan((72, 88), 4, 3), gt,
                                    0.1)
    ref = feat_jax.part_overlap_masks(mj, 0, plan_jax((72, 88), 4, 3), gt,
                                      0.1)
    assert len(got) == len(ref) and any(m.any() for m in got)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_detection_feature_bitwise_equal():
    """Given the JAX detector's Detections and features, the port's
    detection_feature writes the same vector."""
    mt, mj = syn_t.tiny(seed=3), syn_jax.tiny(seed=3)
    mj.thresh = -1e9
    im = np.random.default_rng(5).random((72, 88)) * 255
    det = DetectorJax(mj, k_per_level=8, compose="correct")
    dets = det.detect(im, max_detections=10)
    feats = det.pyramid_features(im)
    lt = vec_t.BlockLayout.for_model(mt)
    lj = vec_jax.BlockLayout.for_model(mj)
    assert dets
    for d in dets:
        assert np.array_equal(feat_t.detection_feature(mt, lt, d, feats),
                              feat_jax.detection_feature(mj, lj, d, feats))


@pytest.mark.parametrize("maker", ["tiny", "tiny_multires"])
def test_feature_invariant_on_the_port(maker):
    """w . detection_feature == score on the port's CPU detector: the
    trainer's Detector(compose="correct"), MultiResDetector for the
    multi-resolution model (tests/test_multires_masked.py:121-141)."""
    seed = 5 if maker == "tiny_multires" else 3
    m = getattr(syn_t, maker)(seed=seed)
    m.thresh = -1e9
    det = trainer_t._latent_detector(m, 8, device="cpu")
    assert isinstance(det, MultiResDetector if m.max_scale() > 0
                      else Detector)
    layout = vec_t.BlockLayout.for_model(m)
    w = _vec(vec_t, m)[0]
    im = np.random.default_rng(11).random((72, 88)) * 255
    dets = det.detect(im, max_detections=10)
    feats = det.pyramid_features(im)
    assert dets
    for d in dets:
        rec = float(w @ feat_t.detection_feature(m, layout, d, feats))
        assert abs(rec - d.score) < 5e-3, (rec, d.score)


def test_update_model_gives_a_fresh_detector():
    """The stage-1 mining detector is shared through update_model: after
    an update to new weights and a new threshold it gives what a fresh
    Detector on the new model gives (no stale packed weights or
    threshold)."""
    rng = np.random.default_rng(6)
    im = rng.random((64, 64)) * 255

    def stage1(thresh):
        return trainer_t._single_filter_model(
            rng.normal(size=(3, 3, 32)), float(rng.normal()), 4, 18, 32,
            thresh)

    det = Detector(stage1(-1.0), k_per_level=8, compose="correct",
                   device="cpu")
    before = det.detect_raw(im)
    new = stage1(0.2)
    det.update_model(new)
    got = det.detect_raw(im)
    ref = Detector(new, k_per_level=8, compose="correct",
                   device="cpu").detect_raw(im)
    for f in ("score", "valid", "component", "level", "boxes", "loc"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert not torch.equal(got.score, before.score)
    assert int(got.valid.sum()) < int(before.valid.sum())


# ------------------------------------------------------------ end to end

def _train(trainer, ds, **kw):
    pos, neg = ds.synthetic_figures(n=8, imsize=(64, 64), nparts=2, seed=3)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model = trainer.train_parts_model(
            "prunetest", [s.image for s in pos],
            np.stack([s.points for s in pos]), neg[:3], [-1, 0],
            trainer.TrainConfig(**SMALL), cache_dir=None, verbose=True,
            **kw)
    return model, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def trained():
    """The small config trained once by each package (the port on the
    CPU)."""
    return {"port": _train(trainer_t, ds_t, device="cpu"),
            "jax": _train(trainer_jax, ds_jax)}


def test_train_parts_model_matches_jax(trained):
    (mt, log_t), (mj, log_j) = trained["port"], trained["jax"]
    assert log_t == log_j
    assert any("prune-and-continue" in line for line in log_t)
    assert type(mt).__module__.startswith("partsbaseddetector_tpu_torch")
    assert_close_weights(mt, mj)


def test_trained_model_detects_alike(trained):
    """The held-out root of tests/test_train.py:222-227: both packages'
    detectors on their own trained models find the same root on pos[0].
    """
    pos, _ = ds_t.synthetic_figures(n=8, imsize=(64, 64), nparts=2, seed=3)
    roots = []
    for det_cls, (m, _) in ((Detector, trained["port"]),
                            (DetectorJax, trained["jax"])):
        m = dataclasses.replace(m)
        m.thresh = -1e9
        kw = {"device": "cpu"} if det_cls is Detector else {}
        det = det_cls(m, k_per_level=4, **kw)
        dets = det.candidates_to_detections(det.detect_raw(pos[0].image), 1)
        assert dets
        roots.append(np.asarray(dets[0].locations[0]).tolist())
    assert roots[0] == roots[1]


def _latent_round(trainer, synthetic, **kw):
    """One latent-SSVM round on tests/test_multires_masked.py:143-176's
    multires fixture."""
    model = synthetic.tiny_multires(seed=5)
    model.thresh = -1e9
    rng = np.random.default_rng(11)
    P = model.components[0].nparts
    pos_images = [rng.random((64, 64)) * 255 for _ in range(2)]
    gt_boxes = np.asarray([[[4, 4, 44, 44]] * P] * 2, float)
    neg_images = [rng.random((64, 64)) * 40 for _ in range(2)]
    cfg = trainer.TrainConfig(nmix=1, binsize=model.binsize,
                              interval=model.interval, latent_iters=1,
                              nmax=200, k_per_level=8, neg_per_image=4,
                              C=0.05, overlap=0.05)
    logs = []
    out = trainer.latent_train(model, pos_images, gt_boxes, neg_images,
                               cfg, logs.append, **kw)
    return out, logs


def test_latent_train_multires_matches_jax():
    mt, log_t = _latent_round(trainer_t, syn_t, device="cpu")
    mj, log_j = _latent_round(trainer_jax, syn_jax)
    assert log_t == log_j
    assert int(log_t[0].split(":")[1].split()[0]) > 0
    assert_close_weights(mt, mj)


def test_trainer_needs_a_card_unless_told_cpu():
    pos, neg = ds_t.synthetic_figures(n=4, imsize=(64, 64), nparts=2)
    args = ("x", [s.image for s in pos], np.stack([s.points for s in pos]),
            neg, [-1, 0])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            trainer_t.train_parts_model(*args, **kw)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            trainer_t.train_multi_component(
                "x", [dict(pos_images=args[1], pos_points=args[2],
                           neg_images=neg, parents=[-1, 0])], **kw)
