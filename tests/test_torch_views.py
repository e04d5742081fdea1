"""Models whose views (components) differ in part count, on the port's
normal path, on the CPU: each view's DP and walk run over its own parts,
and its candidates are padded to the model's most parts (loc -1, boxes
0).  Held against the benchmark's plain reference
(bench_port/reference/detect.py), against each view run alone, and the
part-walking consumers (NMS, the post stage) against the same calls on
the detections cut to their own parts."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_port.core import program, runner, weights
from bench_port.reference import detect as ref
from partsbaseddetector_tpu_torch.infer.detector import (Detection,
                                                         Detector, _dp_groups)
from partsbaseddetector_tpu_torch.infer.stream import (StreamingDetector,
                                                       detections_mask)
from partsbaseddetector_tpu_torch.models.transfer_formats import load_foreign
from partsbaseddetector_tpu_torch.ops.argmax import Candidates
from partsbaseddetector_tpu_torch.ops.nms import paint_nms, part_nms
from partsbaseddetector_tpu_torch.parallel import BatchDetector, make_mesh
from partsbaseddetector_tpu_torch.parallel.pipeline import PipelinedDetector
from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
    ScaleShardedDetector, make_scale_mesh)
from partsbaseddetector_tpu_torch.post.cloud import (bounding_box_3d,
                                                     compute_bounding_boxes)
from partsbaseddetector_tpu_torch.post.depth import CameraModel
from partsbaseddetector_tpu_torch.post.poses import poses_from_part_centers
from partsbaseddetector_tpu_torch.utils import profiling

torch.set_num_threads(2)

SEED = 2718281828459
SHAPE = (96, 128)
K = 16
#: three views of 5, 3 and 4 parts, one mixture a part but the last's 2
VIEWS = [
    {"nparts": 5, "nmixtures": 1, "root_nmixtures": 1,
     "parent": [-1, 0, 1, 1, 0]},
    {"nparts": 3, "nmixtures": 1, "root_nmixtures": 1,
     "parent": [-1, 0, 1]},
    {"nparts": 4, "nmixtures": 2, "root_nmixtures": 2,
     "parent": [-1, 0, 0, 2]},
]
CFG = {"name": "views3", "filter_size": 5, "flen": 32, "norient": 18,
       "binsize": 4, "interval": 5, "k_per_level": K,
       "compose": "reference", "dp_split": None, "conv_engine": "spatial",
       "components": VIEWS}


def _frames(n=2, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.random((n,) + SHAPE + (3,)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def views():
    arrays = weights.model_arrays(CFG, SEED, "cpu")
    det = program.build_detector(arrays, CFG, -1e9, "cpu")
    frames = _frames()
    return arrays, det, frames, det.detect_batch_raw(frames)


def test_candidates_equal_the_reference(views):
    arrays, det, frames, cands = views
    assert det.packed.maxparts == 5 and cands.padded
    assert cands.loc.shape[-2:] == (5, 3)
    model = runner.ref_model(arrays, CFG, -1e9)
    for i, frame in enumerate(frames):
        d = program.detections_dict(Detector.candidates_to_detections(
            cands.map(lambda x: x[i])))
        assert set(d["component"].tolist()) == {0, 1, 2}
        levels, maps = ref.frame_maps(torch.as_tensor(frame), model)
        mine = ref.candidates(levels, maps, model, K, -1e9)
        for k in ("score", "level", "component", "loc", "boxes"):
            assert np.array_equal(mine[k], d[k]), k
        gaps = ref.judge(levels, maps, model, d, K, -1e9)
        assert gaps.pop("scores") == len(d["score"])
        assert all(v == 0 for v in gaps.values()), gaps


def _one_view(det, c):
    m = det.model
    return dataclasses.replace(m, components=[m.components[c]])


def test_views_equal_each_view_alone(views):
    """Each view's candidates in the merged, sorted output are the view
    run alone as a one-component model, its rows padded to 5."""
    _, det, frames, cands = views
    for c, view in enumerate(VIEWS):
        alone = Detector(_one_view(det, c), k_per_level=K, device="cpu")
        got = alone.detect_batch_raw(frames)
        P = view["nparts"]
        assert not got.padded and got.loc.shape[-2] == P
        for i in range(len(frames)):
            sel = cands.valid[i] & (cands.component[i] == c)
            mine = got.valid[i]
            assert torch.equal(cands.score[i][sel], got.score[i][mine])
            assert torch.equal(cands.level[i][sel], got.level[i][mine])
            assert torch.equal(cands.loc[i][sel][:, :P], got.loc[i][mine])
            assert torch.equal(cands.boxes[i][sel][:, :P],
                               got.boxes[i][mine])
            assert (cands.loc[i][sel][:, P:] == -1).all()
            assert (cands.boxes[i][sel][:, P:] == 0).all()


def test_one_view_is_not_padded(views):
    _, det, frames, _ = views
    alone = Detector(_one_view(det, 0), k_per_level=K, device="cpu")
    with profiling.tracing() as t:
        got = alone.detect_batch_raw(frames)
    plan = alone.plan_for(SHAPE)
    groups = sum(len(_dp_groups(b, alone.dp_split)) for b in plan.buckets)
    assert not got.padded and (got.loc >= 0).all()
    assert got.loc.shape[-2] == alone.packed.maxparts == 5
    assert t.counters["parts.padded"] == 0
    assert t.counters["views"] == groups


def test_parallel_detectors_at_world_size_1(views):
    _, det, frames, cands = views
    m = det.model
    bdet = BatchDetector(m, make_mesh(device="cpu"), k_per_level=K)
    _equal(bdet.detect_batch(frames), cands)
    pdet = PipelinedDetector(m, "cpu", "cpu", k_per_level=K)
    for i, got in enumerate(pdet.stream(list(frames))):
        _equal(got, cands.map(lambda x: x[i]))
    sdet = ScaleShardedDetector(m, make_scale_mesh(device="cpu"),
                                k_per_level=K)
    one = Detector(m, k_per_level=K, dp_split=1, device="cpu")
    _equal(sdet.detect_raw(frames[0]), one.detect_raw(frames[0]))


def _equal(a: Candidates, b: Candidates):
    assert a.padded == b.padded
    for f in ("score", "valid", "component", "level", "boxes", "loc"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _frame_cands(cands, i=0) -> Candidates:
    return cands.map(lambda x: x[i])


def _view_rows(c: Candidates, view: int, P: int, cut: bool) -> Candidates:
    """The candidates of one view, cut to its P parts or kept padded."""
    sel = c.component == view
    out = c.map(lambda x: x[sel])
    if cut:
        out = dataclasses.replace(out.map(
            lambda x: x[:, :P] if x.ndim == 3 else x), padded=False)
    return out


def test_nms_skips_padded_rows(views):
    _, _, _, cands = views
    c = _frame_cands(cands)
    for view, spec in enumerate(VIEWS):
        padded = _view_rows(c, view, spec["nparts"], cut=False)
        cut = _view_rows(c, view, spec["nparts"], cut=True)
        for overlap in (0.0, 0.3):
            assert torch.equal(paint_nms(padded, SHAPE, overlap).valid,
                               paint_nms(cut, SHAPE, overlap).valid)
            assert torch.equal(part_nms(padded, overlap).valid,
                               part_nms(cut, overlap).valid)
    # all views at once: a padded row filled with the root's box leaves
    # every hull as it is
    own = c.own_rows()[..., None]
    filled = dataclasses.replace(
        c, boxes=torch.where(own, c.boxes, c.boxes[:, :1]), padded=False)
    for overlap in (0.0, 0.3):
        kept = paint_nms(c, SHAPE, overlap).valid
        assert torch.equal(kept, paint_nms(filled, SHAPE, overlap).valid)
        assert 1 < int(kept.sum())


def _camera():
    return CameraModel(fx=60, fy=60, cx=SHAPE[1] / 2, cy=SHAPE[0] / 2)


def test_post_stage_skips_padded_rows(views):
    _, _, _, cands = views
    dets = Detector.candidates_to_detections(_frame_cands(cands))
    padded = [d for d in dets if d.component == 1][:4]
    assert padded and all(d.parts.shape == (5, 4) for d in padded)
    cut = [Detection(d.score, d.component, d.level, d.parts[:3],
                     d.locations[:3]) for d in padded]
    assert all(d.own().parts.shape == (3, 4) for d in padded)
    rng = np.random.default_rng(7)
    depth = (1.0 + rng.random(SHAPE)).astype(np.float32)
    for a, b in zip(padded, cut):
        assert np.array_equal(a.bounding_box(), b.bounding_box())
        assert np.array_equal(a.bounding_box_norm(), b.bounding_box_norm())
        ra, rb = bounding_box_3d(a, SHAPE, depth), \
            bounding_box_3d(b, SHAPE, depth)
        assert np.array_equal(np.r_[ra.tl(), ra.br()], np.r_[rb.tl(),
                                                              rb.br()])
    assert np.array_equal(detections_mask(SHAPE, padded),
                          detections_mask(SHAPE, cut))
    boxes_a, centres_a = compute_bounding_boxes(padded, SHAPE, depth,
                                                _camera())
    boxes_b, centres_b = compute_bounding_boxes(cut, SHAPE, depth,
                                                _camera())
    for ba, bb, ca, cb in zip(boxes_a, boxes_b, centres_a, centres_b):
        assert np.array_equal(np.r_[ba.tl(), ba.br()], np.r_[bb.tl(),
                                                             bb.br()])
        assert ca.shape == (3, 3) and np.array_equal(ca, cb)
    for pa, pb in zip(poses_from_part_centers(centres_a),
                      poses_from_part_centers(centres_b)):
        assert np.array_equal(pa.position, pb.position)
        assert np.array_equal(pa.orientation, pb.orientation)


def _save_face_views(path, nparts=(5, 3)):
    """A Zhu-Ramanan-style face .mat model whose views have these part
    counts: a chain a view, the first def of a view its scalar bias."""
    import scipy.io
    rng = np.random.default_rng(0)
    nf = sum(nparts)
    filters = np.empty((1, nf), dtype=np.dtype([("w", object)]))
    for i in range(nf):
        filters[0, i]["w"] = rng.standard_normal((4, 4, 32)) * 0.1
    defs = np.empty((1, nf), dtype=np.dtype([("w", object),
                                             ("anchor", object)]))
    part_dt = np.dtype([("filterid", object), ("defid", object),
                        ("parent", object)])
    comps = np.empty((1, len(nparts)), dtype=object)
    i = 0
    for c, n in enumerate(nparts):
        parts = np.empty((1, n), dtype=part_dt)
        for p in range(n):
            if p == 0:
                defs[0, i]["w"] = np.array([[0.3 + c]])
                defs[0, i]["anchor"] = np.zeros((1, 3))
            else:
                defs[0, i]["w"] = np.array([[0.02, 0.01, 0.03, -0.01]])
                defs[0, i]["anchor"] = np.array([[2.0, 3.0, 0.0]])
            parts[0, p]["filterid"] = np.array([[float(i + 1)]])
            parts[0, p]["defid"] = np.array([[float(i + 1)]])
            parts[0, p]["parent"] = np.array([[float(p)]])
            i += 1
        comps[0, c] = parts
    rec = np.empty((1, 1), dtype=np.dtype(
        [(k, object) for k in ("sbin", "interval", "thresh", "filters",
                               "defs", "components")]))
    rec[0, 0]["sbin"] = np.array([[4.0]])
    rec[0, 0]["interval"] = np.array([[5.0]])
    rec[0, 0]["thresh"] = np.array([[-1e9]])
    rec[0, 0]["filters"] = filters
    rec[0, 0]["defs"] = defs
    rec[0, 0]["components"] = comps
    scipy.io.savemat(path, {"model": rec})


def test_converted_face_model_runs(tmp_path):
    path = str(tmp_path / "face.mat")
    _save_face_views(path)
    model = load_foreign(path, "face", "faceviews")
    assert [c.nparts for c in model.components] == [5, 3]
    frame = _frames(1, seed=9)[0]
    det = Detector(model, k_per_level=8, device="cpu")
    cands = det.detect_raw(frame)
    assert cands.padded and cands.loc.shape[-2] == 5
    comp = cands.component[cands.valid]
    assert set(comp.tolist()) == {0, 1}
    assert (cands.loc[cands.component == 1][:, 3:] == -1).all()
    assert (cands.loc[cands.component == 0] >= 0).all()
    depth = np.full(SHAPE, 1.5, np.float32)
    sd = StreamingDetector(det, camera=_camera(), max_overlap=0.3)
    for sink in ("detections", "mask", "boxes3d", "part_centers", "poses"):
        sd.on(sink, lambda _: None)
    res = sd.process(frame, depth)
    assert res.detections and res.mask is not None
    for d, centres in zip(res.detections, res.part_centers):
        if len(centres):
            assert len(centres) == model.components[d.component].nparts
