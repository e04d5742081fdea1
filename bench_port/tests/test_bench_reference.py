"""The plain reference equals the port on the CPU at a small size:
stages 1-2 (responses), stages 3-4 (the candidates, to the bit) with and
without depth pruning, and the post stage of the serving path."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port.core import program, runner, spec, weights
from bench_port.reference import detect as ref
from bench_port.reference import features
from bench_port.reference import post as ref_post
from bench_port.reference.plan import pyramid
from bench_port.tests.conftest import small_cell

SEED = 987654321


@pytest.fixture(scope="module")
def setup():
    cell = small_cell("person26.batch8", nparts=6, shape=(96, 128))
    arrays = weights.model_arrays(cell.config, SEED, "cpu")
    gen = spec.driver("closed_batches").make(cell.traffic, {}, SEED,
                                            "cpu")
    return cell, arrays, gen


def test_plan_is_the_ports(setup):
    from partsbaseddetector_tpu_torch.infer.pyramid_plan import make_plan
    for size, interval in (((480, 640), 10), ((480, 640), 5),
                           ((96, 128), 10)):
        mine = pyramid(size, 4, interval)
        port = make_plan(size, 4, interval).levels
        assert [(l.imsize, l.featsize, l.scale) for l in mine] == \
            [(l.imsize, l.featsize, l.scale) for l in port]


def test_responses_equal_the_ports(setup):
    from partsbaseddetector_tpu_torch.infer.detector import pyramid_pdfs
    cell, arrays, gen = setup
    cfg = cell.config
    det = program.build_detector(arrays, cfg, 0.0, "cpu")
    frame = gen.pool[0]
    plan = det.plan_for(frame.shape[:2])
    port = pyramid_pdfs(torch.as_tensor(frame)[None], det.packed, plan)
    levels = pyramid(frame.shape[:2], cfg["binsize"], cfg["interval"])
    mine = features.level_responses(
        torch.as_tensor(frame), levels, arrays["filters"], cfg["binsize"],
        cfg["interval"], cfg["norient"], cfg["flen"])
    i = 0
    for bucket, pdfs, _, _ in port:
        for j, lvl in enumerate(bucket.levels):
            h, w = lvl.featsize
            got = pdfs[0, j, :h, :w].permute(2, 0, 1)
            assert torch.allclose(got, mine[i], rtol=0, atol=1e-5), lvl
            i += 1
    assert i == len(levels)


@pytest.mark.parametrize("thresh", [0.0, -1e9])
def test_candidates_equal_the_ports(setup, thresh):
    cell, arrays, gen = setup
    cfg = cell.config
    det = program.build_detector(arrays, cfg, thresh, "cpu")
    frames = gen.frames(np.array([1, 2]))
    got = program.batch_call(det, frames)
    model = runner.ref_model(arrays, cfg, thresh)
    for frame, dets in zip(frames, got):
        d = program.detections_dict(dets)
        assert len(d["score"]) > 0
        levels, maps = ref.frame_maps(torch.as_tensor(frame), model)
        mine = ref.candidates(levels, maps, model, cfg["k_per_level"],
                              thresh)
        for k in ("score", "level", "loc", "boxes"):
            assert np.array_equal(mine[k], d[k]), k
        gaps = ref.judge(levels, maps, model, d, cfg["k_per_level"],
                         thresh)
        assert gaps.pop("scores") == len(d["score"])
        assert all(v == 0 for v in gaps.values()), gaps


def test_serving_path_equals_the_reference():
    cell = small_cell("person26.ros_rgbd", nparts=6, shape=(96, 128))
    cfg, tp = cell.config, cell.traffic
    arrays = weights.model_arrays(cfg, SEED, "cpu")
    gen = spec.driver("open_camera").make(tp, cell.workload, SEED, "cpu")
    det = program.build_detector(arrays, cfg, cell.workload["thresh"],
                                 "cpu", tp["depth_prune"])
    sd = program.serving(det, gen.camera, tp, keep={0, 1})
    model = runner.ref_model(arrays, cfg, cell.workload["thresh"])
    prune = runner._prune_args(tp)
    judged = 0
    for i in range(2):
        rgb, depth, cloud = gen.frame(i)
        res = program.frame_result_dict(sd.process(rgb, depth, cloud))
        raw = sd.kept_raw[i]
        levels, maps = ref.frame_maps(torch.as_tensor(rgb), model, False,
                                      torch.as_tensor(depth), prune)
        gaps = ref.judge(levels, maps, model, raw, cfg["k_per_level"],
                         model.thresh)
        assert gaps.pop("scores") == len(raw["score"])
        assert all(v == 0 for v in gaps.values()), gaps
        post = ref_post.judge_post(raw, res, rgb.shape[:2], depth,
                                   gen.camera, tp["max_overlap"],
                                   tp["max_candidates"])
        assert post["nms_mismatch"] == post["mask_mismatch"] == 0, post
        assert post["geom_gap_m"] < 1e-12 and post["quat_gap"] < 1e-12
        judged += len(res["kept_level"])
    assert judged > 0


def test_two_components_equal_the_ports():
    """A configuration of two views (``components``), the second with
    one mixture a part: the reference's candidates equal the port's,
    component ids included, and the judge finds no gap."""
    cell = small_cell("person26.batch8", nparts=4, shape=(96, 128))
    cfg = dict(cell.config, components=[
        {}, {"nmixtures": 1, "root_nmixtures": 1, "parent": [-1, 0, 0, 1]}])
    arrays = weights.model_arrays(cfg, SEED, "cpu")
    assert [t[0] for t in arrays["trees"]][1] == [-1, 0, 0, 1]
    gen = spec.driver("closed_batches").make(cell.traffic, {}, SEED, "cpu")
    det = program.build_detector(arrays, cfg, -1e9, "cpu")
    frames = gen.frames(np.array([0, 1]))
    model = runner.ref_model(arrays, cfg, -1e9)
    for frame, dets in zip(frames, program.batch_call(det, frames)):
        d = program.detections_dict(dets)
        assert set(d["component"].tolist()) == {0, 1}
        levels, maps = ref.frame_maps(torch.as_tensor(frame), model)
        mine = ref.candidates(levels, maps, model, cfg["k_per_level"],
                              -1e9)
        for k in ("score", "level", "component", "loc", "boxes"):
            assert np.array_equal(mine[k], d[k]), k
        gaps = ref.judge(levels, maps, model, d, cfg["k_per_level"], -1e9)
        assert gaps.pop("scores") == len(d["score"])
        assert all(v == 0 for v in gaps.values()), gaps
