"""The port's tracer (utils/profiling): the span tree of the detector's
and the serving path's calls on ``synthetic.tiny`` on the CPU, tracing
off, the spans on torch.profiler's clock, the counters at their sites,
self time and the store's bound."""

import time

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu_torch.infer.detector import (DepthPrune,
                                                         Detector, _dp_groups)
from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
from partsbaseddetector_tpu_torch.models import synthetic
from partsbaseddetector_tpu_torch.ops.nms import paint_nms, part_nms
from partsbaseddetector_tpu_torch.post.depth import CameraModel
from partsbaseddetector_tpu_torch.utils import profiling

torch.set_num_threads(1)

SHAPE = (48, 56)
STAGES = {"ladder+hog", "conv", "dp", "seeds+sort", "walk"}
POST = {"post.nms", "fetch", "post.mask", "post.boxes3d", "post.poses"}


@pytest.fixture(scope="module")
def det():
    m = synthetic.tiny(seed=2)
    m.thresh = -1e9
    # fx scaled so that the tiny model's levels survive the pruning
    return Detector(m, k_per_level=4, device="cpu",
                    depth_prune=DepthPrune(0.4, 60.0, 0.5))


def _frame(seed=3):
    rng = np.random.default_rng(seed)
    rgb = (rng.random(SHAPE + (3,)) * 255).astype(np.uint8)
    depth = np.full(SHAPE, 2.0, np.float32)
    return rgb, depth


def _serving(det):
    sd = StreamingDetector(det, camera=CameraModel(
        fx=60, fy=60, cx=SHAPE[1] / 2, cy=SHAPE[0] / 2), max_overlap=0.5)
    for sink in ("detections", "mask", "boxes3d", "part_centers", "poses"):
        sd.on(sink, lambda _: None)
    return sd


def _groups(det):
    plan = det.plan_for(SHAPE)
    return (len(plan.buckets),
            sum(len(_dp_groups(b, det.dp_split)) for b in plan.buckets)
            * len(det.model.components))


def _names(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def _subtree(spans, top):
    """top and every span below it (a parent is stored before its
    children)."""
    inside, out = {top.index}, [top]
    for s in spans:
        if s.parent in inside:
            inside.add(s.index)
            out.append(s)
    return out


def _check_detect(det, spans, call):
    """One detect.call and its spans: the upload, the five stages as
    many times as the plan asks, a view span a dp group and component
    (attributes component and nparts) around that pass's dp, walk and
    two seeds+sort, the dp spans with their group."""
    buckets, groups = _groups(det)
    names = _names(spans)
    assert names["detect.call"] == names["upload"] == 1
    assert names["ladder+hog"] == names["conv"] == buckets
    assert names["dp"] == names["walk"] == names["view"] == groups
    assert names["seeds+sort"] == 2 * groups + 1
    views = {s.index: s for s in spans if s.name == "view"}
    for s in spans:
        if s.name in ("dp", "walk", "seeds+sort") and s.parent in views:
            assert s.end_ns <= views[s.parent].end_ns, s
        elif s.name != "detect.call":
            assert s.parent == call.index, s
            assert s.name != "seeds+sort" or s.index == spans[-1].index
        assert s.root == call.root and s.end_ns >= s.start_ns
    comps = det.model.components
    for v in views.values():
        inner = [s for s in spans if s.parent == v.index]
        assert sorted(s.name for s in inner) == ["dp", "seeds+sort",
                                                 "seeds+sort", "walk"]
        c = v.attrs["component"]
        assert v.attrs == {"component": c, "nparts": comps[c].nparts}
        assert inner[0].name == "dp" and inner[0].attrs["component"] == c
    keys = {(d.attrs["bucket"], d.attrs["lo"], d.attrs["hi"],
             d.attrs["component"]) for d in spans if d.name == "dp"}
    assert len(keys) == groups


@pytest.mark.parametrize("entry", ["detect_raw", "detect_batch_raw",
                                   "process"])
def test_span_tree(det, entry):
    rgb, depth = _frame()
    with profiling.tracing() as t:
        if entry == "detect_raw":
            det.detect_raw(rgb, depth=depth)
        elif entry == "detect_batch_raw":
            det.detect_batch_raw(np.stack([rgb, rgb]))
        else:
            _serving(det).process(rgb, depth)
    spans = t.spans
    assert t.dropped == 0 and all(s.end_ns is not None for s in spans)
    assert len({s.root for s in spans}) == 1     # one root call
    root = spans[0]
    assert root.parent == -1 and all(s.parent >= 0 for s in spans[1:])
    call = next(s for s in spans if s.name == "detect.call")
    detect = _subtree(spans, call)
    if entry == "process":
        assert root.name == "serve.frame"
        assert root.attrs == {"seq": 0, "frame": 0}
        top = {s.name for s in spans if s.parent == root.index}
        assert top == {"detect.call", "serve.wait"} | POST
        detect = [s for s in detect if s.name != "prune"]
    else:
        assert root is call
    assert ("prune" in _names(spans)) == (entry != "detect_batch_raw")
    _check_detect(det, [s for s in detect if s.name != "prune"], call)


@pytest.mark.parametrize("entry", ["process_batch", "stream"])
def test_served_frames_are_roots(det, entry):
    """A batch's dispatch and wait are roots of their own, then each
    frame's post stage is a serve.frame root, numbered in the stream and
    in its batch; no span stays open across stream's yield."""
    rgb, depth = _frame()
    rgbs, depths = np.stack([rgb] * 3), np.stack([depth] * 3)
    sd = _serving(det)
    with profiling.tracing() as t:
        if entry == "process_batch":
            sd.process_batch(rgbs, depths)
        else:
            for _ in sd.stream(list(rgbs), batch=3, depths=list(depths)):
                with profiling.span("consumer"):
                    pass
    roots = [s for s in t.spans if s.parent == -1]
    frames = [s for s in roots if s.name == "serve.frame"]
    assert [s.attrs for s in frames] == [{"seq": i, "frame": i}
                                         for i in range(3)]
    assert [s.name for s in roots if s.name != "consumer"][:2] == \
        ["detect.call", "serve.wait"]
    assert len({s.root for s in roots}) == len(roots)
    for f in frames:
        assert {s.name for s in t.spans if s.parent == f.index} == POST


def test_tracing_off_records_nothing(det):
    profiling.TRACER.clear()
    assert profiling.span("x") is profiling.NULL_SPAN
    assert profiling.stage("dp", {"lo": 0}) is profiling.NULL_SPAN
    profiling.count("readbacks")
    _serving(det).process(*_frame())
    assert profiling.TRACER.spans == [] and profiling.TRACER.counters == {}
    assert not profiling.TRACER.stats
    with profiling.tracing() as t:
        with profiling.tracing():       # an inner block keeps the outer's
            profiling.count("x", 2)
        profiling.count("x")
        assert profiling.span("y") is not profiling.NULL_SPAN
    assert t.counters == {"x": 3}
    with profiling.tracing():           # the outermost block starts empty
        pass
    assert profiling.TRACER.counters == {}


def test_spans_on_the_profiler_clock(det):
    """Under torch.profiler each span is a record_function range named
    stage:<name> (the detector's stages) or span:<name>, on the same
    clock: its edges within 1 ms of the tracer's record."""
    _check_on_the_profiler_clock(det)


def test_spans_on_the_profiler_clock_through_slow_collections(det):
    """The same with a pass of Python's cyclic garbage collector started
    at every allocation, and 3 ms long (as on a large heap) wherever the
    tracer's own code started it: no pass falls between a span's stamp
    and its range's edge."""
    import gc
    import sys

    def slow(phase, info):
        f = sys._getframe(1)
        while phase == "start" and f is not None:
            if f.f_code.co_filename == profiling.__file__:
                time.sleep(0.003)
                return
            f = f.f_back
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 10000, 10000)
    gc.callbacks.append(slow)
    try:
        _check_on_the_profiler_clock(det)
    finally:
        gc.callbacks.remove(slow)
        gc.set_threshold(*thresholds)


def _check_on_the_profiler_clock(det):
    from torch.profiler import ProfilerActivity, profile
    rgb, depth = _frame()
    sd = _serving(det)
    sd.process(rgb, depth)
    profiling.TRACER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        sd.process(rgb, depth)
    spans = list(profiling.TRACER.spans)
    profiling.TRACER.clear()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith((profiling.STAGE, profiling.SPAN)):
            ranges.setdefault(ev.name(), []).append((ev.start_ns(),
                                                     ev.end_ns()))
    assert spans and sum(map(len, ranges.values())) == len(spans)
    seen = {}
    for s in spans:
        prefix = profiling.STAGE if s.name in STAGES else profiling.SPAN
        key = prefix + s.name
        i = seen[key] = seen.get(key, -1) + 1
        a, b = sorted(ranges[key])[i]
        assert abs(a - s.start_ns) < 1e6 and abs(b - s.end_ns) < 1e6, s
        assert a <= s.start_ns and s.end_ns <= b


def _reference_samples(detection, imsize, depth):
    """The depth samples the reference's z-extent gathers for a
    detection (include/Candidate.hpp:150-175, the JAX package's
    post/cloud.bounding_box_3d): the valid pixels under its part boxes
    and its mean +- 1.5 sigma box, box by box; none when the first box
    holds none."""
    H, W = imsize
    sx, sy = depth.shape[1] / W, depth.shape[0] / H
    parts = detection.own().parts
    cx = (parts[:, 0] + parts[:, 2]) / 2.0
    cy = (parts[:, 1] + parts[:, 3]) / 2.0
    boxes = [np.clip(p, [0, 0, 0, 0], [W, H, W, H]) for p in parts]
    boxes.append(np.clip([cx.mean() - 1.5 * cx.std(),
                          cy.mean() - 1.5 * cy.std(),
                          cx.mean() + 1.5 * cx.std(),
                          cy.mean() + 1.5 * cy.std()],
                         [0, 0, 0, 0], [W, H, W, H]))
    n = 0
    for b in boxes:
        part = depth[int(b[1] * sy):int(b[3] * sy),
                     int(b[0] * sx):int(b[2] * sx)].ravel()
        n += int(((part != 0) & ~np.isnan(part)).sum())
        if not n:
            return 0
    return n


@pytest.mark.parametrize("site", ["paint_nms", "part_nms", "fetch",
                                  "process"])
def test_readbacks(det, site):
    """readbacks: two reads a step of the NMS (a step a kept candidate,
    and one that finds none), a read a field of the fetch, and on the
    serving path the wait besides and the 3-D boxes' one read; the
    detect there counts its views and no padded row (one component),
    the 3-D boxes their detections and samples."""
    rgb, depth = _frame()
    cands = det.detect_raw(rgb, depth=depth)
    sd = _serving(det)
    nms = {"paint_nms": lambda: paint_nms(cands, SHAPE, sd.max_overlap),
           "part_nms": lambda: part_nms(cands, 0.3)}
    kept = nms.get(site, nms["paint_nms"])().valid
    assert 0 < int(kept.sum()) and not bool(kept[-1])
    steps = int(kept.sum()) + 1
    want = {"paint_nms": 2 * steps, "part_nms": 2 * steps, "fetch": 6,
            "process": 1 + 2 * steps + 6 + 1}[site]
    with profiling.tracing() as t:
        if site == "fetch":
            Detector.candidates_to_detections(cands)
        elif site == "process":
            dets = sd.process(rgb, depth).detections
            assert len(dets) == int(kept.sum())
        else:
            nms[site]()
    served = {"views": _groups(det)[1], "parts.padded": 0,
              "boxes3d.dets": len(dets),
              "boxes3d.samples": sum(_reference_samples(d, SHAPE, depth)
                                     for d in dets)} \
        if site == "process" else {}
    assert t.counters == {"readbacks": want, **served}


def test_boxes3d_counters(det):
    """One served frame with holes in its depth: boxes3d.dets counts the
    kept detections, boxes3d.samples the samples the reference gathers
    for them, and the 3-D boxes add one readback to the frame's."""
    rgb, depth = _frame()
    depth[np.random.default_rng(5).random(SHAPE) < 0.3] = 0.0
    depth[:, :20] = 0.0
    sd = _serving(det)
    bare = StreamingDetector(det, camera=sd.camera, max_overlap=0.5)
    bare.on("detections", lambda _: None)
    with profiling.tracing() as t:      # one store: keep its counters
        dets = sd.process(rgb, depth).detections
    served = dict(t.counters)
    with profiling.tracing() as t:
        bare.process(rgb, depth)
    want = [_reference_samples(d, SHAPE, depth) for d in dets]
    assert len(dets) > 1 and 0 < sum(want)
    assert served["boxes3d.dets"] == len(dets)
    assert served["boxes3d.samples"] == sum(want)
    assert served["readbacks"] == t.counters["readbacks"] + 1
    assert "boxes3d.dets" not in t.counters


@pytest.fixture(scope="module")
def views2():
    """Two views of 4 and 2 parts (tests/test_torch_views.py's kind)."""
    from bench_port.core import program, weights
    cfg = {"name": "views2", "filter_size": 5, "flen": 14, "norient": 6,
           "binsize": 4, "interval": 4, "k_per_level": 4,
           "compose": "reference", "dp_split": None,
           "conv_engine": "spatial", "components": [
               {"nparts": 4, "nmixtures": 2, "root_nmixtures": 1,
                "parent": [-1, 0, 1, 1]},
               {"nparts": 2, "nmixtures": 1, "root_nmixtures": 1,
                "parent": [-1, 0]}]}
    arrays = weights.model_arrays(cfg, 31415926535, "cpu")
    return program.build_detector(arrays, cfg, -1e9, "cpu")


def test_view_spans_and_counters(views2):
    """Under detect_batch_raw: a view span a dp group and view, child of
    detect.call, around its pass's stages; views = dp groups x views;
    parts.padded = the smaller view's candidates x the rows it lacks."""
    rgb, _ = _frame()
    B = 2
    with profiling.tracing() as t:
        views2.detect_batch_raw(np.stack([rgb] * B))
    call = t.spans[0]
    assert call.name == "detect.call"
    _check_detect(views2, t.spans, call)
    plan = views2.plan_for(SHAPE)
    groups = [hi - lo for b in plan.buckets
              for lo, hi, _, _ in _dp_groups(b, views2.dp_split)]
    assert t.counters["views"] == 2 * len(groups)
    assert t.counters["parts.padded"] == \
        sum(B * n * views2.k_per_level * (4 - 2) for n in groups)
    assert [v.attrs["nparts"] for v in t.spans if v.name == "view"] == \
        [4, 2] * len(groups)


def test_walk_launches_none_on_the_cpu(det):
    """The walk kernel's launches are counted where it launches; on CPU
    tensors walk_impl="cuda" runs the plain walk and counts none."""
    cpu_cuda = Detector(det.model, k_per_level=4, device="cpu",
                        walk_impl="cuda")
    with profiling.tracing() as t:
        cpu_cuda.detect_raw(_frame()[0])
    assert t.stats["walk"].count == _groups(det)[1]
    assert "walk.launches" not in t.counters


def test_self_time():
    timer = profiling.StageTimer()
    with timer.span("frame"):
        with timer.span("a"):
            pass
        with timer.span("b"):
            with timer.span("a"):
                pass
    # ns: frame [0, 100], a [10, 30], b [50, 90], b's a [60, 70]
    for s, (a, b) in zip(timer.spans, [(0, 100), (10, 30), (50, 90),
                                       (60, 70)]):
        s.start_ns, s.end_ns = a, b
    assert [s.parent for s in timer.spans] == [-1, 0, 0, 2]
    assert timer.self_ns() == [40, 20, 30, 10]
    assert timer.self_ms() == pytest.approx({"frame": 4e-5, "a": 3e-5,
                                             "b": 3e-5})


def test_store_bound():
    timer = profiling.StageTimer(capacity=3)
    for _ in range(2):
        with timer.span("root", {"n": 1}):
            with timer.stage("child"):
                time.sleep(0.001)
    assert [s.name for s in timer.spans] == ["root", "child", "root"]
    assert timer.dropped == 1
    assert timer.stats["child"].count == 2     # stats count every span
    assert timer.spans[2].root != timer.spans[0].root
    timer.clear()
    assert (timer.spans, timer.dropped, dict(timer.stats)) == ([], 0, {})
    assert profiling.TRACER.capacity == profiling.CAPACITY == 1 << 16
