"""Port vs JAX: the streaming pipeline (``infer/stream.py``), on the CPU.

``synthetic.tiny(seed=7)`` at 96x96 as tests/test_stream.py:12-23, every
sink attached, one frame through each package's StreamingDetector:
detections' level, component, locations and part boxes exact and
scores rtol 1e-5 (as tests/test_torch_detector.py:47); the instance
mask and the overlay exact; 3-D boxes, part centers, poses and cluster
centers within 1e-6.  Then the port alone: micro-batched entry points
equal the single-frame one, multi-resolution routing (held to the JAX
package), prebuilt backends, failure recovery through ``_materialize``,
depth pruning, and the options it refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.infer.stream import \
    StreamingDetector as StreamJax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.post.depth import CameraModel as CameraJax
from partsbaseddetector_tpu_torch.infer.detector import DepthPrune, Detector
from partsbaseddetector_tpu_torch.infer.multires import MultiResDetector
from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from partsbaseddetector_tpu_torch.parallel import BatchDetector, make_mesh
from partsbaseddetector_tpu_torch.post.depth import CameraModel

torch.set_num_threads(1)

ALL_SINKS = ("detections", "overlay", "mask", "boxes3d", "clusters",
             "part_centers", "poses")
TOL_3D = dict(rtol=0, atol=1e-6)
#: paint-NMS overlap of these tests: 0.1 (the ROS node's) keeps one
#: detection of the tiny model at 96x96, 0.5 keeps three
OVERLAP = 0.5


def _frame(shape=(96, 96), seed=3):
    """rgb, a sloped depth map (1.5-2.4 m) and its organized cloud
    (f = 80), so that 3-D boxes have volume and clusters points."""
    H, W = shape
    rng = np.random.default_rng(seed)
    rgb = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    depth = (1.5 + 0.6 * xs / W + 0.3 * ys / H).astype(np.float32)
    cloud = np.stack([(xs - W / 2) / 80.0 * depth,
                      (ys - H / 2) / 80.0 * depth, depth], -1)
    return rgb, depth, cloud


def _camera(cls, shape=(96, 96)):
    return cls(fx=80, fy=80, cx=shape[1] / 2, cy=shape[0] / 2)


def _attach_all(sd):
    for sink in ALL_SINKS:
        sd.on(sink, lambda v: None)
    return sd


def assert_same_detections(got, ref, score_rtol=1e-5):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.level, g.component) == (r.level, r.component)
        np.testing.assert_array_equal(g.locations, r.locations)
        np.testing.assert_array_equal(g.parts, r.parts)
        np.testing.assert_allclose(g.score, r.score, rtol=score_rtol)


def assert_same_results(got, ref):
    """FrameResults: detections, images exact; 3-D outputs within 1e-6."""
    assert_same_detections(got.detections, ref.detections)
    for f in ("overlay", "mask"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    if ref.boxes3d is None:
        assert got.boxes3d is None
        return
    np.testing.assert_allclose(
        [dataclasses.astuple(b) for b in got.boxes3d],
        [dataclasses.astuple(b) for b in ref.boxes3d], **TOL_3D)
    for a, b in zip(got.part_centers, ref.part_centers):
        np.testing.assert_allclose(a, b, **TOL_3D)
    for a, b in zip(got.poses, ref.poses):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a.position, b.position, **TOL_3D)
            np.testing.assert_allclose(a.orientation, b.orientation,
                                       **TOL_3D)
    if ref.cluster_centers is not None:
        np.testing.assert_allclose(got.cluster_centers,
                                   ref.cluster_centers, **TOL_3D)
        assert [len(c) for c in got.clusters] == \
            [len(c) for c in ref.clusters]


@pytest.fixture(scope="module")
def model_t():
    m = syn_t.tiny(seed=7)
    m.thresh = -1e9
    return m


@pytest.fixture(scope="module")
def sd_t(model_t):
    return _attach_all(StreamingDetector(
        model_t, camera=_camera(CameraModel), max_candidates=8,
        max_overlap=OVERLAP, device="cpu"))


def test_process_matches_jax(sd_t):
    mj = syn_jax.tiny(seed=7)
    mj.thresh = -1e9
    sd_j = _attach_all(StreamJax(mj, camera=_camera(CameraJax),
                                 max_candidates=8, max_overlap=OVERLAP))
    rgb, depth, cloud = _frame()
    ref = sd_j.process(rgb, depth, cloud)
    got = sd_t.process(rgb, depth, cloud)
    assert len(got.detections) == 3 and got.overlay is not None
    assert all(len(c) for c in got.clusters)
    assert all(p is not None for p in got.poses)
    assert_same_results(got, ref)


def test_batch_and_stream_equal_process(sd_t):
    rng = np.random.default_rng(5)
    frames = [(rng.random((96, 96, 3)) * 255).astype(np.uint8)
              for _ in range(5)]
    _, depth, cloud = _frame()
    depths, clouds = [depth] * 5, [cloud] * 5
    singles = [sd_t.process(f, depth, cloud) for f in frames]
    batched = sd_t.process_batch(np.stack(frames[:4]), np.stack(depths[:4]),
                                 np.stack(clouds[:4]))
    for s, b in zip(singles[:4], batched):
        assert_same_results(b, s)
    # 5 frames at batch=4: the padded final group's results are dropped
    streamed = list(sd_t.stream(frames, batch=4, depths=depths,
                                clouds=clouds))
    assert len(streamed) == len(frames)
    for s, b in zip(singles, streamed):
        assert_same_results(b, s)


def test_multires_routed_and_matches_jax():
    mj, mt = syn_jax.tiny_multires(seed=3), syn_t.tiny_multires(seed=3)
    mj.thresh = mt.thresh = -1e9
    sd = StreamingDetector(mt, k_per_level=8, device="cpu")
    assert isinstance(sd.detector, MultiResDetector)
    rgb, _, _ = _frame((64, 64), seed=7)
    got = sd.process(rgb)
    assert got.detections
    assert_same_detections(got.detections, StreamJax(
        mj, k_per_level=8).process(rgb).detections)
    # batched entry points on the one-frame-a-call backend
    rgbs = np.stack([rgb, rgb[::-1].copy()])
    batched = sd.process_batch(rgbs)
    streamed = list(sd.stream(list(rgbs), batch=2))
    for i in range(2):
        one = sd.process(rgbs[i]).detections
        assert_same_detections(batched[i].detections, one, score_rtol=0)
        assert_same_detections(streamed[i].detections, one, score_rtol=0)


def test_prebuilt_detector_used_as_is(model_t):
    det = Detector(model_t, k_per_level=8, compose="correct", device="cpu")
    sd = StreamingDetector(det, device="not-a-device", k_per_level=3)
    assert sd.detector is det and sd.model is model_t
    assert sd.process(_frame()[0]).detections


def test_failure_recovery(model_t):
    """Failures at the materialize seam go to the 'error' sink and
    re-dispatch the batch (the detector is deterministic, so the retry
    gives the same result); persistent failures raise after
    max_retries (tests/test_stream.py:117-162)."""
    sd = StreamingDetector(model_t, max_candidates=8, max_retries=2,
                           retry_backoff_s=0.01, device="cpu")
    rng = np.random.default_rng(5)
    frames = [(rng.random((64, 64, 3)) * 255).astype(np.uint8)
              for _ in range(4)]
    errors = []
    sd.on("error", errors.append)
    clean = sd.process_batch(np.stack(frames))

    real_materialize = StreamingDetector._materialize
    fails = {"n": 2}

    def flaky(cands_b):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("injected device failure")
        return real_materialize(cands_b)

    sd._materialize = flaky
    recovered = list(sd.stream(frames, batch=4))
    assert len(errors) == 2
    assert all(e["exception"].args[0] == "injected device failure"
               for e in errors)
    for c, r in zip(clean, recovered):
        assert_same_detections(r.detections, c.detections, score_rtol=0)

    fails["n"] = 10
    errors.clear()
    with pytest.raises(RuntimeError, match="injected device failure"):
        sd.process_batch(np.stack(frames))
    assert len(errors) == sd.max_retries + 1
    # a deterministic error is not retried
    fails["n"] = 0
    sd._materialize = lambda c: (_ for _ in ()).throw(ValueError("bug"))
    errors.clear()
    with pytest.raises(ValueError):
        sd.process(frames[0])
    assert errors == []


def test_depth_pruning_wired(model_t):
    """With a depth_prune config the depth map prunes detection
    responses through every entry point (tests/test_stream.py:165-189)."""
    cfg = DepthPrune(part_width_m=0.2, fx=400.0, tol=0.3)
    sd = StreamingDetector(model_t, max_candidates=8, depth_prune=cfg,
                           device="cpu")
    rgb = _frame((64, 64))[0]
    far = np.full((64, 64), 500.0, np.float32)
    assert sd.process(rgb).detections
    assert sd.process(rgb, far).detections == []
    depths = [np.zeros((64, 64), np.float32), far]
    outs = sd.process_batch(np.stack([rgb, rgb]), depths=np.stack(depths))
    assert outs[0].detections and outs[1].detections == []
    streamed = list(sd.stream([rgb, rgb], batch=2, depths=depths))
    assert streamed[0].detections and streamed[1].detections == []


def test_knobs_and_refusals(model_t):
    sd = StreamingDetector(model_t, k_per_level=8, conv_engine="fft",
                           walk_impl="torch", dp_split=2,
                           compose="correct", device="cpu")
    d = sd.detector
    assert (d.conv_engine, d.walk_impl, d.dp_split, d.compose,
            d.k_per_level, d.device.type) == \
        ("fft", "torch", 2, "correct", 8, "cpu")
    # a mesh is a parallel.mesh.Mesh over the job's ranks
    with pytest.raises(TypeError, match="Mesh"):
        StreamingDetector(model_t, mesh=(4, 2), device="cpu")
    with pytest.raises(ValueError, match="world size is 1"):
        make_mesh((4, 2), device="cpu")
    sd = StreamingDetector(model_t, mesh=make_mesh(device="cpu"),
                           k_per_level=8)
    assert isinstance(sd.detector, BatchDetector)
    with pytest.raises(TypeError):
        StreamingDetector(model_t, aot_dir="/nonexistent", device="cpu")
    with pytest.raises(ValueError, match="unknown sink"):
        sd.on("cleaned_cloud", print)


def test_default_device_is_cuda(model_t):
    if torch.cuda.is_available():
        sd = StreamingDetector(model_t)
        assert sd.detector.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            StreamingDetector(model_t)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            StreamingDetector(syn_t.tiny_multires())
