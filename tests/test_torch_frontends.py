"""Port vs JAX: the serving frontends (``frontends/ros_node.py``,
``ecto_cell.py``, ``ork_config.py``, ``messages.py``) and the demo CLI,
on the CPU, over duck-typed transports as tests/test_frontends.py.

The ROS node built by ``from_params`` from a model file that the JAX
package wrote publishes, topic by topic, the messages the JAX node
publishes on the same frames: image bytes exact, marker, pose and
cloud values within 1e-6.  The ECTO cell's pose results match (scores
rtol 1e-5, as tests/test_torch_detector.py:47), and the demo prints the
JAX demo's detection lines.  The port's own behaviour: subscriber
gating, the synchronizer, camera info, a prebuilt detector without a
name (the JAX node raises there, ADVICE.md ros_node.py:77), the ORK
loader, and the parameters it refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.frontends import \
    PartsBasedDetectorCell as CellJax
from partsbaseddetector_tpu.frontends import \
    PartsBasedDetectorNode as NodeJax
from partsbaseddetector_tpu.models import save_filestorage as save_jax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.post.depth import CameraModel as CameraJax
from partsbaseddetector_tpu.tools import demo as demo_jax
from partsbaseddetector_tpu_torch.frontends import (PartsBasedDetectorCell,
                                                    PartsBasedDetectorNode)
from partsbaseddetector_tpu_torch.frontends import messages as msgs
from partsbaseddetector_tpu_torch.frontends.ork_config import (
    instantiate, parse_by_parts)
from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.models import load_any
from partsbaseddetector_tpu_torch.post.depth import CameraModel
from partsbaseddetector_tpu_torch.tools import demo
from partsbaseddetector_tpu_torch.utils import viz

torch.set_num_threads(1)

SHAPE = (64, 64)
K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
TOL = dict(rtol=0, atol=1e-6)


class FakePublisher:
    def __init__(self, topic):
        self.topic = topic
        self.subscribers = 0
        self.published = []

    def publish(self, msg):
        self.published.append(msg)

    def get_num_connections(self):
        return self.subscribers


class FakeTransport:
    def __init__(self, subscribers=0):
        self.pubs = {}
        self.subscribers = subscribers

    def advertise(self, topic, kind):
        pub = FakePublisher(topic)
        pub.subscribers = self.subscribers
        self.pubs[topic] = pub
        return pub

    def pub(self, suffix):
        return next(p for t, p in self.pubs.items() if t.endswith(suffix))


def _frames(n, seed=0):
    """n frames: rgb, uint16 depth in mm (a slope 1.4-2.2 m), organized
    cloud in meters back-projected with K."""
    H, W = SHAPE
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    depth_mm = (1400 + 600 * xs / W + 200 * ys / H).astype(np.uint16)
    z = depth_mm / 1000.0
    cloud = np.stack([(xs - K[0, 2]) / K[0, 0] * z,
                      (ys - K[1, 2]) / K[1, 1] * z, z], -1)
    return [((rng.random((H, W, 3)) * 255).astype(np.uint8), depth_mm,
             cloud) for _ in range(n)]


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """A tiny model file written by the JAX package."""
    m = syn_jax.tiny(seed=2)
    m.thresh = -1e9
    path = str(tmp_path_factory.mktemp("model") / "m.xml")
    save_jax(path, m)
    return path


def _same(a, b, path="msg"):
    """Messages equal: bytes and ints exact, floats within 1e-6."""
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(b):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{path}.{f.name}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(b, (bytes, str, int)) or b is None:
        assert a == b, path
    else:
        np.testing.assert_allclose(a, b, err_msg=path, **TOL)


def test_ros_node_publishes_the_jax_messages(model_file):
    tj, tp = FakeTransport(subscribers=1), FakeTransport(subscribers=1)
    node_j = NodeJax.from_params(tj, {"model": model_file},
                                 camera=CameraJax(100.0, 100.0, 32.0, 32.0))
    node = PartsBasedDetectorNode.from_params(
        tp, {"model": model_file, "device": "cpu"},
        camera=CameraModel(100.0, 100.0, 32.0, 32.0))
    assert set(tp.pubs) == set(tj.pubs)
    for i, (rgb, depth, cloud) in enumerate(_frames(2)):
        header = msgs.Header(stamp=12.5 + i, frame_id="camera", seq=i)
        res = node.depth_image_callback(rgb, depth, cloud, header=header)
        node_j.depth_image_callback(rgb, depth, cloud, header=header)
        assert res.detections and all(len(c) for c in res.clusters)
    for topic, pub in tp.pubs.items():
        ref = tj.pubs[topic].published
        # two frames; bounding_box also re-publishes the first frame's
        # markers as DELETE before the second frame's
        assert len(pub.published) == len(ref) >= 2, topic
        _same(pub.published, ref, topic)


def test_ros_node_subscriber_gating(model_file):
    transport = FakeTransport()
    node = PartsBasedDetectorNode.from_params(
        transport, {"model": model_file, "device": "cpu"},
        camera=CameraModel(100.0, 100.0, 32.0, 32.0))
    suffixes = {t.rsplit("/", 1)[1] for t in transport.pubs}
    assert suffixes == {"candidates_rect_color", "mask", "bounding_box",
                        "cleaned_cloud", "part_centers", "object_poses"}
    rgb, depth, cloud = _frames(1)[0]
    res = node.depth_image_callback(rgb, depth, cloud)
    assert all(not p.published for p in transport.pubs.values())
    assert res.overlay is None and res.boxes3d is None
    bb = transport.pub("bounding_box")
    bb.subscribers = 2
    res = node.depth_image_callback(rgb, depth, cloud)
    assert len(bb.published) == 1 and res.mask is None
    node.depth_image_callback(rgb, depth, cloud)
    assert len(bb.published) == 3
    assert all(m.action == msgs.Marker.DELETE
               for m in bb.published[1].markers)
    bb.subscribers = 0
    node.depth_image_callback(rgb, depth, cloud)
    assert len(bb.published) == 3


def test_synchronizer_and_camera_info(model_file):
    """Message-typed inputs through the synchronizer drive the callback;
    camera info enables the 3-D path."""
    transport = FakeTransport(subscribers=1)
    node = PartsBasedDetectorNode.from_params(
        transport, {"model": model_file, "device": "cpu"})
    assert node.stream.camera is None
    node.depth_camera_callback(K)
    cam = node.stream.camera
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (100.0, 100.0, 32.0, 32.0)

    class InfoMsg:
        K = tuple(np.diag([90.0, 90.0, 1.0]).ravel())
    node.depth_camera_callback(InfoMsg())
    assert node.stream.camera.fx == 90.0

    rgb, depth, cloud = _frames(1, seed=4)[0]
    h = msgs.Header(stamp=3.0, frame_id="kinect")
    sync = node.make_synchronizer(queue_size=10)
    sync.add(0, 3.00, depth)
    sync.add(1, 3.01, msgs.ImageMsg.from_array(rgb, "rgb8", h))
    sync.add(2, 3.02, msgs.PointCloudMsg(
        header=h, points=cloud.reshape(-1, 3).astype(np.float32)))
    sync.flush()
    over = transport.pub("candidates_rect_color")
    assert len(over.published) == 1
    assert over.published[0].header.frame_id == "kinect"
    assert len(transport.pub("bounding_box").published) == 1


def test_prebuilt_detector_without_name(model_file):
    """ADVICE.md ros_node.py:77: the JAX node reads ``model.name`` of a
    prebuilt detector, which has none; the port takes the name from the
    detector's model."""
    m = load_any(model_file)
    det = Detector(m, k_per_level=8, device="cpu")
    transport = FakeTransport()
    node = PartsBasedDetectorNode(det, transport)
    assert node.name == m.name and node.stream.detector is det
    assert all(t.startswith(f"/pbd/{m.name}/") for t in transport.pubs)
    assert node.depth_image_callback(_frames(1)[0][0]).detections
    assert PartsBasedDetectorNode(det, FakeTransport(),
                                  name="cam1").name == "cam1"
    from partsbaseddetector_tpu.infer.detector import Detector as DetJax
    with pytest.raises(AttributeError):
        NodeJax(DetJax(syn_jax.tiny(seed=2), k_per_level=8),
                FakeTransport())


def _run_cell(cell_cls, params, frame):
    p, inputs, outputs = {}, {}, {}
    cell_cls.declare_params(p)
    p.update(params)
    cell_cls.declare_io(p, inputs, outputs)
    cell = cell_cls()
    cell.configure(p, inputs, outputs)
    rgb, depth, cloud = frame
    inputs.update(image=rgb, depth=depth, K=K, input_cloud=cloud)
    assert cell.process(inputs, outputs) == 0
    return outputs


def test_ecto_cell_matches_jax(model_file):
    frame = _frames(1, seed=1)[0]
    got = _run_cell(PartsBasedDetectorCell,
                    {"model_file": model_file, "device": "cpu",
                     "visualize": True}, frame)
    ref = _run_cell(CellJax, {"model_file": model_file, "visualize": True},
                    frame)
    np.testing.assert_array_equal(got["image"], ref["image"])
    gp, rp = got["pose_results"], ref["pose_results"]
    assert len(gp) == len(rp) > 0
    # the cell attaches no clusters sink, so T stays NaN in both
    assert any(p.quat is not None for p in gp)
    for g, r in zip(gp, rp):
        assert g.object_id == r.object_id
        np.testing.assert_allclose(g.T, r.T, **TOL)        # NaN == NaN
        assert (g.quat is None) == (r.quat is None)
        if r.quat is not None:
            np.testing.assert_allclose(g.quat, r.quat, **TOL)
        np.testing.assert_allclose(g.score, r.score, rtol=1e-5)


BY_PARTS = """
source1:
  type: RosKinect
  module: 'object_recognition_ros.io'

sink1:
  type: Publisher
  module: 'object_recognition_by_parts'

pipeline1:
  type: PartsBasedDetector
  module: 'object_recognition_by_parts'
  inputs: [source1]
  outputs: [sink1]
  parameters:
    visualize: true
    k_per_level: 8
    db: {type: CouchDB}
    extra:
        model_file: "/nonexistent/model.xml"
        use_cuda: false
        device: cpu
"""


def test_ork_config_parse_and_instantiate(model_file):
    cfg = parse_by_parts(BY_PARTS)
    assert set(cfg.cells) == {"source1", "sink1", "pipeline1"}
    params = cfg.detector_params()
    assert params["visualize"] is True and params["k_per_level"] == 8
    assert params["device"] == "cpu" and "use_cuda" not in params
    assert set(cfg.ignored_params) == {"db", "use_cuda"}
    cell = instantiate(cfg, model=load_any(model_file))
    rgb = _frames(1)[0][0]
    outputs = {"pose_results": [], "image": None}
    assert cell.process({"image": rgb, "depth": None, "K": None,
                         "input_cloud": None}, outputs) == 0
    assert outputs["pose_results"]
    assert cell._stream.detector.k_per_level == 8
    with pytest.raises(ValueError, match="undeclared cell"):
        parse_by_parts("pipeline1:\n  type: X\n  module: m\n"
                       "  inputs: [ghost]\n")


@pytest.mark.parametrize("frontend", ["ros", "ecto"])
@pytest.mark.parametrize("key,value,exc,match", [
    ("aot_dir", "/tmp/aot", ValueError, "not carried by the port"),
    ("mesh", [4, 2], ValueError, "world size is 1"),
    ("walk_imp", "cuda", ValueError, "unknown parameter"),
])
def test_frontends_refuse(model_file, frontend, key, value, exc, match):
    with pytest.raises(exc, match=match):
        if frontend == "ros":
            PartsBasedDetectorNode.from_params(
                FakeTransport(), {"model": model_file, "device": "cpu",
                                  key: value})
        else:
            _run_cell(PartsBasedDetectorCell,
                      {"model_file": model_file, "device": "cpu",
                       key: value}, _frames(1)[0])


def test_frontends_default_to_cuda(model_file):
    if torch.cuda.is_available():
        node = PartsBasedDetectorNode.from_params(FakeTransport(),
                                                  {"model": model_file})
        assert node.stream.detector.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            PartsBasedDetectorNode.from_params(FakeTransport(),
                                               {"model": model_file})
        with pytest.raises(RuntimeError, match='device="cpu"'):
            _run_cell(PartsBasedDetectorCell, {"model_file": model_file},
                      _frames(1)[0])
    node = PartsBasedDetectorNode.from_params(
        FakeTransport(), {"model": model_file, "device": "cpu",
                          "remove_planes": True, "max_overlap": 0.25,
                          "name": "fromparams"})
    assert node.name == "fromparams"
    assert (node.stream.remove_planes, node.stream.max_overlap) == \
        (True, 0.25)


def test_demo_prints_the_jax_detections(model_file, tmp_path, capsys):
    ipath = str(tmp_path / "im.png")
    viz.save_image(ipath, _frames(1, seed=6)[0][0])
    common = [model_file, ipath, "--k-per-level", "8", "--nms", "0.3",
              "--max-candidates", "6"]

    def lines():
        out = capsys.readouterr().out
        return [x for x in out.splitlines()
                if x.startswith(("  score=", "model:"))
                or "above threshold" in x]

    assert demo_jax.main(common) == 0
    ref = lines()
    out = str(tmp_path / "overlay.png")
    assert demo.main(common + ["--device", "cpu", "--out", out,
                               "--skeleton"]) == 0
    got = lines()
    assert len(ref) > 3 and got == ref
    assert demo.load_image(out).shape == (64, 64, 3)
    with pytest.raises(ValueError, match="world size is 1"):
        demo.main(common + ["--device", "cpu", "--mesh", "4,2"])
