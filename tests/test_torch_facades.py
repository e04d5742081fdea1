"""The port's detector facades behind one surface, on the CPU at world
size 1: Detector, MultiResDetector, BatchDetector, ScaleShardedDetector
and PipelinedDetector("cpu", "cpu"), each on a person-like model and a
multi-resolution one (Detector refuses the latter).  Every facade's
detect_batch_raw equals its stacked detect_raw field by field, a depth
map without ``depth_prune`` raises the one ValueError, and a
StreamingDetector on the prebuilt facade gives from process_batch what
it gives from process.  Then the one-frame CUDA graph's CPU side: a
second program call builds no tensor from host data, a detector whose
plan constants are warm gives a fresh one's Candidates, and the rule
that picks the graph path and the graph a facade holds."""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu_torch.infer import detector as detector_mod
from partsbaseddetector_tpu_torch.infer.detector import (DepthPrune,
                                                         Detector,
                                                         plan_tensors,
                                                         upload)
from partsbaseddetector_tpu_torch.infer.multires import MultiResDetector
from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
from partsbaseddetector_tpu_torch.models import synthetic
from partsbaseddetector_tpu_torch.parallel import BatchDetector, make_mesh
from partsbaseddetector_tpu_torch.parallel.pipeline import PipelinedDetector
from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
    ScaleShardedDetector, make_scale_mesh)
from partsbaseddetector_tpu_torch.utils import profiling

torch.set_num_threads(1)

FIELDS = ("score", "valid", "component", "level", "boxes", "loc")
K = 4

FACADES = {
    "Detector": lambda m: Detector(m, k_per_level=K, device="cpu"),
    "MultiResDetector": lambda m: MultiResDetector(m, k_per_level=K,
                                                   device="cpu"),
    "BatchDetector": lambda m: BatchDetector(m, make_mesh(device="cpu"),
                                             k_per_level=K),
    "ScaleShardedDetector": lambda m: ScaleShardedDetector(
        m, make_scale_mesh(device="cpu"), k_per_level=K),
    "PipelinedDetector": lambda m: PipelinedDetector(m, "cpu", "cpu",
                                                     k_per_level=K),
}
MODELS = {"person_like": (synthetic.person_like, (64, 48)),
          "tiny_multires": (lambda: synthetic.tiny_multires(seed=5),
                            (64, 64))}
CASES = [(m, f) for m in MODELS for f in FACADES
         if (m, f) != ("tiny_multires", "Detector")]


@pytest.mark.parametrize("model_name,facade", CASES)
def test_one_surface(model_name, facade):
    make, shape = MODELS[model_name]
    model = make()
    model.thresh = -1e9
    det = FACADES[facade](model)
    rng = np.random.default_rng(4)
    rgbs = (rng.random((2,) + shape + (3,)) * 255).astype(np.uint8)

    batch = det.detect_batch_raw(rgbs)
    singles = [det.detect_raw(f) for f in rgbs]
    for f in FIELDS:
        assert torch.equal(getattr(batch, f),
                           torch.stack([getattr(s, f) for s in singles])), f
    assert batch.valid.any()

    depth = np.full(shape, 2.0, np.float32)
    with pytest.raises(ValueError, match="depth_prune"):
        det.detect_raw(rgbs[0], depth=depth)
    with pytest.raises(ValueError, match="depth_prune"):
        det.detect_batch_raw(rgbs, depths=np.stack([depth, depth]))

    sd = StreamingDetector(det, max_candidates=8, max_overlap=0.5)
    assert sd.detector is det and sd.model is model
    for got, one in zip(sd.process_batch(rgbs), map(sd.process, rgbs)):
        assert len(got.detections) == len(one.detections) > 0
        for a, b in zip(got.detections, one.detections):
            assert (a.score, a.level, a.component) == \
                (b.score, b.level, b.component)
            np.testing.assert_array_equal(a.locations, b.locations)
            np.testing.assert_array_equal(a.parts, b.parts)


PRUNE = DepthPrune(0.4, 100.0, 0.5)


def _frames(n, shape=(96, 128), seed=6):
    """n seeded uint8 frames and depth maps (meters, half the frame's
    size, 0-3 m: PRUNE keeps some levels' cells and prunes others')."""
    rng = np.random.default_rng(seed)
    rgbs = (rng.random((n,) + shape + (3,)) * 255).astype(np.uint8)
    depths = (rng.random((n, shape[0] // 2, shape[1] // 2)) * 3).astype(
        np.float32)
    return rgbs, depths


def _person(prune=None):
    model = synthetic.person_like()
    model.thresh = -1e9
    return Detector(model, k_per_level=K, depth_prune=prune, device="cpu")


def test_second_program_call_builds_no_tensor_from_host(monkeypatch):
    """After a first call on a plan, the program (stages 1-4, with depth
    pruning) makes no tensor of host data and writes no host scalar by
    index: on the card each is a copy from pageable host memory, which a
    CUDA graph cannot capture (infer/detector.FrameGraph)."""
    det = _person(PRUNE)
    rgbs, depths = _frames(1)
    frames, dmaps, _ = upload(rgbs[0], 3, det.device, depths[0])
    det._program(frames, dmaps)
    made = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        def counted(data, *a, _orig=getattr(torch, name), _name=name, **kw):
            if not isinstance(data, torch.Tensor):
                made.append(_name)
            return _orig(data, *a, **kw)
        monkeypatch.setattr(torch, name, counted)
    setitem = torch.Tensor.__setitem__

    def counted_setitem(self, index, value):
        if not isinstance(value, torch.Tensor):
            made.append("__setitem__")
        return setitem(self, index, value)
    monkeypatch.setattr(torch.Tensor, "__setitem__", counted_setitem)
    try:
        out = det._program(frames, dmaps)
    finally:
        monkeypatch.undo()
    assert made == []
    assert 0 < int(out.valid.sum()) < out.capacity     # some cells pruned


@pytest.mark.parametrize("prune", [None, PRUNE], ids=["plain", "pruned"])
def test_warm_plan_constants_give_fresh_candidates(prune):
    """A detector that built its plan's device constants on an earlier
    frame gives, bit for bit, the Candidates of a fresh detector that
    builds them anew (plan_tensors' cache cleared)."""
    rgbs, depths = _frames(2)

    def depth(i):
        return None if prune is None else depths[i]
    warm = _person(prune)
    warm.detect_raw(rgbs[0], depth=depth(0))
    got = warm.detect_raw(rgbs[1], depth=depth(1))
    plan_tensors.cache_clear()
    want = _person(prune).detect_raw(rgbs[1], depth=depth(1))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.valid.any()


class _CPUGraph:
    """FrameGraph's stand-in on the CPU: the program runs at each replay,
    and every capture and replay is recorded."""

    log = []

    def __init__(self, key, program, frames, depths):
        self.key, self.program = key, program
        self.log.append(("capture", key))

    def replay(self, frames, depths):
        self.log.append(("replay", self.key))
        return self.program(frames.clone(), depths)


def test_graph_rule_and_the_graph_a_facade_holds(monkeypatch):
    """The graph path engages only for one frame on CUDA through the
    facade's own single-resolution program with the default stage hook
    and no masks; a facade captures at the second call in a row of one
    key (frame shape and dtype, depth map shape), replays that key's
    graph while it holds it, runs other keys eagerly, and update_model
    drops the graph and the last key."""
    det = _person(PRUNE)
    one = torch.zeros((1, 96, 128, 3), dtype=torch.uint8)
    eight = torch.zeros((8, 96, 128, 3), dtype=torch.uint8)
    default = profiling.stage
    assert not det._graphable(one, None, default, None)        # the CPU
    monkeypatch.setattr(det, "device", torch.device("cuda"))
    assert det._graphable(one, None, default, None)
    assert not det._graphable(eight, None, default, None)
    assert not det._graphable(one, None, profiling.StageTimer().stage,
                              None)
    assert not det._graphable(one, [torch.ones(1, dtype=torch.bool)],
                              default, None)
    assert not det._graphable(one, None, default, det._program)
    multires = MultiResDetector(synthetic.tiny_multires(seed=5),
                                device="cpu")
    monkeypatch.setattr(multires, "device", torch.device("cuda"))
    assert not multires._graphable(one, None, default, None)
    monkeypatch.undo()

    monkeypatch.setattr(detector_mod, "FrameGraph", _CPUGraph)
    _CPUGraph.log = []
    rgbs, depths = _frames(3)
    frames = [upload(rgbs[i], 3, torch.device("cpu"), depths[i])[:2]
              for i in range(3)]
    small = upload(rgbs[0][:64, :80], 3, torch.device("cpu"),
                   depths[0][:32, :40])[:2]
    key = ((1, 96, 128, 3), torch.uint8, (1, 48, 64))
    calls = [frames[0], frames[1], frames[2], small, frames[0], small,
             small, frames[1]]
    for f, d in calls:
        got = det._graphed(f, d)
        want = det._program(f, d)
        for name in FIELDS:
            assert torch.equal(getattr(got, name), getattr(want, name))
    small_key = ((1, 64, 80, 3), torch.uint8, (1, 32, 40))
    assert _CPUGraph.log == [("capture", key), ("replay", key),
                             ("replay", key), ("replay", key),
                             ("capture", small_key), ("replay", small_key),
                             ]
    assert det._graph.key == small_key and det._last_key == key
    det.update_model(det.model)
    assert det._graph is None and det._last_key is None
    det._graphed(*frames[0])                      # eager again
    assert len(_CPUGraph.log) == 6
