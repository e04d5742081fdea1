"""The port's detector facades behind one surface, on the CPU at world
size 1: Detector, MultiResDetector, BatchDetector, ScaleShardedDetector
and PipelinedDetector("cpu", "cpu"), each on a person-like model and a
multi-resolution one (Detector refuses the latter).  Every facade's
detect_batch_raw equals its stacked detect_raw field by field, a depth
map without ``depth_prune`` raises the one ValueError, and a
StreamingDetector on the prebuilt facade gives from process_batch what
it gives from process."""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.infer.multires import MultiResDetector
from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
from partsbaseddetector_tpu_torch.models import synthetic
from partsbaseddetector_tpu_torch.parallel import BatchDetector, make_mesh
from partsbaseddetector_tpu_torch.parallel.pipeline import PipelinedDetector
from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
    ScaleShardedDetector, make_scale_mesh)

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
