"""Port vs JAX: the three NMS functions on the cases of tests/test_nms.py,
fed the same numpy inputs.  Tolerance: the masks and ``valid`` exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops import nms as nms_jax
from partsbaseddetector_tpu.ops.argmax import Candidates as CandidatesJax
from partsbaseddetector_tpu_torch.ops import nms as nms_t
from partsbaseddetector_tpu_torch.ops.argmax import Candidates

torch.set_num_threads(1)


def _pair(part_boxes, scores, valid=None):
    """The same candidates for both packages: part_boxes (K, P, 4)."""
    part_boxes = np.asarray(part_boxes, np.float32)
    K, P = part_boxes.shape[:2]
    valid = np.ones(K, bool) if valid is None else np.asarray(valid)
    f = dict(score=np.asarray(scores, np.float32), valid=valid,
             component=np.zeros(K, np.int32), level=np.zeros(K, np.int32),
             boxes=part_boxes, loc=np.zeros((K, P, 3), np.int32))
    return (CandidatesJax(**{k: jnp.asarray(v) for k, v in f.items()}),
            Candidates(**{k: torch.from_numpy(v) for k, v in f.items()}))


def _random_boxes(rng, K, P, lo, span):
    b = np.zeros((K, P, 4))
    b[..., 0] = rng.integers(0, lo, (K, P))
    b[..., 1] = rng.integers(0, lo, (K, P))
    b[..., 2] = b[..., 0] + rng.integers(span[0], span[1], (K, P))
    b[..., 3] = b[..., 1] + rng.integers(span[0], span[1], (K, P))
    return b


@pytest.mark.parametrize("sz,masked", [(1, False), (3, False), (7, False),
                                       (2, True)])
def test_grid_nms(sz, masked):
    rng = np.random.default_rng(sz)
    src = rng.standard_normal((40, 50)).astype(np.float32)
    mask = src > 0.5 if masked else None
    ref = nms_jax.grid_nms(jnp.asarray(src), sz,
                           None if mask is None else jnp.asarray(mask))
    got = nms_t.grid_nms(torch.from_numpy(src), sz,
                         None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a constant map has no maxima (src/nms.cpp:55-56)
    assert not nms_t.grid_nms(torch.ones(20, 20), sz).any()


@pytest.mark.parametrize("K,overlap", [(24, 0.0), (24, 0.25), (60, 0.1)])
def test_paint_nms(K, overlap):
    rng = np.random.default_rng(K)
    boxes = _random_boxes(rng, K, 1, 60, (8, 30))
    boxes[: K // 6, 0, 2] = boxes[: K // 6, 0, 0] - 3    # empty regions
    scores = -np.sort(-rng.random(K))
    valid = rng.random(K) > 0.2
    cj, ct = _pair(boxes, scores, valid)
    ref = nms_jax.paint_nms(cj, (64, 96), overlap)
    got = nms_t.paint_nms(ct, (64, 96), overlap)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert torch.equal(got.boxes, ct.boxes)


@pytest.mark.parametrize("K,P,overlap", [(20, 4, 0.3), (20, 4, 0.6),
                                         (300, 3, 0.5)])
def test_part_nms(K, P, overlap, monkeypatch):
    # row blocks smaller than K, so the blocked overlap is exercised
    monkeypatch.setattr(nms_t, "PART_NMS_ROWS", 7)
    rng = np.random.default_rng(K + P)
    boxes = _random_boxes(rng, K, P, 50, (5, 20))
    scores = -np.sort(-rng.random(K))
    valid = np.ones(K, bool)
    valid[::5] = False
    cj, ct = _pair(boxes, scores, valid)
    ref = nms_jax.part_nms(cj, overlap)
    got = nms_t.part_nms(ct, overlap)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    # an invalid candidate suppresses nothing
    cj, ct = _pair([[[0, 0, 10, 10]], [[1, 1, 11, 11]], [[50, 50, 60, 60]]],
                   [3.0, 2.0, 1.0], [False, True, True])
    assert nms_t.part_nms(ct, 0.3).valid.tolist() == [False, True, True]
