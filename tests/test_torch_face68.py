"""Face-68 end to end: the port's Detector against the JAX Detector on
synthetic.face_like() (68 parts x 4 mixtures, 272 filters, interval 5)
at 120x160 on test_native_parity's structured image, k_per_level=8.

``loc``, ``valid``, ``level``, ``component`` and ``boxes`` exact;
``score`` within the tolerance tests/test_torch_detector.py holds
person-26 to (median |difference| < 1e-4 over the valid candidates).
The JAX program runs with dp_split=1 (its compile time is about a third
of the default grouping's); the port runs its default grouping
(dp_split 3) and dp_split=1, which must agree with it exactly."""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.infer.detector import Detector as DetectorJax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from test_native_parity import structured_image

torch.set_num_threads(1)

K = 8
EXACT = ("valid", "level", "component", "boxes", "loc")


@pytest.fixture(scope="module")
def reference():
    mj = syn_jax.face_like()
    mj.thresh = -1e9
    img = structured_image(101, 120, 160)
    ref = DetectorJax(mj, k_per_level=K, dp_split=1).detect_raw(img)
    return img, {f: np.asarray(getattr(ref, f)) for f in EXACT + ("score",)}


@pytest.mark.parametrize("dp_split", [None, 1], ids=["default", "split1"])
def test_face68_matches_jax(reference, dp_split):
    img, ref = reference
    mt = syn_t.face_like()
    mt.thresh = -1e9
    det = Detector(mt, k_per_level=K, dp_split=dp_split, device="cpu")
    assert det.dp_split == (3 if dp_split is None else 1)
    assert mt.components[0].nparts == 68 and mt.nfilters == 272
    got = det.detect_raw(img)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f],
                                      err_msg=f)
    v = ref["valid"]
    assert v.sum() >= 0.9 * v.size
    diff = np.abs(got.score.numpy()[v] - ref["score"][v])
    assert np.median(diff) < 1e-4
