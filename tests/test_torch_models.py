"""The port's model layer against the JAX package's.

Synthetic models must be identical for the same seed (numpy only, same
generator calls); the port's pack_model must equal the JAX pack_model's
leaves carried across with models.transfer.packed_from_numpy, field by
field, dtype included; the pyramid plans must be equal.  All exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.infer import pyramid_plan as plan_jax
from partsbaseddetector_tpu.models import part_tree as tree_jax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu_torch.infer import pyramid_plan as plan_t
from partsbaseddetector_tpu_torch.models import part_tree as tree_t
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from partsbaseddetector_tpu_torch.models.transfer import packed_from_numpy

torch.set_num_threads(1)

_COMP_ARRAYS = ("filterid", "defw", "anchor", "bias", "parent", "nmix",
                "mix_valid", "root_bias", "fsize")


def jax_leaves(packed) -> dict:
    """A JAX PackedModel as the numpy mapping packed_from_numpy takes."""
    out = {f.name: getattr(packed, f.name)
           for f in dataclasses.fields(packed)}
    out["bank"] = np.asarray(packed.bank)
    out["thresh"] = np.asarray(packed.thresh)
    out["components"] = [
        dict({k: np.asarray(getattr(c, k)) for k in _COMP_ARRAYS},
             aliased=c.aliased)
        for c in packed.components]
    return out


def port_packed(jax_packed):
    """The JAX model's parameters as the port's PackedModel (CPU)."""
    return packed_from_numpy(jax_leaves(jax_packed), device="cpu")


def _assert_models_equal(a, b):
    for f in ("name", "interval", "thresh", "binsize", "norient", "flen"):
        assert getattr(a, f) == getattr(b, f), f
    assert len(a.filters) == len(b.filters)
    for x, y in zip(a.filters, b.filters):
        np.testing.assert_array_equal(x, y)
    for xs, ys in ((a.defw, b.defw), (a.anchors, b.anchors)):
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.biasw, b.biasw)
    for ca, cb in zip(a.components, b.components):
        for pa, pb in zip(ca.parts, cb.parts):
            assert dataclasses.asdict(pa) == dataclasses.asdict(pb)


@pytest.mark.parametrize("maker,seed", [("tiny", 0), ("tiny", 7),
                                        ("person_like", 0),
                                        ("face_like", 22),
                                        ("tiny_multires", 1)])
def test_synthetic_same_weights(maker, seed):
    _assert_models_equal(getattr(syn_jax, maker)(seed=seed),
                         getattr(syn_t, maker)(seed=seed))


@pytest.mark.parametrize("maker,seed", [("tiny", 3), ("person_like", 0)])
def test_pack_model_matches_transfer(maker, seed):
    jp = tree_jax.pack_model(getattr(syn_jax, maker)(seed=seed))
    carried = port_packed(jp)
    own = tree_t.pack_model(getattr(syn_t, maker)(seed=seed), "cpu")
    for f in ("interval", "binsize", "norient", "flen", "name",
              "parent_static", "scale_static"):
        assert getattr(own, f) == getattr(carried, f) == getattr(jp, f), f
    for f in ("bank", "thresh"):
        a, b = getattr(own, f), getattr(carried, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert len(own.components) == len(carried.components)
    for ca, cb in zip(own.components, carried.components):
        assert ca.aliased == cb.aliased
        for f in _COMP_ARRAYS:
            a, b = getattr(ca, f), getattr(cb, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(a, b), f
    assert own.components[0].filterid.dtype == torch.int32


@pytest.mark.parametrize("imshape,binsize,interval",
                         [((480, 640), 4, 10), ((64, 80), 4, 3),
                          ((120, 160), 4, 10)])
def test_make_plan_matches(imshape, binsize, interval):
    ours = plan_t.make_plan(imshape, binsize, interval)
    theirs = plan_jax.make_plan(imshape, binsize, interval)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert len(ours.levels) == len(theirs.levels) > 0
