"""Port vs JAX: model files.  Each format is written by one package and
read by the other's ``load_any``: FileStorage XML and YAML, Matlab
``.mat`` and ``.npz``, for ``synthetic.tiny`` and (XML, npz) person-26.
The model the port reads equals the model the JAX package reads from
the same file: every field equal, filters bitwise.  A malformed file
raises the same exception type in both."""

import numpy as np
import pytest

from partsbaseddetector_tpu import models as models_jax
from partsbaseddetector_tpu.models import matio as matio_jax
from partsbaseddetector_tpu.models import npzio as npzio_jax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu_torch import models as models_t
from partsbaseddetector_tpu_torch.models import matio as matio_t
from partsbaseddetector_tpu_torch.models import npzio as npzio_t
from partsbaseddetector_tpu_torch.models import synthetic as syn_t

SAVERS = {
    "jax": {"xml": models_jax.save_filestorage,
            "yml": models_jax.save_filestorage,
            "mat": matio_jax.save_mat, "npz": npzio_jax.save_npz},
    "port": {"xml": models_t.save_filestorage,
             "yml": models_t.save_filestorage,
             "mat": matio_t.save_mat, "npz": npzio_t.save_npz},
}
LOADERS = {"jax": models_jax.load_any, "port": models_t.load_any}
SYNTHETIC = {"jax": syn_jax, "port": syn_t}


def assert_same_model(a, b):
    for f in ("name", "interval", "thresh", "binsize", "norient", "flen"):
        assert getattr(a, f) == getattr(b, f), f
    assert len(a.filters) == len(b.filters)
    for fa, fb in zip(a.filters, b.filters):
        assert fa.dtype == fb.dtype and fa.shape == fb.shape
        assert fa.tobytes() == fb.tobytes()            # bitwise
    for xs, ys in ((a.defw, b.defw), (a.anchors, b.anchors)):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)
    assert a.biasw.dtype == b.biasw.dtype
    np.testing.assert_array_equal(a.biasw, b.biasw)
    assert a.ncomponents == b.ncomponents
    for ca, cb in zip(a.components, b.components):
        assert [vars(p) for p in ca.parts] == [vars(p) for p in cb.parts]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("ext,maker", [
    ("xml", "tiny"), ("yml", "tiny"), ("mat", "tiny"), ("npz", "tiny"),
    ("xml", "person_like"), ("npz", "person_like")])
def test_cross_package_round_trip(tmp_path, writer, ext, maker):
    reader = "port" if writer == "jax" else "jax"
    model = getattr(SYNTHETIC[writer], maker)(seed=4)
    model.name = f"{maker}-{writer}"
    path = str(tmp_path / f"m.{ext}")
    SAVERS[writer][ext](path, model)
    got = LOADERS[reader](path)
    assert type(got).__module__.startswith(
        "partsbaseddetector_tpu_torch" if reader == "port"
        else "partsbaseddetector_tpu.")
    assert_same_model(got, LOADERS[writer](path))
    # the formats keep what the model holds (npz stores float32 filters)
    assert got.name == model.name
    assert len(got.filters) == len(model.filters)


def _truncated(tmp_path, load):
    p = tmp_path / "m.xml"
    models_jax.save_filestorage(str(p), syn_jax.tiny(seed=1))
    text = p.read_text()
    (tmp_path / "trunc.xml").write_text(text[: len(text) // 2])
    load(str(tmp_path / "trunc.xml"))


def _garbage(tmp_path, load):
    p = tmp_path / "g.xml"
    p.write_text("<opencv_storage><name>x</name></opencv_storage>")
    load(str(p))


def _unknown_extension(tmp_path, load):
    p = tmp_path / "model.txt"
    p.write_text("not a model")
    load(str(p))


def _missing(tmp_path, load):
    load(str(tmp_path / "nope.xml"))


def _index_out_of_range(tmp_path, load):
    model = syn_jax.tiny(seed=1)
    model.components[0].parts[1].filterid[0] = 10 ** 6
    p = tmp_path / "bad.xml"
    models_jax.save_filestorage(str(p), model)    # the writer validates not
    load(str(p))


@pytest.mark.parametrize("failure", [
    _unknown_extension, _missing, _truncated, _garbage,
    _index_out_of_range], ids=lambda f: f.__name__[1:])
def test_malformed_files_raise_alike(tmp_path, failure):
    raised = {}
    for name, load in LOADERS.items():
        d = tmp_path / name
        d.mkdir()
        with pytest.raises(Exception) as ei:
            failure(d, load)
        assert not isinstance(ei.value, AttributeError)
        raised[name] = type(ei.value)
    assert raised["port"] is raised["jax"], raised
