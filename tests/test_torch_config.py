"""The port's config.py and Detector.from_config against the JAX
package's: the twin of tests/test_detector.py::test_detector_from_config,
JSON round trips both ways, and the JAX-only knobs, which the port
accepts at their defaults and refuses otherwise."""

import json

import pytest
import torch

from partsbaseddetector_tpu import config as config_jax
from partsbaseddetector_tpu_torch import config
from partsbaseddetector_tpu_torch.infer import detector as det_mod
from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.models import synthetic
from partsbaseddetector_tpu_torch.ops import conv

torch.set_num_threads(1)


def test_detector_from_config():
    model = synthetic.tiny(seed=3)
    cfg = config.RuntimeConfig(k_per_level=8, conv_engine="fft", dp_split=2,
                               walk_impl="torch", compose="correct",
                               device="cpu")
    det = Detector.from_config(model, cfg)
    assert det.k_per_level == 8
    assert det.conv_engine == "fft"
    assert det.dp_split == 2
    assert (det.walk_impl, det.compose, det.device.type) == \
        ("torch", "correct", "cpu")
    # the defaults give the default detector, on CUDA (raising without
    # a card, as Detector(model) does)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Detector.from_config(model, config.RuntimeConfig())
    # the engines by name, re-exported where the JAX package has them
    assert det_mod.CONV_ENGINES is conv.CONV_ENGINES


@pytest.mark.parametrize("jax_cfg", [
    config_jax.PipelineConfig(),
    config_jax.PipelineConfig(
        runtime=config_jax.RuntimeConfig(k_per_level=16, dp_split=3,
                                         conv_engine="fft",
                                         max_candidates=None,
                                         remove_planes=True),
        mesh=config_jax.MeshConfig(data=4, filter=2),
        model_file="m.xml"),
], ids=["defaults", "knobs"])
def test_jax_written_json_loads(tmp_path, jax_cfg):
    """A file the JAX package's PipelineConfig.save wrote loads in the
    port, every shared field equal, and the port's own round trip gives
    the same config back."""
    path = str(tmp_path / "pipeline.json")
    jax_cfg.save(path)
    got = config.PipelineConfig.load(path)
    mine = json.loads(got.to_json())
    assert mine["runtime"].pop("device") is None
    assert mine == json.loads(jax_cfg.to_json())
    assert got.mesh.shape() == jax_cfg.mesh.shape()
    got.save(path)
    assert config.PipelineConfig.load(path) == got
    assert config.PipelineConfig.from_json(got.to_json()) == got


@pytest.mark.parametrize("key,value", [
    ("dt_impl", "xla"), ("platform", "tpu"), ("aot_dir", "/tmp/aot"),
    ("walk_impl", "pallas"), ("walk_impl", "pallas_interpret"),
])
def test_jax_only_knobs_refused(key, value):
    with pytest.raises(ValueError, match="not carried by the port"):
        config.RuntimeConfig(**{key: value})
    with pytest.raises(ValueError, match="not carried by the port"):
        config.PipelineConfig.from_json(json.dumps({"runtime": {key: value}}))
    # at their defaults they load
    assert config.RuntimeConfig(dt_impl="auto", platform=None,
                                aot_dir=None, walk_impl="auto")
