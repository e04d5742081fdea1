"""The port stands alone: importing every module of
partsbaseddetector_tpu_torch loads neither JAX nor any module of the JAX
package, and its entry points run on CUDA unless told otherwise."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import partsbaseddetector_tpu_torch
from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.models import synthetic
from partsbaseddetector_tpu_torch.ops.common import resolve_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _port_modules():
    pkg = partsbaseddetector_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        pkg.__path__, prefix=pkg.__name__ + "."))


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("ops.common", "models.schema", "models.synthetic",
                 "ops.conv", "models.part_tree", "models.transfer",
                 "ops.hog", "infer.pyramid_plan", "ops.imageops",
                 "ops.dt", "ops.dp", "ops.argmax", "ops.walk",
                 "ops._build", "infer.detector", "ops.nms",
                 "infer.multires", "post.rect3", "post.depth",
                 "post.poses", "post.cloud", "models.filestorage",
                 "models.matio", "models.npzio", "utils.viz",
                 "infer.stream", "frontends.messages", "frontends.ros_node",
                 "frontends.ecto_cell", "frontends.ork_config",
                 "tools.demo", "oracle.reference", "train.vectorize",
                 "train.qp", "train.cluster", "train.build",
                 "train.features", "train.trainer", "tools.datasets",
                 "tools.train", "tools.evaluate", "tools.model_transfer",
                 "tools.annotate", "utils.eval",
                 "models.transfer_formats", "config", "utils.profiling",
                 "parallel", "parallel.mesh", "parallel.distributed",
                 "parallel.sharded", "parallel.scale_sharded",
                 "parallel.pipeline"):
        assert f"partsbaseddetector_tpu_torch.{name}" in mods, name
    assert (REPO / "partsbaseddetector_tpu_torch/csrc/walk.cu").is_file()


def _run(code: str) -> dict:
    """Run code in a fresh interpreter that sees the repo; its last line
    of output is JSON."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or "
        "m.startswith('jaxlib.') or m == 'partsbaseddetector_tpu' or "
        "m.startswith('partsbaseddetector_tpu.')]\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    res = _run(code)
    assert res["n"] >= 62
    assert res["bad"] == []


def test_parallel_imports_without_a_process_group():
    """parallel/ imports, and builds its world-size-1 meshes and
    detectors, in a process where no torch.distributed process group
    (and no backend) was ever initialised; importing it initialises
    none."""
    code = (
        "import json\n"
        "import torch.distributed as dist\n"
        "from partsbaseddetector_tpu_torch import parallel\n"
        "from partsbaseddetector_tpu_torch.parallel import (distributed,\n"
        "    mesh, pipeline, scale_sharded, sharded)\n"
        "from partsbaseddetector_tpu_torch.models import synthetic\n"
        "before = dist.is_initialized()\n"
        "m = parallel.make_mesh(device='cpu')\n"
        "s = scale_sharded.make_scale_mesh(device='cpu')\n"
        "b = parallel.BatchDetector(synthetic.tiny(), m)\n"
        "print(json.dumps({'before': before,\n"
        "                  'after': dist.is_initialized(),\n"
        "                  'shapes': [m.shape, s.shape]}))\n")
    assert _run(code) == {"before": False, "after": False,
                          "shapes": [{"data": 1, "filter": 1},
                                     {"scale": 1, "filter": 1}]}


def test_the_port_imports_without_pil_and_yaml():
    """Neither PIL, PyYAML nor matplotlib is on the card machine: every
    port module imports with the three blocked; only the overlay and the
    training views, the demo's image files, the PARSE loader, the ORK
    parser and the annotator need them, inside the functions that use
    them."""
    code = (
        "import importlib, json, sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from partsbaseddetector_tpu_torch.frontends import parse_by_parts\n"
        "try:\n"
        "    parse_by_parts('a:\\n  type: X\\n  module: m\\n')\n"
        "    blocked = False\n"
        "except ImportError:\n"
        "    blocked = True\n"
        "print(json.dumps({'n': len(mods), 'blocked': blocked}))\n")
    res = _run(code)
    assert res == {"n": len(_port_modules()), "blocked": True}


def test_precision_flags_off_at_import():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_default_device_is_cuda():
    model = synthetic.tiny()
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert Detector(model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device(None)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Detector(model)
    assert Detector(model, device="cpu").device.type == "cpu"
