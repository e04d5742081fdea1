"""ORK ``.by_parts`` pipeline-config loader (port of
partsbaseddetector_tpu/frontends/ork_config.py; PyYAML is imported by
``parse_by_parts`` alone, so the module loads without it).

The reference ships two Object Recognition Kitchen pipeline configs
(reference: conf/config_person.by_parts:17-31,
conf/config_face.by_parts:17-32) — standard ORK YAML: named cells
(``source1``/``sink1``/``pipeline1``) with ``type``/``module``/
``inputs``/``outputs``/``parameters``, the detector's own parameters
under ``extra`` (``model_file``, the dead ``use_cuda`` flag).  The
reference's ONLY automated tests lint + instantiate exactly these files
(reference: test/CMakeLists.txt:5-9).

This module is the migration path for ORK users: parse a ``.by_parts``
file, validate it the way ``object_recognition_core_config_test`` does
(every cell typed, every pipeline input/output resolving to a declared
cell), and instantiate the detector cell (frontends/ecto_cell.py) from
its parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from partsbaseddetector_tpu_torch.frontends.ecto_cell import \
    PartsBasedDetectorCell

#: parameters cells/detect.cpp declares (reference: cells/detect.cpp:115-126)
#: plus this framework's detector-facade knobs (ecto_cell.declare_params);
#: anything else under ``extra`` is passed through to the cell, which
#: refuses keys it does not know.
DECLARED_PARAMS = ("visualize", "remove_planes", "model_file",
                   "max_overlap",
                   # facade knobs (frontends reach the full framework:
                   # multires routing, the device, mesh serving); aot_dir
                   # is declared so that the cell refuses it by name
                   "k_per_level", "conv_engine", "walk_impl", "dp_split",
                   "compose", "device", "aot_dir", "mesh", "depth_prune")


@dataclasses.dataclass
class CellSpec:
    """One named cell of an ORK pipeline config."""
    name: str
    type: str
    module: str
    inputs: List[str]
    outputs: List[str]
    parameters: Dict


@dataclasses.dataclass
class OrkConfig:
    cells: Dict[str, CellSpec]
    #: pipeline-level params dropped by detector_params() (db,
    #: object_ids, use_cuda, ...) — populated on first call
    ignored_params: tuple = ()

    def pipelines(self) -> List[CellSpec]:
        return [c for c in self.cells.values()
                if c.name.startswith("pipeline")]

    def detector_pipeline(self) -> CellSpec:
        """The PartsBasedDetector pipeline cell (reference configs name
        it ``pipeline1`` with type PartsBasedDetector)."""
        for c in self.pipelines():
            if c.type == "PartsBasedDetector":
                return c
        raise ValueError("no PartsBasedDetector pipeline cell in config")

    def detector_params(self) -> Dict:
        """The detector cell's parameter dict: ORK keeps the cell's own
        params under ``parameters.extra`` (model_file, use_cuda, ...)
        with pipeline-level ones (visualize, ...) beside it
        (reference: conf/config_person.by_parts:22-31).

        Pipeline-level keys outside DECLARED_PARAMS (the reference
        configs carry ``db`` and ``object_ids``) are NOT honored by the
        detector cell; they are collected into ``self.ignored_params``
        and warned about once, so migrating ORK users whose setup
        depends on them get a signal instead of silence."""
        p = dict(self.detector_pipeline().parameters)
        extra = p.pop("extra", {}) or {}
        dropped = sorted(k for k in p if k not in DECLARED_PARAMS)
        out = {k: v for k, v in p.items() if k in DECLARED_PARAMS}
        out.update(extra)
        # the reference configs carry use_cuda: false; nothing reads it
        # there (declared nowhere in cells/detect.cpp) and nothing here —
        # tolerated for compatibility, dropped on use
        if out.pop("use_cuda", None) is not None:
            dropped.append("use_cuda")
        self.ignored_params = tuple(dropped)
        if dropped:
            import warnings
            warnings.warn(
                f"ignored ORK pipeline params: {', '.join(dropped)} "
                "(not honored by this framework)", stacklevel=2)
        return out


def parse_by_parts(text_or_path: str) -> OrkConfig:
    """Parse + validate a ``.by_parts`` config (path or YAML text).

    Validation mirrors the ORK config test the reference runs in CI
    (reference: test/CMakeLists.txt:5-9, .travis.yml:53-55): every cell
    mapping must carry ``type`` and ``module``; every ``inputs``/
    ``outputs`` entry must name another declared cell."""
    import os

    import yaml
    if "\n" not in text_or_path and (
            text_or_path.endswith(".by_parts")
            or os.path.exists(text_or_path)):
        # a newline-free string naming an existing file is a path even
        # without the .by_parts extension (e.g. config.yaml)
        with open(text_or_path) as f:
            text = f.read()
    else:
        text = text_or_path
    doc = yaml.safe_load(text)
    if not isinstance(doc, dict) or not doc:
        raise ValueError("empty or non-mapping .by_parts config")
    cells: Dict[str, CellSpec] = {}
    for name, body in doc.items():
        if not isinstance(body, dict):
            raise ValueError(f"cell {name!r} is not a mapping")
        for req in ("type", "module"):
            if req not in body:
                raise ValueError(f"cell {name!r} missing {req!r}")
        cells[name] = CellSpec(
            name=name, type=str(body["type"]),
            module=str(body["module"]),
            inputs=list(body.get("inputs", [])),
            outputs=list(body.get("outputs", [])),
            parameters=dict(body.get("parameters", {})))
    for c in cells.values():
        for ref in c.inputs + c.outputs:
            if ref not in cells:
                raise ValueError(
                    f"cell {c.name!r} references undeclared cell "
                    f"{ref!r}")
    return OrkConfig(cells=cells)


def instantiate(cfg: OrkConfig, model=None) -> PartsBasedDetectorCell:
    """Build + configure the detector cell from a parsed config.

    model: optional in-memory PartsModel overriding ``model_file`` (the
    reference configs point at absolute paths on the original author's
    machine — reference: conf/config_person.by_parts:30)."""
    params: Dict = {}
    PartsBasedDetectorCell.declare_params(params)
    params.update(cfg.detector_params())
    if model is not None:
        params["model_file"] = model
    inputs: Dict = {}
    outputs: Dict = {}
    PartsBasedDetectorCell.declare_io(params, inputs, outputs)
    cell = PartsBasedDetectorCell()
    cell.configure(params, inputs, outputs)
    return cell
