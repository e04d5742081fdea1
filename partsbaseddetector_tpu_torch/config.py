"""Unified typed configuration (port of partsbaseddetector_tpu/config.py).

The reference scatters configuration across three mechanisms — CMake
options (reference: CMakeLists.txt:8-12), ROS private params
(ros/Node.cpp:72-73), and ecto/ORK YAML configs
(conf/config_person.by_parts:17-31) — with model hyperparameters living
inside the model file.  Here a single dataclass covers runtime + mesh +
pipeline knobs, JSON round-trippable, with the model still carrying its
own hyperparameters (interval/thresh/sbin/norient/flen) as in the
reference serialization schema.

The JSON is the JAX package's: a file its ``PipelineConfig.save`` wrote
loads here.  The port adds ``RuntimeConfig.device`` (None = CUDA,
ops/common.resolve_device).  The JAX-only knobs — ``dt_impl``,
``platform``, ``aot_dir`` and the Pallas walks — are accepted at their
defaults, so such a file loads, and any other value raises ValueError:
the port does not carry them (README, "Not carried").
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

#: the port's walks (infer/detector.Detector's walk_impl)
WALK_IMPLS = ("auto", "cuda", "torch")


@dataclasses.dataclass
class RuntimeConfig:
    """Per-detector runtime knobs."""

    k_per_level: int = 64          # top-K candidates per pyramid level
    compose: str = "reference"     # DT argmin composition mode (the
                                   # reference quirk vs corrected; see
                                   # ops/dp.walk_children)
    dt_impl: str = "auto"          # JAX-only: "auto" only
    conv_engine: str = "spatial"   # "spatial" | "fft" stage-2 engine
                                   # (the reference's engine wiring,
                                   # src/PartsBasedDetector.cpp:108-118)
    dp_split: Optional[int] = None  # stage-3/4 level groups per bucket
                                   # (None = (interval + 1) // 2)
    walk_impl: str = "auto"        # backtracking walk: "auto" | "cuda"
                                   # (the walk kernel) | "torch" (plain)
    max_overlap: float = 0.1       # paint-NMS overlap (ros/Node.cpp:196)
    remove_planes: bool = False    # plane removal before clustering
    max_candidates: Optional[int] = 32
    platform: Optional[str] = None  # JAX-only: None only (see device)
    aot_dir: Optional[str] = None  # JAX-only: None only
    device: Optional[str] = None   # torch device; None = CUDA

    def __post_init__(self):
        for name, default in (("dt_impl", "auto"), ("platform", None),
                              ("aot_dir", None)):
            if getattr(self, name) != default:
                raise ValueError(
                    f"{name}={getattr(self, name)!r} is not carried by "
                    f"the port (only the default {default!r} is "
                    "accepted; README, 'Not carried')")
        if self.walk_impl not in WALK_IMPLS:
            raise ValueError(f"walk_impl {self.walk_impl!r} is not "
                             f"carried by the port; one of {WALK_IMPLS}")


@dataclasses.dataclass
class MeshConfig:
    """Device-mesh shape for batch/model parallel execution
    (parallel/mesh.make_mesh)."""

    data: int = 1                  # image/batch axis
    filter: int = 1                # mixture-filter-bank axis

    def shape(self) -> Tuple[int, int]:
        return (self.data, self.filter)


@dataclasses.dataclass
class PipelineConfig:
    runtime: RuntimeConfig = dataclasses.field(
        default_factory=RuntimeConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    model_file: Optional[str] = None   # ecto param "model_file"
                                       # (cells/detect.cpp:119)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        raw = json.loads(text)
        return cls(runtime=RuntimeConfig(**raw.get("runtime", {})),
                   mesh=MeshConfig(**raw.get("mesh", {})),
                   model_file=raw.get("model_file"))

    @classmethod
    def load(cls, path: str) -> "PipelineConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
