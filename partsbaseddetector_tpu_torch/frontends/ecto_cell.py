"""ECTO/ORK cell adapter over StreamingDetector (port of
partsbaseddetector_tpu/frontends/ecto_cell.py).

Reference: cells/detect.cpp — an object-recognition-core cell with
declare_params (visualize / remove_planes / model_file / max_overlap,
detect.cpp:115-126), declare_io (inputs image/depth/K/input_cloud,
outputs pose_results/image, detect.cpp:138-155), configure (model load
+ distribute, detect.cpp:163-186) and process (detect -> NMS ->
cluster -> PoseResult list, detect.cpp:205-340).

ecto's tendrils are dict-like; the adapter speaks plain dicts so it
runs (and is tested) without ecto, and wraps directly into an ecto
cell class when ecto is importable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from partsbaseddetector_tpu_torch.frontends.ros_node import detector_kwargs
from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
from partsbaseddetector_tpu_torch.ops.common import resolve_device
from partsbaseddetector_tpu_torch.post.depth import CameraModel


def ecto_available() -> bool:
    try:
        import ecto  # noqa: F401
        return True
    except ImportError:
        return False


@dataclasses.dataclass
class PoseResult:
    """The subset of object_recognition_core's PoseResult the reference
    fills in (detect.cpp:322-335): object id + translation (cluster
    center) + orientation (PCA pose quaternion)."""
    object_id: str
    T: np.ndarray                 # (3,) translation
    quat: Optional[np.ndarray]    # (4,) (w, x, y, z) or None
    score: float


class PartsBasedDetectorCell:
    """ecto-shaped lifecycle: declare_params/declare_io are static and
    fill dicts; configure builds the detector; process consumes/fills
    the io dicts."""

    @staticmethod
    def declare_params(params: dict) -> None:
        params.setdefault("visualize", False)
        params.setdefault("remove_planes", False)
        params.setdefault("model_file", None)    # required
        params.setdefault("max_overlap", 0.1)
        # detector-facade knobs (the full surface the facade grew —
        # None = facade default), reachable from ORK configs exactly
        # like the reference exposes its knobs through every frontend
        # (cells/detect.cpp:115-126)
        params.setdefault("k_per_level", None)
        params.setdefault("conv_engine", None)   # "spatial" | "fft"
        params.setdefault("walk_impl", None)
        params.setdefault("dp_split", None)
        params.setdefault("compose", None)
        params.setdefault("device", None)        # None = CUDA
        params.setdefault("depth_prune", None)   # {part_width_m,fx,tol}
        params.setdefault("mesh", None)          # [data, filter] sizes
        # declared so that a config naming it reaches configure, which
        # refuses it: aot_dir is not carried by the port
        params.setdefault("aot_dir", None)

    @staticmethod
    def declare_io(params: dict, inputs: dict, outputs: dict) -> None:
        inputs.setdefault("image", None)         # rgb full frame
        inputs.setdefault("depth", None)         # 16-bit depth image
        inputs.setdefault("K", None)             # camera intrinsics
        inputs.setdefault("input_cloud", None)
        outputs.setdefault("pose_results", [])
        outputs.setdefault("image", None)        # visualization

    def configure(self, params: dict, inputs: dict,
                  outputs: dict) -> None:
        """Load the model and keep the detector-facade knobs; an unknown
        key or ``aot_dir`` raises (ros_node.detector_kwargs).
        """
        from partsbaseddetector_tpu_torch.models import load_any

        model_file = params["model_file"]
        if model_file is None:
            raise ValueError("model_file param is required")
        # detector-facade knobs forwarded to StreamingDetector
        self._detector_kwargs = detector_kwargs(
            params, ("visualize", "remove_planes", "model_file",
                     "max_overlap"))
        # the stream is built at the first frame (it needs K); the device
        # rule is checked now, so a missing card fails at configure
        resolve_device(self._detector_kwargs.get("device"))
        self.model = (model_file if not isinstance(model_file, str)
                      else load_any(model_file))
        self.model_name = self.model.name
        self.visualize = bool(params.get("visualize", False))
        self.remove_planes = bool(params.get("remove_planes", False))
        self.max_overlap = float(params.get("max_overlap", 0.1))
        self._stream = None

    def _get_stream(self, K, imsize) -> StreamingDetector:
        if self._stream is None:
            camera = None
            if K is not None:
                K = np.asarray(K, float)
                camera = CameraModel(fx=K[0, 0], fy=K[1, 1],
                                     cx=K[0, 2], cy=K[1, 2])
            self._stream = StreamingDetector(
                self.model, camera=camera,
                max_overlap=self.max_overlap,
                remove_planes=self.remove_planes,
                **self._detector_kwargs)
            # the cell always produces pose_results; visualization only
            # when asked (detect.cpp:241-247)
            self._stream.on("poses", lambda _: None)
            if self.visualize:
                self._stream.on("overlay", lambda _: None)
        return self._stream

    def process(self, inputs: dict, outputs: dict) -> int:
        """detect.cpp:205-340: one frame -> pose_results (+ overlay).
        depth arrives 16-bit in millimeters (the Kinect convention the
        reference consumes); converted to meters here."""
        rgb = np.asarray(inputs["image"])
        depth = inputs.get("depth")
        if depth is not None:
            depth = np.asarray(depth)
            if depth.dtype == np.uint16:
                depth = depth.astype(np.float32) / 1000.0
        stream = self._get_stream(inputs.get("K"), rgb.shape[:2])
        res = stream.process(rgb, depth, inputs.get("input_cloud"))

        pose_results: List[PoseResult] = []
        centers = (res.cluster_centers
                   if res.cluster_centers is not None else None)
        for i, det in enumerate(res.detections):
            T = (np.asarray(centers[i], float)
                 if centers is not None and i < len(centers)
                 and np.asarray(centers[i]).size == 3
                 else np.full(3, np.nan))
            quat = None
            if res.poses is not None and i < len(res.poses) \
                    and res.poses[i] is not None:
                quat = np.asarray(res.poses[i].orientation)
            pose_results.append(PoseResult(
                object_id=self.model_name, T=T, quat=quat,
                score=float(det.score)))
        outputs["pose_results"] = pose_results
        outputs["image"] = res.overlay if self.visualize else rgb
        return 0
