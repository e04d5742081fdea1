"""Everything the benchmark takes from the port: the model and the
detectors built from the benchmark's arrays, the calls the windows
drive, and the port's stage hook.  No other harness module imports the
port."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from partsbaseddetector_tpu_torch.infer.detector import DepthPrune, Detector
from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
from partsbaseddetector_tpu_torch.models.schema import (ComponentSpec,
                                                        PartSpec,
                                                        PartsModel)
from partsbaseddetector_tpu_torch.post.depth import CameraModel
from partsbaseddetector_tpu_torch.utils.profiling import CudaStageTimer

__all__ = ["CudaStageTimer", "build_detector", "serving", "batch_call",
           "detections_dict"]


def parts_model(arrays: Dict, cfg: Dict, thresh: float) -> PartsModel:
    """The port's PartsModel of the benchmark's arrays: a component a
    tree; filter and deformation ids run component by component, part by
    part, mixture by mixture; part p's mixture m reads its biases over
    the parent's mixtures from a block of its own (the root: one a
    mixture)."""
    filters = arrays["filters"].cpu().numpy()
    defw = arrays["defw"].cpu().numpy().astype(np.float64)
    anchors = arrays["anchors"].cpu().numpy().astype(np.int64)
    comps, f, b = [], 0, 0
    for parent, nmix in arrays["trees"]:
        parts = []
        for p, n in enumerate(nmix):
            step = 1 if p == 0 else nmix[parent[p]]
            ids = list(range(f, f + n))
            parts.append(PartSpec(parentid=parent[p], filterid=ids,
                                  biasid=[b + i * step for i in range(n)],
                                  defid=ids))
            f += n
            b += n * step
        comps.append(ComponentSpec(parts=parts))
    return PartsModel(
        name=cfg["name"], interval=cfg["interval"], thresh=float(thresh),
        binsize=cfg["binsize"], norient=cfg["norient"], flen=cfg["flen"],
        filters=list(filters), defw=list(defw), anchors=list(anchors),
        biasw=arrays["biasw"].cpu().numpy().astype(np.float64),
        components=comps)


def build_detector(arrays: Dict, cfg: Dict, thresh: float, device,
                   depth_prune: Optional[Dict] = None) -> Detector:
    return Detector(parts_model(arrays, cfg, thresh),
                    k_per_level=cfg["k_per_level"], compose=cfg["compose"],
                    dp_split=cfg["dp_split"],
                    depth_prune=None if depth_prune is None else
                    DepthPrune(**depth_prune),
                    conv_engine=cfg["conv_engine"], walk_impl="auto",
                    device=device)


def detections_dict(dets) -> Dict[str, np.ndarray]:
    """Host Detections as the judge's arrays."""
    P = dets[0].parts.shape[0] if dets else 0
    return dict(
        score=np.array([d.score for d in dets], np.float64),
        level=np.array([d.level for d in dets], np.int64),
        component=np.array([d.component for d in dets], np.int64),
        boxes=np.stack([d.parts for d in dets]) if dets else
        np.zeros((0, P, 4), np.float32),
        loc=np.stack([d.locations for d in dets]) if dets else
        np.zeros((0, P, 3), np.int64))


def batch_call(det: Detector, frames: np.ndarray, stage=None):
    """The offline path: one detect_batch_raw, then each frame's
    detections to the host."""
    if stage is None:
        cands = det.detect_batch_raw(frames)
    else:
        cands = det.detect_batch_raw(frames, stage=stage)
    return [Detector.candidates_to_detections(cands.map(lambda x: x[i]))
            for i in range(frames.shape[0])]


def _annotated(name: str, on: bool):
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


class SpannedStreamingDetector(StreamingDetector):
    """StreamingDetector with host-clock spans around a frame's detect
    and fetch (``process`` up to the post stage) and around its post
    stage (``_postprocess``), and the raw candidates of chosen frames
    kept on the host for the check."""

    def __init__(self, *a, keep: Set[int] = frozenset(), **kw):
        super().__init__(*a, **kw)
        self.keep = set(keep)
        self.frame = -1
        self.detect_s: List[float] = []
        self.post_s: List[float] = []
        self.kept_raw: Dict[int, Dict[str, np.ndarray]] = {}
        self.annotate = False
        self._t0 = 0.0

    def process(self, rgb, depth=None, cloud=None):
        self.frame += 1
        self._t0 = time.perf_counter()
        with _annotated("span:detect", self.annotate):
            return super().process(rgb, depth, cloud)

    def _postprocess(self, cands, rgb, depth, cloud):
        t1 = time.perf_counter()
        with _annotated("span:post", self.annotate):
            res = super()._postprocess(cands, rgb, depth, cloud)
        t2 = time.perf_counter()
        self.detect_s.append(t1 - self._t0)
        self.post_s.append(t2 - t1)
        if self.frame in self.keep:
            v = cands.valid.cpu().numpy()
            self.kept_raw[self.frame] = {
                k: getattr(cands, k).cpu().numpy()[v]
                for k in ("score", "level", "component", "boxes", "loc")}
        return res


def serving(det: Detector, camera, params: Dict, keep=()):
    sd = SpannedStreamingDetector(
        det, camera=CameraModel(*camera), max_overlap=params["max_overlap"],
        max_candidates=params["max_candidates"], keep=keep)
    for sink in params["sinks"]:
        sd.on(sink, lambda _: None)
    return sd


def frame_result_dict(res) -> Dict:
    """A FrameResult as the judge's arrays."""
    dets = res.detections
    return dict(
        kept_level=[d.level for d in dets],
        kept_loc=[d.locations for d in dets],
        kept_score=[d.score for d in dets],
        mask=res.mask,
        boxes3d=[(b.tl(), b.br()) for b in res.boxes3d],
        centres=res.part_centers,
        poses=[None if p is None else (p.position, p.orientation)
               for p in res.poses])
