"""Streaming RGB-D detection pipeline.

Port of partsbaseddetector_tpu/infer/stream.py: the transport-agnostic
equivalent of the reference's ROS node (reference: ros/Node.cpp:46-250)
and ECTO/ORK cell (reference: cells/detect.cpp:74-355), a per-frame
pipeline that runs

    detect -> sort -> paint NMS (overlap 0.1, ros/Node.cpp:192-196)
    -> 3-D bounding boxes + part centers (ros/Node.cpp:210-212)
    -> [optional] plane removal + Euclidean clustering
       (ros/Node.cpp:218-229)
    -> result messages (overlay image, instance mask, 3-D boxes,
       clusters, part-center clouds, PCA poses — ros/Messages.cpp)

and delivers them to registered sinks (callbacks), the library analog of
ROS publishers gated on subscriber count (ros/Node.cpp:205-249): a
message is only materialized if a sink is attached.

Detection and the paint NMS run on the detector's device (CUDA unless
``device="cpu"``); the detections are fetched to the host after the
NMS, and the 3-D stages are numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from partsbaseddetector_tpu_torch.infer.detector import Detection, Detector
from partsbaseddetector_tpu_torch.infer.multires import detector_for
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops.argmax import Candidates
from partsbaseddetector_tpu_torch.post.cloud import (
    cluster_objects, compute_bounding_boxes,
    organized_multiplane_segmentation)
from partsbaseddetector_tpu_torch.post.depth import CameraModel
from partsbaseddetector_tpu_torch.post.poses import poses_from_part_centers
from partsbaseddetector_tpu_torch.post.rect3 import Rect3
from partsbaseddetector_tpu_torch.utils import profiling

@dataclasses.dataclass
class FrameResult:
    """Everything the reference node publishes for one frame."""

    detections: List[Detection]
    overlay: Optional[np.ndarray] = None          # RGB uint8
    mask: Optional[np.ndarray] = None             # uint8 instance mask
    boxes3d: Optional[List[Rect3]] = None
    part_centers: Optional[List[np.ndarray]] = None
    clusters: Optional[List[np.ndarray]] = None
    cluster_centers: Optional[List[np.ndarray]] = None
    poses: Optional[List] = None


def detections_mask(imsize, detections: List[Detection]) -> np.ndarray:
    """Instance mask: nonzero value n+1 under the n-th detection's
    covering box (reference: include/Candidate.hpp:320-331)."""
    H, W = imsize
    mask = np.zeros((H, W), np.uint8)
    for n, det in enumerate(detections):
        bb = det.bounding_box()
        x1, y1 = int(np.clip(bb[0], 0, W)), int(np.clip(bb[1], 0, H))
        x2, y2 = int(np.clip(bb[2], 0, W)), int(np.clip(bb[3], 0, H))
        region = mask[y1:y2, x1:x2]
        region[region == 0] = n + 1
    return mask


class StreamingDetector:
    """Frame-loop pipeline with attachable sinks.

    >>> sd = StreamingDetector(model, camera=CameraModel(...),
    ...                        remove_planes=False)
    >>> sd.on("overlay", lambda img: display(img))
    >>> result = sd.process(rgb, depth, cloud)

    The first argument is either a PartsModel — routed to the right
    backend like the reference frontends wrap the full facade
    (ros/Node.cpp:72-105, cells/detect.cpp:167-185): a ``mesh`` goes to
    the sharded BatchDetector, anything else to the facade that
    infer/multires.detector_for picks, with every facade knob
    (k_per_level / depth_prune / conv_engine / walk_impl / dp_split /
    compose / device) passed through — or a PREBUILT detector facade
    (any of the port's: Detector, MultiResDetector, BatchDetector,
    ScaleShardedDetector, PipelinedDetector), used as-is through its
    detect_raw and detect_batch_raw.
    """

    SINKS = ("detections", "overlay", "mask", "boxes3d", "clusters",
             "part_centers", "poses", "error")

    def __init__(self, model,
                 camera: Optional[CameraModel] = None,
                 max_overlap: float = 0.1,
                 remove_planes: bool = False,
                 k_per_level: int = 64,
                 max_candidates: Optional[int] = 32,
                 max_retries: int = 1,
                 retry_backoff_s: float = 0.5,
                 depth_prune=None,
                 *,
                 mesh=None,
                 conv_engine: str = "spatial",
                 walk_impl: str = "auto",
                 dp_split=None,
                 compose: str = "reference",
                 device=None):
        """depth_prune: optional infer.detector.DepthPrune — when set,
        per-frame depth maps prune stage-2 responses BEFORE the DP (the
        reference's detect(rgb, depth, candidates) semantics,
        include/PartsBasedDetector.hpp:172-174), in addition to their
        role in 3-D post-processing.

        model: a PartsModel OR a prebuilt detector facade (any object
        with detect_raw, detect_batch_raw, ``depth_prune`` and ``model``);
        when prebuilt, the detector-construction knobs (k_per_level,
        depth_prune, mesh, conv_engine, walk_impl, dp_split, compose,
        device) are ignored.
        device: where a built backend runs; None means CUDA, and raises
        without a card (ops/common.resolve_device).
        mesh: optional parallel.mesh.Mesh with (data, filter) axes —
        serve through the sharded BatchDetector on it (its device is
        the mesh's)."""
        if isinstance(model, PartsModel):
            self.detector = self._build_backend(
                model, mesh=mesh, k_per_level=k_per_level,
                depth_prune=depth_prune,
                conv_engine=conv_engine, walk_impl=walk_impl,
                dp_split=dp_split, compose=compose, device=device)
            self.model = model
        else:
            self.detector = model              # prebuilt facade
            self.model = model.model
        self.camera = camera
        self.max_overlap = float(max_overlap)
        self.remove_planes = bool(remove_planes)
        self.max_candidates = max_candidates
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._sinks: Dict[str, List[Callable]] = {s: []
                                                  for s in self.SINKS}
        self._seq = 0        # frames served, the serve.frame spans' seq

    @staticmethod
    def _build_backend(model: PartsModel, *, mesh, k_per_level,
                       depth_prune, conv_engine, walk_impl, dp_split,
                       compose, device):
        """Route a model to the right detector facade (the frontends'
        distributeModel step, ros/Node.cpp:72-105)."""
        if mesh is not None:
            from partsbaseddetector_tpu_torch.parallel.sharded import \
                BatchDetector
            return BatchDetector(
                model, mesh, k_per_level=k_per_level, compose=compose,
                dp_split=dp_split, conv_engine=conv_engine,
                depth_prune=depth_prune, walk_impl=walk_impl)
        return detector_for(
            model, k_per_level=k_per_level, compose=compose,
            dp_split=dp_split, depth_prune=depth_prune,
            conv_engine=conv_engine, walk_impl=walk_impl, device=device)

    def on(self, sink: str, fn: Callable) -> None:
        if sink not in self._sinks:
            raise ValueError(f"unknown sink {sink!r}; "
                             f"one of {self.SINKS}")
        self._sinks[sink].append(fn)

    def _wants(self, sink: str) -> bool:
        return bool(self._sinks[sink])

    def _emit(self, sink: str, value) -> None:
        for fn in self._sinks[sink]:
            fn(value)

    # ------------------------------------------------- failure recovery
    #: exception types treated as transient (retried): device runtime
    #: failures (CUDA errors and torch.OutOfMemoryError are
    #: RuntimeErrors) and I/O errors.  Deterministic programming errors
    #: (TypeError/ValueError shape bugs) are re-raised immediately
    #: without wasting a re-dispatch.
    TRANSIENT_ERRORS = (RuntimeError, OSError)

    @staticmethod
    def _materialize(cands_b: Candidates) -> Candidates:
        """Wait for the dispatch to finish: synchronize the device the
        Candidates live on (the detector's), so that an asynchronous
        CUDA failure surfaces HERE as a RuntimeError, and return the
        Candidates where they are.  Seam for fault-injection tests.

        A sticky CUDA error (a device-side assert) leaves the context
        unusable: every re-dispatch fails the same way, so it re-raises
        after ``max_retries``; only a fresh process recovers from it."""
        dev = cands_b.score.device
        with profiling.span("serve.wait"):
            profiling.count("readbacks")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return cands_b

    def _fetch_or_retry(self, cands_b, rgbs, redispatch):
        """Materialize a batch result; on a device/runtime failure,
        notify the ``error`` sink and RE-DISPATCH the batch (the
        detector is pure + deterministic, so a retry reproduces the
        exact result) with exponential backoff, up to ``max_retries``
        times.

        redispatch: zero-arg callable re-issuing the device call.

        Neither the reference nor its runtime has any failure handling
        (SURVEY.md §5 "none anywhere"); this is the serving-level story
        for the streaming pipeline: a transient device failure costs one
        batch re-execution instead of the stream."""
        import time as _time

        delay = self.retry_backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                return self._materialize(cands_b)
            except self.TRANSIENT_ERRORS as e:  # device failure
                self._emit("error", {"attempt": attempt,
                                     "exception": e,
                                     "frames": len(rgbs)})
                if attempt == self.max_retries:
                    raise
                _time.sleep(delay)
                delay *= 2
                cands_b = redispatch()

    def process(self, rgb: np.ndarray,
                depth: Optional[np.ndarray] = None,
                cloud: Optional[np.ndarray] = None) -> FrameResult:
        """Run one frame.  rgb: (H, W, 3); depth: (h, w) meters; cloud:
        (H, W, 3) organized or (N, 3) unorganized camera-frame points.
        Single frames go through the same fetch/retry seam as batches,
        so the ecto/ORK path gets the identical recovery story.  With a
        ``depth_prune`` config, the depth map also prunes detection
        responses (not just the 3-D post stage); without one the depth
        feeds only the 3-D post stage (the detector rejects unsolicited
        depth maps)."""
        d = depth if self.detector.depth_prune is not None else None
        with self._frame_span(0):
            cands = self._fetch_or_retry(
                self.detector.detect_raw(rgb, depth=d), [rgb],
                redispatch=lambda: self.detector.detect_raw(rgb, depth=d))
            return self._postprocess(cands, rgb, depth, cloud)

    def _frame_span(self, index: int):
        """The serve.frame span of the next frame, ``index`` in its
        batch."""
        self._seq += 1
        return profiling.span("serve.frame", {"seq": self._seq - 1,
                                              "frame": index})

    def process_batch(self, rgbs, depths=None,
                      clouds=None) -> List[FrameResult]:
        """Micro-batched frame loop: ONE detector dispatch for B frames
        (detect_batch_raw), then the per-frame post/publish path.  The
        per-frame math is identical to process(); batching amortizes the
        per-dispatch host overhead (the reference's frame loop,
        ros/Node.cpp:144, is strictly sequential)."""
        rgbs = np.asarray(rgbs)
        d = None
        if depths is not None and self.detector.depth_prune is not None:
            d = np.asarray(depths)
        cands_b = self._fetch_or_retry(
            self.detector.detect_batch_raw(rgbs, depths=d), rgbs,
            redispatch=lambda: self.detector.detect_batch_raw(rgbs,
                                                              depths=d))
        out = []
        for i in range(rgbs.shape[0]):
            with self._frame_span(i):
                out.append(self._postprocess(
                    cands_b.map(lambda x: x[i]), rgbs[i],
                    None if depths is None else depths[i],
                    None if clouds is None else clouds[i]))
        return out

    def stream(self, frames, batch: int = 8, depths=None, clouds=None):
        """Pipelined streaming: generator over FrameResults.  Frames are
        grouped into micro-batches of `batch`; the NEXT batch's dispatch
        is issued before the current batch's host-side post-processing,
        in the JAX package's order (how much device work eager torch
        leaves queued behind a dispatch is a measurement, PERF.md).  A
        short final group is padded by repeating the last frame, so
        every dispatch has the batch shape of process_batch (and with
        it cuDNN's algorithm choice and the same results), and the
        padding results are dropped."""
        frames = list(frames)
        if not frames:
            return
        prune = (depths is not None
                 and self.detector.depth_prune is not None)
        groups = [frames[i:i + batch]
                  for i in range(0, len(frames), batch)]
        pending = None      # (rgbs, depths, n_real, offset, candidates)
        offset = 0
        for g in groups:
            n_real = len(g)
            dg = list(depths[offset:offset + n_real]) if prune else None
            while len(g) < batch and len(frames) > 1:
                g = g + [g[-1]]
                if prune:
                    dg = dg + [dg[-1]]
            rgbs = np.asarray(g)
            db = np.asarray(dg) if prune else None
            cands_b = self.detector.detect_batch_raw(rgbs, depths=db)
            if pending is not None:
                yield from self._drain(pending, depths, clouds)
            pending = (rgbs, db, n_real, offset, cands_b)
            offset += n_real
        if pending is not None:
            yield from self._drain(pending, depths, clouds)

    def _drain(self, pending, depths, clouds):
        rgbs, db, n_real, offset, cands_b = pending
        cands_b = self._fetch_or_retry(
            cands_b, rgbs,
            redispatch=lambda: self.detector.detect_batch_raw(rgbs,
                                                              depths=db))
        for i in range(n_real):
            j = offset + i
            # the span closes before the yield: the consumer's time is
            # not the frame's
            with self._frame_span(i):
                res = self._postprocess(
                    cands_b.map(lambda x: x[i]), rgbs[i],
                    None if depths is None else depths[j],
                    None if clouds is None else clouds[j])
            yield res

    def _postprocess(self, cands: Candidates, rgb: np.ndarray,
                     depth: Optional[np.ndarray],
                     cloud: Optional[np.ndarray]) -> FrameResult:
        """sort/NMS -> sinks for one frame's raw candidates
        (ros/Node.cpp:181-249).  The paint NMS runs where the
        candidates are; candidates_to_detections fetches the kept ones
        to the host.  Each step is a span of the port's tracer (a sink's
        own time counts toward the step that feeds it)."""
        from partsbaseddetector_tpu_torch.ops.nms import paint_nms

        with profiling.span("post.nms"):
            cands = paint_nms(cands, rgb.shape[:2], self.max_overlap)
        detections = Detector.candidates_to_detections(
            cands, self.max_candidates)
        res = FrameResult(detections=detections)
        self._emit("detections", detections)

        if self._wants("overlay"):
            from partsbaseddetector_tpu_torch.utils.viz import \
                draw_detections
            with profiling.span("post.overlay"):
                res.overlay = draw_detections(rgb, detections)
                self._emit("overlay", res.overlay)
        if self._wants("mask"):
            with profiling.span("post.mask"):
                res.mask = detections_mask(rgb.shape[:2], detections)
                self._emit("mask", res.mask)

        needs_3d = (self._wants("boxes3d") or self._wants("clusters")
                    or self._wants("part_centers")
                    or self._wants("poses"))
        if needs_3d and depth is not None and self.camera is not None:
            with profiling.span("post.boxes3d"):
                res.boxes3d, res.part_centers = compute_bounding_boxes(
                    detections, rgb.shape[:2], depth, self.camera,
                    device=cands.score.device)
                self._emit("boxes3d", res.boxes3d)
                self._emit("part_centers", res.part_centers)
            if self._wants("clusters") and cloud is not None:
                with profiling.span("post.clusters"):
                    pts = cloud.reshape(-1, 3) if cloud.ndim == 3 \
                        else cloud
                    if self.remove_planes and cloud.ndim == 3:
                        pts = organized_multiplane_segmentation(cloud)
                    res.clusters, res.cluster_centers = cluster_objects(
                        pts, res.boxes3d)
                    self._emit("clusters", res.clusters)
            if self._wants("poses"):
                with profiling.span("post.poses"):
                    res.poses = poses_from_part_centers(res.part_centers)
                    self._emit("poses", res.poses)
        return res
