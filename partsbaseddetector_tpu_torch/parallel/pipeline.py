"""Pipeline parallelism across detection stages (port of
partsbaseddetector_tpu/parallel/pipeline.py).

The reference's detect() is a 4-stage pipeline run sequentially per
frame (src/PartsBasedDetector.cpp:69-95).  For streaming video the
stages can run on different devices — pyramid + HOG + filter-bank conv
and the depth pruning (stages 1-2) on a front device, DP + backtracking
(stages 3-4) on a back device — with frames in flight in both at once
(BASELINE.json config 5; SURVEY.md §2.4 row 4).

JAX overlaps the two through asynchronous dispatch.  Eager torch runs
each op on its device's current stream, so here each half has a CUDA
stream of its own: the host enqueues stage 1-2 of frame i+1 on the front
stream while stage 3-4 of frame i runs on the back stream, and an event
orders each frame's responses before the back stream (and the copy to
the back device) reads them.  On one card front and back are the same
device and the overlap is between the two streams.  On the CPU there
are no streams and the stages run in turn.

Multi-resolution models run too: their stages 1-2 are the same per
bucket, and the cross-octave coupling lives wholly in stages 3-4 on the
back device.  (The JAX package refuses them here,
partsbaseddetector_tpu/parallel/pipeline.py:98-102.)
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Optional

import torch

from partsbaseddetector_tpu_torch.infer import multires as multires_mod
from partsbaseddetector_tpu_torch.infer.detector import (
    Detector, _stage12, _stage34, device_depths, device_frames,
    device_masks)
from partsbaseddetector_tpu_torch.models.part_tree import pack_model
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops import argmax as argmax_ops
from partsbaseddetector_tpu_torch.ops.common import resolve_device
from partsbaseddetector_tpu_torch.parallel.sharded import _facade


class PipelinedDetector:
    """Two-device cross-stage pipelined detector.

    >>> pdet = PipelinedDetector(model, front="cuda:0", back="cuda:1")
    >>> for cands in pdet.stream(frames): ...
    """

    def __init__(self, model: PartsModel, front, back,
                 k_per_level: int = 64, compose: str = "reference",
                 dp_split: Optional[int] = None,
                 conv_engine: str = "spatial", depth_prune=None,
                 walk_impl: str = "auto"):
        self.model = model
        self.front = resolve_device(front)
        self.back = resolve_device(back)
        self.multires = model.max_scale() > 0
        # the back half's facade: its checks, packed model and plans
        self._det = _facade(model, self.back, k_per_level=k_per_level,
                            compose=compose, dp_split=dp_split,
                            conv_engine=conv_engine,
                            depth_prune=depth_prune, walk_impl=walk_impl)
        self.k_per_level = self._det.k_per_level
        self.compose = compose
        self.conv_engine = self._det.conv_engine
        self.depth_prune = depth_prune
        self.dp_split = getattr(self._det, "dp_split", None)
        self.walk_impl = getattr(self._det, "walk_impl", "torch")
        self.packed_back = self._det.packed
        # the front half convolves: it needs the bank
        self.packed_front = (self.packed_back if self.front == self.back
                             else pack_model(model, self.front))
        cuda = self.front.type == "cuda" and self.back.type == "cuda"
        self._s_front = torch.cuda.Stream(self.front) if cuda else None
        self._s_back = torch.cuda.Stream(self.back) if cuda else None

    def plan_for(self, imshape):
        return self._det.plan_for(imshape)

    @staticmethod
    def _on(stream):
        """The stream as current (it first waits for the work already
        queued on the device's current stream), or nothing on the CPU."""
        if stream is None:
            return contextlib.nullcontext()
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        return torch.cuda.stream(stream)

    def _dispatch(self, image, depth=None, part_masks=None):
        """Enqueue one frame on both halves; returns its Candidates (on
        the back device) and the back stream's event after them."""
        if depth is not None and self.depth_prune is None:
            raise ValueError(
                "depth map passed but this detector has no depth_prune "
                "config (matches Detector behavior)")
        with self._on(self._s_front):
            frame = device_frames(image, 3, self.front)
            plan = self.plan_for(frame.shape[:2])
            d = None if depth is None else \
                device_depths(depth, self.front)[None]
            per_bucket = _stage12(frame[None], self.packed_front, plan,
                                  self.conv_engine, depth=d,
                                  depth_cfg=self.depth_prune)
            if self.back != self.front:
                # the copy runs on the front stream (the source's)
                per_bucket = [(b,) + tuple(
                    t.to(self.back, non_blocking=True) for t in rest)
                    for b, *rest in per_bucket]
            ready = None
            if self._s_front is not None:
                ready = torch.cuda.Event()
                ready.record(self._s_front)
        with self._on(self._s_back):
            if ready is not None:
                self._s_back.wait_event(ready)
                for _, *rest in per_bucket:
                    for t in rest:
                        t.record_stream(self._s_back)
            masks = None if part_masks is None else \
                device_masks(part_masks, self.back)
            if self.multires:
                cands = multires_mod._multires_stage34(
                    [(b, p[0], t, s) for b, p, t, s in per_bucket],
                    self.packed_back, self.k_per_level, masks)
            else:
                cands = _stage34(per_bucket, self.packed_back,
                                 self.k_per_level, self.compose,
                                 self.dp_split, self.walk_impl,
                                 part_masks=masks).map(lambda x: x[0])
            done = None
            if self._s_back is not None:
                done = torch.cuda.Event()
                done.record(self._s_back)
        return cands, done

    def _collect(self, cands, done) -> argmax_ops.Candidates:
        """The Candidates, safe to use on the back device's current
        stream."""
        if done is not None:
            cur = torch.cuda.current_stream(self.back)
            cur.wait_event(done)
            for f in dataclasses.fields(cands):
                getattr(cands, f.name).record_stream(cur)
        return cands

    def detect_raw(self, image, depth=None) -> argmax_ops.Candidates:
        """One frame through both halves (no overlap for a single frame;
        use stream() for throughput).  depth: optional (dh, dw) metric
        depth map (needs depth_prune; pruning runs on the front)."""
        return self._collect(*self._dispatch(image, depth))

    def detect_masked_raw(self, image, part_masks
                          ) -> argmax_ops.Candidates:
        """Latent-positive masked search through the pipeline: the masks
        apply in the DP, so they go to the back device only."""
        return self._collect(*self._dispatch(image,
                                             part_masks=part_masks))

    def stream(self, frames, depth_of_pipeline: int = 2, depths=None):
        """Generator over Candidates, one per frame, with up to
        ``depth_of_pipeline`` frames enqueued ahead of the one yielded.

        depths: optional per-frame metric depth maps (needs
        depth_prune); pruning runs on the front, per frame."""
        if depths is not None and self.depth_prune is None:
            raise ValueError(
                "depth maps passed but this detector has no "
                "depth_prune config (matches Detector behavior)")
        pending = deque()
        for i, f in enumerate(frames):
            pending.append(self._dispatch(
                f, None if depths is None else depths[i]))
            if len(pending) >= depth_of_pipeline:
                yield self._collect(*pending.popleft())
        while pending:
            yield self._collect(*pending.popleft())

    def detect(self, image, max_detections: Optional[int] = None):
        return Detector.candidates_to_detections(
            self.detect_raw(image), max_detections)
