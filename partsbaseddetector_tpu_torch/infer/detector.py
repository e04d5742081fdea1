"""Detector facade: the PyTorch counterpart of partsbaseddetector_tpu's
Detector (single-resolution models; multi-resolution ones go to
infer/multires.py), and the surface every one-device facade shares
(DetectorFacade).

Mirrors the reference's 4-stage pipeline (reference:
src/PartsBasedDetector.cpp:69-95), run eagerly on one device with the
frames of a batch folded into the level axis:

  stage 1  resize ladder + HOG per octave bucket (levels of a bucket
           share one padded buffer and run as one batch)
  stage 2  one filter-bank conv per bucket (cuDNN, TF32 off; or the FFT
           engine, conv_engine="fft"), then optional depth pruning
  stage 3  the part-tree DP per (level group, component), levels as a
           batch axis, with optional part placement masks
  stage 4  top-K root seeds per level, the fused walk kernel
           (ops/walk.py), then one stable sort
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import (Callable, ContextManager, Dict, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from partsbaseddetector_tpu_torch.infer.pyramid_plan import (PyramidPlan,
                                                             make_plan)
from partsbaseddetector_tpu_torch.models.part_tree import (PackedModel,
                                                           pack_model)
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops import argmax as argmax_ops
from partsbaseddetector_tpu_torch.ops.common import NEG, resolve_device
# CONV_ENGINES is re-exported: the engines by name, as the JAX package's
# infer/detector exports them
from partsbaseddetector_tpu_torch.ops.conv import CONV_ENGINES
from partsbaseddetector_tpu_torch.ops.dp import dp_min_levels
from partsbaseddetector_tpu_torch.ops.hog import hog_features
from partsbaseddetector_tpu_torch.ops.imageops import pyr_down, resize_linear
from partsbaseddetector_tpu_torch.utils import profiling

#: a stage timer: stage(name) is a context manager around that stage's
#: work (utils/profiling.CudaStageTimer records CUDA events with it).  The
#: default, profiling.stage, records the stages as spans of the port's
#: tracer while it is on; a hook the caller passes replaces it.
StageTimer = Callable[[str], ContextManager]


@dataclasses.dataclass
class Detection:
    """Host-side detection result (the reference's Candidate,
    include/Candidate.hpp:56-101)."""

    score: float
    component: int
    level: int
    parts: np.ndarray      # (P, 4) float boxes x1, y1, x2, y2
    locations: np.ndarray  # (P, 3) int x, y, mixture (feature-grid coords)

    def own(self) -> "Detection":
        """The detection cut to its component's parts.  P is the model's
        most parts: a component of fewer parts pads the rows past them
        with locations -1 and boxes 0, and every consumer that walks the
        rows takes them from here."""
        keep = self.locations[:, 0] >= 0
        if keep.all():
            return self
        return dataclasses.replace(self, parts=self.parts[keep],
                                   locations=self.locations[keep])

    def bounding_box(self) -> np.ndarray:
        """Hull over part boxes (reference: include/Candidate.hpp:105-111).
        """
        parts = self.own().parts
        return np.array([parts[:, 0].min(), parts[:, 1].min(),
                         parts[:, 2].max(), parts[:, 3].max()])

    def bounding_box_norm(self) -> np.ndarray:
        """mean +- 1.5 sigma box over part centroids
        (reference: include/Candidate.hpp:117-130)."""
        parts = self.own().parts
        cx = (parts[:, 0] + parts[:, 2]) / 2.0
        cy = (parts[:, 1] + parts[:, 3]) / 2.0
        return np.array([cx.mean() - 1.5 * cx.std(),
                         cy.mean() - 1.5 * cy.std(),
                         cx.mean() + 1.5 * cx.std(),
                         cy.mean() + 1.5 * cy.std()])

    def resized(self, factor: float) -> "Detection":
        """Scale all part boxes (reference: include/Candidate.hpp:82-89).
        """
        return dataclasses.replace(self, parts=self.parts * factor)


@dataclasses.dataclass(frozen=True)
class DepthPrune:
    """Depth-based response pruning: the completed form of the
    reference's abandoned filterResponseByDepth
    (src/SearchSpacePruning.cpp:47-70; its call site is commented out
    at src/PartsBasedDetector.cpp:86).  A part of physical width
    ``part_width_m`` detected at pyramid scale s (pixels per cell) is
    plausible only at depths within ``tol`` (relative) of
    fx * part_width_m / s; response cells at implausible depths are
    masked to NEG before the DP.  Depth 0 means unknown: never pruned.
    """

    part_width_m: float
    fx: float
    tol: float = 0.5


def _depth_tables(bucket, depth_hw: Tuple[int, int], cfg: DepthPrune,
                  device: torch.device):
    """The depth pruning's constants for the levels of ``bucket`` and a
    (dh, dw) depth map: ys (L, fh) and xs (L, fw) int64, the map's row
    and column under each response cell's center, computed on the host
    (partsbaseddetector_tpu/infer/detector.py:99-117); zexp and lim (L,
    1, 1) float32, each level's plausible depth and tolerance."""
    dh, dw = depth_hw
    fh, fw = bucket.feat_pad
    ys, xs, zexp, lim = [], [], [], []
    for lvl in bucket.levels:
        th, tw = lvl.featsize
        ys.append(np.clip(((np.arange(fh) + 0.5) * dh
                           / max(th, 1)).astype(np.int32), 0, dh - 1))
        xs.append(np.clip(((np.arange(fw) + 0.5) * dw
                           / max(tw, 1)).astype(np.int32), 0, dw - 1))
        z = cfg.fx * cfg.part_width_m / float(lvl.scale)
        zexp.append(z)
        lim.append(cfg.tol * z)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)
    return (dev(ys, np.int64), dev(xs, np.int64),
            dev(zexp, np.float32)[:, None, None],
            dev(lim, np.float32)[:, None, None])


def _depth_bad_mask(depth: torch.Tensor, tables) -> torch.Tensor:
    """(B, L, fh, fw) bool: True where the response cell's observed
    depth is implausible for its level's scale.  depth: (B, dh, dw)
    float32 maps in meters; tables: _depth_tables' (ys, xs, zexp, lim)
    of the L levels.  The comparison runs in float32 against the float32
    image of each level's plausible depth and tolerance, as the JAX
    package's does."""
    ys, xs, zexp, lim = tables
    sdepth = depth[:, ys[:, :, None], xs[:, None, :]]   # (B, L, fh, fw)
    return (sdepth > 0) & ((sdepth - zexp).abs() > lim)


class PlanTensors:
    """A pyramid plan's constants on one device, built once (plan_tensors
    caches them): stages 1-2 read them there instead of copying host
    lists to the device on every call, and a copy from pageable host
    memory cannot be captured in a CUDA graph (FrameGraph).  ``frame``
    (2,) int32 the frame's size; per bucket ``imsizes`` (L, 2) and
    ``featsizes`` (L, 2) int32, the levels' true image and feature
    sizes, and ``scales`` (L,) float32, pixels per cell; ``depth``, the
    depth pruning's tables of a bucket per depth map size and config."""

    def __init__(self, plan: PyramidPlan, device: torch.device):
        def dev(values, dtype):
            return torch.tensor(values, dtype=dtype, device=device)
        self.plan, self.device = plan, device
        self.frame = dev(plan.imsize, torch.int32)
        self.imsizes = [dev([lvl.imsize for lvl in b.levels], torch.int32)
                        for b in plan.buckets]
        self.featsizes = [dev([lvl.featsize for lvl in b.levels],
                              torch.int32) for b in plan.buckets]
        self.scales = [dev([lvl.scale for lvl in b.levels], torch.float32)
                       for b in plan.buckets]
        self._depth: Dict[tuple, tuple] = {}

    def depth(self, octave: int, depth_hw: Tuple[int, int],
              cfg: DepthPrune):
        """_depth_tables of bucket ``octave`` for a (dh, dw) map."""
        key = (octave, tuple(depth_hw), cfg)
        if key not in self._depth:
            self._depth[key] = _depth_tables(self.plan.buckets[octave],
                                             key[1], cfg, self.device)
        return self._depth[key]


@functools.lru_cache(maxsize=64)
def plan_tensors(plan: PyramidPlan, device: torch.device) -> PlanTensors:
    """The PlanTensors of a plan on a device, one per (plan, device)."""
    return PlanTensors(plan, device)


def _dp_groups(bucket, dp_split: int):
    """Split a bucket's levels into <= dp_split groups for stages 3-4,
    each padded only to ITS largest level (level sizes decay within an
    octave, so the DT on the octave-padded buffer would waste ~2x on the
    upper levels).  Returns (lo, hi, fh, fw) per group."""
    L = len(bucket.levels)
    n = max(1, min(dp_split, L))
    size = (L + n - 1) // n
    groups = []
    for lo in range(0, L, size):
        hi = min(lo + size, L)
        fh, fw = bucket.levels[lo].featsize   # largest level in group
        groups.append((lo, hi, fh, fw))
    return groups


def _ladder_hog(images: torch.Tensor, plan: PyramidPlan, norient: int,
                flen: int, stage: StageTimer = profiling.stage
                ) -> Iterator[Tuple[object, torch.Tensor, torch.Tensor]]:
    """Stage 1 per bucket: the resize ladder into the bucket's padded
    buffer, then HOG.  images: (B, H, W, C).  Yields (bucket, imsizes
    (L, 2) int32, feats (B*L, fh, fw, flen)), frames b-major."""
    consts = plan_tensors(plan, images.device)
    B = images.shape[0]
    img = images.to(torch.float32)
    prev_buf = None
    for bucket in plan.buckets:
        L = len(bucket.levels)
        with stage("ladder+hog"):
            imsizes = consts.imsizes[bucket.octave]
            if bucket.octave == 0:
                buf = resize_linear(img[:, None], bucket.img_pad, imsizes,
                                    consts.frame)
            else:
                buf = pyr_down(prev_buf[:, :L], bucket.img_pad,
                               consts.imsizes[bucket.octave - 1][:L])
            prev_buf = buf                                  # (B, L, ...)
            feats = hog_features(
                buf.flatten(0, 1), plan.binsize, norient, flen,
                true_size=imsizes.repeat(B, 1), feat_pad=bucket.feat_pad)
        yield bucket, imsizes, feats


def pyramid_pdfs(images: torch.Tensor, packed: PackedModel,
                 plan: PyramidPlan, conv_engine: str = "spatial",
                 stage: StageTimer = profiling.stage,
                 pdfs_transform: Optional[Callable] = None, depths=None,
                 depth_prune: Optional[DepthPrune] = None,
                 levels: Optional[Sequence[Tuple[int, int]]] = None):
    """Stages 1-2 for every bucket (ladder + HOG + filter-bank conv, then
    the optional depth pruning): the one code that convolves a bucket.

    images: (B, H, W, C) frames on the model's device, any real dtype
    (uint8 frames are cast to float32 here, on the device).
    Returns a list of (bucket, pdfs, tsizes, scales): pdfs (B, L, fh, fw,
    F) responses; tsizes (L, 2) int32 true feature sizes; scales (L,)
    f32 pixels per cell.  Cells of pdfs beyond a level's true size hold
    garbage: the DP masks them to NEG for both engines
    (dp_min_levels(true_sizes=...)), value-identical to the JAX
    package's masking of the FFT responses
    (partsbaseddetector_tpu/infer/detector.py:191-199).  conv_engine:
    "spatial" or "fft" (ops/conv.CONV_ENGINES).  pdfs_transform:
    optional fn(pdfs) applied to each bucket's responses after the conv
    (the filter-sharded paths all-gather their bank's output channels
    with it, parallel/mesh.Mesh.gather_filters).  depths + depth_prune:
    optional (B, dh, dw) float32 depth maps and the pruning config:
    responses at implausible depths become NEG, every bucket's after
    the last conv.  levels: optional (lo, hi) per bucket, the levels of
    it that are convolved (a scale-sharded rank's share, the ladder and
    HOG still run whole); a bucket with none gets None in place of
    pdfs and empty tsizes and scales."""
    conv = CONV_ENGINES[conv_engine]
    consts = plan_tensors(plan, images.device)
    B = images.shape[0]
    ranges = levels or [(0, len(b.levels)) for b in plan.buckets]
    out = []
    for (bucket, _, feats), (lo, hi) in zip(
            _ladder_hog(images, plan, packed.norient, packed.flen, stage),
            ranges):
        tsizes = consts.featsizes[bucket.octave][lo:hi]
        scales = consts.scales[bucket.octave][lo:hi]
        n = len(bucket.levels[lo:hi])
        if not n:
            out.append((bucket, None, tsizes, scales))
            continue
        if n < len(bucket.levels):
            feats = feats.unflatten(0, (B, -1))[:, lo:hi].flatten(0, 1)
        with stage("conv"):
            pdfs = conv(feats, packed.bank, true_size=tsizes.repeat(B, 1)
                        ).unflatten(0, (B, n))
            if pdfs_transform is not None:
                pdfs = pdfs_transform(pdfs)
        out.append((bucket, pdfs, tsizes, scales))
    if depths is not None and depth_prune is not None:
        with profiling.span("prune"):
            for (bucket, pdfs, _, _), (lo, hi) in zip(out, ranges):
                if pdfs is not None:
                    tables = consts.depth(bucket.octave, depths.shape[-2:],
                                          depth_prune)
                    bad = _depth_bad_mask(depths, [t[lo:hi] for t in tables])
                    pdfs.masked_fill_(bad[..., None], NEG)
    return out


def dp_backtrack_bucket(bucket, pdfs, tsizes, scales,
                        packed: PackedModel, k_per_level: int,
                        compose: str, dp_split: int = 1,
                        walk_impl: str = "cuda", bmask=None,
                        stage: StageTimer = profiling.stage
                        ) -> List[argmax_ops.Candidates]:
    """Stages 3-4 for one octave bucket of a batch of frames: per (level
    group, component) DP + backtracking, with the batch folded into the
    level axis (every level is independent).  pdfs: (B, L, fh, fw, F);
    bmask: optional (L, P, fh, fw) bool part placement masks, the same
    for every frame, or (B, L, P, fh, fw), one set per frame (the
    batched masked search, parallel/sharded.py), sliced per group as the
    JAX package does (partsbaseddetector_tpu/infer/detector.py:301).
    Returns per group a Candidates with fields (B, Lg*k, ...)."""
    B = pdfs.shape[0]
    dev = pdfs.device
    walk = argmax_ops.WALKS[walk_impl]
    out: List[argmax_ops.Candidates] = []
    for lo, hi, gfh, gfw in _dp_groups(bucket, dp_split):
        Lg = hi - lo
        gpdfs = pdfs[:, lo:hi, :gfh, :gfw].flatten(0, 1)   # (B*Lg, ...)
        gsizes = tsizes[lo:hi].repeat(B, 1)
        gscales = scales[lo:hi].repeat(B)
        if bmask is None:
            gmask = None
        elif bmask.ndim == 5:
            gmask = bmask[:, lo:hi, :, :gfh, :gfw].flatten(0, 1)
        else:
            gmask = bmask[lo:hi, :, :gfh, :gfw].repeat(B, 1, 1, 1)
        # levels run b-major; each frame's level indices restart
        levels = (torch.arange(lo, hi, dtype=torch.int32, device=dev)
                  + bucket.levels[0].index).repeat(B)
        for c, comp in enumerate(packed.components):
            # a view (component) runs its DP and walk over its own parts;
            # its candidates are padded to the model's most parts
            with profiling.span("view", {"component": c,
                                         "nparts": comp.nparts}):
                profiling.count("views")
                # the tracer's dp spans carry the group: its bucket, by
                # the bucket's first pyramid level, its levels lo..hi-1
                # in the bucket and the component
                with stage("dp", {"bucket": bucket.levels[0].index,
                                  "lo": lo, "hi": hi, "component": c}) \
                        if stage is profiling.stage else stage("dp"):
                    res = dp_min_levels(gpdfs, comp, compose, gmask,
                                        true_sizes=gsizes)
                with stage("seeds+sort"):
                    topv, valid, xs, ys, mv = argmax_ops._root_seeds(
                        res.rootv, res.rooti, packed.thresh, k_per_level,
                        gsizes)
                with stage("walk"):
                    X, Y, Mm = walk(
                        res.scores, res.tmp, xs, ys, mv, comp.defw,
                        comp.anchor.to(torch.float32), comp.bias,
                        comp.parent_host, compose)
                with stage("seeds+sort"):
                    cands = argmax_ops._walked_candidates(
                        X, Y, Mm, topv, valid, comp, gscales, k_per_level,
                        c, levels, packed.maxparts)
                    out.append(cands.map(
                        lambda x: x.unflatten(0, (B, Lg * k_per_level))))
    return out


def _free_cublas_workspaces() -> None:
    """Free cuBLAS's per-stream workspaces; the next matmul on a stream
    allocates its stream's anew (a build without CUDA has none)."""
    free = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if free is not None:
        free()


class FrameGraph:
    """The one-frame detection program (stages 1-4: from the frame in a
    static input buffer to the sorted Candidates) captured as one CUDA
    graph for one key, and replayed: the hand-written kernels are
    captured with the rest.  Spans and counters inside the program
    record once, while it is captured; every replay is a span
    ``detect.graph`` and counts one in ``detect.graph.replays``, a
    capture one in ``detect.graph.captures``.  A replay returns a clone
    of the static Candidates, so results outlive the next call."""

    def __init__(self, key, program: Callable, frames: torch.Tensor,
                 depths: Optional[torch.Tensor]):
        self.key = key
        self.frames = frames.clone()
        self.depths = None if depths is None else depths.clone()
        self.graph = torch.cuda.CUDAGraph()
        # cuBLAS holds a workspace for each stream a matmul runs on (32
        # MiB on an H100), and the capture runs on a stream of its own:
        # freed before the capture, the eager stream's makes room for the
        # capture stream's, and freed after it, the capture stream's
        # stays in the graph's private pool, which nothing else allocates
        # from.  So a capture's allocated peak is an eager call's.
        with torch.cuda.device(frames.device):
            _free_cublas_workspaces()
            with torch.cuda.graph(self.graph):
                self.out = program(self.frames, self.depths)
            _free_cublas_workspaces()
        # the last replay's end: a replay on another stream waits for it
        # before it writes the static inputs
        self.done = torch.cuda.Event()
        profiling.count("detect.graph.captures")

    def replay(self, frames: torch.Tensor, depths: Optional[torch.Tensor]
               ) -> argmax_ops.Candidates:
        with profiling.span("detect.graph"), torch.cuda.device(frames.device):
            profiling.count("detect.graph.replays")
            stream = torch.cuda.current_stream()
            stream.wait_event(self.done)
            self.frames.copy_(frames)
            if depths is not None:
                self.depths.copy_(depths)
            self.graph.replay()
            out = self.out.map(torch.clone)
            self.done.record(stream)
        return out


def device_frames(images, ndim: int, device: torch.device) -> torch.Tensor:
    """Frames onto the device as they are (uint8 stays uint8; the cast
    to float32 happens there), with a channel axis."""
    images = torch.as_tensor(images).to(device)
    if images.ndim == ndim - 1:
        images = images[..., None]          # grayscale
    return images


def device_masks(part_masks, device: torch.device) -> List[torch.Tensor]:
    """Per-bucket part placement masks as bool tensors on the device."""
    return [torch.as_tensor(m, dtype=torch.bool, device=device)
            for m in part_masks]


def check_depth(depths, depth_prune: Optional[DepthPrune]) -> None:
    """A depth map is for the depth pruning: a detector without a
    ``depth_prune`` config refuses one."""
    if depths is not None and depth_prune is None:
        raise ValueError(
            "depth map passed but this detector has no depth_prune "
            "config; construct it with depth_prune=DepthPrune(...)")


def upload(images, ndim: int, device: torch.device, depths=None,
           part_masks=None):
    """The inputs of one call onto the device: images (H, W[, C]) for
    ndim 3 (one frame) or (B, H, W[, C]) for ndim 4, as (B, H, W, C)
    frames; depths (meters) as (B, dh, dw) float32 maps or None;
    part_masks per bucket as bool tensors or None."""
    frames = device_frames(images, ndim, device)
    if ndim == 3:
        frames = frames[None]
    elif frames.ndim != 4:
        raise ValueError("a batch of frames is (B, H, W[, 3]), got "
                         f"shape {tuple(frames.shape)}")
    if depths is not None:
        depths = torch.as_tensor(depths, dtype=torch.float32, device=device)
        depths = depths.reshape(frames.shape[:1] + depths.shape[-2:])
    if part_masks is not None:
        part_masks = device_masks(part_masks, device)
    return frames, depths, part_masks


def frame_by_frame(program, frames: torch.Tensor, depths=None,
                   part_masks=None, *args) -> argmax_ops.Candidates:
    """program(frames, depths, part_masks, *args) on one frame of a
    (B, H, W, C) batch at a time, its Candidates (1, ...) stacked to
    (B, ...): the programs whose later stages take one frame (the
    multi-resolution DP and walk, the scale split).  Per-frame masks
    (B, L, P, fh, fw) are cut to each frame's."""
    return argmax_ops.stack_candidates([program(
        frames[b:b + 1], None if depths is None else depths[b:b + 1],
        None if part_masks is None else
        [m[b] if m.ndim == 5 else m for m in part_masks],
        *args).map(lambda x: x[0]) for b in range(frames.shape[0])])


class DetectorFacade:
    """What the one-device facades share (Detector, and MultiResDetector
    in infer/multires.py): the packed model, the plan cache, the input
    checks and the upload, and every entry point.  A facade gives the
    stages 3-4 of its program (``_stage34``); ``multires`` says which
    program it is.  The parallel detectors (parallel/) hold one and run
    its ``_run``, ``_program`` or ``_stage34`` on their own share of the
    work.  infer/multires.detector_for picks the facade for a model."""

    multires = False

    def __init__(self, model: PartsModel, k_per_level: int = 64,
                 depth_prune: Optional[DepthPrune] = None,
                 conv_engine: str = "spatial", device=None):
        if conv_engine not in CONV_ENGINES:
            raise ValueError(f"conv_engine {conv_engine!r}; one of "
                             f"{sorted(CONV_ENGINES)}")
        self.conv_engine = conv_engine
        self.device = resolve_device(device)
        self.model = model
        self.packed = self._pack(model)
        self.k_per_level = int(k_per_level)
        self.depth_prune = depth_prune
        self._plans: Dict[Tuple[int, int], PyramidPlan] = {}
        # the one-frame program's CUDA graph (FrameGraph) and the key of
        # the last graphable call; the lock guards both and the graph's
        # static buffers
        self._graph: Optional[FrameGraph] = None
        self._last_key = None
        self._graph_lock = threading.Lock()

    def _pack(self, model: PartsModel) -> PackedModel:
        return pack_model(model, self.device)

    def plan_for(self, imshape: Tuple[int, int]) -> PyramidPlan:
        key = (int(imshape[0]), int(imshape[1]))
        if key not in self._plans:
            self._plans[key] = make_plan(key, self.model.binsize,
                                         self.model.interval)
        return self._plans[key]

    def _run(self, images, ndim: int, stage: StageTimer = profiling.stage,
             depths=None, part_masks=None, program=None
             ) -> argmax_ops.Candidates:
        """The detection program on host or device images: (H, W[, C])
        for ndim 3 (one frame), (B, H, W[, C]) for ndim 4; returns
        Candidates (B, ...).  program: fn(frames, depths, part_masks,
        stage) in place of this facade's ``_program`` (a parallel
        detector's, on this facade's device)."""
        check_depth(depths, self.depth_prune)
        with profiling.span("detect.call"):
            with profiling.span("upload"):
                frames, depths, part_masks = upload(
                    images, ndim, self.device, depths, part_masks)
            if self._graphable(frames, part_masks, stage, program):
                return self._graphed(frames, depths)
            return (program or self._program)(frames, depths, part_masks,
                                              stage)

    def _graphable(self, frames: torch.Tensor, part_masks, stage,
                   program) -> bool:
        """Whether a call runs through the one-frame CUDA graph: one
        frame on CUDA, this facade's own single-resolution program, no
        part masks and the default stage hook (a caller's hook records
        per call, which a replay would skip)."""
        return (self.device.type == "cuda" and frames.shape[0] == 1
                and program is None and part_masks is None
                and stage is profiling.stage and not self.multires)

    def _graphed(self, frames: torch.Tensor, depths
                 ) -> argmax_ops.Candidates:
        """The program of a graphable call: keyed by the frame's shape
        and dtype and the depth map's shape.  A key other than the last
        call's runs eagerly; the second call in a row of one key
        captures the graph (dropping the one held before), and every
        call of the held graph's key replays it."""
        key = (tuple(frames.shape), frames.dtype,
               None if depths is None else tuple(depths.shape))
        with self._graph_lock:
            graph = self._graph
            if graph is None or graph.key != key:
                if key != self._last_key:
                    self._last_key = key
                    return self._program(frames, depths)
                self._graph = None
                graph = self._graph = FrameGraph(key, self._program,
                                                 frames, depths)
            self._last_key = key
            return graph.replay(frames, depths)

    def _program(self, frames: torch.Tensor, depths=None, part_masks=None,
                 stage: StageTimer = profiling.stage,
                 packed: Optional[PackedModel] = None,
                 pdfs_transform: Optional[Callable] = None
                 ) -> argmax_ops.Candidates:
        """The full detection program for a (B, H, W, C) batch of frames
        on the device; returns Candidates with fields (B, nlevels*k,
        ...), each frame's sorted by score, invalid last.

        depths: optional (B, dh, dw) float32 depth maps, pruned with
        ``depth_prune`` before the DP.  part_masks: optional per-bucket
        (L, P, fh, fw) bool masks of allowed part placements (the
        latent-positive search), or (B, L, P, fh, fw) ones per frame.
        packed, pdfs_transform: a filter-sharded detector's bank shard
        and its gather (pyramid_pdfs); stages 3-4 use the whole model."""
        per_bucket = pyramid_pdfs(
            frames, self.packed if packed is None else packed,
            self.plan_for(frames.shape[1:3]), self.conv_engine, stage,
            pdfs_transform, depths, self.depth_prune)
        return self._stage34(per_bucket, part_masks, stage)

    def detect_raw(self, image, depth=None) -> argmax_ops.Candidates:
        """Detect in one (H, W[, 3]) frame; returns the fixed-capacity
        Candidates (scores sorted descending, invalid entries last).
        depth: optional (dh, dw) depth map in meters; with a
        ``depth_prune`` config, responses at implausible depths are
        masked before the DP (the reference's detect(im, depth,
        candidates), include/PartsBasedDetector.hpp:172-174)."""
        return self._run(image, 3, depths=depth).map(lambda x: x[0])

    def detect_batch_raw(self, images, depths=None,
                         stage: StageTimer = profiling.stage
                         ) -> argmax_ops.Candidates:
        """Detect in a (B, H, W[, 3]) stack of frames in one call.
        Returns Candidates with a leading (B, ...) axis; each frame's
        equal to its detect_raw.  depths: optional (B, dh, dw) depth
        maps, one per frame (needs ``depth_prune``).  stage: optional
        stage timer."""
        return self._run(images, 4, stage, depths=depths)

    def detect_masked_raw(self, image, part_masks) -> argmax_ops.Candidates:
        """Detection with per-part placement masks (latent-positive
        search).  part_masks: per-bucket list of (L, P, fh, fw) bool
        arrays (train/features.part_overlap_masks stacked per plan
        bucket)."""
        return self._run(image, 3, part_masks=part_masks).map(
            lambda x: x[0])

    def pyramid_features(self, image) -> List[np.ndarray]:
        """Stage 1 alone: per-level HOG feature maps at their true sizes,
        as host numpy arrays, the trainer's feature write-back
        (train/features.py; partsbaseddetector_tpu/infer/detector.py:
        207-237)."""
        frame = device_frames(image, 3, self.device)
        plan = self.plan_for(frame.shape[:2])
        feats = [f for _, _, bucket_feats in _ladder_hog(
                     frame[None], plan, self.packed.norient, self.packed.flen)
                 for f in bucket_feats.unbind(0)]
        return [f[:lvl.featsize[0], :lvl.featsize[1]].cpu().numpy()
                for f, lvl in zip(feats, plan.levels)]

    def detect(self, image, *, depth=None,
               max_detections: Optional[int] = None) -> List[Detection]:
        """Detect and return host-side Detections above the model
        threshold, sorted by score descending."""
        return self.candidates_to_detections(
            self.detect_raw(image, depth=depth), max_detections)

    def update_model(self, model: PartsModel) -> None:
        """Swap in updated weights of the same binsize and interval."""
        if (model.binsize != self.model.binsize
                or model.interval != self.model.interval):
            raise ValueError("update_model needs the same binsize and "
                             "interval")
        self.packed = self._pack(model)
        self.model = model
        with self._graph_lock:          # weights and thresh are baked in
            self._graph = self._last_key = None

    @staticmethod
    def candidates_to_detections(cands: argmax_ops.Candidates,
                                 max_detections: Optional[int] = None
                                 ) -> List[Detection]:
        """Convert one frame's Candidates to host Detections (valid
        entries only, preserving order): six reads back from the
        device, one a field."""
        with profiling.span("fetch"):
            profiling.count("readbacks", 6)
            score = cands.score.cpu().numpy()
            valid = cands.valid.cpu().numpy()
            comp = cands.component.cpu().numpy()
            level = cands.level.cpu().numpy()
            boxes = cands.boxes.cpu().numpy()
            locs = cands.loc.cpu().numpy()
            out: List[Detection] = []
            # a Detection is an object the cyclic collector tracks: built
            # by the thousand, they would start a full collection of the
            # whole heap every few frames
            with profiling.gc_held():
                for i in range(len(score)):
                    if not valid[i]:
                        continue
                    out.append(Detection(score=float(score[i]),
                                         component=int(comp[i]),
                                         level=int(level[i]),
                                         parts=boxes[i], locations=locs[i]))
                    if max_detections is not None and \
                            len(out) >= max_detections:
                        break
            return out


class Detector(DetectorFacade):
    """User-facing facade for single-resolution models.

    >>> det = Detector(model)                # CUDA; device="cpu" for CPU
    >>> detections = det.detect(image)       # (H, W[, 3]) RGB array

    depth_prune: optional DepthPrune config, used when a depth map is
    passed.  conv_engine: "spatial" or "fft".  walk_impl: "cuda" (the
    walk kernel; its plain version on CPU tensors), "torch" (the plain
    walk) or "auto" ("cuda" on a CUDA device, "torch" on the CPU).  A
    batch of frames is folded into the level axis of the DP and the
    walk."""

    def __init__(self, model: PartsModel, k_per_level: int = 64,
                 compose: str = "reference",
                 dp_split: Optional[int] = None,
                 depth_prune: Optional[DepthPrune] = None,
                 conv_engine: str = "spatial",
                 walk_impl: str = "auto",
                 device=None):
        if model.max_scale() > 0:
            raise ValueError(
                "model has parts at multiple resolutions (anchor ds > "
                "0); use infer.multires.MultiResDetector")
        if compose not in ("reference", "correct"):
            raise ValueError(f"compose {compose!r}")
        if walk_impl not in ("auto", "cuda", "torch"):
            raise ValueError(f"walk_impl {walk_impl!r}; one of 'auto', "
                             "'cuda', 'torch'")
        super().__init__(model, k_per_level, depth_prune, conv_engine,
                         device)
        self.compose = compose
        if dp_split is None:
            # the JAX package's default: groups of about two levels
            # (partsbaseddetector_tpu/infer/detector.py:346-351)
            dp_split = max(1, (model.interval + 1) // 2)
        self.dp_split = int(dp_split)
        if walk_impl == "auto":
            walk_impl = "cuda" if self.device.type == "cuda" else "torch"
        self.walk_impl = walk_impl

    @classmethod
    def from_config(cls, model: PartsModel, cfg) -> "Detector":
        """Build from a config.RuntimeConfig (the unified typed config;
        partsbaseddetector_tpu/infer/detector.py:403-411), its
        ``device`` included."""
        return cls(model, k_per_level=cfg.k_per_level,
                   compose=cfg.compose, dp_split=cfg.dp_split,
                   conv_engine=cfg.conv_engine, walk_impl=cfg.walk_impl,
                   device=cfg.device)

    def _stage34(self, per_bucket, part_masks=None,
                 stage: StageTimer = profiling.stage
                 ) -> argmax_ops.Candidates:
        """Stages 3-4 on pyramid_pdfs' entries: the DP and the walk per
        (bucket, dp group, component), then one stable sort per frame.
        part_masks: optional per-bucket masks (dp_backtrack_bucket's
        bmask)."""
        all_cands: List[argmax_ops.Candidates] = []
        # padded cells are masked in the DP (dp_min_levels(true_sizes=...))
        # for both conv engines
        for bucket, pdfs, tsizes, scales in per_bucket:
            bmask = None if part_masks is None else part_masks[bucket.octave]
            all_cands.extend(dp_backtrack_bucket(
                bucket, pdfs, tsizes, scales, self.packed, self.k_per_level,
                self.compose, self.dp_split, self.walk_impl, bmask, stage))
        with stage("seeds+sort"):
            return argmax_ops.sort_candidates(
                argmax_ops.concat_candidates(all_cands))
