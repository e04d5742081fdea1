"""Sharded batch detection over a (data, filter) mesh (port of
partsbaseddetector_tpu/parallel/sharded.py).

Frames split over ``data``; the packed filter bank's output channels
split over ``filter``, so the stage-2 conv (the FLOPs bulk, reference
analog src/SpatialConvolutionEngine.cpp:106-124) runs model-parallel.
The DP gathers responses by filter id, so each rank all-gathers its
filter group's responses before the DP: the one collective of the JAX
package's program (its sharded.py:177-227), here
``Mesh.gather_filters``.  Stages 3-4 then run on every rank of a filter
group for that group's frames — each rank launches the walk kernel for
its own frames — and the Candidates are all-gathered over ``data``, so
every rank returns the whole batch, each frame sorted by score
(deterministic, the replacement for the reference's OpenMP-critical
push_back, src/DynamicProgram.cpp:246-251).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from partsbaseddetector_tpu_torch.infer.detector import Detector
from partsbaseddetector_tpu_torch.infer.multires import detector_for
from partsbaseddetector_tpu_torch.models.part_tree import PackedModel
from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops.argmax import Candidates
from partsbaseddetector_tpu_torch.parallel.mesh import Mesh


def shard_filters(bank: torch.Tensor, nshards: int, index: int
                  ) -> torch.Tensor:
    """Shard ``index`` of ``nshards`` of a (FH, FW, C, F) filter bank's
    output-channel axis, the bank first padded with all-zero filters to
    a multiple of ``nshards`` (no filter id names a padded filter, so
    the DP never reads their responses; the JAX package's
    sharded.py:80-96)."""
    F = bank.shape[3]
    pad = (-F) % nshards
    if pad:
        bank = torch.cat([bank, bank.new_zeros(bank.shape[:3] + (pad,))],
                         dim=3)
    n = bank.shape[3] // nshards
    return bank[..., index * n:(index + 1) * n].contiguous()


def sharded_packed(packed: PackedModel, mesh: Mesh) -> PackedModel:
    """The packed model with this rank's shard of the filter bank."""
    return dataclasses.replace(packed, bank=shard_filters(
        packed.bank, mesh.shape["filter"], mesh.index("filter")))


def check_mesh(mesh, axes) -> Mesh:
    """mesh, if it is a Mesh with these axes; else TypeError."""
    if not isinstance(mesh, Mesh) or tuple(mesh.axis_names) != axes:
        raise TypeError(f"mesh: a parallel.mesh.Mesh with axes {axes} "
                        f"(parallel/mesh.make_mesh), got {mesh!r}")
    return mesh


def gather_candidates(c: Candidates, mesh: Mesh, axis: str, dim: int
                      ) -> Candidates:
    """Every field all-gathered along ``axis`` of the mesh, concatenated
    along ``dim``."""
    return c.map(lambda x: mesh.all_gather(x, axis, dim))


def _held(name: str) -> property:
    return property(lambda self: getattr(self._det, name),
                    doc=f"The held facade's ``{name}``.")


class ParallelFacade:
    """What the parallel detectors share: each holds the one-device
    facade of its model (infer/multires.detector_for, ``_det``), runs
    that facade's input checks, upload and stages 3-4, and reads its
    knobs from it (a multi-resolution facade has no compose, dp_split or
    walk_impl)."""

    device = _held("device")
    k_per_level = _held("k_per_level")
    conv_engine = _held("conv_engine")
    depth_prune = _held("depth_prune")
    multires = _held("multires")
    compose = _held("compose")
    dp_split = _held("dp_split")
    walk_impl = _held("walk_impl")

    def plan_for(self, imshape):
        return self._det.plan_for(imshape)

    def detect(self, image, max_detections: Optional[int] = None):
        return Detector.candidates_to_detections(
            self.detect_raw(image), max_detections)


class BatchDetector(ParallelFacade):
    """Batched, mesh-sharded detector.

    >>> mesh = make_mesh((4, 2))             # 8 ranks, one card each
    >>> bdet = BatchDetector(model, mesh)
    >>> cands = bdet.detect_batch(images)    # (B, H, W, 3), B % data == 0

    Every rank calls it with the same frames and gets the whole batch's
    Candidates; ``detect_batch_distributed`` takes each rank's own frames
    instead, and ``detect_raw`` / ``detect_batch_raw`` any number of
    frames.  Multi-resolution models run the MultiResDetector program
    (one frame at a time, the plain walk), with the same sharding."""

    def __init__(self, model: PartsModel, mesh: Mesh,
                 k_per_level: int = 64, compose: str = "reference",
                 dp_split: Optional[int] = None,
                 conv_engine: str = "spatial", depth_prune=None,
                 walk_impl: str = "auto"):
        self.model = model
        self.mesh = check_mesh(mesh, ("data", "filter"))
        self._det = detector_for(
            model, k_per_level=k_per_level, compose=compose,
            dp_split=dp_split, depth_prune=depth_prune,
            conv_engine=conv_engine, walk_impl=walk_impl,
            device=mesh.device)
        # this rank's filter shard; the rest of the model is whole
        self.packed = sharded_packed(self._det.packed, mesh)
        self._gather = (mesh.gather_filters if mesh.shape["filter"] > 1
                        else None)

    def _check_batch(self, images) -> int:
        B = len(images)
        ndata = self.mesh.shape["data"]
        if B % ndata:
            raise ValueError(f"batch {B} not divisible by data axis "
                             f"{ndata}")
        return B

    def local_frame_slices(self, global_batch: int
                           ) -> List[Tuple[int, int]]:
        """The rows of a global batch this rank owns under the data
        axis: one contiguous (start, stop) range; ranks that share a
        data coordinate (a filter group) own the same rows."""
        n = global_batch // self.mesh.shape["data"]
        i = self.mesh.index("data")
        return [(i * n, (i + 1) * n)]

    def local_frames(self, global_images):
        """A global batch cut down to the frames this rank owns (see
        local_frame_slices)."""
        (a, b), = self.local_frame_slices(len(global_images))
        return global_images[a:b]

    def _run_local(self, images, depths=None, part_masks=None
                   ) -> Candidates:
        """This rank's frames through the facade's program with this
        rank's filter shard: (B_local, ...)."""
        return self._det._run(images, 4, depths=depths,
                              part_masks=part_masks,
                              program=functools.partial(
                                  self._det._program, packed=self.packed,
                                  pdfs_transform=self._gather))

    def detect_batch(self, images, depths=None) -> Candidates:
        """images: (B, H, W[, 3]), the same on every rank; B must divide
        evenly over the data axis.  Returns Candidates with a leading
        batch axis (B, ...).

        depths: optional (B, H, W) metric depth maps — with a
        ``depth_prune`` config, per-frame stage-2 response pruning
        exactly like Detector.detect_raw(image, depth)."""
        self._check_batch(images)
        return gather_candidates(self._run_local(
            self.local_frames(images),
            None if depths is None else self.local_frames(depths)),
            self.mesh, "data", 0)

    def detect_masked_batch(self, images, part_masks: Sequence
                            ) -> Candidates:
        """Batched latent-positive masked search: part_masks is a
        per-bucket sequence of (B, L, P, fh, fw) bool arrays (the batched
        form of Detector.detect_masked_raw's per-image masks)."""
        self._check_batch(images)
        return gather_candidates(self._run_local(
            self.local_frames(images),
            part_masks=[self.local_frames(m) for m in part_masks]),
            self.mesh, "data", 0)

    def detect_batch_distributed(self, local_images) -> Candidates:
        """Multi-process entry point: every rank passes the (B_local, H,
        W, 3) frames it OWNS under the data axis — the rows
        local_frame_slices reports, so ranks of one filter group pass
        the same rows.  Returns the global Candidates (B_local * data,
        ...) on every rank."""
        if np.ndim(local_images) != 4:
            raise ValueError("detect_batch_distributed expects local "
                             "(B_local, H, W, 3) images")
        return gather_candidates(self._run_local(local_images),
                                 self.mesh, "data", 0)

    def detect_raw(self, image, depth=None) -> Candidates:
        """One (H, W[, 3]) frame, replicated over the data axis, result
        0 kept: a single frame on a mesh pays the replication;
        detect_batch_raw is the mesh's throughput path."""
        return self.detect_batch_raw(
            np.asarray(image)[None],
            None if depth is None else np.asarray(depth)[None]).map(
                lambda x: x[0])

    def detect_batch_raw(self, images, depths=None) -> Candidates:
        """Any (B, H, W[, 3]) stack of frames: the last frame repeated up
        to a multiple of the data axis, the padding's results dropped."""
        ndata = self.mesh.shape["data"]
        B = len(images)
        pad = (-B) % ndata
        if pad:      # repeat the last frame up to a data-axis multiple
            images = np.concatenate(
                [images, np.repeat(np.asarray(images)[-1:], pad, 0)])
            if depths is not None:
                depths = np.concatenate(
                    [depths, np.repeat(np.asarray(depths)[-1:], pad, 0)])
        out = self.detect_batch(images, depths=depths)
        return out.map(lambda x: x[:B]) if pad else out
