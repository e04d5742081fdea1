"""Mesh construction over the ranks of a torch.distributed job (port of
partsbaseddetector_tpu/parallel/mesh.py).

Axes:
  data    — image/batch parallelism (the analog of running the reference
            detector on many frames, ros/Node.cpp:144);
  filter  — mixture-filter-bank model parallelism (the analog of the
            reference's OpenMP loop over filters,
            src/SpatialConvolutionEngine.cpp:114-117);
  scale   — pyramid-level parallelism, in place of data
            (parallel/scale_sharded.make_scale_mesh).

A JAX mesh is a grid of devices inside one SPMD program; here it is a
grid of processes, one device each.  Ranks fill the grid row-major, as
``np.reshape`` fills a JAX mesh from its device list: rank r sits at
(r // n1, r % n1).  Each rank keeps one process group per axis, the
ranks that share its other coordinate, and the collectives of the
parallel detectors run over them.  World size 1 needs no process
group: every axis then has size 1 and every collective is the identity.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from partsbaseddetector_tpu_torch.ops.common import resolve_device


def world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) when none
    is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a 2-D grid of ranks.

    axis_names: the two axes' names; sizes: their sizes; coords: this
    rank's coordinates; device: the device this rank computes on;
    groups: the process group along each axis (None where the axis has
    size 1)."""

    axis_names: Tuple[str, str]
    sizes: Tuple[int, int]
    coords: Tuple[int, int]
    device: torch.device
    groups: Tuple[Optional[object], Optional[object]] = (None, None)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r}; the mesh has "
                             f"{self.axis_names}")
        return self.axis_names.index(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self._axis(axis)]

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The ranks along ``axis`` each give t (one shape on all of
        them); returns their tensors concatenated along ``dim`` in
        coordinate order.  The identity on an axis of size 1."""
        a = self._axis(axis)
        if self.sizes[a] == 1:
            return t
        src = t.contiguous()
        if src.dtype == torch.bool:        # gathered as bytes
            return self.all_gather(src.to(torch.uint8), axis, dim).bool()
        parts = [torch.empty_like(src) for _ in range(self.sizes[a])]
        dist.all_gather(parts, src, group=self.groups[a])
        return torch.cat(parts, dim=dim)

    def gather_filters(self, pdfs: torch.Tensor) -> torch.Tensor:
        """Responses of this rank's filter shard (..., F_local) -> the
        whole padded bank's (..., F_local * filter size): the one
        collective of the filter-sharded detect program
        (partsbaseddetector_tpu/parallel/sharded.py:177-227)."""
        return self.all_gather(pdfs, "filter", -1)


def _local_cuda(rank: int) -> torch.device:
    local = int(os.environ.get("LOCAL_RANK",
                               rank % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ("data", "filter"),
              device=None) -> Mesh:
    """A 2-D mesh over the ranks of the default process group (every
    rank calls it, with the same arguments).

    shape defaults to (world size, 1) — pure data parallelism; its
    product must be the world size.  device: where this rank computes;
    None means CUDA — the card ``LOCAL_RANK`` names (else rank modulo
    the cards) — and raises without one (ops/common.resolve_device)."""
    size, rank = world()
    shape = (size, 1) if shape is None else tuple(int(n) for n in shape)
    if len(shape) != 2 or shape[0] * shape[1] != size:
        raise ValueError(f"mesh shape {shape} does not fit the job: the "
                         f"world size is {size} (one process per device, "
                         "parallel/distributed.initialize)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and size > 1:
        dev = _local_cuda(rank)
    n0, n1 = shape
    coords = divmod(rank, n1)
    groups = [None, None]
    # every rank creates every group, in the same order (new_group is
    # collective over the default group)
    if n0 > 1:
        for j in range(n1):
            g = dist.new_group([i * n1 + j for i in range(n0)])
            if j == coords[1]:
                groups[0] = g
    if n1 > 1:
        for i in range(n0):
            g = dist.new_group([i * n1 + j for j in range(n1)])
            if i == coords[0]:
                groups[1] = g
    return Mesh(tuple(axis_names), (n0, n1), coords, dev, tuple(groups))
