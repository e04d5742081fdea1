"""Multi-process initialization (port of
partsbaseddetector_tpu/parallel/distributed.py).

The reference is strictly single-process (SURVEY.md §2.4).  Here a
multi-card job is one process per card under torch.distributed: NCCL
between cards, gloo between CPU processes.  This module is the one
place that touches process-level runtime state."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from partsbaseddetector_tpu_torch.ops.common import resolve_device


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None) -> None:
    """Join the job's default process group.  With no arguments, reads
    the standard environment: ``WORLD_SIZE``, ``RANK`` and, through the
    ``env://`` init method, ``MASTER_ADDR`` / ``MASTER_PORT``.  A world
    of one process needs no group: then nothing is initialised.

    device: where this process computes (None = CUDA): NCCL on CUDA,
    with the process's card (``LOCAL_RANK``, else rank modulo the cards)
    made current; gloo on the CPU."""
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if world_size == 1:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def global_mesh_shape(filter_axis: int = 1) -> Tuple[int, int]:
    """Default (data, filter) mesh shape over all ranks of the job."""
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if n % filter_axis:
        raise ValueError(f"filter axis {filter_axis} does not divide the "
                         f"world size {n}")
    return (n // filter_axis, filter_axis)
