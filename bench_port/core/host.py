"""Small helpers of a run shared by the runner and the drivers: the log
on standard error, a device synchronize, the device's memory peak."""

from __future__ import annotations

import sys

import torch


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev: torch.device) -> int:
    """torch.cuda.max_memory_allocated since the run's reset; 0 off a
    card."""
    if dev.type != "cuda":
        return 0
    sync(dev)
    return int(torch.cuda.max_memory_allocated(dev))
