"""Helpers of the benchmark's tests: small cells for the CPU, and the
``card`` marker for tests that need a CUDA card (they skip without one,
decided inside the fixture)."""

from __future__ import annotations

import time

import pytest
import torch

from bench_port.core import runner, spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest bench_port/tests -m card")
    return torch.device("cuda")


def small_cell(name: str, nparts: int = 6, shape=(96, 128)) -> spec.Cell:
    """The cell's files at a size the CPU runs in seconds: the config's
    widths, fewer parts, small frames, a batch of 2; for the camera,
    fx of the depth pruning scaled so that a few levels survive."""
    cell = spec.load_cell(name)
    cell.config["nparts"] = nparts
    cell.traffic.update(height=shape[0], width=shape[1])
    if cell.traffic["kind"] == "closed_batches":
        cell.traffic.update(batch=2, pool=4)
    else:
        cell.traffic.update(scenes=3, check_frames=2)
        cell.traffic["depth_prune"] = dict(cell.traffic["depth_prune"],
                                           fx=60.0)
        cell.workload["rate_hz"] = 4.0
    return cell


def run_small(cell, seed=123456789012, seconds=0.5, trace=False, **kw):
    return runner.run(cell, seed, seconds, trace, "cpu",
                      time.perf_counter(), **kw)
