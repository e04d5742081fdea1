"""Traffic kind ``closed_batches``: offline evaluation or annotation.

The mix (``traffic/<mix>.json``) gives ``height``, ``width``, ``batch``
and ``pool``: a pool of ``pool`` distinct uint8 RGB frames made on the
device in set-up, and an endless seeded sequence of batches of
``batch`` distinct pool frames.  The entry is Detector.detect_batch_raw,
then Detector.candidates_to_detections for each frame; a batch is sent
when the previous one's detections reached the host (closed loop).
Every seed gets the same sizes; it changes the pixels and the order.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator

import numpy as np
import torch

from bench_port.core import trace
from bench_port.core.host import log, peak_bytes, sync
from bench_port.core.seeds import numpy_rng, torch_gen

#: batches profiled after the window (the traced sub-window)
TRACE_BATCHES = 4


class Generator:
    def __init__(self, params: Dict, seed: int, device):
        self.shape = (params["height"], params["width"])
        self.batch = params["batch"]
        g = torch_gen(seed, "traffic", device)
        self.pool = torch.randint(0, 256, (params["pool"],) + self.shape
                                  + (3,), generator=g, device=device,
                                  dtype=torch.uint8).cpu().numpy()
        self._rng = numpy_rng(seed, "traffic")

    def batches(self) -> Iterator[np.ndarray]:
        """Pool indices of each batch, distinct within a batch."""
        while True:
            yield self._rng.choice(len(self.pool), self.batch,
                                   replace=False)

    def frames(self, idx) -> np.ndarray:
        """The (B, H, W, 3) uint8 frames of a batch, as a host array."""
        return self.pool[idx]


def make(params: Dict, cell_params: Dict, seed: int, device) -> Generator:
    return Generator(params, seed, device)


def build(cell, arrays: Dict, dev):
    from bench_port.core import program
    return program.build_detector(arrays, cell.config,
                                  cell.workload["thresh"], dev,
                                  cell.traffic.get("depth_prune"))


def drive(cell, gen: Generator, det, dev, seconds, trace_on, t_start,
          sample_rng, run):
    """Warm-up (one batch), the window, the traced batches; returns the
    sample to check: (frame, detections, None) of one batch of the
    window, drawn from the seed."""
    from bench_port.core import program
    batches = gen.batches()
    program.batch_call(det, gen.frames(next(batches)))
    sync(dev)
    run.setup_s = time.perf_counter() - t_start
    timer = program.CudaStageTimer() if trace_on and dev.type == "cuda" \
        else None
    stage = None if timer is None else timer.stage
    n = frames = 0
    sample = None
    t0 = time.perf_counter()
    while True:
        idx = next(batches)
        dets = program.batch_call(det, gen.frames(idx), stage)
        n += 1
        frames += len(idx)
        if sample_rng.random() * n < 1:          # a reservoir of one
            sample = (idx, dets)
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.frames = run.attempted = frames
    run.peak_bytes = peak_bytes(dev)
    if timer is not None:
        run.stage_ms = timer.totals_ms()
    log(f"window: {n} batches of {gen.batch}, {frames} frames in "
        f"{run.window_s} s")
    if trace_on:
        traced = [next(batches) for _ in range(TRACE_BATCHES)]

        def stage_mark(name):
            return torch.profiler.record_function(trace.STAGE + name)

        def step():
            return sum(len(program.batch_call(det, gen.frames(idx),
                                              stage_mark))
                       for idx in traced)
        run.profile = trace.profile(step)
        run.profiled_frames = [f for idx in traced for f in gen.frames(idx)]
    return [(gen.frames(sample[0])[i], program.detections_dict(d), None)
            for i, d in enumerate(sample[1])]


def control_sample(cell, gen: Generator, seconds, sample_rng):
    """The frames a run would check, for the control."""
    idx = next(gen.batches())
    return [(f, None, None) for f in gen.frames(idx)]
