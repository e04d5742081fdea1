"""Traffic kind ``open_camera``: one RGB-D camera on a robot, the ROS
node's path.

The mix (``traffic/<mix>.json``) gives ``height``, ``width``,
``scenes`` (seeded RGB-D frames, core/scene.py, sent in a seeded
order), the serving parameters (``depth_prune``, ``max_overlap``,
``max_candidates``, ``sinks``) and ``check_frames``; the cell gives
``rate_hz``.  Frame i is due at i / rate_hz whatever the system does
(open loop) and goes through StreamingDetector.process at B=1.  Every
seed gets the same sizes and schedule; it changes the pixels, the
depths and the order.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np

from bench_port.core import scene, trace
from bench_port.core.host import log, peak_bytes, sync
from bench_port.core.seeds import numpy_rng

#: frames served back to back under the profiler after the window
TRACE_FRAMES = 4


class Generator:
    def __init__(self, params: Dict, rate_hz: float, seed: int):
        self.shape = (params["height"], params["width"])
        self.rate_hz = float(rate_hz)
        rng = numpy_rng(seed, "traffic")
        self.scenes = scene.scenes(params["scenes"], self.shape, rng)
        self._order = rng.permutation(params["scenes"])
        self.camera = scene.kinect_camera(self.shape)

    def due(self, seconds: float) -> List[float]:
        """Due times (s from the window's start) of the frames of a
        window: all i / rate_hz below ``seconds``, at least one."""
        n = max(1, math.ceil(seconds * self.rate_hz))
        return [i / self.rate_hz for i in range(n)]

    def frame(self, i: int):
        """(rgb, depth metres float32, cloud) of the i-th frame."""
        return self.scenes[self._order[i % len(self._order)]]


def make(params: Dict, cell_params: Dict, seed: int, device) -> Generator:
    return Generator(params, cell_params["rate_hz"], seed)


def build(cell, arrays: Dict, dev):
    from bench_port.core import program
    return program.build_detector(arrays, cell.config,
                                  cell.workload["thresh"], dev,
                                  cell.traffic.get("depth_prune"))


def _keep(cell, n: int, sample_rng) -> List[int]:
    return sorted(int(i) for i in sample_rng.choice(
        n, min(cell.traffic["check_frames"], n), replace=False))


def drive(cell, gen: Generator, det, dev, seconds, trace_on, t_start,
          sample_rng, run):
    """Warm-up (one frame), the window on the camera's schedule, the
    traced frames; returns the sample to check: (rgb, the raw
    candidates, (depth, the FrameResult)) of check_frames frames of the
    window, drawn from the seed."""
    from bench_port.core import program
    tp = cell.traffic
    due = gen.due(seconds)
    keep = _keep(cell, len(due), sample_rng)
    sd = program.serving(det, gen.camera, tp, keep=keep)
    sd.process(*gen.frame(len(due)))             # warm-up
    sync(dev)
    sd.frame, sd.detect_s, sd.post_s = -1, [], []
    sd.kept_raw = {}
    run.setup_s = time.perf_counter() - t_start
    lat: List[float] = []
    late: List[float] = []
    results: Dict[int, Dict] = {}
    t0 = time.perf_counter()
    for i, d in enumerate(due):
        target = t0 + d
        wait = target - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        start = time.perf_counter()
        res = sd.process(*gen.frame(i))
        done = time.perf_counter()
        lat.append(done - target)
        late.append(start - target)
        if i in keep:
            results[i] = program.frame_result_dict(res)
    run.window_s = time.perf_counter() - t0
    run.frames = run.attempted = len(due)
    run.latencies_s, run.late_s = lat, late
    run.detect_s, run.post_s = list(sd.detect_s), list(sd.post_s)
    run.peak_bytes = peak_bytes(dev)
    log(f"window: {len(due)} frames due at {gen.rate_hz} Hz over "
        f"{seconds} s, served in {run.window_s} s; start behind schedule: "
        f"mean {1e3 * float(np.mean(late))} ms, max "
        f"{1e3 * float(np.max(late))} ms; a frame's detect and fetch "
        f"{1e3 * float(np.mean(run.detect_s))} ms, post stage "
        f"{1e3 * float(np.mean(run.post_s))} ms (means)")
    if trace_on:
        nxt = len(due) + 1
        sd.annotate = True

        def step():
            for j in range(TRACE_FRAMES):
                sd.process(*gen.frame(nxt + j))
            return TRACE_FRAMES
        run.profile = trace.profile(step)
    raw = dict(sd.kept_raw)
    return [(gen.frame(i)[0], raw[i], (gen.frame(i)[1], results[i]))
            for i in keep]


def control_sample(cell, gen: Generator, seconds, sample_rng):
    """The frames a run would check, for the control."""
    return [(gen.frame(i)[0], None, (gen.frame(i)[1], None))
            for i in _keep(cell, len(gen.due(seconds)), sample_rng)]
