"""Profiling and observability (port of
partsbaseddetector_tpu/utils/profiling.py).

The reference has no tracing (SURVEY.md §5: ad-hoc tick prints only).
Here: per-stage wall timers, frame counters, a context manager around
torch.profiler, and the two device views of a detect call that the
port is measured by:

* ``CudaStageTimer``: CUDA events at the detector's ``stage=`` hook
  (infer/detector.StageTimer), device ms per stage of one call;
* ``device_busy``: from a profiler's events, the device kernels' count,
  the union of their intervals (busy), the span from the first to the
  last, the idle share of that span and the kernels that take the most
  device time.  The profiler adds host work per launch, so the idle
  share it shows is an upper bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    best_s: float = float("inf")

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class StageTimer:
    """Accumulating per-stage timer on the host clock.

    >>> timer = StageTimer()
    >>> with timer.stage("detect"):
    ...     out = det.detect_raw(im)
    ...     torch.cuda.synchronize()
    >>> timer.report()

    ``timer.stage`` also fits the detector's ``stage=`` hook; without a
    synchronize inside a stage it times the host's enqueue, not the
    device (CudaStageTimer times the device)."""

    def __init__(self):
        self.stats: Dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s.count += 1
            s.total_s += dt
            s.best_s = min(s.best_s, dt)

    def report(self) -> str:
        lines = [f"{'stage':<20} {'count':>6} {'mean':>10} {'best':>10}"]
        for name, s in sorted(self.stats.items()):
            lines.append(f"{name:<20} {s.count:>6} "
                         f"{s.mean_s * 1e3:>8.2f}ms "
                         f"{s.best_s * 1e3:>8.2f}ms")
        return "\n".join(lines)


class CudaStageTimer:
    """Device ms per stage: a CUDA event pair around each stage entered
    through the detector's ``stage=`` hook, summed by name.  Launch gaps
    inside a stage count toward it.

    >>> timer = CudaStageTimer()
    >>> det.detect_batch_raw(frames, stage=timer.stage)
    >>> timer.totals_ms()        # synchronizes; {"dp": ..., ...}
    """

    def __init__(self):
        if not torch.cuda.is_available():
            raise RuntimeError("CudaStageTimer records CUDA events; no "
                               "CUDA device is available")
        self._pending: List[tuple] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            self._pending.append((name, a, b))

    def totals_ms(self) -> Dict[str, float]:
        """Summed device ms per stage name, in first-entered order."""
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, a, b in self._pending:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """torch.profiler trace of the block, host and (with a card) CUDA
    activity; on exit the Chrome trace is written to
    ``<logdir>/trace.json`` (logdir: default ``pbd_trace`` in the
    temporary directory).  Yields the profiler: ``device_busy(
    prof.events())`` reads its device kernels."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "pbd_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_busy(events, top: int = 8) -> Optional[dict]:
    """Device time of a profiler's events (``prof.events()``): None if
    they hold no device kernel, else {"kernels": count, "busy_ms": the
    union of the kernels' intervals, "span_ms": first start to last end,
    "idle_share": 1 - busy / span, "top": [(name, ms, count)] of the
    ``top`` kernels by device time}."""
    from torch.autograd import DeviceType
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = max(e for _, e in spans) - spans[0][0]
    per_name: Dict[str, list] = {}
    for e in dev:
        d = per_name.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernels": len(dev), "busy_ms": busy / 1e3,
            "span_ms": span / 1e3,
            "idle_share": 1 - busy / span if span > 0 else 0.0,
            "top": [(name, us / 1e3, n) for name, (us, n) in ranked]}


class FrameCounter:
    """Streaming throughput counter (frames/s over a sliding window)."""

    def __init__(self, window: int = 30):
        self.window = window
        self.times = []

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        self.times.append(now)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 2:
            return None
        return (len(self.times) - 1) / (self.times[-1] - self.times[0])
