"""The traced sub-window: torch.profiler over a few steady steps after
the measured window (the drivers give the steps), its events kept in
memory and reduced here, and the arithmetic of the device metrics that
several cells' readers share.

``union_s`` is the arithmetic of the port's utils/profiling.device_busy
(frozen): the union of the device operations' intervals.  Unlike it, the
idle share is taken over the traced wall window, from before the first
operation to after the last, not over the span between them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

STAGE = "stage:"
SPAN = "span:"
WINDOW = "trace:window"
OURS = (STAGE, SPAN, WINDOW)


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) ns intervals."""
    if not intervals:
        return 0.0
    spans = sorted(intervals)
    busy, cs, ce = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > ce:
            busy += ce - cs
            cs, ce = s0, e0
        else:
            ce = max(ce, e0)
    return (busy + ce - cs) * 1e-9


def _merged(intervals):
    out: List[List[float]] = []
    for s0, e0 in sorted(intervals):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return out


def profile(step: Callable[[], int]) -> Dict:
    """Run ``step`` (which returns the frames it served) under the
    profiler, with the device synchronized on both sides; reduce the
    events: the traced wall window, device busy seconds, device kernels
    (memory copies and sets excluded), seconds by kernel name, and idle
    seconds by the stage or span the host was in."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            frames = step()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, marks, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(OURS) and \
                ev.device_type() == torch.autograd.DeviceType.CUDA:
            continue            # our marks, mirrored on the device
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((name, ev.start_ns(), ev.end_ns()))
        elif name == WINDOW:
            window = (ev.start_ns(), ev.end_ns())
        elif name.startswith((STAGE, SPAN)):
            marks.append((name.split(":", 1)[1], ev.start_ns(),
                          ev.end_ns()))
    kernels = [d for d in dev if not d[0].startswith(("Memcpy", "Memset"))]
    by_name: Dict[str, float] = {}
    for name, s0, e0 in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0) * 1e-9
    idle: Dict[str, float] = {}
    if dev and window is not None:
        merged = _merged([(s0, e0) for _, s0, e0 in dev])
        edges = [window[0]] + [x for m in merged for x in m] + [window[1]]
        marks.sort(key=lambda m: m[1])
        nxt, active = 0, []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            while nxt < len(marks) and marks[nxt][1] <= mid:
                active.append(marks[nxt])
                nxt += 1
            active = [m for m in active if m[2] >= mid]
            # the innermost stage or span the host was in
            label = min(active, key=lambda m: m[2] - m[1])[0] if active \
                else "host"
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return dict(frames=frames, window_s=window_s,
                busy_s=union_s([(s0, e0) for _, s0, e0 in dev]),
                kernels=len(kernels), kernel_s=by_name, idle_s=idle)


def top(d: Dict[str, float], n: int = 10, width: int = 160) -> List[list]:
    """The n largest entries, names cut to ``width`` characters."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def idle_pct(prof) -> Optional[float]:
    """The share of the traced wall window in which no device operation
    ran, in %; None without a trace or a device operation."""
    if prof is None or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def kernels_per_frame(prof) -> Optional[float]:
    """Device kernels (memory copies and sets left out) in the traced
    window over its frames; None without a trace or a kernel."""
    if prof is None or not prof["kernels"]:
        return None
    return prof["kernels"] / prof["frames"]
