"""Profiling and observability (port of
partsbaseddetector_tpu/utils/profiling.py).

The reference has no tracing (SURVEY.md §5: ad-hoc tick prints only).
Here the port has one tracer and the device views it is measured by:

* ``StageTimer``: spans, counters and per-name stats.  A span is a
  name, start and end (``time.time_ns()``, the clock torch.profiler
  stamps its events with), the index of its parent span, the id of the
  root call it belongs to and a few attributes; its self time is its
  duration less what its child spans cover.  Spans go to a bounded
  in-memory store (``capacity``; later spans are dropped and counted in
  ``dropped``).  While a torch.profiler records, each span is also a
  ``record_function`` range, ``stage:<name>`` for a detector stage and
  ``span:<name>`` for the rest, so it sits on the profiler's timeline
  beside the kernels it launched.
* ``TRACER``: the process-wide StageTimer the port's own spans and
  counters go to.  ``span``, ``stage`` and ``count`` record into it
  while it is on, inside ``with tracing():`` or while a torch.profiler
  records; off, ``span`` and ``stage`` return the shared ``NULL_SPAN``
  and ``count`` returns after one check.  ``stage`` is the detector's
  default ``stage=`` hook.

  Spans: ``detect.call`` (a detector call; ``upload``, the frames',
  depths' and masks' copy to the device; ``prune``, the depth pruning;
  the stages ``ladder+hog`` and ``conv``; ``view`` (attributes
  component and nparts), one a dp group and component, around that
  pass's stages ``dp`` (attributes bucket, its first pyramid level, the
  group's levels lo..hi-1 in it and component), ``seeds+sort`` and
  ``walk``; the final ``seeds+sort``; or, in their place, ``detect.graph``,
  a replay of the one-frame CUDA graph, infer/detector.FrameGraph, whose
  program's spans record once, at its capture), ``fetch``
  (Detector.candidates_to_detections), and on the serving path
  (infer/stream.py) ``serve.frame`` (attributes seq, the frame's number
  in the stream, and frame, its index in the batch), ``serve.wait``
  (the host blocked on the device) and ``post.nms``, ``post.overlay``,
  ``post.mask``, ``post.boxes3d``, ``post.clusters``, ``post.poses``.
  Counters: ``readbacks`` (device-to-host reads and synchronizes that
  stall the launch queue: paint/part NMS's two reads a step, the six
  fields a fetch reads, the serving wait, the walk's read of a
  ``parent`` given on the device, the 3-D boxes' one read a frame),
  ``boxes3d.dets`` and ``boxes3d.samples`` (the detections of a
  post/cloud.compute_bounding_boxes call, and the depth samples of
  their z-extents), ``walk.launches`` (launches of
  the walk kernel), ``dp.launches`` (launches of the DP kernel,
  csrc/dp.cu: two a depth of the tree a (group, component) call, two a
  part on the filter-keyed DP of shared filter ids), ``views`` (one a
  (dp group, component) pass), ``parts.padded`` (the part rows a
  pass pads: its candidates times the model's most parts less the
  component's, ops/argmax._walked_candidates), and
  ``detect.graph.captures`` and ``detect.graph.replays`` (the one-frame
  CUDA graph's captures and replays; a call that captures also replays,
  and the launch counters count a graph's launches once, at its
  capture).
* ``CudaStageTimer``: CUDA events at the detector's ``stage=`` hook,
  device ms per stage of one call;
* ``device_trace`` and ``device_busy``: a torch.profiler trace of a
  block, and from its events the device kernels' count, the union of
  their intervals (busy), the traced wall window, the idle share of
  that window and the kernels that take the most device time.  The
  profiler adds host work per launch, so the idle share it shows is an
  upper bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: record_function prefixes: a detector stage, any other span, and the
#: traced window of device_trace.  torch.profiler mirrors a range on the
#: device's timeline; device_busy drops the mirrors of these three.
STAGE = "stage:"
SPAN = "span:"
WINDOW = "trace:window"

#: spans TRACER keeps until it is cleared: about 16 MB (250 bytes a span,
#: 470 with attributes), some 7 minutes of the B=1 serving path (113
#: spans a frame at 1.36 Hz)
CAPACITY = 1 << 16


@dataclasses.dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    best_s: float = float("inf")

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Span:
    """One span: times in ns on ``time.time_ns()``'s clock (``end_ns``
    is None while it is open), ``parent`` its parent's index in the
    store (-1 for a root), ``root`` the id of its root call, ``attrs``
    a dict or None."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "root", "attrs",
                 "index")

    def __init__(self, name, parent, root, attrs):
        self.name = name
        self.parent = parent
        self.root = root
        self.attrs = attrs
        self.index = -1
        self.end_ns = None
        self.start_ns = 0

    @property
    def duration_ns(self) -> int:
        return 0 if self.end_ns is None else self.end_ns - self.start_ns

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_ns} ns, parent "
                f"{self.parent}, root {self.root}, {self.attrs})")


class _Open:
    """The context of one span of a StageTimer.

    Under a torch.profiler the span's stamps are taken right inside its
    record_function range, with every allocation of the span's own
    bookkeeping before the range opens or after it closes, and Python's
    cyclic garbage collector held off between a range's edge and the
    stamp beside it: a collection that an allocation starts there (tens
    of milliseconds on a large heap) would put the two clocks' records
    of one edge that far apart."""

    __slots__ = ("timer", "name", "prefix", "attrs", "span", "mark")

    def __init__(self, timer, name, prefix, attrs):
        self.timer, self.name, self.prefix = timer, name, prefix
        self.attrs = attrs
        self.mark = None

    def __enter__(self) -> Span:
        s = self.span = self.timer._open(self.name, self.attrs)
        if _autograd_profiler._is_profiler_enabled:
            self.mark = torch.profiler.record_function(self.prefix
                                                       + self.name)
            with gc_held():
                self.mark.__enter__()
                s.start_ns = time.time_ns()
        else:
            s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc):
        s = self.span
        if self.mark is None:
            s.end_ns = time.time_ns()
        else:
            with gc_held():
                s.end_ns = time.time_ns()
                self.mark.__exit__(*exc)
        self.timer._close(s)
        return False


@contextlib.contextmanager
def gc_held():
    """Python's cyclic garbage collector off for the block, if it was
    on."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class StageTimer:
    """Spans, counters and per-name stats on the host clock.

    >>> timer = StageTimer()
    >>> with timer.stage("detect"):
    ...     out = det.detect_raw(im)
    ...     torch.cuda.synchronize()
    >>> timer.report()

    ``timer.stage`` also fits the detector's ``stage=`` hook; without a
    synchronize inside a stage it times the host's enqueue, not the
    device (CudaStageTimer times the device).  ``span`` is ``stage``
    under another profiler prefix; both take a dict of attributes.
    Spans nest per thread.  Clear between calls, not inside one."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self.stats: Dict[str, StageStats] = defaultdict(StageStats)
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self._roots = itertools.count()
        self._local = threading.local()

    def stage(self, name: str, attrs: Optional[dict] = None):
        return _Open(self, name, STAGE, attrs)

    def span(self, name: str, attrs: Optional[dict] = None):
        return _Open(self, name, SPAN, attrs)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _open(self, name: str, attrs) -> Span:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        if stack:
            top = stack[-1]
            s = Span(name, top.index, top.root, attrs)
        else:
            s = Span(name, -1, next(self._roots), attrs)
        if len(self.spans) < self.capacity:
            s.index = len(self.spans)
            self.spans.append(s)
        else:
            self.dropped += 1
        stack.append(s)
        return s

    def _close(self, s: Span) -> None:
        """Book a span whose end _Open has stamped."""
        self._local.stack.pop()
        dt = (s.end_ns - s.start_ns) * 1e-9
        st = self.stats[s.name]
        st.count += 1
        st.total_s += dt
        st.best_s = min(st.best_s, dt)

    def self_ns(self) -> List[int]:
        """Each stored span's self time, ns: its duration less its
        children's (they nest on one thread, so they do not overlap)."""
        out = [s.duration_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.duration_ns
        return out

    def self_ms(self) -> Dict[str, float]:
        """Summed self time of the stored spans by name, ms."""
        out: Dict[str, float] = {}
        for s, ns in zip(self.spans, self.self_ns()):
            out[s.name] = out.get(s.name, 0.0) + ns * 1e-6
        return out

    def clear(self) -> None:
        """Forget every span, counter and stat."""
        self.stats.clear()
        self.spans = []
        self.counters = {}
        self.dropped = 0

    def report(self) -> str:
        lines = [f"{'stage':<20} {'count':>6} {'mean':>10} {'best':>10}"]
        for name, s in sorted(self.stats.items()):
            lines.append(f"{name:<20} {s.count:>6} "
                         f"{s.mean_s * 1e3:>8.2f}ms "
                         f"{s.best_s * 1e3:>8.2f}ms")
        return "\n".join(lines)


#: the port's process-wide tracer
TRACER = StageTimer()
#: what span and stage return while TRACER is off
NULL_SPAN = contextlib.nullcontext()
_tracing = 0


def span(name: str, attrs: Optional[dict] = None):
    """A span of TRACER around a block, or NULL_SPAN while it is off."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return NULL_SPAN
    return _Open(TRACER, name, SPAN, attrs)


def stage(name: str, attrs: Optional[dict] = None):
    """A detector stage's span of TRACER (the ``stage=`` hook's
    default), or NULL_SPAN while it is off."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return NULL_SPAN
    return _Open(TRACER, name, STAGE, attrs)


def count(name: str, n: int = 1) -> None:
    """Add n to TRACER's counter ``name`` while it is on."""
    if _tracing or _autograd_profiler._is_profiler_enabled:
        TRACER.count(name, n)


@contextlib.contextmanager
def tracing():
    """TRACER on for the block, from an empty store (an inner block
    keeps the outer one's); yields it.

    >>> with profiling.tracing() as t:
    ...     node.spin()
    >>> print(t.report()); t.counters["readbacks"]; t.self_ms()
    """
    global _tracing
    if not _tracing:
        TRACER.clear()
    _tracing += 1
    try:
        yield TRACER
    finally:
        _tracing -= 1


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
    activity, the block inside a ``trace:window`` range with the device
    synchronized on both sides; on exit the Chrome trace, TRACER's spans
    included, is written to ``<logdir>/trace.json`` (logdir: default
    ``pbd_trace`` in the temporary directory).  Yields the profiler:
    ``device_busy(prof.events())`` reads its device kernels."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "pbd_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield prof
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_busy(events, top: int = 8) -> Optional[dict]:
    """Device time of a device_trace's events (``prof.events()``): None
    if they hold no device kernel, else {"kernels": count, "busy_ms":
    the union of the kernels' intervals, "window_ms": the traced wall
    window (the ``trace:window`` range), "idle_share": 1 - busy /
    window, "top": [(name, ms, count)] of the ``top`` kernels by device
    time}.  The device mirrors of ``stage:``, ``span:`` and the window's
    range are no kernels."""
    from torch.autograd import DeviceType
    marks = (STAGE, SPAN, WINDOW)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(marks)]
    if not dev:
        return None
    window = [e.time_range for e in events
              if e.device_type == DeviceType.CPU and e.name == WINDOW]
    if not window:
        raise ValueError(f"no {WINDOW!r} range among the events: trace "
                         "the block with device_trace()")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    wall = window[0].end - window[0].start
    per_name: Dict[str, list] = {}
    for e in dev:
        d = per_name.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernels": len(dev), "busy_ms": busy / 1e3,
            "window_ms": wall / 1e3,
            "idle_share": 1 - busy / wall if wall > 0 else 0.0,
            "top": [(name, us / 1e3, n) for name, (us, n) in ranked]}
