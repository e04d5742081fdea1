"""The port's own spans and counters of a run, for the program_span
readers: the port's tracer (utils/profiling.TRACER) records while a
torch.profiler records, that is over the traced sub-window
(core/trace.profile), and this module takes its store once a run, on
the first reader's call, and clears it, so that two runs in one process
never mix and every reader of a run sees the same records.

Without the tracer (a port that has none) or without a traced
sub-window, ``of`` gives None and every reader gives None.
"""

from __future__ import annotations

from typing import Dict, Optional

_KEY = "program_spans"


def _take() -> Optional[Dict]:
    try:
        from partsbaseddetector_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    if tracer is None or not hasattr(tracer, "self_ns"):
        return None
    out = dict(spans=list(tracer.spans), self_ns=tracer.self_ns(),
               counters=dict(tracer.counters), dropped=tracer.dropped)
    tracer.clear()
    return out


def of(run) -> Optional[Dict]:
    """{"spans", "self_ns", "counters", "dropped"} of the run's traced
    sub-window, or None."""
    if run.profile is None:
        return None
    got = vars(run)
    if _KEY not in got:
        got[_KEY] = _take()
    return got[_KEY]


def ms_per_frame(run, name: str, self_time: bool = False
                 ) -> Optional[float]:
    """Summed ms of the spans ``name`` (their self time with
    ``self_time``) over the traced frames; None without such a span."""
    rec = of(run)
    if rec is None:
        return None
    ns = [own if self_time else s.duration_ns
          for s, own in zip(rec["spans"], rec["self_ns"]) if s.name == name]
    if not ns:
        return None
    return 1e-6 * sum(ns) / run.profile["frames"]


def per_frame(run, counter: str) -> Optional[float]:
    """A counter over the traced frames; None without the counter."""
    rec = of(run)
    if rec is None or counter not in rec["counters"]:
        return None
    return rec["counters"][counter] / run.profile["frames"]
