"""views_per_frame.face: (dp group, view) passes a frame (the port's
``views`` counter, one a pass of a view's DP, seeds and walk over a dp
group), over the traced frames (core/spans.py)."""

from bench_port.core.spans import per_frame


def read(run):
    return per_frame(run, "views")
