"""readbacks_per_frame.ros: device-to-host reads and synchronizes a
frame on the serving path (the port's ``readbacks`` counter: the wait,
the paint NMS's read a step, the fetch's six fields), over the traced
frames (core/spans.py)."""

from bench_port.core.spans import per_frame


def read(run):
    return per_frame(run, "readbacks")
