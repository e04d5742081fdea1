"""readbacks_per_frame.batch: device-to-host reads a frame on the offline
path (the port's ``readbacks`` counter: the fetch's six fields), over
the traced frames (core/spans.py)."""

from bench_port.core.spans import per_frame


def read(run):
    return per_frame(run, "readbacks")
