"""padded_rows_per_frame.face: part rows padded a frame (the port's
``parts.padded`` counter: a view's candidates times the model's most
parts less the view's parts, rows that hold loc -1 and boxes 0), over
the traced frames (core/spans.py)."""

from bench_port.core.spans import per_frame


def read(run):
    return per_frame(run, "parts.padded")
