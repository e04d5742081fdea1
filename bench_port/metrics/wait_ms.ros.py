"""wait_ms.ros: host ms a frame blocked on the card in the serving
path's wait (the port's ``serve.wait`` span, StreamingDetector.
_materialize's synchronize), over the traced frames (core/spans.py)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "serve.wait")
