"""post_ms.nms.ros: host ms a frame in the serving path's paint NMS (the
port's ``post.nms`` span, ops/nms.paint_nms, a read back a step), over
the traced frames (core/spans.py)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "post.nms")
