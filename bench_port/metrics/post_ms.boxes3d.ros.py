"""post_ms.boxes3d.ros: host ms a frame in the 3-D boxes and part centres
(the port's ``post.boxes3d`` span, post/cloud.compute_bounding_boxes and
its sinks), over the traced frames (core/spans.py)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "post.boxes3d")
