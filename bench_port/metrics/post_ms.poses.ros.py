"""post_ms.poses.ros: host ms a frame in the PCA poses (the port's
``post.poses`` span, post/poses.poses_from_part_centers and its sink),
over the traced frames (core/spans.py)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "post.poses")
