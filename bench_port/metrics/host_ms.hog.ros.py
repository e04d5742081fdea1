"""host_ms.hog.ros: host ms a frame in stage 1, the resize ladder and
HOG at B=1 (the port's ``ladder+hog`` spans, one a bucket), over the
traced frames (core/spans.py; the profiler's cost per launch
included)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "ladder+hog")
