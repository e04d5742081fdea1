"""post_ms.fetch.ros: host ms a frame fetching the kept detections to
the host (the port's ``fetch`` span, Detector.candidates_to_detections,
six reads back), over the traced frames (core/spans.py)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "fetch")
