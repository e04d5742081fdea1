"""fetch_ms.batch: host ms a frame fetching its detections to the host
(the port's ``fetch`` span, Detector.candidates_to_detections, one a
frame of each batch), over the traced frames (core/spans.py)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "fetch")
