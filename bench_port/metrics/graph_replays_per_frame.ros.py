"""graph_replays_per_frame.ros: replays of the detector's one-frame CUDA
graph a frame on the serving path (the port's ``detect.graph.replays``
counter), over the traced frames (core/spans.py); None where the port
has no such counter."""

from bench_port.core.spans import per_frame


def read(run):
    return per_frame(run, "detect.graph.replays")
