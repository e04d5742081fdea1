"""kernels_per_frame: device kernels (memory copies and sets left out)
in the traced sub-window, over its frames (torch.profiler,
core/trace.py)."""

from bench_port.core.trace import kernels_per_frame


def read(run):
    return kernels_per_frame(run.profile)
