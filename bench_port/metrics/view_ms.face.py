"""view_ms.face: host ms a frame inside the port's ``view`` spans (one a
dp group and view: its DP, seeds, walk and candidates; attributes
component and nparts), over the traced frames (core/spans.py)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "view")
