"""host_ms.dp.ros: host ms a frame in stage 3, the part-tree DP at B=1:
the self time of the port's ``dp`` spans (the host's enqueue of the DP's
launches, one span a dp group and component), over the traced frames
(core/spans.py; the profiler's cost per launch included)."""

from bench_port.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "dp", self_time=True)
