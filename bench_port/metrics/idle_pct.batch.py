"""idle_pct: the share of the traced sub-window's wall time in which no
device operation ran (torch.profiler; the union of the operations'
intervals, core/trace.py), in %."""

from bench_port.core.trace import idle_pct


def read(run):
    return idle_pct(run.profile)
