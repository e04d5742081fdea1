"""latency_p95_ms: the 95th percentile over every frame of the window
of the time from the frame's due time on the camera's schedule to its
FrameResult returned.  Host clock."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
