"""stage_ms.dp.batch: device ms a frame of stage 3, the part-tree DP
(ops/dp.py, ops/dt.py),
from the port's CudaStageTimer (CUDA events at the detector's stage=
hook, launch gaps included) over every batch of the traced run's window,
divided by its frames."""


def read(run):
    if run.stage_ms is None or "dp" not in run.stage_ms:
        return None
    return run.stage_ms["dp"] / run.frames
