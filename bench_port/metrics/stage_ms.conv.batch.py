"""stage_ms.conv.batch: device ms a frame of stage 2, the filter-bank
conv (ops/conv.py),
from the port's CudaStageTimer (CUDA events at the detector's stage=
hook, launch gaps included) over every batch of the traced run's window,
divided by its frames."""


def read(run):
    if run.stage_ms is None or "conv" not in run.stage_ms:
        return None
    return run.stage_ms["conv"] / run.frames
