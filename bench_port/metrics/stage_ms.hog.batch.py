"""stage_ms.hog.batch: device ms a frame of stage 1, ladder + HOG
(ops/imageops.py, ops/hog.py),
from the port's CudaStageTimer (CUDA events at the detector's stage=
hook, launch gaps included) over every batch of the traced run's window,
divided by its frames."""


def read(run):
    if run.stage_ms is None or "ladder+hog" not in run.stage_ms:
        return None
    return run.stage_ms["ladder+hog"] / run.frames
