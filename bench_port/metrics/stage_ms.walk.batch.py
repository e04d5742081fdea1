"""stage_ms.walk.batch: device ms a frame of stage 4, root seeds, the
walk and the sort (ops/argmax.py, ops/walk.py): the "seeds+sort" and
"walk" stages of the port's CudaStageTimer over the traced run's window,
divided by its frames."""


def read(run):
    if run.stage_ms is None or "walk" not in run.stage_ms:
        return None
    return (run.stage_ms["walk"] + run.stage_ms.get("seeds+sort", 0.0)) \
        / run.frames
