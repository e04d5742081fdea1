"""step_mfu.batch: the whole detect step's share of the card's float32
peak: the operations a frame needs (counts/detector.py) times the
frames of the traced run's window, over the window's seconds and 67
TFLOP/s, in %."""


def read(run):
    if not run.window_s:
        return None
    return 100.0 * run.flops_per_frame * run.frames / run.window_s \
        / run.peaks.F32_FLOPS
