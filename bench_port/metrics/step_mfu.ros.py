"""step_mfu.ros: the share of the card's float32 peak while a frame is
served: the operations a frame needs (counts/detector.py) times the
frames, over the summed detect and post spans of the traced run's
window and 67 TFLOP/s, in %.  Waiting for the camera is left out."""


def read(run):
    if not run.detect_s:
        return None
    busy = sum(run.detect_s) + sum(run.post_s)
    return 100.0 * run.flops_per_frame * len(run.detect_s) / busy \
        / run.peaks.F32_FLOPS
