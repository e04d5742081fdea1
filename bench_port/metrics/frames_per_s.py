"""frames_per_s: frames whose detections reached the host, over the
whole window (from the first batch's send to the last batch's
detections on the host).  Host clock."""


def read(run):
    if not run.window_s:
        return None
    return run.frames / run.window_s
