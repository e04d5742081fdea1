"""post_ms.ros: host ms a frame in StreamingDetector._postprocess (paint
NMS, the fetch of the detections, the mask, 3-D boxes and part centres,
poses), a span taken in the benchmark's subclass over every frame of the
traced run's window."""


def read(run):
    if not run.post_s:
        return None
    return 1e3 * sum(run.post_s) / len(run.post_s)
