"""detect_ms.ros: host ms a frame from StreamingDetector.process's start
to its post stage (the dispatch of detect_raw at B=1 and the fetch that
waits for it), a span taken in the benchmark's subclass over every
frame of the traced run's window."""


def read(run):
    if not run.detect_s:
        return None
    return 1e3 * sum(run.detect_s) / len(run.detect_s)
