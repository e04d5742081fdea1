"""setup_s: seconds from the start of the process to the end of the
warm-up (imports, the kernel build or load, weights, inputs, the
detector, one warm-up call).  Host clock."""


def read(run):
    return run.setup_s
