"""peak_mem_gib: torch.cuda.max_memory_allocated() over the warm-up and
the window, after a reset at the start, in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
