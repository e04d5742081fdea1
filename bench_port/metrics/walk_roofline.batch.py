"""walk_roofline.batch: the walk kernel (csrc/walk.cu) against its
bytes bound.  The bytes the walks of the profiled batches need
(counts/walk.py, from the reference's own walk of the same frames) at
the HBM peak, over the device time of every walk kernel launch in the
profiled batches (torch.profiler), in %."""

WALK_KERNEL = "walk_tree_kernel"


def read(run):
    prof = run.profile
    if prof is None or not run.walk_bytes:
        return None
    t = sum(s for name, s in prof["kernel_s"].items()
            if WALK_KERNEL in name)
    if t <= 0:
        return None
    return 100.0 * run.walk_bytes / run.peaks.HBM_BYTES_PER_S / t
