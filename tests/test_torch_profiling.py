"""utils/profiling: the plain-Python timers against the JAX package's,
the detector's stage hook, device_trace on the CPU and device_busy's
interval arithmetic over the traced window (the tracer's spans:
tests/test_torch_tracing.py)."""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.utils import profiling as prof_jax
from partsbaseddetector_tpu_torch.infer.detector import Detector, _dp_groups
from partsbaseddetector_tpu_torch.models import synthetic
from partsbaseddetector_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_stage_timer_like_jax():
    timers = (profiling.StageTimer(), prof_jax.StageTimer())
    for t in timers:
        for name in ("a", "b", "a"):
            with t.stage(name):
                time.sleep(0.002)
    ours, theirs = timers
    assert {k: v.count for k, v in ours.stats.items()} == \
        {k: v.count for k, v in theirs.stats.items()} == {"a": 2, "b": 1}
    s = ours.stats["a"]
    assert 0.004 <= s.total_s and s.best_s <= s.mean_s <= s.total_s
    got, want = ours.report().splitlines(), theirs.report().splitlines()
    assert got[0] == want[0] and len(got) == len(want) == 3
    assert [x.split()[:2] for x in got] == [x.split()[:2] for x in want]
    assert profiling.StageStats().mean_s == 0.0


def test_stage_timer_on_the_detector_hook():
    """StageTimer.stage fits Detector's stage= hook: every stage is
    entered, dp once per dp group and component."""
    m = synthetic.tiny(seed=2)
    det = Detector(m, k_per_level=4, device="cpu")
    timer = profiling.StageTimer()
    frames = np.zeros((2, 48, 56, 3), np.uint8)
    det.detect_batch_raw(frames, stage=timer.stage)
    plan = det.plan_for((48, 56))
    ngroups = sum(len(_dp_groups(b, det.dp_split)) for b in plan.buckets)
    assert set(timer.stats) == {"ladder+hog", "conv", "dp", "walk",
                                "seeds+sort"}
    assert timer.stats["dp"].count == ngroups * len(m.components)
    assert timer.stats["ladder+hog"].count == len(plan.buckets)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.CudaStageTimer()


def test_device_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # no device kernels on the CPU: nothing to measure
    assert profiling.device_busy(prof.events()) is None


def test_device_busy_intervals():
    from torch.autograd import DeviceType

    def ev(name, a, b, dev=DeviceType.CUDA):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(start=a, end=b))
    # us: [0, 100] and [50, 150] overlap, a gap, then [300, 400]; a host
    # event is not a kernel, nor is a span's mirror on the device; the
    # traced window runs from -100 to 900
    events = [
        ev("k1", 0, 100), ev("k2", 50, 150), ev("k1", 300, 400),
        ev("host", 0, 1000, DeviceType.CPU),
        ev("stage:dp", 0, 800), ev(profiling.WINDOW, -100, 900),
        ev(profiling.WINDOW, -100, 900, DeviceType.CPU)]
    got = profiling.device_busy(events)
    assert got["kernels"] == 3
    assert got["busy_ms"] == pytest.approx(0.25)
    assert got["window_ms"] == pytest.approx(1.0)
    assert got["idle_share"] == pytest.approx(1 - 0.25 / 1.0)
    assert got["top"] == [("k1", pytest.approx(0.2), 2),
                          ("k2", pytest.approx(0.1), 1)]
    with pytest.raises(ValueError, match="trace:window"):
        profiling.device_busy(events[:3])
