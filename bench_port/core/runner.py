"""One run of one cell: set-up, warm-up, the measured window, the
traced sub-window, the check against the reference, the metrics.

What belongs to a kind of traffic (its generator, the system it builds,
its entry call, its window and the sample it checks) is the driver
``drivers/<kind>.py``, found by the ``kind`` of the cell's traffic
file.

``run`` takes the device it is given; ``run.py`` gives it the card and
refuses to run without one.  The tests give it the CPU at small sizes,
a ``wrap`` that breaks the timed path, or ``control=True``, which puts
the reference in TF32 in the program's place.
"""

from __future__ import annotations

import gc
import time
import types
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bench_port.core import peaks, spec, trace, weights
from bench_port.core.host import log
from bench_port.core.seeds import numpy_rng
from bench_port.counts.detector import flops_per_frame
from bench_port.counts.walk import walk_bytes
from bench_port.reference import detect as ref
from bench_port.reference import post as ref_post


def ref_model(arrays: Dict, cfg: Dict, thresh: float) -> ref.Model:
    return ref.Model(trees=arrays["trees"], filters=arrays["filters"],
                     defw=arrays["defw"], anchors=arrays["anchors"],
                     biasw=arrays["biasw"],
                     binsize=cfg["binsize"], interval=cfg["interval"],
                     norient=cfg["norient"], flen=cfg["flen"],
                     thresh=thresh)


#: counts summed over the judged frames; every other number is a worst case
SUMMED = ("off_scores", "scores", "box_mismatch", "order_mismatch",
          "nms_mismatch", "mask_mismatch")


def _worst(acc: Dict[str, float], got: Dict[str, float]) -> None:
    for k, v in got.items():
        if k in SUMMED:
            acc[k] = acc.get(k, 0.0) + float(v)
        else:
            acc[k] = max(acc.get(k, 0.0), float(v))


def _numbers(acc: Dict[str, float]) -> Dict[str, float]:
    """The compared numbers: off_share, the share of judged scores more
    than rounding off, in place of its two counts."""
    out = dict(acc)
    n = out.pop("scores")
    out["off_share"] = out.pop("off_scores") / n if n else 0.0
    return out


def _prune_args(tp: Dict):
    p = tp.get("depth_prune")
    return None if p is None else (p["part_width_m"], p["fx"], p["tol"])


# ----------------------------------------------------------------- check
def _judge(cell, model: ref.Model, sample, dev, tf32_outputs=False):
    """The compared numbers of the sampled frames: (frame, detector
    output, serving extras) each; with tf32_outputs the outputs are the
    control's, made here."""
    tp, cfg = cell.traffic, cell.config
    k = cfg["k_per_level"]
    prune = _prune_args(tp)
    out: Dict[str, float] = {}
    for frame, dets, serve in sample:
        img = torch.as_tensor(frame, device=dev)
        depth = None if serve is None else torch.as_tensor(serve[0],
                                                           device=dev)
        levels, maps = ref.frame_maps(img, model, False, depth, prune)
        if tf32_outputs:
            _, cmaps = ref.frame_maps(img, model, True, depth, prune)
            dets = ref.candidates(levels, cmaps, model, k, model.thresh)
            del cmaps
            if serve is not None:
                got = ref_post.serve(dets, frame.shape[:2], serve[0],
                                     _camera(frame), tp["max_overlap"],
                                     tp["max_candidates"], np.float32)
                serve = (serve[0], _as_served(dets, got))
        _worst(out, ref.judge(levels, maps, model, dets, k, model.thresh))
        if serve is not None:
            _worst(out, ref_post.judge_post(
                dets, serve[1], frame.shape[:2], serve[0], _camera(frame),
                tp["max_overlap"], tp["max_candidates"]))
        del maps
    return _numbers(out)


def _camera(frame):
    from bench_port.core.scene import kinect_camera
    return kinect_camera(frame.shape[:2])


def _as_served(dets, got) -> Dict:
    kept = got["kept"]
    return dict(kept_level=[dets["level"][i] for i in kept],
                kept_loc=[dets["loc"][i] for i in kept],
                kept_score=[dets["score"][i] for i in kept],
                mask=got["mask"], boxes3d=got["boxes3d"],
                centres=got["centres"], poses=got["poses"])


def _walk_bytes(cell, model, frames, dev) -> int:
    k = cell.config["k_per_level"]
    total = 0
    for frame in frames:
        levels, maps = ref.frame_maps(torch.as_tensor(frame, device=dev),
                                      model)
        for tree, tmaps in zip(model.components, maps):
            locs = [ref.walk(m, tree, k)[0].cpu().numpy() for m in tmaps]
            total += walk_bytes([lvl.featsize for lvl in levels], locs,
                                tree.parent, tree.nmix)
    return total


# ------------------------------------------------------------------- run
def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
        device, t_start: float, *, control: bool = False,
        wrap: Optional[Callable] = None, bench_dir=spec.BENCH_DIR) -> Dict:
    """One run; returns {"result": the result line's object, "checks":
    {name: (value, limit)}, "run": what the metric readers read}."""
    dev = torch.device(device)
    cfg, tp, wl = cell.config, cell.traffic, cell.workload
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver = spec.driver(tp["kind"], bench_dir)
    arrays = weights.model_arrays(cfg, seed, dev)
    gen = driver.make(tp, wl, seed, dev)
    sample_rng = numpy_rng(seed, "sample")
    run = types.SimpleNamespace(
        cell=cell, setup_s=None, window_s=None, frames=0,
        attempted=0, latencies_s=None, late_s=None, detect_s=None, post_s=None,
        stage_ms=None, profile=None, profiled_frames=None, walk_bytes=None,
        peak_bytes=0, flops_per_frame=flops_per_frame(
            cfg, gen.shape, arrays["trees"]),
        peaks=peaks)
    model = ref_model(arrays, cfg, wl["thresh"])
    if control:
        sample = driver.control_sample(cell, gen, seconds, sample_rng)
        numbers = _judge(cell, model, sample, dev, tf32_outputs=True)
    else:
        det = driver.build(cell, arrays, dev)
        if wrap is not None:
            det = wrap(det)
        sample = driver.drive(cell, gen, det, dev, seconds, trace_on,
                              t_start, sample_rng, run)
        del det
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers = _judge(cell, model, sample, dev)
        if run.profiled_frames is not None:
            run.walk_bytes = _walk_bytes(cell, model, run.profiled_frames,
                                         dev)
        log(f"check: {len(sample)} frames against the reference in "
            f"{time.perf_counter() - t0} s")
    limits = wl["limits"]
    checks = {k: (v, limits.get(k)) for k, v in numbers.items()}
    correct = all(lim is not None and v <= lim
                  for v, lim in checks.values())
    metrics = {}
    names = cell.per_layer if trace_on else cell.end_to_end
    if not control:
        for m in names:
            v = spec.reader(m["name"], bench_dir)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": 0, "metrics": metrics,
              "device": _device(dev, run, trace_on)}
    if trace_on and run.profile is not None:
        result["breakdown"] = {
            "device_ops": trace.top(run.profile["kernel_s"]),
            "idle_gaps": trace.top(run.profile["idle_s"])}
    return {"result": result, "checks": checks, "run": run}


def _device(dev, run, trace_on) -> Dict:
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu",
           "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    if trace_on and run.profile is not None:
        out["busy_s"] = run.profile["busy_s"]
        out["window_s"] = run.profile["window_s"]
    return out
