#!/usr/bin/env python3
"""The open loop's rate sweep: one process serves a camera cell at each
rate for --seconds and reports the frames, the latency tail and how far
behind its schedule each frame started.  The knee is the highest rate
whose lag does not grow over the window; the cell runs at four fifths
of it.

    python3 bench_port/tools/sweep.py --workload person26.ros_rgbd \\
        --seed 5 --seconds 30 --rates 1.2 1.4 1.6 1.8
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench_port.core import runner, spec
    if not torch.cuda.is_available():
        print("sweep.py: needs a CUDA card", file=sys.stderr)
        return 2
    for rate in args.rates:
        cell = spec.load_cell(args.workload)
        cell.workload["rate_hz"] = rate
        out = runner.run(cell, args.seed, args.seconds, False, "cuda",
                         time.perf_counter())
        run = out["run"]
        lat = np.asarray(run.latencies_s) * 1e3
        late = np.asarray(run.late_s) * 1e3
        q = max(1, len(late) // 4)
        print(json.dumps({
            "rate_hz": rate, "frames": len(lat),
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "service_ms": 1e3 * float(np.mean(np.asarray(run.detect_s)
                                              + np.asarray(run.post_s))),
            "lag_first_quarter_ms": float(late[:q].mean()),
            "lag_last_quarter_ms": float(late[-q:].mean()),
            "correct": out["result"]["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
