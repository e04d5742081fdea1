#!/usr/bin/env python3
"""The readings a cell's limits are set from: the numbers the check
compares, for sound runs on many seeds and for the control (the
reference in TF32 in the port's place) on a few, in one process.

    python3 bench_port/tools/readings.py --workload person26.batch8 \\
        --first 1000 --seeds 12 --control-seeds 3 --seconds 3

One JSON line a run, then for each number the largest sound reading
(the lower end of its limit) and the smallest control reading (the
upper end).  Needs the cell's card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench_port.core import runner, spec
    if not torch.cuda.is_available():
        print("readings.py: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    sound, control = {}, {}
    runs = [(args.first + i, False) for i in range(args.seeds)] + \
        [(args.first + 10_000 + i, True) for i in range(args.control_seeds)]
    for seed, ctl in runs:
        t0 = time.perf_counter()
        out = runner.run(cell, seed, args.seconds, False, "cuda", t0,
                         control=ctl)
        nums = {k: v for k, (v, _) in out["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": ctl, "correct":
                          out["result"]["correct"], "numbers": nums,
                          "s": time.perf_counter() - t0}), flush=True)
        acc = control if ctl else sound
        for k, v in nums.items():
            acc.setdefault(k, []).append(v)
    print(json.dumps({"workload": args.workload, "summary": {
        k: {"sound_max": max(sound.get(k, [0.0])),
            "control_min": min(control.get(k, [float("nan")])),
            "sound": sound.get(k), "control": control.get(k)}
        for k in sound}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
