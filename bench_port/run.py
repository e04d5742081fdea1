#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload person26.batch8 --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout that holds BENCHMARK.json, this folder and
the port (partsbaseddetector_tpu_torch/), on a machine with the CUDA
cards the cell asks for.  It makes the weights and the inputs from the
seed, warms up the cell's own shapes, measures for --seconds, checks a
sample of what the timed path produced against the plain reference,
and prints one JSON line last: the cell's end-to-end metrics with
--trace 0, its per-layer metrics (read from a traced run) with --trace
1.  The numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.  Without a card, or without
the port beside this folder, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "partsbaseddetector_tpu"}


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "partsbaseddetector_tpu_torch").is_dir():
        print(f"run.py: the port, partsbaseddetector_tpu_torch/, is not "
              f"beside {Path(__file__).parent.name}/ in {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    from bench_port.core import runner, spec
    from bench_port.core.host import log
    cell = spec.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    smi = power_limit()
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
               f"{torch.version.cuda}")
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"run.py: loaded after the window: {bad}", file=sys.stderr)
        return 3
    res = out["result"]
    res["device"]["power_limit"] = smi
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in out["checks"].items()}
    for k, (v, lim) in out["checks"].items():
        log(f"check {k} {v} limit {lim}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
