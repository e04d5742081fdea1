"""A cell's files, found by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic; ``configs/<config>.json``,
``traffic/<mix>.json`` and ``workloads/<cell>.json`` hold their
parameters, ``drivers/<kind>.py`` the driver of each kind of traffic
(the ``kind`` of a traffic file) and ``metrics/<metric>.py`` the reader
of each metric.
Adding any of them takes a new file and a new entry, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict          # the cell's entry in BENCHMARK.json
    workload: Dict       # workloads/<cell>.json
    config: Dict         # configs/<config>.json
    traffic: Dict        # traffic/<mix>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = _json(bench_dir.parent / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(entries)}")
    entry = entries[name]
    workload = _json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    config = _json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, entry, workload, config, traffic,
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name))


def _module(folder: str, name: str, bench_dir: Path):
    path = bench_dir / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py in {bench_dir}")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read(run) -> float | None`` of metrics/<metric>.py."""
    return _module("metrics", metric, bench_dir).read


def driver(kind: str, bench_dir: Path = BENCH_DIR):
    """drivers/<kind>.py, the driver of a kind of traffic: ``make``
    (the generator), ``build`` (the system under test), ``drive`` (the
    warm-up, the window and the traced steps; returns the sample to
    check) and ``control_sample``."""
    return _module("drivers", kind, bench_dir)
