"""Every cell, configuration, traffic mix and metric of BENCHMARK.json
loads by name, the file keeps to the benchmark's contract, and a new
cell needs only new files and entries."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port.core import spec
from bench_port.tests.conftest import run_small, small_cell

ROOT = spec.BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    drv = spec.driver(c.traffic["kind"])
    assert all(callable(getattr(drv, f)) for f in
               ("make", "build", "drive", "control_sample"))
    assert "limits" in c.workload and "thresh" in c.workload
    assert c.entry["chips"] == 1
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(spec.reader(metric))


def test_an_unknown_traffic_kind_is_refused():
    cell = small_cell("person26.batch8")
    cell.traffic["kind"] = "no_such_kind"
    with pytest.raises(KeyError, match="drivers/no_such_kind.py"):
        run_small(cell)


def test_benchmark_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert NAME.match(m["name"])
    assert "setup_s" in e2e


def test_a_new_cell_takes_only_new_files(tmp_path):
    """A throwaway configuration of two views, a traffic mix of a new
    kind with its driver, a cell and a per-layer metric, added to a copy
    of the benchmark as files and entries, run by the unchanged
    harness."""
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench_dir / "configs" / "person26.json").read_text())
    cfg.update(name="tiny4", nparts=4, nmixtures=2, root_nmixtures=2,
               components=[{}, {"nparts": 4, "nmixtures": 1,
                                "root_nmixtures": 1}])
    (bench_dir / "configs" / "tiny4.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "batch2.json").write_text(json.dumps(
        {"kind": "closed_pairs", "height": 64, "width": 80, "batch": 2,
         "pool": 4}))
    (bench_dir / "drivers" / "closed_pairs.py").write_text(
        '"""A throwaway kind: the closed loop under another name."""\n'
        "from bench_port.core import spec\n"
        "_base = spec.driver('closed_batches')\n"
        "make, build, drive = _base.make, _base.build, _base.drive\n"
        "control_sample = _base.control_sample\n")
    (bench_dir / "workloads" / "tiny4.batch2.json").write_text(json.dumps(
        {"config": "tiny4", "traffic": "batch2", "thresh": 0.0,
         "limits": {"score_gap": 0.001, "off_share": 0.0,
                    "walk_gap": 0.001,
                    "topk_gap": 0.001, "box_mismatch": 0,
                    "order_mismatch": 0}}))
    (bench_dir / "metrics" / "batches.tiny.py").write_text(
        "def read(run):\n    return run.frames / 2\n")
    bench["configs"].append({"name": "tiny4", "source": "a test",
                             "file": "bench_port/configs/tiny4.json",
                             "reduced": ["nparts"], "why": "a test"})
    bench["workloads"].append({"name": "tiny4.batch2", "config": "tiny4",
                               "traffic": "batch2", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "batches.tiny", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "detect step",
                               "moves": "frames_per_s",
                               "workloads": ["tiny4.batch2"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "person26.batch8" in m["workloads"]:
            m["workloads"].append("tiny4.batch2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny4.batch2", bench_dir)
    out = run_small(cell, trace=False, bench_dir=bench_dir)
    assert out["result"]["correct"]
    assert set(out["result"]["metrics"]) == {"setup_s", "frames_per_s"}
    out = run_small(cell, trace=True, bench_dir=bench_dir)
    assert out["result"]["correct"]
    assert out["result"]["metrics"]["batches.tiny"]["value"] >= 1


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "person26.batch8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_where_only_the_benchmark_is(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
