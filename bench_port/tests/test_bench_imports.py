"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
package's harness: by its sources, and by the modules a run loads."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from bench_port.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "partsbaseddetector_tpu", "bench",
             "chip_smoke", "tools"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if path.name == "test_bench_imports.py":
            continue
        text = path.read_text()
        for name in ("BENCH_r0", "MULTICHIP_r0", "BASELINE.json"):
            assert name not in text, (path, name)


def test_a_run_loads_no_jax():
    code = textwrap.dedent("""
        import sys, time
        sys.path.insert(0, %r)
        from bench_port.tests.conftest import small_cell, run_small
        from bench_port import run
        out = run_small(small_cell("person26.batch8", nparts=3,
                                   shape=(64, 80)))
        assert out["result"]["correct"]
        print(sorted({m.split(".")[0] for m in sys.modules}))
        print(run.loaded_forbidden())
    """ % str(spec.BENCH_DIR.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "partsbaseddetector_tpu_torch" in loaded
