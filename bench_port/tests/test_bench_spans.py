"""The readers of the port's own spans and counters (core/spans.py): two
traced small runs of each cell in one process give every such metric a
number, and the second run counts none of the first run's spans."""

from __future__ import annotations

import pytest

from bench_port.tests.conftest import run_small, small_cell

METRICS = {
    "person26.ros_rgbd": ["wait_ms.ros", "host_ms.dp.ros", "host_ms.hog.ros",
                          "post_ms.nms.ros", "post_ms.fetch.ros",
                          "post_ms.boxes3d.ros", "post_ms.poses.ros",
                          "readbacks_per_frame.ros"],
    "person26.batch8": ["fetch_ms.batch", "readbacks_per_frame.batch"],
}
#: the spans each traced frame opens once
ONCE = {"person26.ros_rgbd": ("serve.frame", "serve.wait", "post.nms",
                              "fetch"),
        "person26.batch8": ("fetch",)}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_two_traced_runs_read_their_own_spans(name):
    for _ in range(2):
        out = run_small(small_cell(name), trace=True)
        assert out["result"]["correct"], out["checks"]
        got = out["result"]["metrics"]
        assert all(got[m]["value"] > 0 for m in METRICS[name]), got
        run = out["run"]
        rec = run.program_spans
        frames = run.profile["frames"]
        for span in ONCE[name]:
            assert sum(s.name == span for s in rec["spans"]) == frames
        assert rec["dropped"] == 0
    if name == "person26.batch8":
        assert got["readbacks_per_frame.batch"]["value"] == 6.0
