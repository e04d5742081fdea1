"""The work counts behind step_mfu, pinned at 640x480, and the walk's
byte count on a hand-made case."""

from __future__ import annotations

import json

import numpy as np

from bench_port.core import spec
from bench_port.counts.detector import flops_per_frame
from bench_port.counts.walk import walk_bytes
from bench_port.reference.plan import pyramid


def _config(name):
    return json.loads((spec.BENCH_DIR / "configs"
                       / f"{name}.json").read_text())


def test_flops_per_frame_at_640x480():
    cfg = _config("person26")
    plan = pyramid((480, 640), cfg["binsize"], cfg["interval"])
    assert len(plan) == 46
    cells = sum(l.featsize[0] * l.featsize[1] for l in plan)
    assert cells == 140725
    P, K, K0 = cfg["nparts"], cfg["nmixtures"], cfg["root_nmixtures"]
    chain = ([-1] + list(range(P - 1)), [K0] + [K] * (P - 1))
    flops = flops_per_frame(cfg, (480, 640), [chain])
    assert flops == 35738802450.0
    # the correlation is most of it: F filters x 800 taps x 2
    nf = K0 + K * (P - 1)
    assert flops > cells * nf * 800 * 2 > 0.95 * flops


def test_flops_per_frame_sums_the_components():
    cfg = _config("person26")
    a = ([-1, 0, 1, 1], [2, 3, 3, 3])
    b = ([-1, 0, 0], [1, 1, 1])
    one = [flops_per_frame(cfg, (120, 160), [t]) for t in (a, b)]
    assert flops_per_frame(cfg, (120, 160), [a, b]) == sum(one)
    assert one[0] > one[1] > 0


def test_walk_bytes_counts_each_line_once():
    # one level 4 x 5, parts 0 <- 1, 2 mixtures; two seeds at the same
    # parent x read the same mixture columns once
    loc = np.array([[[1, 1, 0], [2, 3, 1]],
                    [[1, 2, 0], [2, 0, 1]]])
    got = walk_bytes([(4, 5)], [loc], [-1, 0], [1, 2])
    cols = 2 + 1             # mixtures 0, 1 at x = 1; mixture 1 at x = 2
    rows = 2                 # mixture 1 at y = 1 and y = 2
    assert got == (cols * 4 + rows * 5) * 4 + 3 * 2 * 4 + 3 * 2 * 2 * 4
