"""The generators and the weights are deterministic in the seed, and
every seed gets the same sizes and schedule."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from bench_port.core import spec, weights
from bench_port.tests.conftest import small_cell

SEED = 2**31 + 12345


def _make(tp, cell_params, seed):
    return spec.driver(tp["kind"]).make(tp, cell_params, seed, "cpu")


def _batches(gen, n=5):
    return [b.tolist() for b in itertools.islice(gen.batches(), n)]


def test_closed_batches_repeat_with_the_seed():
    tp = small_cell("person26.batch8").traffic
    a, b = (_make(tp, {}, SEED) for _ in range(2))
    c = _make(tp, {}, SEED + 1)
    assert np.array_equal(a.pool, b.pool) and _batches(a) == _batches(b)
    assert not np.array_equal(a.pool, c.pool)
    assert a.pool.shape == c.pool.shape and a.pool.dtype == np.uint8
    for idx in itertools.islice(c.batches(), 20):
        assert len(set(idx.tolist())) == tp["batch"]


def test_open_camera_repeats_with_the_seed():
    cell = small_cell("person26.ros_rgbd")
    a, b = (_make(cell.traffic, cell.workload, SEED)
            for _ in range(2))
    c = _make(cell.traffic, cell.workload, SEED + 7)
    assert a.due(3.0) == c.due(3.0) == [i / 4.0 for i in range(12)]
    for i in range(5):
        for x, y in zip(a.frame(i), b.frame(i)):
            assert np.array_equal(x, y)
    assert not np.array_equal(a.frame(0)[0], c.frame(0)[0])
    rgb, depth, cloud = a.frame(0)
    assert rgb.dtype == np.uint8 and depth.dtype == np.float32
    assert cloud.shape == rgb.shape and (depth > 1.1).all()


def test_weights_repeat_with_the_seed():
    cfg = small_cell("person26.batch8").config
    a, b = (weights.model_arrays(cfg, SEED, "cpu") for _ in range(2))
    c = weights.model_arrays(cfg, SEED + 1, "cpu")
    for k in ("filters", "defw", "anchors", "biasw"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert a["trees"] == b["trees"] and len(a["trees"]) == 1
    parent, nmix = a["trees"][0]
    assert all(0 <= parent[p] < p for p in range(1, cfg["nparts"]))
    assert nmix == [cfg["root_nmixtures"]] + [cfg["nmixtures"]] * (
        cfg["nparts"] - 1)
    assert a["filters"].shape == (cfg["root_nmixtures"] + cfg["nmixtures"]
                                  * (cfg["nparts"] - 1), 5, 5, 32)
