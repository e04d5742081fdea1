"""The check fails what it must: the control (the reference in TF32 in
the port's place) and each fault the cells can have, planted under the
timed path of an otherwise whole run.  A sound run passes.  (The cells
run on one card, so none can leave out an exchange between cards.)"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from bench_port.core import runner, spec
from bench_port.tests.conftest import run_small, small_cell

CELLS = ["person26.batch8", "person26.ros_rgbd"]


class Broken:
    """A detector whose results are broken where they are produced."""

    def __init__(self, det, fault: str):
        self._det, self._fault, self._last = det, fault, None

    def __getattr__(self, name):
        return getattr(self._det, name)

    def _break(self, c):
        if self._fault == "stale":
            # the step hands back its state unchanged: the last result
            last, self._last = self._last, c
            return c if last is None else last
        if self._fault == "half":
            # half of the batch left out: its frames get the others'
            half = c.score.shape[0] // 2
            return c.map(lambda x: torch.cat([x[:half], x[:half]])[
                :x.shape[0]])
        # one answer altered: the best candidate's score raised by 1 and
        # a part of it moved 3 cells
        loc, score = c.loc.clone(), c.score.clone()
        loc.reshape(-1, *loc.shape[-3:])[:, 0, 1, 0] += 3
        score.reshape(-1, score.shape[-1])[:, 0] += 1.0
        return dataclasses.replace(c, loc=loc, score=score)

    def detect_batch_raw(self, images, depths=None, **kw):
        return self._break(self._det.detect_batch_raw(images, depths,
                                                      **kw))

    def detect_raw(self, image, depth=None):
        return self._break(self._det.detect_raw(image, depth=depth))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run_small(small_cell(name))
    assert out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    out = run_small(small_cell(name), control=True)
    assert not out["result"]["correct"]
    assert out["checks"]["off_share"][0] > out["checks"]["off_share"][1]


@pytest.mark.parametrize("name, fault", [
    ("person26.batch8", "half"), ("person26.batch8", "altered"),
    ("person26.batch8", "stale"), ("person26.ros_rgbd", "altered"),
    ("person26.ros_rgbd", "stale")])
def test_a_planted_fault_fails(name, fault):
    out = run_small(small_cell(name), seconds=1.0,
                    wrap=lambda det: Broken(det, fault))
    assert not out["result"]["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    out = runner.run(spec.load_cell(name), 20260101, 2.0, False, card,
                     time.perf_counter(), control=True)
    assert not out["result"]["correct"], out["checks"]
