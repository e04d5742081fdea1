"""The face13 configuration: Zhu & Ramanan's 13-view face model, its
trees written by rule in the 68-point Multi-PIE scheme (0-indexed).
Each view loads by name with its published width: 7 frontal trees of 68
parts and 6 profile trees of 39, each valid and of depth 17, one mixture
a part, 710 independent 5x5x32 filters; each tree is the rule's."""

from __future__ import annotations

from typing import List, Tuple

import pytest

from bench_port.core import spec, weights

#: (landmark hung from, the chain hung from it in order), root 30 (the
#: nose tip); the 68-part tree of the views from -45 to +45 degrees
FRONTAL = [
    (30, [29, 28, 27]), (30, [33, 32, 31]), (33, [34, 35]),
    (27, [21, 20, 19, 18, 17]), (27, [22, 23, 24, 25, 26]),
    (28, [39, 38, 37, 36, 41, 40]), (28, [42, 43, 44, 45, 46, 47]),
    (33, [51, 50, 49, 48, 59, 58, 57]), (51, [52, 53, 54, 55, 56]),
    (51, [62, 61, 60, 67, 66]), (62, [63, 64, 65]),
    (57, [8, 7, 6, 5, 4, 3, 2, 1, 0]), (8, [9, 10, 11, 12, 13, 14, 15, 16]),
]
#: the 39-part tree of the profile views: the visible half (jaw 8-16,
#: brow 22-26, nose 27-35, eye 42-47, outer lip 51-57, inner lip 62-64)
#: with the frontal attachments, the outer lip one chain along its
#: contour to 57
PROFILE = [
    (30, [29, 28, 27]), (30, [33, 32, 31]), (33, [34, 35]),
    (27, [22, 23, 24, 25, 26]), (28, [42, 43, 44, 45, 46, 47]),
    (33, [51, 52, 53, 54, 55, 56, 57]), (51, [62, 63, 64]),
    (57, [8]), (8, [9, 10, 11, 12, 13, 14, 15, 16]),
]
#: the left-right mirror of the scheme
PAIRS = ([(i, 16 - i) for i in range(8)]
         + [(17, 26), (18, 25), (19, 24), (20, 23), (21, 22), (31, 35),
            (32, 34), (36, 45), (37, 44), (38, 43), (39, 42), (40, 47),
            (41, 46), (48, 54), (49, 53), (50, 52), (55, 59), (56, 58),
            (60, 64), (61, 63), (65, 67)])
MIRROR = {**{a: b for a, b in PAIRS}, **{b: a for a, b in PAIRS}}


def rule_tree(chains) -> Tuple[List[int], List[int]]:
    """(parent, landmarks): the chains hung from their landmarks,
    renumbered breadth-first from the root, so that parent[p] < p."""
    par, children = {30: None}, {}
    for top, chain in chains:
        for a, b in zip([top] + chain, chain):
            assert b not in par
            par[b] = a
            children.setdefault(a, []).append(b)
    order = [30]
    for lm in order:
        order.extend(children.get(lm, []))
    index = {lm: i for i, lm in enumerate(order)}
    return [-1] + [index[par[lm]] for lm in order[1:]], order


def depth(parent) -> int:
    d = [0] * len(parent)
    for p in range(1, len(parent)):
        d[p] = d[parent[p]] + 1
    return max(d)


@pytest.fixture(scope="module")
def cell():
    return spec.load_cell("face13.batch8")


def test_face13_loads_by_name(cell):
    cfg = cell.config
    assert cell.entry["config"] == cfg["name"] == "face13"
    assert (cfg["filter_size"], cfg["flen"], cfg["binsize"],
            cfg["interval"], cfg["k_per_level"]) == (5, 32, 4, 5, 64)
    comps = weights.components(cfg)
    yaws = [c["yaw"] for c in comps]
    assert yaws == list(range(90, -91, -15))
    for c in comps:
        assert (c["nmixtures"], c["root_nmixtures"]) == (1, 1)
        assert c["nparts"] == (68 if abs(c["yaw"]) <= 45 else 39)
        assert len(c["parent"]) == len(c["landmarks"]) == c["nparts"]
        assert depth(c["parent"]) == 17
    arrays = weights.model_arrays(cfg, 20121, "cpu")
    assert [len(p) for p, _ in arrays["trees"]] == \
        [c["nparts"] for c in comps]
    assert arrays["filters"].shape == (710, 5, 5, 32)


def test_face13_trees_follow_the_rule(cell):
    frontal, profile = rule_tree(FRONTAL), rule_tree(PROFILE)
    assert (len(frontal[0]), len(profile[0])) == (68, 39)
    assert sorted(frontal[1]) == list(range(68))
    assert depth(frontal[0]) == depth(profile[0]) == 17
    for c in weights.components(cell.config):
        parent, lms = frontal if c["nparts"] == 68 else profile
        if c["yaw"] < -45:
            lms = [MIRROR.get(lm, lm) for lm in lms]
        assert c["parent"] == parent and c["landmarks"] == lms, c["yaw"]
