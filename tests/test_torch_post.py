"""Port vs JAX: the 3-D post-processing modules (``post/rect3``,
``post/depth``, ``post/poses``, ``post/cloud``).  The port keeps numpy
copies of them, so every function gives the JAX package's outputs
exactly on the same seeded inputs (arrays equal, NaNs in the same
places)."""

import dataclasses
import types

import numpy as np
import pytest

import partsbaseddetector_tpu as pkg_jax
import partsbaseddetector_tpu_torch as pkg_t
from partsbaseddetector_tpu.infer.detector import Detection as DetJax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.post import (cloud as cloud_jax,
                                         depth as depth_jax,
                                         poses as poses_jax,
                                         rect3 as rect3_jax)
from partsbaseddetector_tpu_torch.infer.detector import Detection as DetT
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from partsbaseddetector_tpu_torch.post import (cloud as cloud_t,
                                               depth as depth_t,
                                               poses as poses_t,
                                               rect3 as rect3_t)

PKGS = {
    pkg_jax: types.SimpleNamespace(rect3=rect3_jax, depth=depth_jax,
                                   poses=poses_jax, cloud=cloud_jax,
                                   Detection=DetJax, synthetic=syn_jax),
    pkg_t: types.SimpleNamespace(rect3=rect3_t, depth=depth_t,
                                 poses=poses_t, cloud=cloud_t,
                                 Detection=DetT, synthetic=syn_t),
}


def _detections(m, rng, n, P, H, W):
    """n seeded detections of P part boxes inside an (H, W) image."""
    out = []
    for i in range(n):
        xy = rng.uniform(0, [W - 12, H - 12], (P, 2))
        wh = rng.uniform(4, 12, (P, 2))
        parts = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        out.append(m.Detection(score=float(1.0 - 0.1 * i), component=0,
                               level=i % 3, parts=parts,
                               locations=np.zeros((P, 3), np.int32)))
    return out


def _depth_map(rng, H, W):
    """Two planes at 1.5 and 2.2 m with noise, unknown (0) and NaN
    pixels."""
    d = np.where(np.arange(W)[None, :] < W // 2, 1.5, 2.2) \
        + rng.normal(0, 0.004, (H, W))
    d = d.astype(np.float32)
    d[rng.random((H, W)) < 0.05] = 0.0
    d[rng.random((H, W)) < 0.02] = np.nan
    return d


def case_rect3(m, rng):
    R = m.rect3.Rect3
    a = R(*rng.uniform(-1, 1, 3), *rng.uniform(0.5, 2, 3))
    b = R(*rng.uniform(-1, 1, 3), *rng.uniform(0.5, 2, 3))
    far = R(5, 5, 5, 1, 1, 1)
    pts = rng.uniform(-1.5, 2.5, (6, 3))
    return [a.volume(), a.tl(), a.br(), a.centroid(), a.is_valid(),
            [a.contains(p) for p in pts], a.expand(1.2),
            R.convex_hull(a, b), R.intersection(a, b),
            R.intersection(a, far).volume(), R.from_corners(a.tl(), b.br()),
            R(np.nan, 0, 0, 1, 1, 1).is_valid()]


def case_filter_candidates_by_depth(m, rng):
    model = m.synthetic.tiny(seed=0)
    P = model.components[0].nparts
    dets = _detections(m, rng, 12, P, 60, 60)
    depth = _depth_map(rng, 60, 60)
    depth = np.nan_to_num(depth)
    kept = m.depth.filter_candidates_by_depth(model, dets, depth)
    return [[d.score for d in kept],
            len(m.depth.filter_candidates_by_depth(
                model, dets, depth, zfactor=0.5))]


def case_filter_response_by_depth(m, rng):
    pdfs = rng.standard_normal((4, 9, 11, 3)).astype(np.float32)
    depth = np.nan_to_num(_depth_map(rng, 40, 48))
    return m.depth.filter_response_by_depth(
        pdfs, depth, [2.0, 3.0, 4.5, 6.0], part_width_m=0.3, fx=20.0,
        tol=0.4)


def case_poses_from_part_centers(m, rng):
    line = np.array([[0, 0, 0], [1, 0.01, 0], [2, -0.01, 0],
                     [3, 0.02, 0]], float)
    cloud = rng.normal([0.2, -0.1, 1.8], [0.1, 0.3, 0.05], (26, 3))
    holes = cloud.copy()
    holes[::3] = np.nan
    single = rng.normal(0, 1, (1, 3))
    poses = m.poses.poses_from_part_centers(
        [line, np.zeros((0, 3)), cloud, holes, single,
         np.full((4, 3), np.nan)])
    return [None if p is None else (p.position, p.orientation)
            for p in poses]


def case_euclidean_clusters(m, rng):
    a = rng.normal([0, 0, 0], 0.002, (50, 3))
    b = rng.normal([1, 0, 0], 0.002, (40, 3))
    c = rng.uniform(-0.5, 1.5, (30, 3))
    cls = m.cloud.euclidean_clusters(np.vstack([a, b, c]), 0.01)
    return sorted((np.sort(x) for x in cls), key=lambda x: (len(x), x[0]))


def case_cluster_objects(m, rng):
    R = m.rect3.Rect3
    obj = rng.normal([0.5, 0.5, 1.0], 0.01, (200, 3))
    clutter = rng.normal([0.8, 0.5, 1.0], 0.005, (30, 3))
    far = rng.normal([5, 5, 5], 0.01, (300, 3))
    cloud = np.vstack([obj, clutter, far])
    cloud[rng.random(len(cloud)) < 0.05] = np.nan
    boxes = [R(0.3, 0.3, 0.8, 0.6, 0.4, 0.4), R(0, 0, 0, 0, 0, 0),
             R(4.9, 4.9, 4.9, 0.2, 0.2, 0.2), R(-3, -3, -3, 0.1, 0.1, 0.1)]
    return m.cloud.cluster_objects(cloud, boxes)


def case_bounding_box_3d(m, rng):
    depth = _depth_map(rng, 100, 100)
    dets = _detections(m, rng, 6, 5, 100, 100)
    flat = np.full((100, 100), 1.5, np.float32)
    empty = np.zeros((50, 50), np.float32)
    return ([m.cloud.bounding_box_3d(d, (100, 100), depth) for d in dets]
            + [m.cloud.bounding_box_3d(dets[0], (100, 100), flat),
               m.cloud.bounding_box_3d(dets[1], (100, 100), empty)])


def case_compute_bounding_boxes(m, rng):
    cam = m.depth.CameraModel(fx=100, fy=100, cx=50, cy=50)
    depth = np.nan_to_num(_depth_map(rng, 100, 100))
    depth[:20] = 0.0                    # no depth under some detections
    dets = _detections(m, rng, 8, 5, 100, 100)
    return m.cloud.compute_bounding_boxes(dets, (100, 100), depth, cam)


def case_organized_multiplane_segmentation(m, rng):
    H = W = 40
    xs, ys = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H))
    plane = np.stack([xs, ys, np.full_like(xs, 2.0)], -1)
    plane += rng.normal(0, 0.001, plane.shape)
    blob = (np.abs(xs) < 0.2) & (np.abs(ys) < 0.2)
    plane[blob, 2] = 1.5
    plane[rng.random((H, W)) < 0.02] = np.nan
    return [m.cloud.organized_multiplane_segmentation(plane,
                                                      min_inliers=200),
            m.cloud.organized_normals(plane)]


CASES = {f.__name__[5:]: f for f in (
    case_rect3, case_filter_candidates_by_depth,
    case_filter_response_by_depth, case_poses_from_part_centers,
    case_euclidean_clusters, case_cluster_objects, case_bounding_box_3d,
    case_compute_bounding_boxes, case_organized_multiplane_segmentation)}


def _assert_same(got, ref, path="out"):
    """Exact equality through lists, tuples and dataclasses; arrays of
    equal dtype kind, NaNs in the same places."""
    if dataclasses.is_dataclass(ref):
        assert type(got).__name__ == type(ref).__name__, path
        _assert_same(dataclasses.astuple(got), dataclasses.astuple(ref),
                     path)
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == ref.dtype, path
        np.testing.assert_array_equal(got, ref, err_msg=path)
    elif ref is None:
        assert got is None, path
    else:
        assert type(got) is type(ref), path
        np.testing.assert_array_equal(got, ref, err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_post_matches_jax(name):
    ref = CASES[name](PKGS[pkg_jax], np.random.default_rng(17))
    got = CASES[name](PKGS[pkg_t], np.random.default_rng(17))
    _assert_same(got, ref)
