"""The port's parallel/ against the JAX package's sharded detectors.

In this process the world size is 1, so the port's meshes are (1, 1):
BatchDetector, ScaleShardedDetector and PipelinedDetector (front = back
= the CPU) are held against the JAX package's on its virtual 8-device
CPU mesh (tests/conftest.py), on the frames and models of
tests/test_parallel.py, and against the port's one-device detectors.
Integer fields (``valid``, ``loc``, ``level``, ``component``) and
``boxes`` exact, ``score`` rtol 1e-5 and atol 1e-6 against JAX (conv
and resampling sums in another order, as tests/test_torch_detector.py;
the atol covers scores near zero, whose f32 rounding is about 1e-7
absolute); all fields
exact against the port's Detector (MultiResDetector for a
multi-resolution model).  Across ranks: two gloo processes
(tests/torch_parallel_worker.py) per case, each rank's result equal to
Detector's (MultiResDetector's) on all fields."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.infer.detector import DepthPrune as DepthPruneJax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.parallel import pipeline as pipe_jax
from partsbaseddetector_tpu.parallel import scale_sharded as scale_jax
from partsbaseddetector_tpu.parallel import sharded as sharded_jax
from partsbaseddetector_tpu.parallel.mesh import make_mesh as make_mesh_jax
from partsbaseddetector_tpu_torch.infer.detector import DepthPrune, Detector
from partsbaseddetector_tpu_torch.infer.multires import MultiResDetector
from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from partsbaseddetector_tpu_torch.parallel import (BatchDetector, Mesh,
                                                   distributed, make_mesh)
from partsbaseddetector_tpu_torch.parallel.pipeline import PipelinedDetector
from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
    ScaleShardedDetector, make_scale_mesh)
from partsbaseddetector_tpu_torch.parallel.sharded import shard_filters

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("score", "valid", "component", "level", "boxes", "loc")
EXACT = ("valid", "component", "level", "boxes", "loc")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_like_jax(got, ref):
    for f in EXACT:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(_np(got.score), _np(ref.score), rtol=1e-5,
                               atol=1e-6)


def assert_equal(got, ref):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.fixture(scope="module")
def models():
    mj, mt = syn_jax.tiny(seed=3), syn_t.tiny(seed=3)
    mj.thresh = mt.thresh = -1e9
    return mj, mt


def _frames(seed, n, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    return (rng.random((n,) + shape + (3,)) * 255).astype(np.float32)


def test_mesh_at_world_size_1():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "filter": 1}
    assert mesh.coords == (0, 0) and mesh.groups == (None, None)
    assert not torch.distributed.is_initialized()
    t = torch.arange(6).reshape(2, 3)
    assert mesh.all_gather(t, "filter", -1) is t
    assert make_scale_mesh(device="cpu").shape == {"scale": 1, "filter": 1}
    assert distributed.global_mesh_shape() == (1, 1)
    distributed.initialize()           # one process: nothing to join
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="world size is 1"):
        make_mesh((2, 1), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        distributed.global_mesh_shape(2)


def test_batch_detector_matches_jax(models):
    mj, mt = models
    images = _frames(0, 8)
    ref = sharded_jax.BatchDetector(mj, make_mesh_jax((8, 1)),
                                    k_per_level=16).detect_batch(images)
    bdet = BatchDetector(mt, make_mesh(device="cpu"), k_per_level=16)
    got = bdet.detect_batch(images)
    assert got.score.shape[0] == 8
    assert_like_jax(got, ref)
    assert_equal(got, Detector(mt, k_per_level=16,
                               device="cpu").detect_batch_raw(images))
    assert bdet.local_frame_slices(8) == [(0, 8)]
    assert_equal(bdet.detect_batch_distributed(images), got)


def test_batch_detector_depth_and_masks_match_jax(models):
    mj, mt = models
    cfg = dict(part_width_m=0.2, fx=400.0, tol=0.3)
    images = _frames(1, 4)
    det = Detector(mt, k_per_level=8, dp_split=1, device="cpu")
    scales = [lv.scale for lv in det.plan_for((64, 64)).levels]
    z = cfg["fx"] * cfg["part_width_m"] / scales[len(scales) // 2]
    depths = np.stack([np.full((64, 64), z, np.float32),
                       np.zeros((64, 64), np.float32),
                       np.full((64, 64), 500.0, np.float32),
                       np.full((64, 64), z, np.float32)])
    bj = sharded_jax.BatchDetector(mj, make_mesh_jax((4, 2)), k_per_level=8,
                                   dp_split=1,
                                   depth_prune=DepthPruneJax(**cfg))
    bt = BatchDetector(mt, make_mesh(device="cpu"), k_per_level=8,
                       dp_split=1, depth_prune=DepthPrune(**cfg))
    got = bt.detect_batch(images, depths=depths)
    assert_like_jax(got, bj.detect_batch(images, depths=depths))
    assert not got.valid[2].any()          # the far depth prunes all
    # per-frame masks: frame b's masks allow only its own corner
    plan = det.plan_for((64, 64))
    P = mt.components[0].nparts
    masks = []
    for bucket in plan.buckets:
        fh, fw = bucket.feat_pad
        m = np.zeros((4, len(bucket.levels), P, fh, fw), bool)
        for b in range(4):
            m[b, :, :, :fh // 2 + b, :fw // 2 + b] = True
        masks.append(m)
    got = bt.detect_masked_batch(images, masks)
    assert_like_jax(got, bj.detect_masked_batch(images, tuple(masks)))
    for b in range(4):
        assert_equal(got.map(lambda x: x[b]), det.detect_masked_raw(
            images[b], [m[b] for m in masks]))


def test_batch_detector_multires_matches_jax():
    mj, mt = syn_jax.tiny_multires(seed=5), syn_t.tiny_multires(seed=5)
    mj.thresh = mt.thresh = -1e9
    images = _frames(2, 4)
    ref = sharded_jax.BatchDetector(mj, make_mesh_jax((4, 2)),
                                    k_per_level=8).detect_batch(images)
    bdet = BatchDetector(mt, make_mesh(device="cpu"), k_per_level=8)
    assert bdet.multires
    got = bdet.detect_batch(images)
    assert_like_jax(got, ref)
    single = MultiResDetector(mt, k_per_level=8, device="cpu")
    for b in range(4):
        assert_equal(got.map(lambda x: x[b]), single.detect_raw(images[b]))
    aliased = syn_t.tiny_multires(seed=5)
    aliased.components[0].parts[2].filterid[0] = \
        aliased.components[0].parts[3].filterid[0]
    with pytest.raises(NotImplementedError, match="shared filter ids"):
        BatchDetector(aliased, make_mesh(device="cpu"))


def test_bad_batch_and_padded_filter_axis(models):
    _, mt = models
    # a (data 8, filter 1) view of a mesh: the batch check needs no
    # collective
    mesh8 = Mesh(("data", "filter"), (8, 1), (0, 0), torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        BatchDetector(mt, mesh8).detect_batch(np.zeros((3, 64, 64, 3)))
    with pytest.raises(TypeError, match="Mesh"):
        BatchDetector(mt, (8, 1))
    with pytest.raises(TypeError, match="Mesh"):
        ScaleShardedDetector(mt, make_mesh(device="cpu"))
    # 7 filters over a filter axis of 2 or 3: zero filters pad the bank
    # to a multiple, then it splits in order
    bank = torch.randn(3, 3, 14, 7)
    for n in (2, 3):
        shards = [shard_filters(bank, n, i) for i in range(n)]
        whole = torch.cat(shards, dim=3)
        assert whole.shape[3] == 7 + (-7) % n
        assert torch.equal(whole[..., :7], bank)
        assert not whole[..., 7:].any()
    # a rank's view at filter coordinate 1 of 2 holds the second shard
    mesh12 = Mesh(("data", "filter"), (1, 2), (0, 1), torch.device("cpu"))
    b = BatchDetector(mt, mesh12)
    full = Detector(mt, device="cpu").packed.bank
    assert torch.equal(b.packed.bank, shard_filters(full, 2, 1))


def test_scale_sharded_matches_jax(models):
    mj, mt = models
    im = _frames(4, 1, (72, 56))[0]
    ref = scale_jax.ScaleShardedDetector(
        mj, scale_jax.make_scale_mesh((8, 1)), k_per_level=16).detect_raw(im)
    sdet = ScaleShardedDetector(mt, make_scale_mesh(device="cpu"),
                                k_per_level=16)
    got = sdet.detect_raw(im)
    # the JAX result keeps each bucket's padding levels (8 per bucket on
    # its mesh), all invalid; the valid entries agree in value and order
    v = _np(ref.valid)
    n = int(v.sum())
    assert int(got.valid.sum()) == n and v[:n].all()
    for f in EXACT:
        np.testing.assert_array_equal(_np(getattr(got, f))[:n],
                                      _np(getattr(ref, f))[:n], err_msg=f)
    np.testing.assert_allclose(_np(got.score)[:n], _np(ref.score)[:n],
                               rtol=1e-5, atol=1e-6)
    assert_equal(got, Detector(mt, k_per_level=16, dp_split=1,
                               device="cpu").detect_raw(im))


def test_scale_sharded_depth_masks_multires(models):
    _, mt = models
    cfg = DepthPrune(part_width_m=0.2, fx=400.0, tol=0.3)
    im = _frames(11, 1)[0]
    det = Detector(mt, k_per_level=8, dp_split=1, depth_prune=cfg,
                   device="cpu")
    sdet = ScaleShardedDetector(mt, make_scale_mesh(device="cpu"),
                                k_per_level=8, depth_prune=cfg)
    depth = np.full((64, 64), 10.0, np.float32)
    depth[:32] = 0.0
    assert_equal(sdet.detect_raw(im, depth=depth),
                 det.detect_raw(im, depth=depth))
    plan = det.plan_for((64, 64))
    P = mt.components[0].nparts
    masks = [np.ones((len(b.levels), P) + b.feat_pad, bool)
             for b in plan.buckets]
    masks[0][:, 1:, 10:] = False
    assert_equal(sdet.detect_masked_raw(im, masks),
                 det.detect_masked_raw(im, masks))
    mm = syn_t.tiny_multires(seed=5)
    mm.thresh = -1e9
    assert_equal(ScaleShardedDetector(mm, make_scale_mesh(device="cpu"),
                                      k_per_level=8).detect_raw(im),
                 MultiResDetector(mm, k_per_level=8,
                                  device="cpu").detect_raw(im))


MR_DEPTH = DepthPrune(part_width_m=0.2, fx=400.0, tol=0.3)


@pytest.fixture(scope="module")
def mr_models():
    mj, mt = syn_jax.tiny_multires(seed=5), syn_t.tiny_multires(seed=5)
    mj.thresh = mt.thresh = -1e9
    return mj, mt


def _multires_inputs(mt, shape, seed):
    """A seeded frame, a depth map (a plausible depth for the middle
    level, its top quarter 0) and seeded part masks at each plan
    bucket's feature size, for tiny_multires on an (H, W) frame."""
    rng = np.random.default_rng(seed)
    im = (rng.random(shape + (3,)) * 255).astype(np.float32)
    plan = MultiResDetector(mt, device="cpu").plan_for(shape)
    scales = [lv.scale for lv in plan.levels]
    depth = np.full(shape, MR_DEPTH.fx * MR_DEPTH.part_width_m
                    / scales[len(scales) // 2], np.float32)
    depth[:shape[0] // 4] = 0.0
    P = mt.components[0].nparts
    masks = [rng.random((len(b.levels), P) + b.feat_pad) < 0.6
             for b in plan.buckets]
    return im, depth, masks


def _multires_case(det, case, im, depth, masks):
    if case == "depth":
        return det.detect_raw(im, depth=depth)
    if case == "masked":
        return det.detect_masked_raw(im, masks)
    return det.detect_raw(im)


# every (mesh, frame, case) but fft on (4, 2) at 96x96, where the JAX
# package's program fails on the CPU inside XLA's FFT thunk (a RET_CHECK
# on the input layout, fft_thunk.cc:167) and gives no reference
MULTIRES_CASES = [
    (mesh, shape, case) for mesh in [(8, 1), (4, 2)]
    for shape in [(64, 64), (96, 96)]
    for case in ["plain", "depth", "masked", "fft"]
    if (mesh, shape, case) != ((4, 2), (96, 96), "fft")]


@pytest.mark.parametrize("jax_mesh,shape,case", MULTIRES_CASES)
def test_scale_sharded_multires_matches_jax(mr_models, jax_mesh, shape,
                                            case):
    """A multi-resolution model's slots split over ``scale`` (one rank
    here) against the JAX package's level-sharded multires program on
    its virtual mesh, and bit for bit against MultiResDetector.  fft:
    ``valid`` exact and ``score`` within 2e-3 against JAX, the bound of
    tests/test_parallel.py::test_multires_fft_scale_sharded."""
    mj, mt = mr_models
    im, depth, masks = _multires_inputs(mt, shape, seed=sum(shape))
    engine = "fft" if case == "fft" else "spatial"
    cfg = MR_DEPTH if case == "depth" else None
    jcfg = DepthPruneJax(**dataclasses.asdict(cfg)) if cfg else None
    ref = _multires_case(scale_jax.ScaleShardedDetector(
        mj, scale_jax.make_scale_mesh(jax_mesh), k_per_level=8,
        conv_engine=engine, depth_prune=jcfg), case, im, depth, masks)
    sdet = ScaleShardedDetector(mt, make_scale_mesh(device="cpu"),
                                k_per_level=8, conv_engine=engine,
                                depth_prune=cfg)
    assert sdet.local_slot_range(shape) == (0, 3)
    got = _multires_case(sdet, case, im, depth, masks)
    if case == "fft":
        np.testing.assert_array_equal(_np(got.valid), _np(ref.valid))
        np.testing.assert_allclose(_np(got.score), _np(ref.score),
                                   atol=2e-3)
    else:
        assert_like_jax(got, ref)
    single = MultiResDetector(mt, k_per_level=8, conv_engine=engine,
                              depth_prune=cfg, device="cpu")
    want = _multires_case(single, case, im, depth, masks)
    assert_equal(got, want)
    assert got.valid.any()
    if case in ("depth", "masked"):     # the pruning and masks bite
        assert not torch.equal(want.score, single.detect_raw(im).score)


def test_pipelined_matches_jax(models):
    mj, mt = models
    frames = list(_frames(6, 3))
    devs = jax.devices()
    ref = list(pipe_jax.PipelinedDetector(
        mj, front=devs[0], back=devs[1], k_per_level=16,
        dp_split=3).stream(frames))
    pdet = PipelinedDetector(mt, "cpu", "cpu", k_per_level=16, dp_split=3)
    got = list(pdet.stream(frames))
    assert len(got) == 3
    det = Detector(mt, k_per_level=16, dp_split=3, device="cpu")
    for f, g, r in zip(frames, got, ref):
        assert_like_jax(g, r)
        assert_equal(g, det.detect_raw(f))
    assert_equal(pdet.detect_raw(frames[0]), got[0])
    cfg = DepthPrune(part_width_m=0.2, fx=400.0, tol=0.3)
    pd = PipelinedDetector(mt, "cpu", "cpu", k_per_level=8, dp_split=1,
                           depth_prune=cfg)
    dd = Detector(mt, k_per_level=8, dp_split=1, depth_prune=cfg,
                  device="cpu")
    depth = np.full((64, 64), 12.0, np.float32)
    outs = list(pd.stream(frames[:2], depths=[depth, depth]))
    for f, o in zip(frames, outs):
        assert_equal(o, dd.detect_raw(f, depth=depth))
    with pytest.raises(ValueError, match="depth_prune"):
        pdet.detect_raw(frames[0], depth=depth)


def test_pipelined_multires_runs():
    """The JAX package refuses multi-resolution models on its pipeline
    (its pipeline.py:98-102: "stage groups cannot split them").  The
    split is between stages 2 and 3, and the cross-octave coupling is
    all in stages 3-4, which run on the back device whole: the port
    runs them, equal to MultiResDetector."""
    mj, mt = syn_jax.tiny_multires(seed=5), syn_t.tiny_multires(seed=5)
    mj.thresh = mt.thresh = -1e9
    devs = jax.devices()
    with pytest.raises(ValueError, match="multi-resolution"):
        pipe_jax.PipelinedDetector(mj, front=devs[0], back=devs[1])
    pdet = PipelinedDetector(mt, "cpu", "cpu", k_per_level=8)
    single = MultiResDetector(mt, k_per_level=8, device="cpu")
    frames = list(_frames(2, 2))
    for f, got in zip(frames, pdet.stream(frames, depth_of_pipeline=1)):
        assert_equal(got, single.detect_raw(f))


def test_streaming_detector_on_a_mesh(models):
    """mesh= at world size 1: process (the frame replicated over the
    data axis), process_batch and stream give the results of the
    StreamingDetector without a mesh."""
    _, mt = models
    rgbs = _frames(9, 3).astype(np.uint8)
    plain = StreamingDetector(mt, k_per_level=8, device="cpu")
    meshed = StreamingDetector(mt, mesh=make_mesh(device="cpu"),
                               k_per_level=8)
    assert isinstance(meshed.detector, BatchDetector)

    def same(a, b):
        assert len(a.detections) == len(b.detections) > 0
        for x, y in zip(a.detections, b.detections):
            assert x.score == y.score
            np.testing.assert_array_equal(x.locations, y.locations)

    for a, b in zip(meshed.process_batch(rgbs), plain.process_batch(rgbs)):
        same(a, b)
    for a, b in zip(meshed.stream(list(rgbs), batch=2),
                    plain.stream(list(rgbs), batch=2)):
        same(a, b)
    same(meshed.process(rgbs[0]), plain.process(rgbs[0]))


# ---------------------------------------------------------------------
# across ranks: two gloo processes a case


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(kind: str, shape):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests/torch_parallel_worker.py"),
         str(rank), "2", port, kind, str(shape[0]), str(shape[1])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_batch_detector_two_ranks(shape):
    outs = _two_ranks("batch", shape)
    for rank, out in enumerate(outs):
        assert out["equal"] == list(FIELDS), out
        assert out["distributed_equal"] == list(FIELDS), out
        assert out["nvalid"] > 0
        if shape == (2, 1):
            assert out["slices"] == [[2 * rank, 2 * rank + 2]]
            assert out["bank"] == 7
        else:       # 7 filters + one zero filter, half a rank
            assert out["slices"] == [[0, 4]]
            assert out["bank"] == 4


def test_scale_sharded_two_ranks():
    for out in _two_ranks("scale", (2, 1)):
        assert out["equal"] == list(FIELDS), out
        assert out["nvalid"] > 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_scale_sharded_multires_two_ranks(shape):
    """tiny_multires at 96x96 has buckets of (3, 3, 1) slots.  On
    (scale, filter) = (2, 1) each bucket's slots split at C = 2: rank 0
    convolves slots 0-1 of buckets 0-1 and slot 0 of bucket 2, and walks
    root levels 3, 4 (bucket 1) and 6 (bucket 2); rank 1 slot 2 of
    buckets 0-1 and nothing of bucket 2, and walks level 5.  On (1, 2)
    both ranks run every slot with half the bank.  Every rank's result
    equals MultiResDetector's on all fields, capacity included."""
    outs = _two_ranks("scale_multires", shape)
    ran = ([{"slots": [0, 2], "conv": [2, 2, 1], "dp": [[1, 2], [2, 1]],
             "walk": [[3, 4], [6]]},
            {"slots": [2, 3], "conv": [1, 1], "dp": [[1, 1]],
             "walk": [[5]]}] if shape == (2, 1) else
           [{"slots": [0, 3], "conv": [3, 3, 1], "dp": [[1, 3], [2, 1]],
             "walk": [[3, 4, 5], [6]]}] * 2)
    for out, want in zip(outs, ran):
        for what in ("equal", "depth_equal", "masked_equal"):
            assert out[what] == list(FIELDS), (what, out)
        assert out["bite"] == [True, True], out
        assert out["nvalid"] > 0 and out["capacity"] == 4 * 8
        assert out["slots"] == want["slots"]
        assert out["ran"] == {k: want[k] for k in ("conv", "dp", "walk")}
