"""Worker process for tests/test_torch_parallel.py's multi-process cases
(not a pytest file).

Each worker is one rank of a gloo job on the CPU.  It builds a mesh of
the given shape, runs the sharded detector on a seeded batch and holds
the result against the port's one-process Detector on the same frames;
its last line of output is a JSON summary.

Usage: python torch_parallel_worker.py RANK WORLD PORT KIND N0 N1
  KIND "batch": BatchDetector on a (data, filter) = (N0, N1) mesh;
  KIND "scale": ScaleShardedDetector on a (scale, filter) = (N0, N1) mesh;
  KIND "scale_multires": ScaleShardedDetector on a multi-resolution model
  (tiny_multires, one 96x96 frame) on a (scale, filter) = (N0, N1)
  mesh, plain, depth-pruned and masked, against MultiResDetector; it
  also reports the slots this rank convolved, ran the DP on and walked.
"""

import json
import sys

import numpy as np
import torch

FIELDS = ("score", "valid", "component", "level", "boxes", "loc")


def scale_multires(shape, out) -> None:
    """The "scale_multires" kind: fills out with this rank's slot range,
    the levels each stage ran on, and the fields equal to
    MultiResDetector's for plain, depth-pruned and masked detection."""
    from partsbaseddetector_tpu_torch.infer import multires
    from partsbaseddetector_tpu_torch.infer.detector import DepthPrune
    from partsbaseddetector_tpu_torch.models import synthetic
    from partsbaseddetector_tpu_torch.ops import conv as conv_ops
    from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
        ScaleShardedDetector, make_scale_mesh)

    model = synthetic.tiny_multires(seed=5)
    model.thresh = -1e9
    cfg = DepthPrune(part_width_m=0.2, fx=400.0, tol=0.3)
    sdet = ScaleShardedDetector(model, make_scale_mesh(shape, "cpu"),
                                k_per_level=8, depth_prune=cfg)
    ref = multires.MultiResDetector(
        model, k_per_level=8, depth_prune=cfg, device="cpu")
    rng = np.random.default_rng(12)          # the same inputs everywhere
    im = (rng.random((96, 96, 3)) * 255).astype(np.float32)
    plan = ref.plan_for(im.shape[:2])
    scales = [lv.scale for lv in plan.levels]
    depth = np.full(im.shape[:2], cfg.fx * cfg.part_width_m
                    / scales[len(scales) // 2], np.float32)
    depth[:24] = 0.0
    P = model.components[0].nparts
    masks = [rng.random((len(b.levels), P) + b.feat_pad) < 0.6
             for b in plan.buckets]

    # what each stage of the sharded detector ran on: conv batch sizes
    # per bucket, DP level counts and walked levels per root segment
    ran = {"conv": [], "dp": [], "walk": []}
    conv, dp, walk = (conv_ops.CONV_ENGINES["spatial"],
                      multires._dp_multires, multires._walk_levels)

    def conv_spy(feats, *a, **kw):
        ran["conv"].append(feats.shape[0])
        return conv(feats, *a, **kw)

    def dp_spy(per_bucket, o, L, *a, **kw):
        ran["dp"].append([o, L])
        return dp(per_bucket, o, L, *a, **kw)

    def walk_spy(*a):
        ran["walk"].append(a[-1].tolist())
        return walk(*a)

    conv_ops.CONV_ENGINES["spatial"] = conv_spy
    multires._dp_multires, multires._walk_levels = dp_spy, walk_spy
    try:
        got = sdet.detect_raw(im)
    finally:
        conv_ops.CONV_ENGINES["spatial"] = conv
        multires._dp_multires, multires._walk_levels = dp, walk
    out["ran"] = ran
    out["slots"] = list(sdet.local_slot_range(im.shape[:2]))
    want = ref.detect_raw(im)
    dwant = ref.detect_raw(im, depth=depth)
    mwant = ref.detect_masked_raw(im, masks)
    out["equal"] = equal_fields(got, want)
    out["depth_equal"] = equal_fields(sdet.detect_raw(im, depth=depth),
                                      dwant)
    out["masked_equal"] = equal_fields(sdet.detect_masked_raw(im, masks),
                                       mwant)
    # the pruning and the masks change the result
    out["bite"] = [not torch.equal(x.score, want.score)
                   for x in (dwant, mwant)]
    out["capacity"] = got.capacity
    out["nvalid"] = int(want.valid.sum())


def equal_fields(a, b):
    return [f for f in FIELDS if torch.equal(getattr(a, f), getattr(b, f))]


def single_resolution(kind, shape, out) -> None:
    """The "batch" and "scale" kinds: fills out with the fields equal to
    Detector's (and the batch path's slices and bank width)."""
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.models import synthetic

    # 7 filters: a filter axis of 2 pads the bank with one zero filter
    model = synthetic.tiny(seed=3, root_nmixtures=1)
    model.thresh = -1e9
    rng = np.random.default_rng(11)          # the same frames on every rank
    images = (rng.random((4, 48, 56, 3)) * 255).astype(np.float32)
    if kind == "batch":
        from partsbaseddetector_tpu_torch.parallel import (BatchDetector,
                                                           make_mesh)
        bdet = BatchDetector(model, make_mesh(shape, device="cpu"),
                             k_per_level=8)
        got = bdet.detect_batch(images)
        dist = bdet.detect_batch_distributed(bdet.local_frames(images))
        ref = Detector(model, k_per_level=8,
                       device="cpu").detect_batch_raw(images)
        out["slices"] = bdet.local_frame_slices(len(images))
        out["bank"] = bdet.packed.bank.shape[3]
        out["distributed_equal"] = equal_fields(dist, got)
    else:
        from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
            ScaleShardedDetector, make_scale_mesh)
        sdet = ScaleShardedDetector(model, make_scale_mesh(shape, "cpu"),
                                    k_per_level=8)
        got = sdet.detect_raw(images[0])
        ref = Detector(model, k_per_level=8, dp_split=1,
                       device="cpu").detect_raw(images[0])
    out["equal"] = equal_fields(got, ref)
    out["score_diff"] = float((got.score - ref.score).abs()[ref.valid]
                              .max())
    out["nvalid"] = int(ref.valid.sum())


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    kind = sys.argv[4]
    shape = (int(sys.argv[5]), int(sys.argv[6]))
    torch.set_num_threads(1)

    from partsbaseddetector_tpu_torch.parallel import distributed

    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                           device="cpu")
    out = {"rank": rank, "kind": kind, "shape": list(shape)}
    if kind == "scale_multires":
        scale_multires(shape, out)
    else:
        single_resolution(kind, shape, out)
    torch.distributed.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
