"""Worker process for tests/test_torch_parallel.py's multi-process cases
(not a pytest file).

Each worker is one rank of a gloo job on the CPU.  It builds a mesh of
the given shape, runs the sharded detector on a seeded batch and holds
the result against the port's one-process Detector on the same frames;
its last line of output is a JSON summary.

Usage: python torch_parallel_worker.py RANK WORLD PORT KIND N0 N1
  KIND "batch": BatchDetector on a (data, filter) = (N0, N1) mesh;
  KIND "scale": ScaleShardedDetector on a (scale, filter) = (N0, N1) mesh.
"""

import json
import sys

import numpy as np
import torch

FIELDS = ("score", "valid", "component", "level", "boxes", "loc")


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    kind = sys.argv[4]
    shape = (int(sys.argv[5]), int(sys.argv[6]))
    torch.set_num_threads(1)

    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.models import synthetic
    from partsbaseddetector_tpu_torch.parallel import distributed

    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                           device="cpu")
    # 7 filters: a filter axis of 2 pads the bank with one zero filter
    model = synthetic.tiny(seed=3, root_nmixtures=1)
    model.thresh = -1e9
    rng = np.random.default_rng(11)          # the same frames on every rank
    images = (rng.random((4, 48, 56, 3)) * 255).astype(np.float32)
    out = {"rank": rank, "kind": kind, "shape": list(shape)}
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
        out["distributed_equal"] = [f for f in FIELDS if torch.equal(
            getattr(dist, f), getattr(got, f))]
    else:
        from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
            ScaleShardedDetector, make_scale_mesh)
        sdet = ScaleShardedDetector(model, make_scale_mesh(shape, "cpu"),
                                    k_per_level=8)
        got = sdet.detect_raw(images[0])
        ref = Detector(model, k_per_level=8, dp_split=1,
                       device="cpu").detect_raw(images[0])
    out["equal"] = [f for f in FIELDS
                    if torch.equal(getattr(got, f), getattr(ref, f))]
    out["score_diff"] = float((got.score - ref.score).abs()[ref.valid]
                              .max())
    out["nvalid"] = int(ref.valid.sum())
    torch.distributed.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
