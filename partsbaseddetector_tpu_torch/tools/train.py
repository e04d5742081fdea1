"""Training CLI — the reference's training_demo.m entry
(reference: matlab/training_demo.m, trainmodel.m):

    python -m partsbaseddetector_tpu_torch.tools.train DATASET OUT_MODEL
        --parents 0,1,2 [--nmix K] [--binsize B] [--interval I]
        [--iters N] [--cache DIR] [--negatives NEG.npz]
        [--device cuda|cpu]

DATASET: a .npz from tools/datasets.py, a PARSE-style DIRECTORY
(images + labels.mat with (P, 2, N) keypoints — the layout
matlab/learning/getPositiveData.m reads, driven from
matlab/training_demo.m:1-42), or 'synthetic[:N]' for the built-in
generator.  parents: 1-based parent list like the reference's pa
vector (0 = root), or 0-based with --zero-based.  The detectors of
training run on the CUDA card unless --device cpu."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="latent SSVM trainer")
    ap.add_argument("dataset")
    ap.add_argument("out")
    ap.add_argument("--parents", required=True,
                    help="comma-separated parent list (1-based, 0=root "
                         "like the reference's pa vector)")
    ap.add_argument("--zero-based", action="store_true")
    ap.add_argument("--nmix", type=int, default=2)
    ap.add_argument("--binsize", type=int, default=4)
    ap.add_argument("--interval", type=int, default=5)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--C", type=float, default=0.002)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--negatives", default=None)
    ap.add_argument("--mirror", default=None,
                    help="comma-separated part permutation under "
                         "left/right mirroring (same index base as "
                         "--parents); enables flip augmentation "
                         "(train.m:130,165).  'identity' for symmetric "
                         "parts")
    ap.add_argument("--overlap", type=float, default=0.6,
                    help="latent-search min box overlap (train.m:41); "
                         "lower it when part boxes are small relative "
                         "to the feature-grid stride")
    ap.add_argument("--name", default="trained")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) | cpu")
    args = ap.parse_args(argv)

    from partsbaseddetector_tpu_torch.models import npzio, filestorage, matio
    from partsbaseddetector_tpu_torch.tools.datasets import (
        load_dataset, synthetic_figures)
    from partsbaseddetector_tpu_torch.train import (TrainConfig,
                                                    train_parts_model)

    parents = [int(x) for x in args.parents.split(",")]
    if not args.zero_based:
        parents = [p - 1 for p in parents]   # 1-based pa -> 0-based

    if args.dataset.startswith("synthetic"):
        n = int(args.dataset.split(":")[1]) if ":" in args.dataset \
            else 20
        pos, neg = synthetic_figures(n, nparts=len(parents))
        pos_images = [s.image for s in pos]
        pos_points = np.stack([s.points for s in pos])
    else:
        ds = load_dataset(args.dataset)
        pos_images = [s.image for s in ds]
        pos_points = np.stack([s.points for s in ds])
        neg = ([s.image for s in load_dataset(args.negatives)]
               if args.negatives else
               [np.random.default_rng(0).random(
                   pos_images[0].shape[:2]) * 40 for _ in range(8)])

    mirror = None
    if args.mirror == "identity":
        mirror = list(range(len(parents)))
    elif args.mirror:
        mirror = [int(x) for x in args.mirror.split(",")]
        if not args.zero_based:
            mirror = [m - 1 for m in mirror]

    cfg = TrainConfig(nmix=args.nmix, binsize=args.binsize,
                      interval=args.interval, latent_iters=args.iters,
                      C=args.C, overlap=args.overlap)
    model = train_parts_model(args.name, pos_images, pos_points, neg,
                              parents, cfg, cache_dir=args.cache,
                              mirror_map=mirror, device=args.device)

    if args.out.endswith(".npz"):
        npzio.save_npz(args.out, model)
    elif args.out.endswith((".xml", ".yml", ".yaml")):
        filestorage.save_model(args.out, model)
    elif args.out.endswith(".mat"):
        matio.save_mat(args.out, model)
    else:
        ap.error(f"unsupported model extension: {args.out}")
    print(f"trained model ({model.components[0].nparts} parts, "
          f"thresh {model.thresh:.3f}) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
