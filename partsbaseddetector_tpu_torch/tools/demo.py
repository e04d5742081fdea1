"""Demo CLI — the reference's demo executable
(reference: src/demo.cpp:55-118), port of
partsbaseddetector_tpu/tools/demo.py:

    python -m partsbaseddetector_tpu_torch.tools.demo MODEL IMAGE [DEPTH]
        [--out overlay.png] [--nms OVERLAP] [--max-candidates N]
        [--device cuda|cpu] [--mesh DATA,FILTER | --scale-mesh SCALE,FILTER]

Loads a model by extension (.xml/.yml/.mat/.npz — reference:
src/demo.cpp:63-77), runs detection on the device (CUDA unless
``--device cpu``), sorts candidates, applies the paint NMS, prints
results, and optionally writes the overlay image (needs PIL, as does
reading the images).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def load_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def load_depth(path: str) -> np.ndarray:
    """16-bit depth in millimeters -> meters
    (reference: src/demo.cpp:95-99)."""
    from PIL import Image
    d = np.asarray(Image.open(path)).astype(np.float32)
    return d / 1000.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="mixtures-of-parts detector demo")
    ap.add_argument("model")
    ap.add_argument("image")
    ap.add_argument("depth", nargs="?", default=None)
    ap.add_argument("--out", default=None, help="overlay output path")
    ap.add_argument("--skeleton", action="store_true",
                    help="draw part-tree stick figures on the overlay "
                         "(matlab/visualization/showskeletons.m)")
    ap.add_argument("--nms", type=float, default=None,
                    help="paint-NMS overlap; omit to skip NMS")
    ap.add_argument("--max-candidates", type=int, default=20)
    ap.add_argument("--k-per-level", type=int, default=64)
    ap.add_argument("--conv-engine", default="spatial",
                    choices=("spatial", "fft"),
                    help="stage-2 scoring engine (the reference's "
                         "engine wiring, src/PartsBasedDetector.cpp:"
                         "108-118)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) | cpu")
    ap.add_argument("--mesh", default=None, metavar="DATA,FILTER",
                    help="serve on a (data, filter) mesh of the job's "
                         "ranks via BatchDetector (the frame replicated "
                         "over the data axis)")
    ap.add_argument("--scale-mesh", default=None, metavar="SCALE,FILTER",
                    help="shard pyramid levels over a (scale, filter) "
                         "mesh of the job's ranks (ScaleShardedDetector)")
    ap.add_argument("--walk-impl", default="auto",
                    choices=("auto", "cuda", "torch"))
    ap.add_argument("--dp-split", type=int, default=None)
    args = ap.parse_args(argv)

    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.models import load_any

    model = load_any(args.model)
    print(f"model: {model.name} ({model.ncomponents} component(s), "
          f"{model.components[0].nparts} parts, "
          f"{model.nfilters} filters)")
    im = load_image(args.image)
    depth = load_depth(args.depth) if args.depth else None

    def _axes(text):
        return tuple(int(x) for x in text.split(","))

    if args.scale_mesh is not None:
        from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
            ScaleShardedDetector, make_scale_mesh)
        det = ScaleShardedDetector(
            model, make_scale_mesh(_axes(args.scale_mesh), args.device),
            k_per_level=args.k_per_level, conv_engine=args.conv_engine,
            walk_impl=args.walk_impl)
        print(f"levels sharded over mesh {args.scale_mesh}")
    elif args.mesh is not None:
        from partsbaseddetector_tpu_torch.parallel import (BatchDetector,
                                                           make_mesh)
        det = BatchDetector(
            model, make_mesh(_axes(args.mesh), device=args.device),
            k_per_level=args.k_per_level, conv_engine=args.conv_engine,
            walk_impl=args.walk_impl, dp_split=args.dp_split)
        print(f"serving on mesh {args.mesh} "
              f"({'multires program' if det.multires else 'sharded'})")
    else:
        from partsbaseddetector_tpu_torch.infer.multires import \
            detector_for
        det = detector_for(model, k_per_level=args.k_per_level,
                           conv_engine=args.conv_engine,
                           walk_impl=args.walk_impl, dp_split=args.dp_split,
                           device=args.device)
        if det.multires:
            print("multi-resolution model: using MultiResDetector")
    t0 = time.time()
    cands = det.detect_raw(im)
    if args.nms is not None:
        from partsbaseddetector_tpu_torch.ops.nms import paint_nms
        cands = paint_nms(cands, im.shape[:2], args.nms)
    detections = Detector.candidates_to_detections(cands)
    dt = time.time() - t0
    print(f"detection took {dt:.3f}s (first call includes the kernel "
          f"build on CUDA)")
    print(f"{len(detections)} candidates above threshold "
          f"{model.thresh:.3f}")
    for d in detections[:args.max_candidates]:
        bb = d.bounding_box()
        print(f"  score={d.score:+.4f} comp={d.component} "
              f"level={d.level} bbox=({bb[0]:.0f},{bb[1]:.0f})-"
              f"({bb[2]:.0f},{bb[3]:.0f})")

    if depth is not None:
        from partsbaseddetector_tpu_torch.post.depth import \
            filter_candidates_by_depth
        kept = filter_candidates_by_depth(model, detections, depth)
        print(f"depth consistency kept {len(kept)}/{len(detections)}")
        detections = kept

    if args.out:
        from partsbaseddetector_tpu_torch.utils.viz import (
            draw_detections, save_image)
        overlay = draw_detections(im, detections,
                                  max_candidates=args.max_candidates)
        if args.skeleton:
            from partsbaseddetector_tpu_torch.utils.viz import \
                draw_skeleton
            parents = [p.parentid for p in model.components[0].parts]
            overlay = draw_skeleton(
                overlay, detections[:args.max_candidates], parents)
        save_image(args.out, overlay)
        print(f"overlay written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
