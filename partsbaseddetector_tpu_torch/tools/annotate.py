"""Keypoint annotation tool — the reference's annotateParts.m
(reference: matlab/learning/annotateParts.m): click part locations on
each image in order; writes a dataset .npz consumable by the trainer and
evaluator.

    python -m partsbaseddetector_tpu_torch.tools.annotate IMAGE_DIR OUT.npz
        --parts P [--names name1,name2,...]

Requires an interactive matplotlib backend (a display).  Keys: click to
place the next part, 'u' undo, 'n'/'enter' next image, 'q' quit+save.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def annotate_images(image_paths, nparts: int, names=None):
    import matplotlib.pyplot as plt
    from PIL import Image

    from partsbaseddetector_tpu_torch.tools.datasets import Sample

    samples = []
    for path in image_paths:
        im = np.asarray(Image.open(path).convert("RGB"))
        pts = []
        fig, ax = plt.subplots()
        ax.imshow(im)
        title = os.path.basename(path)

        def refresh():
            ax.set_title(f"{title} — part {len(pts) + 1}/{nparts}"
                         + (f" ({names[len(pts)]})"
                            if names and len(pts) < nparts else ""))
            fig.canvas.draw_idle()

        done = {"next": False, "quit": False}

        def onclick(ev):
            if ev.inaxes is ax and len(pts) < nparts:
                pts.append([ev.xdata, ev.ydata])
                ax.plot(ev.xdata, ev.ydata, "r+")
                refresh()

        def onkey(ev):
            if ev.key == "u" and pts:
                pts.pop()
                refresh()
            elif ev.key in ("n", "enter"):
                done["next"] = True
                plt.close(fig)
            elif ev.key == "q":
                done["quit"] = True
                plt.close(fig)

        fig.canvas.mpl_connect("button_press_event", onclick)
        fig.canvas.mpl_connect("key_press_event", onkey)
        refresh()
        plt.show()
        if len(pts) == nparts:
            p = np.asarray(pts)
            span = p.max(0) - p.min(0)
            samples.append(Sample(
                image=im, points=p,
                scale=float(np.sqrt(max(span[0] * span[1], 1.0)))))
        if done["quit"]:
            break
    return samples


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="keypoint annotator")
    ap.add_argument("image_dir")
    ap.add_argument("out")
    ap.add_argument("--parts", type=int, required=True)
    ap.add_argument("--names", default=None)
    args = ap.parse_args(argv)

    from partsbaseddetector_tpu_torch.tools.datasets import save_dataset
    paths = sorted(glob.glob(os.path.join(args.image_dir, "*.jpg"))
                   + glob.glob(os.path.join(args.image_dir, "*.png")))
    if not paths:
        ap.error(f"no images in {args.image_dir}")
    names = args.names.split(",") if args.names else None
    samples = annotate_images(paths, args.parts, names)
    save_dataset(args.out, samples)
    print(f"{len(samples)} annotated images -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
