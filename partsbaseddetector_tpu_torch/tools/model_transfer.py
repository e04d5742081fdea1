"""Model format converter CLI — the reference's ModelTransfer
(reference: src/ModelTransfer.cpp:44-74), extended to every supported
format in BOTH directions (the reference could only do .mat -> FileStorage
since MatlabIOModel::serialize was unimplemented,
src/MatlabIOModel.cpp:191-195):

    python -m partsbaseddetector_tpu_torch.tools.model_transfer IN OUT

Formats by extension: .mat (Matlab v5), .xml / .yml / .yaml (OpenCV
FileStorage), .npz (native fast format).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="model format converter")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--from-format", default=None, choices=["voc", "face"],
                    help="convert a foreign .mat model (VOC DPM or "
                         "Zhu-Ramanan face) to the pose format "
                         "(reference: matlab/modelTransfer.m)")
    ap.add_argument("--name", default=None, help="output model name")
    args = ap.parse_args(argv)

    from partsbaseddetector_tpu_torch.models import (load_any, matio,
                                                     filestorage, npzio)

    if args.from_format:
        from partsbaseddetector_tpu_torch.models.transfer_formats import \
            load_foreign
        import os
        model = load_foreign(
            args.input, args.from_format,
            args.name or os.path.splitext(
                os.path.basename(args.input))[0])
    else:
        model = load_any(args.input)
        if args.name:
            model.name = args.name
    out = args.output
    if out.endswith((".xml", ".yml", ".yaml")):
        filestorage.save_model(out, model)
    elif out.endswith(".mat"):
        matio.save_mat(out, model)
    elif out.endswith(".npz"):
        npzio.save_npz(out, model)
    else:
        ap.error(f"unsupported output extension: {out}")
    print(f"{args.input} -> {out} "
          f"({model.components[0].nparts} parts, "
          f"{model.nfilters} filters)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
