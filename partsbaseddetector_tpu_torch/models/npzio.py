"""Native fast model format: a single .npz with a JSON manifest (the
port's own copy of ``partsbaseddetector_tpu/models/npzio.py``).

This is the framework's preferred artifact format (one mmap-able file, no
parsing), produced from .mat/.xml/.yml by the ``pbd-model-transfer`` CLI
(the reference's ModelTransfer equivalent, reference: src/ModelTransfer.cpp:
44-74)."""

from __future__ import annotations

import json
from typing import List

import numpy as np

from partsbaseddetector_tpu_torch.models.schema import (
    ComponentSpec, PartSpec, PartsModel)

_FORMAT_VERSION = 1


def save_npz(path: str, model: PartsModel) -> None:
    model.validate()
    manifest = {
        "format_version": _FORMAT_VERSION,
        "name": model.name,
        "interval": int(model.interval),
        "thresh": float(model.thresh),
        "sbin": int(model.binsize),
        "norient": int(model.norient),
        "flen": int(model.flen),
        "components": [
            {"parts": [{"parentid": int(p.parentid),
                        "filterid": [int(i) for i in p.filterid],
                        "biasid": [int(i) for i in p.biasid],
                        "defid": [int(i) for i in p.defid]}
                       for p in comp.parts]}
            for comp in model.components
        ],
        "filter_shapes": [list(f.shape) for f in model.filters],
    }
    arrays = {
        "manifest": np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8),
        "biasw": np.asarray(model.biasw, dtype=np.float64),
        "defw": np.stack([np.asarray(d, dtype=np.float64)
                          for d in model.defw]),
        # anchors stored (N, 3): (ax, ay, ds); ds = 0 for plain 2-comp
        # anchors (multi-resolution models carry ds — schema.anchor_ds)
        "anchors": np.stack([
            np.concatenate([np.asarray(a, dtype=np.int64).ravel(),
                            np.zeros(3, np.int64)])[:3]
            for a in model.anchors]),
    }
    for i, f in enumerate(model.filters):
        arrays[f"filter_{i}"] = np.asarray(f, dtype=np.float32)
    np.savez(path, **arrays)


def load_npz(path: str) -> PartsModel:
    data = np.load(path)
    manifest = json.loads(bytes(data["manifest"]).decode())
    if manifest["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported npz model version "
                         f"{manifest['format_version']}")
    filters: List[np.ndarray] = [
        np.asarray(data[f"filter_{i}"], dtype=np.float64)
        for i in range(len(manifest["filter_shapes"]))]
    components = [
        ComponentSpec(parts=[PartSpec(**p) for p in comp["parts"]])
        for comp in manifest["components"]]
    model = PartsModel(
        name=manifest["name"], interval=manifest["interval"],
        thresh=manifest["thresh"], binsize=manifest["sbin"],
        norient=manifest["norient"], flen=manifest["flen"],
        filters=filters,
        defw=list(data["defw"]),
        anchors=[a[:2] if (a.size < 3 or a[2] == 0) else a
                 for a in data["anchors"]],
        biasw=data["biasw"],
        components=components)
    model.validate()
    return model
