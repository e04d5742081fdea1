"""Matlab v5 ``.mat`` model deserialization via scipy.io (the port's own
copy of ``partsbaseddetector_tpu/models/matio.py``).

Replaces the reference's cvmatio-based ``MatlabIOModel``
(reference: src/MatlabIOModel.cpp:71-188).  Semantics replicated:

  * ``model.interval`` -> interval, ``model.thresh`` -> thresh,
    ``model.sbin`` -> binsize (src/MatlabIOModel.cpp:98-100);
  * ``norient`` hardcoded to 18 (src/MatlabIOModel.cpp:101);
  * ``flen`` derived from the filter channel count
    (src/MatlabIOModel.cpp:113-114);
  * filters ``model.filters(i).w`` are H x W x C arrays — the reference
    flattens them to H x (W*C) interleaved; we keep them 3-D
    (src/MatlabIOModel.cpp:106-125);
  * all indices (parent, filterid, defid, biasid) and anchors converted from
    Matlab 1-based to 0-based (src/MatlabIOModel.cpp:44-58,152-162,176);
  * model name from the file stem when no ``name`` variable exists
    (src/MatlabIOModel.cpp:84-87).

Also provides the inverse (``save_mat``) — which the reference never
implemented (``MatlabIOModel::serialize``, src/MatlabIOModel.cpp:191-195) —
so the converter CLI can round-trip.
"""

from __future__ import annotations

import os
from typing import Any, List

import numpy as np
import scipy.io

from partsbaseddetector_tpu_torch.models.schema import (
    ComponentSpec, PartSpec, PartsModel)


def _scalar(v: Any) -> float:
    return float(np.asarray(v).ravel()[0])


def _ivec(v: Any) -> List[int]:
    return [int(round(x)) for x in np.asarray(v, dtype=np.float64).ravel()]


def _field(rec: Any, name: str) -> Any:
    """Field access tolerant of scipy's several struct representations."""
    if isinstance(rec, np.void) or (hasattr(rec, "dtype")
                                    and rec.dtype.names):
        return rec[name]
    raise KeyError(name)


def load_mat(path: str) -> PartsModel:
    raw = scipy.io.loadmat(path, squeeze_me=False, struct_as_record=True)
    if "model" not in raw:
        raise ValueError(f"{path}: no 'model' variable")
    model = raw["model"][0, 0]

    if "name" in raw:
        name = str(np.asarray(raw["name"]).ravel()[0])
    else:
        name = os.path.splitext(os.path.basename(path))[0]

    interval = int(_scalar(_field(model, "interval")))
    thresh = _scalar(_field(model, "thresh"))
    binsize = int(_scalar(_field(model, "sbin")))
    # the .mat schema has no norient; the reference hardcodes 18
    # (src/MatlabIOModel.cpp:101).  Our writer adds a top-level
    # "norient" variable; honor it when present.
    norient = int(_scalar(raw["norient"])) if "norient" in raw else 18

    # filters: struct array with field w of shape (h, w, C)
    filters_rec = _field(model, "filters").ravel()
    filters: List[np.ndarray] = []
    flen = None
    for f in filters_rec:
        w = np.asarray(_field(f, "w"), dtype=np.float64)
        if w.ndim == 2:
            w = w[:, :, None]
        flen = w.shape[2]
        filters.append(np.ascontiguousarray(w))
    if flen is None:
        raise ValueError(f"{path}: model has no filters")

    # defs: struct array with fields w (1x4) and anchor (1x2, 1-based)
    defs_rec = _field(model, "defs").ravel()
    defw, anchors = [], []
    for d in defs_rec:
        w = np.asarray(_field(d, "w"), dtype=np.float64).ravel()
        if w.size == 1:  # root def in some trained models is scalar
            w = np.array([w[0], 0.0, 0.0, 0.0])
        defw.append(w[:4])
        a = np.asarray(_field(d, "anchor"), dtype=np.float64).ravel()
        # 1-based -> 0-based (reference: src/MatlabIOModel.cpp:176);
        # a 3rd component is the scale offset ds (NOT an index — no
        # re-basing; matlab/detection/detect.m:201-204), kept only when
        # nonzero so single-resolution models stay in the (2,) schema
        if a.size >= 3 and int(round(a[2])) != 0:
            anchors.append(np.array([int(round(a[0])) - 1,
                                     int(round(a[1])) - 1,
                                     int(round(a[2]))], dtype=np.int64))
        else:
            anchors.append(np.array([int(round(a[0])) - 1,
                                     int(round(a[1])) - 1],
                                    dtype=np.int64))

    # bias: struct array with field w (scalar or block written flat)
    bias_rec = _field(model, "bias").ravel()
    biasw_list: List[float] = []
    for b in bias_rec:
        biasw_list.extend(
            np.asarray(_field(b, "w"), dtype=np.float64).ravel().tolist())
    biasw = np.asarray(biasw_list, dtype=np.float64)

    # components: cell array, each a struct array of parts
    comp_cell = _field(model, "components").ravel()
    components: List[ComponentSpec] = []
    for comp in comp_cell:
        parts_rec = np.asarray(comp).ravel()
        parts: List[PartSpec] = []
        for p, part in enumerate(parts_rec):
            parentid = int(_scalar(_field(part, "parent"))) - 1
            filterid = [i - 1 for i in _ivec(_field(part, "filterid"))]
            defid = [i - 1 for i in _ivec(_field(part, "defid"))]
            biasid = [i - 1 for i in _ivec(_field(part, "biasid"))]
            parts.append(PartSpec(parentid=parentid, filterid=filterid,
                                  biasid=biasid, defid=defid))
        components.append(ComponentSpec(parts=parts))

    out = PartsModel(name=name, interval=interval, thresh=thresh,
                     binsize=binsize, norient=norient, flen=int(flen),
                     filters=filters, defw=defw, anchors=anchors,
                     biasw=biasw, components=components)
    out.validate()
    return out


def save_mat(path: str, model: PartsModel) -> None:
    """Write a PartsModel as a Matlab struct compatible with load_mat and
    the reference MatlabIOModel reader (indices re-based to 1)."""
    def cellrec(fields: dict) -> np.ndarray:
        dt = np.dtype([(k, object) for k in fields])
        rec = np.empty((1, 1), dtype=dt)
        for k, v in fields.items():
            rec[0, 0][k] = v
        return rec

    filters = np.empty((1, len(model.filters)), dtype=object)
    filt_dt = np.dtype([("w", object)])
    filters = np.empty((1, len(model.filters)), dtype=filt_dt)
    for i, f in enumerate(model.filters):
        filters[0, i]["w"] = np.asarray(f, dtype=np.float64)

    defs_dt = np.dtype([("w", object), ("anchor", object)])
    defs = np.empty((1, len(model.defw)), dtype=defs_dt)
    for i, (w, a) in enumerate(zip(model.defw, model.anchors)):
        defs[0, i]["w"] = np.asarray(w, dtype=np.float64).reshape(1, -1)
        defs[0, i]["anchor"] = np.asarray(
            [a[0] + 1, a[1] + 1], dtype=np.float64).reshape(1, -1)

    bias_dt = np.dtype([("w", object)])
    bias = np.empty((1, len(model.biasw)), dtype=bias_dt)
    for i, b in enumerate(model.biasw):
        bias[0, i]["w"] = np.asarray([[float(b)]])

    part_dt = np.dtype([("parent", object), ("filterid", object),
                        ("defid", object), ("biasid", object)])
    comp_cell = np.empty((1, model.ncomponents), dtype=object)
    for c, comp in enumerate(model.components):
        parts = np.empty((1, comp.nparts), dtype=part_dt)
        for p, part in enumerate(comp.parts):
            parts[0, p]["parent"] = np.asarray(
                [[float(part.parentid + 1)]])
            parts[0, p]["filterid"] = np.asarray(
                [[i + 1 for i in part.filterid]], dtype=np.float64)
            parts[0, p]["defid"] = np.asarray(
                [[i + 1 for i in part.defid]], dtype=np.float64)
            parts[0, p]["biasid"] = np.asarray(
                [[i + 1 for i in part.biasid]], dtype=np.float64)
        comp_cell[0, c] = parts

    model_rec = cellrec({
        "interval": np.asarray([[float(model.interval)]]),
        "thresh": np.asarray([[float(model.thresh)]]),
        "sbin": np.asarray([[float(model.binsize)]]),
        "filters": filters,
        "defs": defs,
        "bias": bias,
        "components": comp_cell,
    })
    scipy.io.savemat(path, {"model": model_rec, "name": model.name,
                            "norient": float(model.norient)})
