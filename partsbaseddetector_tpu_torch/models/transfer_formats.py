"""Foreign model-format converters: VOC DPM and Face models -> pose.

Python port of the reference's Matlab converter
(reference: matlab/modelTransfer.m:60-230):

  * VOC (Felzenszwalb et al., "Object detection with discriminatively
    trained part based models"): grammar model with rules/symbols —
    every second start rule (skipping mirrored components) contributes
    one component: offset -> global bias, root filter, per-part
    (def.w, anchor+1, filter)  (modelTransfer.m:79-159,
    modelTransferVOC2Face);
  * Face (Zhu & Ramanan, "Face detection, pose estimation and landmark
    localization in the wild"): per-component global bias from the first
    def, per-part defs with anchors, a shared zero pairwise bias
    (modelTransfer.m:164-230, modelTransferFace2Pose).

Anchors arrive 1-based from both formats and are re-based to 0 like the
C++ loader (reference: src/MatlabIOModel.cpp:176).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import scipy.io

from partsbaseddetector_tpu_torch.models.schema import (ComponentSpec,
                                                        PartSpec,
                                                        PartsModel)


def _sq(v):
    """Unwrap scipy's nested (1,1) object arrays."""
    a = np.asarray(v)
    while a.dtype == object and a.size == 1:
        a = a.ravel()[0]
        a = np.asarray(a)
    return a


def _field(rec, name):
    return rec[name] if rec.dtype.names and name in rec.dtype.names \
        else None


def _scalar(v) -> float:
    return float(_sq(v).ravel()[0])


def _filter_array(w) -> np.ndarray:
    w = np.asarray(_sq(w), dtype=np.float64)
    if w.ndim == 2:
        w = w[:, :, None]
    return w


class _FaceModel:
    """Intermediate 'face' representation (what VOC converts into and
    what converts to pose)."""

    def __init__(self):
        self.filters: List[np.ndarray] = []
        self.defs: List[dict] = []          # {w: array, anchor: (3,)}
        self.components: List[List[dict]] = []
        self.sbin = 8
        self.interval = 10
        self.thresh = -0.6


def _load_face_struct(m) -> _FaceModel:
    out = _FaceModel()
    out.sbin = int(_scalar(_field(m, "sbin")))
    if _field(m, "interval") is not None:
        out.interval = int(_scalar(_field(m, "interval")))
    if _field(m, "thresh") is not None:
        out.thresh = _scalar(_field(m, "thresh"))
    for f in _sq(_field(m, "filters")).ravel():
        out.filters.append(_filter_array(f["w"]))
    for d in _sq(_field(m, "defs")).ravel():
        w = np.asarray(_sq(d["w"]), np.float64).ravel()
        anchor = (np.asarray(_sq(d["anchor"]), np.float64).ravel()
                  if "anchor" in d.dtype.names and d["anchor"].size
                  else np.zeros(3))
        out.defs.append({"w": w, "anchor": anchor})
    comps = _sq(_field(m, "components"))
    for c in comps.ravel():
        parts = []
        for p in _sq(c).ravel():
            parts.append({
                "filterid": int(_scalar(p["filterid"])) - 1,
                "defid": int(_scalar(p["defid"])) - 1,
                "parent": int(_scalar(p["parent"])),
            })
        out.components.append(parts)
    return out


def _voc_to_face(m) -> _FaceModel:
    """modelTransferVOC2Face (reference: matlab/modelTransfer.m:79-159).
    """
    out = _FaceModel()
    out.sbin = int(_scalar(_field(m, "sbin")))
    out.interval = int(_scalar(_field(m, "interval")))
    out.thresh = -0.6

    start = int(_scalar(_field(m, "start"))) - 1
    rules = _sq(_field(m, "rules"))            # cell array
    symbols = _sq(_field(m, "symbols")).ravel()
    filters = _sq(_field(m, "filters")).ravel()
    start_rules = _sq(rules.ravel()[start]).ravel()

    layer = 0
    for c in range(0, len(start_rules), 2):    # skip mirrored components
        rule = start_rules[c]
        # offset -> global bias def (anchor 0)
        off_w = np.asarray(_sq(_sq(rule["offset"])["w"]),
                           np.float64).ravel()
        out.defs.append({"w": off_w, "anchor": np.zeros(3)})
        bias_defid = len(out.defs) - 1

        rhs = np.asarray(_sq(rule["rhs"]), np.float64).ravel().astype(
            int) - 1
        anchors = _sq(rule["anchor"]).ravel()

        # root filter: terminal, or through a deformation rule
        sym0 = symbols[rhs[0]]
        stype = str(_sq(sym0["type"]))
        if stype == "T":
            root_f = int(_scalar(sym0["filter"])) - 1
        else:
            sub = _sq(rules.ravel()[rhs[0]]).ravel()[layer]
            sub_rhs = int(np.asarray(_sq(sub["rhs"])).ravel()[0]) - 1
            root_f = int(_scalar(symbols[sub_rhs]["filter"])) - 1
        out.filters.append(_filter_array(filters[root_f]["w"]))

        parts = [{"filterid": len(out.filters) - 1,
                  "defid": bias_defid, "parent": 0}]
        for i in range(1, len(rhs)):
            sub = _sq(rules.ravel()[rhs[i]]).ravel()[layer]
            def_w = np.asarray(_sq(_sq(sub["def"])["w"]),
                               np.float64).ravel()
            anc = np.asarray(_sq(anchors[i]), np.float64).ravel()
            anc3 = np.zeros(3)
            anc3[:min(len(anc), 3)] = anc[:3]
            anc3[:2] += 1.0       # + [1 1 0] (modelTransfer.m:128)
            out.defs.append({"w": def_w, "anchor": anc3})
            fi = int(_scalar(symbols[int(np.asarray(
                _sq(sub["rhs"])).ravel()[0]) - 1]["filter"])) - 1
            out.filters.append(_filter_array(filters[fi]["w"]))
            parts.append({"filterid": len(out.filters) - 1,
                          "defid": len(out.defs) - 1, "parent": 1})
        out.components.append(parts)
    return out


def _face_to_pose(face: _FaceModel, name: str) -> PartsModel:
    """modelTransferFace2Pose (reference: matlab/modelTransfer.m:
    164-230)."""
    ncomp = len(face.components)
    biasw: List[float] = [0.0] * (ncomp + 1)   # +1 dummy zero pairwise
    filters = [np.ascontiguousarray(f) for f in face.filters]
    defw: List[np.ndarray] = []
    anchors: List[np.ndarray] = []
    components: List[ComponentSpec] = []

    for i, comp in enumerate(face.components):
        # the first def of the component is its global bias
        b = face.defs[comp[0]["defid"]]["w"]
        assert b.size == 1, "component bias must be scalar"
        biasw[i] = float(b.ravel()[0])
        parts: List[PartSpec] = []
        for j, p in enumerate(comp):
            if j == 0:
                # root: its own bias, a zero def slot (the reference
                # leaves defid empty; our schema requires one — use a
                # zero def with zero anchor, which the DP never reads)
                defw.append(np.zeros(4))
                anchors.append(np.zeros(2, np.int64))
                parts.append(PartSpec(parentid=-1,
                                      filterid=[p["filterid"]],
                                      biasid=[i],
                                      defid=[len(defw) - 1]))
            else:
                d = face.defs[p["defid"]]
                w = np.zeros(4)
                w[:min(4, d["w"].size)] = d["w"].ravel()[:4]
                defw.append(w)
                # anchors 1-based -> 0-based
                anchors.append(np.asarray(
                    [int(round(d["anchor"][0])) - 1,
                     int(round(d["anchor"][1])) - 1], np.int64))
                parts.append(PartSpec(parentid=p["parent"] - 1,
                                      filterid=[p["filterid"]],
                                      biasid=[ncomp],   # dummy zero
                                      defid=[len(defw) - 1]))
        components.append(ComponentSpec(parts=parts))

    flen = filters[0].shape[2]
    model = PartsModel(
        name=name, interval=face.interval, thresh=face.thresh,
        binsize=face.sbin, norient=18, flen=flen,
        filters=filters, defw=defw, anchors=anchors,
        biasw=np.asarray(biasw), components=components)
    model.validate()
    return model


def load_foreign(path: str, fmt: str, name: str = "converted"
                 ) -> PartsModel:
    """Load a VOC or Face .mat model and convert to the pose format
    (reference: matlab/modelTransfer.m:62-73)."""
    raw = scipy.io.loadmat(path, squeeze_me=False,
                           struct_as_record=True)
    if "model" not in raw:
        raise ValueError(f"{path}: no 'model' variable")
    m = raw["model"][0, 0]
    if fmt.lower() == "voc":
        face = _voc_to_face(m)
    elif fmt.lower() == "face":
        face = _load_face_struct(m)
    else:
        raise ValueError(f"unknown source format {fmt!r}; "
                         "options: voc, face")
    return _face_to_pose(face, name)
