"""Canonical in-memory model schema (numpy only; the port's own copy of
``partsbaseddetector_tpu/models/schema.py``).

``PartsModel`` is the single in-memory representation of a mixtures-of-parts
model.  It mirrors the parameter content of the reference ``Model`` class
(reference: include/Model.hpp:49-122) but stores everything as plain numpy
arrays / Python lists with **0-based indices** and **3-D filters** (H, W, C)
rather than the reference's flattened-interleaved H x (W*C) cv::Mat layout
(reference: src/MatlabIOModel.cpp:106-125).

Field map vs the reference serialization schema
(reference: src/FileStorageModel.cpp:104-153):

==============  =======================  ====================================
PartsModel      reference field           meaning
==============  =======================  ====================================
name            "name"                    model name
interval        "interval" -> nscales_    levels per octave of the pyramid
                                          (the reference stores it in
                                          ``nscales_`` and copies it to
                                          ``interval_``; see
                                          include/HOGFeatures.hpp:76-78)
thresh          "thresh"                  detection threshold on root score
binsize         "sbin"   -> binsize_      HOG cell size in pixels
norient         "norient"                 orientation bins (18)
flen            "flen"                    feature length (32 = 31 + trunc)
filters         "filtersw"                list of (h, w, flen) float arrays
defw            "defs"                    list of (4,) float arrays
anchors         "anchors"                 list of (ax, ay) int pairs, 0-based
biasw           "biasw"                   flat float vector of bias weights
components      "indexers"                per component, per part:
  .parentid       "parentid"              parent part index (root: -1)
  .filterid       "filterid"              per-mixture filter index
  .biasid         "biasid"                per-mixture offset into biasw
  .defid          "defid"                 per-mixture index into defw/anchors
==============  =======================  ====================================
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class PartSpec:
    """Indexing record for one part of one component.

    Mirrors one ``part-p`` node of the reference "indexers" section
    (reference: src/FileStorageModel.cpp:140-153).  All indices 0-based.
    """

    parentid: int                  # parent part index; -1 for the root
    filterid: List[int]            # len = nmixtures, into PartsModel.filters
    biasid: List[int]              # len = nmixtures, offsets into biasw
    defid: List[int]               # len = nmixtures, into defw/anchors

    @property
    def nmixtures(self) -> int:
        return len(self.filterid)


@dataclasses.dataclass
class ComponentSpec:
    """One part tree. Parts are stored root-first with parent index < child
    index (guaranteed by the training pipeline; the DP relies on it —
    reference: src/DynamicProgram.cpp:95)."""

    parts: List[PartSpec]

    @property
    def nparts(self) -> int:
        return len(self.parts)


@dataclasses.dataclass
class PartsModel:
    """Canonical deserialized model (see module docstring)."""

    name: str
    interval: int
    thresh: float
    binsize: int
    norient: int
    flen: int
    filters: List[np.ndarray]        # each (h, w, flen) float64/float32
    defw: List[np.ndarray]           # each (4,) float
    anchors: List[np.ndarray]        # each (2,) or (3,) int:
                                     # (ax, ay[, ds]), 0-based positions;
                                     # ds = scale offset vs parent
    biasw: np.ndarray                # (nbias,) float
    components: List[ComponentSpec]

    # ----------------------------------------------------------------- utils
    @property
    def ncomponents(self) -> int:
        return len(self.components)

    @property
    def nfilters(self) -> int:
        return len(self.filters)

    def validate(self) -> None:
        """Structural sanity checks; raises ValueError on inconsistency."""
        if self.norient % 2 != 0:
            raise ValueError("norient must be even (reference: "
                             "include/HOGFeatures.hpp:79)")
        for f in self.filters:
            if f.ndim != 3:
                raise ValueError("filters must be (h, w, flen) 3-D arrays")
            if f.shape[2] != self.flen:
                raise ValueError(
                    f"filter channel dim {f.shape[2]} != flen {self.flen}")
        for d in self.defw:
            if np.asarray(d).shape != (4,):
                raise ValueError("defw entries must have shape (4,)")
        for a in self.anchors:
            if np.asarray(a).shape not in ((2,), (3,)):
                raise ValueError("anchors entries must have shape (2,) "
                                 "or (3,) — (ax, ay[, ds]); ds is the "
                                 "part's scale offset relative to its "
                                 "parent (matlab/detection/detect.m:"
                                 "201-212; 0 for single-resolution "
                                 "models)")
        nf, nd, nb = len(self.filters), len(self.defw), len(self.biasw)
        for c, comp in enumerate(self.components):
            for p, part in enumerate(comp.parts):
                if p == 0:
                    if part.parentid not in (-1, 0):
                        raise ValueError(
                            f"component {c}: root parentid must be -1/0")
                else:
                    if not (0 <= part.parentid < p):
                        raise ValueError(
                            f"component {c} part {p}: parent "
                            f"{part.parentid} must precede the part "
                            "(reference: src/DynamicProgram.cpp:95 relies "
                            "on topological order)")
                if not (len(part.filterid) == len(part.biasid)
                        == len(part.defid)):
                    raise ValueError(
                        f"component {c} part {p}: index vectors must have "
                        "equal length (one entry per mixture)")
                for m in range(part.nmixtures):
                    if not (0 <= part.filterid[m] < nf):
                        raise ValueError(f"filterid out of range at "
                                         f"c{c} p{p} m{m}")
                    if not (0 <= part.defid[m] < nd):
                        raise ValueError(f"defid out of range at c{c} p{p}")
                    if not (0 <= part.biasid[m] < nb):
                        raise ValueError(f"biasid out of range at c{c} p{p}")

    # ------------------------------------------------------------ accessors
    def part_nmixtures(self, c: int) -> List[int]:
        return [p.nmixtures for p in self.components[c].parts]

    def max_nmixtures(self) -> int:
        return max(p.nmixtures
                   for comp in self.components for p in comp.parts)

    def filter_sizes(self) -> np.ndarray:
        """(nfilters, 2) array of (rows, cols)."""
        return np.array([[f.shape[0], f.shape[1]] for f in self.filters],
                        dtype=np.int32)

    def anchor_ds(self, defid: int) -> int:
        """Scale offset of a def's child part relative to its parent
        (the 3rd anchor component, matlab/detection/detect.m:201-204;
        0 when absent — all C++-format models)."""
        a = np.asarray(self.anchors[defid]).ravel()
        return int(a[2]) if a.size >= 3 else 0

    def part_scales(self, c: int) -> List[int]:
        """Absolute scale offset per part (octaves finer than the root):
        scale[p] = ds(p) + scale[parent(p)] (matlab/detection/detect.m:
        184-204).  All zeros for single-resolution models.  Mixtures of
        one part must agree on ds (validated here)."""
        comp = self.components[c]
        scales = [0] * comp.nparts
        for p in range(1, comp.nparts):
            part = comp.parts[p]
            dss = {self.anchor_ds(d) for d in part.defid}
            if len(dss) > 1:
                raise ValueError(
                    f"part {p}: mixtures disagree on scale offset {dss}")
            scales[p] = dss.pop() + scales[part.parentid]
        return scales

    def max_scale(self) -> int:
        """Largest absolute part scale offset across components (0 for
        single-resolution models)."""
        return max((s for c in range(self.ncomponents)
                    for s in self.part_scales(c)), default=0)

    def component_model(self, c: int) -> "PartsModel":
        """Single-component view of component ``c`` — the parameter
        pools are shared (ids stay valid), only the component list
        shrinks.  The per-component inverse of train.build.merge_models
        (the reference's DP treats components independently,
        src/DynamicProgram.cpp:80-93), used for engines that take one
        component at a time (native cross-check)."""
        return dataclasses.replace(
            self, components=[self.components[c]])


def flatten_filter(f: np.ndarray) -> np.ndarray:
    """(h, w, C) -> reference's flattened interleaved (h, w*C) layout
    (reference: src/MatlabIOModel.cpp:115-122: flat[m, n*C+c] = f[m, n, c])."""
    h, w, c = f.shape
    return np.ascontiguousarray(f.reshape(h, w * c))


def unflatten_filter(flat: np.ndarray, flen: int) -> np.ndarray:
    """Inverse of :func:`flatten_filter`: (h, w*C) -> (h, w, C)."""
    h, wc = flat.shape
    if wc % flen:
        raise ValueError(f"flattened width {wc} not divisible by flen {flen}")
    return np.ascontiguousarray(flat.reshape(h, wc // flen, flen))


def tree_children(parentid: Sequence[int]) -> List[List[int]]:
    """children[i] = sorted list of parts whose parent is i."""
    out: List[List[int]] = [[] for _ in parentid]
    for p, par in enumerate(parentid):
        if p == 0:
            continue
        out[par].append(p)
    return out
