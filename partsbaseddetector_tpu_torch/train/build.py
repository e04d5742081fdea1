"""Model initialization and assembly.

Python counterparts of initmodel.m / buildmodel.m / mergemodels.m
(reference: matlab/learning/): template sizing from the 5th-percentile
annotated box area, and the merge of per-part mixture filters into one
tree-structured PartsModel with per-edge bias blocks and deformation
parameters."""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import numpy as np

from partsbaseddetector_tpu_torch.models.schema import (ComponentSpec,
                                                        PartSpec,
                                                        PartsModel)


def merge_models(models: Sequence[PartsModel],
                 name: str | None = None) -> PartsModel:
    """Merge independently trained models into one multi-component
    mixture model (reference: matlab/learning/mergemodels.m:1-46, called
    from the trainmodel flow): concatenate the filter/def/bias pools
    with index offsets and append each model's components with their
    filterid/defid/biasid re-based.  The detect loop then searches every
    component at every scale (reference: src/DynamicProgram.cpp:80-87).

    Hyperparameters (interval, binsize, norient, flen) must agree; the
    merged threshold is the minimum of the inputs' (any component firing
    above its own threshold must fire in the merge — the root score
    thresholding is shared, src/DynamicProgram.cpp:208).
    """
    if not models:
        raise ValueError("merge_models needs at least one model")
    base = models[0]
    for m in models[1:]:
        for attr in ("interval", "binsize", "norient", "flen"):
            if getattr(m, attr) != getattr(base, attr):
                raise ValueError(
                    f"merge_models: {attr} mismatch "
                    f"({getattr(m, attr)} != {getattr(base, attr)})")

    filters: List[np.ndarray] = []
    defw: List[np.ndarray] = []
    anchors: List[np.ndarray] = []
    biasw: List[float] = []
    components: List[ComponentSpec] = []
    for m in models:
        nf, nd, nb = len(filters), len(defw), len(biasw)
        filters.extend(np.asarray(f) for f in m.filters)
        defw.extend(np.asarray(w) for w in m.defw)
        anchors.extend(np.asarray(a) for a in m.anchors)
        biasw.extend(float(b) for b in np.asarray(m.biasw).ravel())
        for comp in m.components:
            parts = [PartSpec(
                parentid=p.parentid,
                filterid=[f + nf for f in p.filterid],
                biasid=[b + nb for b in p.biasid],
                defid=[d + nd for d in p.defid]) for p in comp.parts]
            components.append(ComponentSpec(parts=parts))

    merged = PartsModel(
        name=name or "+".join(m.name for m in models),
        interval=base.interval,
        thresh=float(min(m.thresh for m in models)),
        binsize=base.binsize, norient=base.norient, flen=base.flen,
        filters=filters, defw=defw, anchors=anchors,
        biasw=np.asarray(biasw, np.float64), components=components)
    merged.validate()
    return merged


def mirror_component(model: PartsModel, mirror_map: Sequence[int],
                     name: str | None = None) -> PartsModel:
    """Two-component model from one: the original plus a left-right
    MIRRORED component that SHARES the original's filter pool with
    x-flipped reads expressed through new def/anchor entries — the
    converted-model pattern that motivates the reference's
    filter-id-keyed response cache (include/Parts.hpp:165-168: filters
    are convolved once, both components index the responses).

    mirror_map[p] = the part that part p maps to under left-right
    reflection (e.g. left wrist <-> right wrist; identity for parts on
    the symmetry axis).  The mirrored component's part p takes
    mirror_map[p]'s filters (SHARED ids — no new filters) and negates
    the x anchor / odd x deformation term of its defs.  Exact left-right
    detection symmetry would also need flipped filter weights; sharing
    ids unflipped keeps the filter pool identical, which is the property
    under test (cross-component response sharing), and matches how
    merged models reuse one pool (mergemodels.m semantics with a shared
    filter section).
    """
    comp = model.components[0]
    P = comp.nparts
    mirror_map = list(mirror_map)
    if sorted(mirror_map) != list(range(P)):
        raise ValueError("mirror_map must be a permutation of parts")
    for p in range(1, P):
        # the reflection must commute with the tree: the mirror of a
        # part's parent is the parent of the part's mirror — otherwise
        # the per-edge bias blocks (sized by the parent's mixture
        # count) would be read from the wrong source block
        if mirror_map[comp.parts[p].parentid] != \
                comp.parts[mirror_map[p]].parentid:
            raise ValueError(
                f"mirror_map is not tree-consistent at part {p}: "
                "mirror(parent(p)) != parent(mirror(p))")

    out = copy.deepcopy(model)
    if name:
        out.name = name
    biasw = list(np.asarray(out.biasw).ravel())
    parts2: List[PartSpec] = []
    for p in range(P):
        src = comp.parts[mirror_map[p]]
        tmpl = comp.parts[p]
        for m in range(src.nmixtures):
            w = np.asarray(out.defw[src.defid[m]]).copy()
            a = np.asarray(out.anchors[src.defid[m]]).copy()
            w[1] = -w[1]              # odd x term flips under reflection
            a[0] = -a[0]              # x anchor flips
            out.defw.append(w)
            out.anchors.append(a)
        biasid2 = []
        if p == 0:
            # faithful mirror: copy the root bias PER MIXTURE from the
            # source part (distinct per-mixture root biases survive the
            # mirror; the packed detector itself reads only
            # biasid[0][0], matching src/DynamicProgram.cpp:162-171)
            src_root = np.asarray(model.biasw).ravel()
            for m in range(src.nmixtures):
                bid = len(biasw)
                biasw.append(float(src_root[src.biasid[m]]))
                biasid2.append(bid)
        else:
            pn = comp.parts[mirror_map[tmpl.parentid]].nmixtures
            for m in range(src.nmixtures):
                bid = len(biasw)
                src_off = src.biasid[m]
                biasw.extend(float(x) for x in
                             np.asarray(model.biasw).ravel()[
                                 src_off:src_off + pn])
                biasid2.append(bid)
        parts2.append(PartSpec(
            parentid=tmpl.parentid,
            filterid=list(src.filterid),      # SHARED with component 0
            biasid=biasid2,
            defid=[len(out.defw) - src.nmixtures + m
                   for m in range(src.nmixtures)]))
    out.biasw = np.asarray(biasw, np.float64)
    out.components = [out.components[0], ComponentSpec(parts=parts2)]
    out.validate()
    return out


def template_size(boxes: np.ndarray, binsize: int) -> Tuple[int, int]:
    """Square template size in cells from the 5th-percentile box area
    (reference: matlab/learning/initmodel.m:8-23)."""
    w = boxes[:, 0, 2] - boxes[:, 0, 0] + 1
    h = boxes[:, 0, 3] - boxes[:, 0, 1] + 1
    areas = np.sort(h * w)
    area = areas[int(np.floor(len(areas) * 0.05))]
    nw = np.sqrt(area)
    t = max(int(np.floor(nw / binsize)), 1)
    return (t, t)


def build_model(name: str,
                filters_per_part: Sequence[Sequence[np.ndarray]],
                idx: Sequence[np.ndarray],
                deffeat: np.ndarray,
                parents: Sequence[int],
                binsize: int, interval: int,
                norient: int, flen: int,
                thresh: float = 0.0) -> PartsModel:
    """Merge per-part mixture filters into a tree model
    (reference: matlab/learning/buildmodel.m).

    filters_per_part[p][k]: (th, tw, flen) filter of part p mixture k;
    idx[p]: (N,) mixture assignment of each positive for part p;
    deffeat: (N, P, 2) scale-normalized part positions;
    parents[p]: parent index (root: -1 or 0)."""
    P = len(parents)
    filters: List[np.ndarray] = []
    defw: List[np.ndarray] = []
    anchors: List[np.ndarray] = []
    biasw: List[float] = []
    parts: List[PartSpec] = []

    for p in range(P):
        K = len(filters_per_part[p])
        parent = parents[p] if p > 0 else -1
        biasid: List[int] = []
        filterid: List[int] = []
        defid: List[int] = []
        if p == 0:
            # root: single scalar bias shared by all mixtures
            bid = len(biasw)
            biasw.append(0.0)
            biasid = [bid] * K
        else:
            Kp = len(filters_per_part[parents[p]])
            for k in range(K):
                bid = len(biasw)
                biasw.extend([0.0] * Kp)   # block indexed by parent mix
                biasid.append(bid)
        for k in range(K):
            filterid.append(len(filters))
            filters.append(np.asarray(filters_per_part[p][k],
                                      np.float64))
            did = len(defw)
            defid.append(did)
            if p == 0:
                defw.append(np.zeros(4))
                anchors.append(np.zeros(2, np.int64))
            else:
                defw.append(np.array([0.01, 0.0, 0.01, 0.0]))
                sel = idx[p] == k
                if sel.any():
                    rel = (deffeat[sel, p] - deffeat[sel, parents[p]]
                           ).mean(0)
                else:
                    rel = np.zeros(2)
                # mean relative displacement, rounded
                # (reference: buildmodel.m:62-69; 1-based round(x+1)
                # re-based to 0 == round(x))
                anchors.append(np.rint(rel).astype(np.int64))
        parts.append(PartSpec(parentid=parent, filterid=filterid,
                              biasid=biasid, defid=defid))

    model = PartsModel(
        name=name, interval=interval, thresh=thresh, binsize=binsize,
        norient=norient, flen=flen, filters=filters, defw=defw,
        anchors=anchors, biasw=np.asarray(biasw),
        components=[ComponentSpec(parts=parts)])
    model.validate()
    return model
