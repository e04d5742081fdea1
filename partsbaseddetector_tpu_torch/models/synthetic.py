"""Synthetic model generation (numpy only; the port's own copy of
``partsbaseddetector_tpu/models/synthetic.py`` — the same seed gives
the same weights).

The reference ships its trained models (Person_26parts.xml, Face_68parts.xml)
in a separate git submodule (reference: .gitmodules:1-3, conf/
config_person.by_parts:30, conf/config_face.by_parts:31) which is not
available here.  This module generates structurally-faithful random models of
the same shape — person-scale (26 parts) and face-scale (68 parts) trees with
per-part mixtures — used as fixtures for parity tests and benchmarks.

Layout conventions replicated from the trained Yang-Ramanan models:
  * one component, parts in topological (root-first) order;
  * every (part, mixture) has its own filter, def and bias slot, as produced
    by the Matlab model assembly (reference: matlab/learning/buildmodel.m);
  * the root has a single mixture whose biasid points at a scalar prior;
  * for non-root parts, biasw holds, per child mixture, a block of
    parent-mixture biases, addressed as biasw[biasid[p][m] + mp]
    (reference: include/Parts.hpp:172-175 with src/DynamicProgram.cpp:139);
  * deformation weights w = (wx2, wx1, wy2, wy1) with positive quadratic
    terms (penalties; the DP negates them — src/DynamicProgram.cpp:126-127).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from partsbaseddetector_tpu_torch.models.schema import (
    ComponentSpec, PartSpec, PartsModel)


def _chain_tree(nparts: int, rng: np.random.Generator,
                branching: float = 0.35) -> List[int]:
    """Random topologically-ordered tree: parent[p] < p, parent[0] = -1.

    With probability ``branching`` a new part attaches to a random earlier
    part instead of the previous one, giving star/limb structures similar to
    pose skeletons."""
    parent = [-1]
    for p in range(1, nparts):
        if p == 1 or rng.random() > branching:
            parent.append(p - 1)
        else:
            parent.append(int(rng.integers(0, p)))
    return parent


def make_model(name: str = "synthetic",
               nparts: int = 26,
               nmixtures: int | Sequence[int] = 4,
               filter_size: int = 5,
               flen: int = 32,
               norient: int = 18,
               binsize: int = 4,
               interval: int = 10,
               thresh: float = -1.0,
               root_nmixtures: int = 1,
               seed: int = 0,
               parent: Optional[Sequence[int]] = None,
               part_ds: Optional[Sequence[int]] = None,
               dtype=np.float64) -> PartsModel:
    """Generate a random but structurally-valid PartsModel.

    part_ds: optional per-part scale offset relative to the parent
    (the 3rd anchor component, matlab/detection/detect.m:201-204);
    nonzero entries make a multi-resolution model."""
    rng = np.random.default_rng(seed)
    if parent is None:
        parent = _chain_tree(nparts, rng)
    parent = list(parent)
    if isinstance(nmixtures, int):
        nmix = [root_nmixtures] + [nmixtures] * (nparts - 1)
    else:
        nmix = list(nmixtures)
        assert len(nmix) == nparts

    filters: List[np.ndarray] = []
    defw: List[np.ndarray] = []
    anchors: List[np.ndarray] = []
    biasw: List[float] = []
    parts: List[PartSpec] = []

    for p in range(nparts):
        filterid, biasid, defid = [], [], []
        pm = nmix[parent[p]] if p > 0 else 1
        for m in range(nmix[p]):
            # filter: small magnitude SVM-like weights
            f = (rng.standard_normal((filter_size, filter_size, flen))
                 * 0.05).astype(dtype)
            # keep truncation channel weights small & negative-ish, like
            # trained models (occlusion should not boost scores)
            f[..., flen - 1] = -np.abs(f[..., flen - 1]) * 0.5
            filterid.append(len(filters))
            filters.append(f)

            if p == 0:
                # root def: unused by the DP (the root is never distance-
                # transformed) but present in real models.
                w = np.zeros(4, dtype=np.float64)
                anc = np.zeros(2, dtype=np.int64)
            else:
                # convex quadratic penalty: wx2, wx1, wy2, wy1
                w = np.array([rng.uniform(0.01, 0.12),
                              rng.uniform(-0.05, 0.05),
                              rng.uniform(0.01, 0.12),
                              rng.uniform(-0.05, 0.05)])
                anc = rng.integers(-4, 5, size=2).astype(np.int64)
                if part_ds is not None and int(part_ds[p]) != 0:
                    anc = np.concatenate(
                        [anc, np.array([int(part_ds[p])], np.int64)])
            defid.append(len(defw))
            defw.append(w)
            anchors.append(anc)

            # bias block: root gets a scalar, others a block of pm entries
            biasid.append(len(biasw))
            if p == 0:
                biasw.append(float(rng.uniform(-0.2, 0.2)))
            else:
                biasw.extend(rng.uniform(-0.2, 0.2, size=pm).tolist())
        parts.append(PartSpec(parentid=parent[p] if p > 0 else -1,
                              filterid=filterid, biasid=biasid, defid=defid))

    model = PartsModel(
        name=name, interval=interval, thresh=thresh, binsize=binsize,
        norient=norient, flen=flen,
        filters=filters,
        defw=[np.asarray(w, dtype=np.float64) for w in defw],
        anchors=[np.asarray(a, dtype=np.int64) for a in anchors],
        biasw=np.asarray(biasw, dtype=np.float64),
        components=[ComponentSpec(parts=parts)],
    )
    model.validate()
    return model


def person_like(seed: int = 0, **kw) -> PartsModel:
    """26-part person-scale model (reference: conf/config_person.by_parts:30,
    Person_26parts: 26 parts, mixtures per part, 5x5x32 filters)."""
    kw.setdefault("nparts", 26)
    kw.setdefault("nmixtures", 4)
    kw.setdefault("root_nmixtures", 1)
    kw.setdefault("binsize", 4)
    kw.setdefault("interval", 10)
    return make_model(name="person_like", seed=seed, **kw)


def face_like(seed: int = 0, **kw) -> PartsModel:
    """68-part face-scale model (reference: conf/config_face.by_parts:31,
    Face_68parts).  The real model files live in an unavailable
    submodule; this proxy keeps the structural stressors that
    distinguish face-68 from person-26: 2.6x the parts (longer DP scan,
    more backtracking steps), a 272-filter bank (~2.6x the MXU conv and
    the FFT-crossover regime), and a denser tree.  Mixtures are uniform
    (4 incl. root) so the same topology drives the dense-layout native
    engine in the cross-engine parity test."""
    kw.setdefault("nparts", 68)
    kw.setdefault("nmixtures", 4)
    kw.setdefault("root_nmixtures", 4)
    kw.setdefault("binsize", 4)
    kw.setdefault("interval", 5)
    return make_model(name="face_like", seed=seed, **kw)


def tiny_multires(seed: int = 0, **kw) -> PartsModel:
    """Small multi-resolution model: root at the coarse octave, all
    child parts one octave finer (the DPM-style layout the Matlab
    detector supports via anchor ds, matlab/detection/detect.m:198-212,
    dropped by the C++ port)."""
    kw.setdefault("nparts", 4)
    kw.setdefault("nmixtures", 2)
    kw.setdefault("root_nmixtures", 2)
    kw.setdefault("filter_size", 3)
    kw.setdefault("norient", 6)
    kw.setdefault("flen", 14)
    kw.setdefault("binsize", 4)
    kw.setdefault("interval", 3)
    kw.setdefault("parent", [-1, 0, 1, 1])
    kw.setdefault("part_ds", [0, 1, 0, 0])   # part 1 one octave finer
    return make_model(name="tiny_multires", seed=seed, **kw)


def tiny(seed: int = 0, **kw) -> PartsModel:
    """Small model for fast unit tests: 4 parts, 2 mixtures, 3x3 filters."""
    kw.setdefault("nparts", 4)
    kw.setdefault("nmixtures", 2)
    kw.setdefault("root_nmixtures", 2)
    kw.setdefault("filter_size", 3)
    # flen must satisfy the HOG layout flen = 3*norient/2 + 5
    # (norient sensitive + norient/2 insensitive + 4 texture + 1 truncation;
    # reference: src/HOGFeatures.cpp:303-338)
    kw.setdefault("norient", 6)
    kw.setdefault("flen", 14)
    kw.setdefault("binsize", 4)
    kw.setdefault("interval", 3)
    return make_model(name="tiny", seed=seed, **kw)
