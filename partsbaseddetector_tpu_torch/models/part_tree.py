"""Packed, padded device representation of a PartsModel.

Port of partsbaseddetector_tpu/models/part_tree.py: the same field
names, dtypes (int32 indices) and shapes, as plain dataclasses of
tensors on one device.  A flat struct-of-arrays per component, padded
to the maximum mixture count, plus one global packed filter bank shared
by all components (reference: include/Parts.hpp:51-261,
src/SpatialConvolutionEngine.cpp:106-124).  Invalid (padded) mixture
slots carry ``NEG`` biases so they can never win a max.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from partsbaseddetector_tpu_torch.models.schema import PartsModel
from partsbaseddetector_tpu_torch.ops.common import NEG, resolve_device
from partsbaseddetector_tpu_torch.ops.conv import pack_filter_bank


@dataclasses.dataclass(frozen=True)
class PackedComponent:
    """One part tree, padded to M = max mixtures.

    Index semantics mirror the reference accessors
    (include/Parts.hpp:124-187):
      filterid[p, m]  -> global filter index (pad: repeats mixture 0)
      defw[p, m, 4]   -> deformation weights (w0..w3)
      anchor[p, m, 2] -> (ax, ay) anchor offsets
      bias[p, mc, mp] -> biasw[biasid[p][mc] + mp]; NEG outside valid
      parent[p]       -> parent part index (parent[0] = 0)
      nmix[p]         -> true mixture count
      root_bias       -> biasw[biasid[0][0]]
      fsize[p, m]     -> filter rows (box size; the reference uses rows
                         for both x and y — include/Parts.hpp:185-187)
      aliased         -> some filter id is shared by two (part, mixture)
                         slots of this component (ops/dp runs the
                         filter-keyed DP for it)
      message_fids[p] -> host copy: the filter ids of part p's parent's
                         valid mixtures, the buffers its messages are
                         added to in the filter-keyed DP (() for the
                         root)
      parent_static   -> host copy of parent, from which ops/dp builds
                         the DP kernel's launch schedule without reading
                         the device
      parent_host     -> parent_static as an int32 CPU tensor, built
                         once: the walk reads the tree there, without a
                         sync
    """

    filterid: torch.Tensor     # (P, M) int32
    defw: torch.Tensor         # (P, M, 4) f32
    anchor: torch.Tensor       # (P, M, 2) int32
    bias: torch.Tensor         # (P, M, M) f32
    parent: torch.Tensor       # (P,) int32
    nmix: torch.Tensor         # (P,) int32
    mix_valid: torch.Tensor    # (P, M) bool
    root_bias: torch.Tensor    # () f32
    fsize: torch.Tensor        # (P, M) int32
    aliased: bool = False
    message_fids: Tuple[Tuple[int, ...], ...] = ()
    parent_static: Tuple[int, ...] = ()

    @functools.cached_property
    def parent_host(self) -> torch.Tensor:
        return torch.tensor(self.parent_static, dtype=torch.int32)

    @property
    def nparts(self) -> int:
        return self.filterid.shape[0]

    @property
    def maxmix(self) -> int:
        return self.filterid.shape[1]


@dataclasses.dataclass(frozen=True)
class PackedModel:
    """Device-ready model: global filter bank + per-component part trees
    + static hyperparameters."""

    bank: torch.Tensor                    # (FH, FW, C, F) f32, HWIO
    components: Tuple[PackedComponent, ...]
    thresh: torch.Tensor                  # () f32
    interval: int
    binsize: int
    norient: int
    flen: int
    name: str
    # per-component, per-part absolute scale offsets (all zeros for
    # single-resolution models — PartsModel.part_scales)
    scale_static: Tuple[Tuple[int, ...], ...] = ()

    @property
    def nfilters(self) -> int:
        return self.bank.shape[3]

    @property
    def parent_static(self) -> Tuple[Tuple[int, ...], ...]:
        """Host copies of the components' trees, for the tree walks."""
        return tuple(c.parent_static for c in self.components)

    @property
    def maxparts(self) -> int:
        """The most parts of a component: the part rows of every
        candidate, a smaller component's padded to it
        (ops/argmax._walked_candidates)."""
        return max(len(p) for p in self.parent_static)


def message_fids(filterid, parent, nmix) -> Tuple[Tuple[int, ...], ...]:
    """PackedComponent.message_fids from the (P, M) filter ids, (P,)
    parents and (P,) mixture counts of one component."""
    filterid, parent, nmix = (np.asarray(a) for a in (filterid, parent,
                                                       nmix))
    return ((),) + tuple(
        tuple(int(f) for f in filterid[parent[p], :nmix[parent[p]]])
        for p in range(1, len(parent)))


def pack_model(model: PartsModel, device=None) -> PackedModel:
    """Pack ``model`` onto ``device`` (``None`` means CUDA; see
    ops/common.resolve_device)."""
    device = resolve_device(device)
    model.validate()
    bank_np, _ = pack_filter_bank([np.asarray(f) for f in model.filters])
    M = model.max_nmixtures()

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    comps: List[PackedComponent] = []
    for comp in model.components:
        P = comp.nparts
        filterid = np.zeros((P, M), np.int32)
        defw = np.zeros((P, M, 4), np.float32)
        anchor = np.zeros((P, M, 2), np.int32)
        bias = np.full((P, M, M), NEG, np.float32)
        parent = np.zeros(P, np.int32)
        nmix = np.zeros(P, np.int32)
        fsize = np.zeros((P, M), np.int32)
        for p, part in enumerate(comp.parts):
            n = part.nmixtures
            nmix[p] = n
            parent[p] = max(part.parentid, 0)
            pn = comp.parts[parent[p]].nmixtures if p > 0 else 1
            for m in range(M):
                mm = min(m, n - 1)
                filterid[p, m] = part.filterid[mm]
                defw[p, m] = np.asarray(model.defw[part.defid[mm]])
                anchor[p, m] = np.asarray(
                    model.anchors[part.defid[mm]]).ravel()[:2]
                fsize[p, m] = model.filters[part.filterid[mm]].shape[0]
            if p > 0:
                for mc in range(n):
                    off = part.biasid[mc]
                    for mp in range(pn):
                        bias[p, mc, mp] = model.biasw[off + mp]
        # shared filter ids within one component alias the reference's
        # filter-keyed accumulation buffers (include/Parts.hpp:165-168)
        fids = [part.filterid[m] for part in comp.parts
                for m in range(part.nmixtures)]
        comps.append(PackedComponent(
            aliased=len(set(fids)) != len(fids),
            message_fids=message_fids(filterid, parent, nmix),
            parent_static=tuple(int(x) for x in parent),
            filterid=dev(filterid),
            defw=dev(defw),
            anchor=dev(anchor),
            bias=dev(bias),
            parent=dev(parent),
            nmix=dev(nmix),
            mix_valid=dev(np.arange(M)[None, :] < nmix[:, None]),
            root_bias=dev(float(model.biasw[comp.parts[0].biasid[0]]),
                          torch.float32),
            fsize=dev(fsize)))

    return PackedModel(
        bank=dev(bank_np, torch.float32),
        components=tuple(comps),
        thresh=dev(float(model.thresh), torch.float32),
        interval=int(model.interval), binsize=int(model.binsize),
        norient=int(model.norient), flen=int(model.flen),
        name=model.name,
        scale_static=tuple(tuple(model.part_scales(c))
                           for c in range(model.ncomponents)))
