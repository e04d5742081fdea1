"""Carry packed weights across from numpy.

``packed_from_numpy`` builds the port's PackedModel from the leaves of
a packed model held as numpy arrays — for example those of the JAX
package's ``PackedModel``, fetched with ``np.asarray`` — so that both
packages run on the same parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from partsbaseddetector_tpu_torch.models.part_tree import (PackedComponent,
                                                           PackedModel,
                                                           message_fids)
from partsbaseddetector_tpu_torch.ops.common import resolve_device

#: PackedModel fields that are plain Python values, not arrays
_STATIC = ("interval", "binsize", "norient", "flen", "name",
           "parent_static", "scale_static")


def packed_from_numpy(arrays: Mapping[str, Any],
                      device=None) -> PackedModel:
    """arrays: ``bank`` (FH, FW, C, F), ``thresh`` (), the static fields
    (``interval``, ``binsize``, ``norient``, ``flen``, ``name``,
    ``parent_static``, optionally ``scale_static``), and ``components``:
    one mapping per component with the PackedComponent field names
    (``filterid``, ``defw``, ``anchor``, ``bias``, ``parent``, ``nmix``,
    ``mix_valid``, ``root_bias``, ``fsize`` and optionally ``aliased``).
    Arrays keep their dtypes; ``device`` follows ops/common's rule."""
    device = resolve_device(device)

    def dev(a):
        # a copy: arrays fetched from another framework may be read-only
        return torch.tensor(np.asarray(a), device=device)

    comps = []
    for c in arrays["components"]:
        kw = {f.name: dev(c[f.name])
              for f in dataclasses.fields(PackedComponent)
              if f.name not in ("aliased", "message_fids")}
        comps.append(PackedComponent(
            aliased=bool(c.get("aliased", False)),
            message_fids=message_fids(c["filterid"], c["parent"],
                                      c["nmix"]),
            **kw))
    static = {k: arrays[k] for k in _STATIC if k in arrays}
    static["parent_static"] = tuple(tuple(int(v) for v in par)
                                    for par in arrays["parent_static"])
    if "scale_static" in static:
        static["scale_static"] = tuple(tuple(int(v) for v in s)
                                       for s in static["scale_static"])
    return PackedModel(bank=dev(arrays["bank"]), components=tuple(comps),
                       thresh=dev(arrays["thresh"]), **static)
