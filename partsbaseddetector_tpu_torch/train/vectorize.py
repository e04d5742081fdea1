"""Model <-> weight-vector mapping for SSVM training.

Python counterpart of model2vec/vec2model
(reference: matlab/learning/model2vec.m, vec2model.m): a deterministic
block layout over (biases, defs, filters) with

  * wreg: per-coordinate regularization scale — root biases get 0.01
    (model2vec.m:27-32);
  * w0 / noneg: minimum quadratic deformation cost 0.01 enforced on the
    two quadratic def coordinates (model2vec.m:20-25).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from partsbaseddetector_tpu_torch.models.schema import PartsModel


@dataclasses.dataclass
class BlockLayout:
    """Offsets of every parameter block in the flat weight vector."""

    bias_off: np.ndarray       # (nbias,) offset of each biasw scalar
    def_off: np.ndarray        # (ndefs,) offset of each (4,) def block
    filter_off: np.ndarray     # (nfilters,) offset of each filter block
    filter_size: np.ndarray    # (nfilters,) numel of each filter
    length: int

    @classmethod
    def for_model(cls, model: PartsModel) -> "BlockLayout":
        off = 0
        bias_off = np.zeros(len(model.biasw), np.int64)
        for i in range(len(model.biasw)):
            bias_off[i] = off
            off += 1
        def_off = np.zeros(len(model.defw), np.int64)
        for i in range(len(model.defw)):
            def_off[i] = off
            off += 4
        filter_off = np.zeros(len(model.filters), np.int64)
        filter_size = np.zeros(len(model.filters), np.int64)
        for i, f in enumerate(model.filters):
            filter_off[i] = off
            filter_size[i] = f.size
            off += f.size
        return cls(bias_off, def_off, filter_off, filter_size, off)


def model_to_vec(model: PartsModel, layout: BlockLayout
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
    """Returns (w, wreg, w0, noneg_idx)."""
    w = np.zeros(layout.length)
    wreg = np.ones(layout.length)
    w0 = np.zeros(layout.length)
    noneg: List[int] = []
    for i, b in enumerate(model.biasw):
        w[layout.bias_off[i]] = b
    for i, d in enumerate(model.defw):
        j = layout.def_off[i]
        w[j:j + 4] = d
        # minimum quadratic deformation cost (model2vec.m:20-25)
        w0[j] = 0.01
        w0[j + 2] = 0.01
        noneg.extend([j, j + 2])
    for i, f in enumerate(model.filters):
        j = layout.filter_off[i]
        w[j:j + f.size] = np.asarray(f).ravel()
    # root biases regularized with 0.01 (model2vec.m:27-32)
    for comp in model.components:
        bid = comp.parts[0].biasid[0]
        wreg[layout.bias_off[bid]] = 0.01
    return w, wreg, w0, np.asarray(noneg, np.int64)


def vec_to_model(w: np.ndarray, model: PartsModel,
                 layout: BlockLayout) -> PartsModel:
    """Write the weight vector back into a (copied) model."""
    out = dataclasses.replace(model)
    out.biasw = np.array([w[layout.bias_off[i]]
                          for i in range(len(model.biasw))])
    out.defw = [np.array(w[layout.def_off[i]:layout.def_off[i] + 4])
                for i in range(len(model.defw))]
    out.filters = [np.asarray(
        w[layout.filter_off[i]:layout.filter_off[i] + f.size]
    ).reshape(f.shape) for i, f in enumerate(model.filters)]
    return out
