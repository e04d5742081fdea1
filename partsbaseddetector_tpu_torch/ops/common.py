"""Shared constants, precision settings and the device rule.

Importing this module switches TF32 off for cuDNN convolutions and
cuBLAS matmuls and asks for "highest" float32 matmul precision — the
torch form of the JAX package's ``PRECISION = "highest"``
(partsbaseddetector_tpu/ops/common.py:18).  cuDNN's TF32 switch is on
by default, and a TF32 filter-bank conv keeps about three decimal
digits, too few for detection parity.
"""

from __future__ import annotations

from typing import Union

import torch

#: large-negative sentinel used instead of -inf so masked cells never
#: produce NaNs under addition (partsbaseddetector_tpu/ops/common.py:10)
NEG = -1.0e30

DEFAULT_DTYPE = torch.float32

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cv_round(x: torch.Tensor) -> torch.Tensor:
    """OpenCV cvRound semantics: round half to even (``torch.round``
    rounds half to even, like ``jnp.rint``)."""
    return torch.round(x)


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The port's device rule: ``None`` means CUDA.  Without a CUDA
    device that is an error (for ``None`` and for an explicit "cuda"),
    never a silent fall back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run "
            "the port on the CPU")
    return device
