"""Inference layer: pyramid planning and the detector facade."""

from partsbaseddetector_tpu_torch.infer.detector import (  # noqa: F401
    Detection, Detector)
