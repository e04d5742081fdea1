"""Training subsystem: latent structured SVM for mixtures-of-parts models.

The PyTorch port of partsbaseddetector_tpu/train: a re-implementation
of the reference's Matlab/Octave training stack (reference:
matlab/learning/, SURVEY.md §2.2): part-displacement k-means clustering,
per-part mixture SVMs on warped positives, tree model assembly, and
joint latent-SSVM training with dual-coordinate-descent QP and
hard-negative mining.  Feature extraction / detection runs on the
port's detector (CUDA unless device="cpu"); the QP cache lives on host
(it is a sequential coordinate descent over a few-GB example cache,
exactly as in the reference — matlab/learning/train.m:50-70)."""

from partsbaseddetector_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig, train_parts_model)
