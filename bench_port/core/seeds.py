"""Streams of random numbers drawn from one ``--seed``: each consumer
(weights, traffic, the check's sample) gets its own stream, so adding a
consumer changes no other stream."""

from __future__ import annotations

import numpy as np
import torch

STREAMS = {"weights": 1, "traffic": 2, "sample": 3}


def seed64(seed: int, stream: str) -> int:
    """A 64-bit seed for ``stream`` from any whole number."""
    ss = np.random.SeedSequence([seed % 2**64, STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0])


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(seed64(seed, stream))


def torch_gen(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed64(seed, stream))
