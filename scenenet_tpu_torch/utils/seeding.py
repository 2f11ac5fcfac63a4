"""Deterministic seeding of the host-side RNGs (python, numpy, torch)."""

from __future__ import annotations

import random

import numpy as np
import torch


def fix_randomness(seed: int = 0) -> np.random.Generator:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
