"""Seeding (counterpart of the JAX package's ``utils/seeding.py``).

``set_seed`` seeds Python's ``random`` and numpy's global generator, as the
JAX package's does (the host-side draws of data shuffling), and torch's
default generators (``torch.manual_seed``: the CPU's and every CUDA
device's). In the port those generators do what JAX's explicit keys do for
initialisation: a model built after ``set_seed(s)`` has the same weights
every time. The train step does not draw from them directly: it seeds its
own draws per step from ``TrainConfig.seed`` (``train/training.py``).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
