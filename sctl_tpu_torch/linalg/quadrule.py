"""Gauss-Legendre rules on [0, 1] (numpy copy of
sctl_tpu/linalg/quadrule.py `leg_quad_rule`)."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def leg_quad_rule(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Nodes and weights of the n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1) / 2, w / 2
