"""Scalar math utilities (counterpart of sctl_tpu/mathutils.py:22-69).

The precision introspection that algorithms use to pick iteration
counts and orders from a target accuracy (reference: math_utils.hpp:
18-51), over torch dtypes and `quadmath.DD`, the double-double type.
"""

from __future__ import annotations

import math

import torch

from . import quadmath


def const_pi(dtype=torch.float64):
    """pi in the given dtype: a 0-d tensor, or a DD for quadmath.DD."""
    if dtype is quadmath.DD:
        return quadmath.dd_pi()
    return torch.tensor(math.pi, dtype=dtype)


def const_e(dtype=torch.float64):
    if dtype is quadmath.DD:
        return quadmath.dd_e()
    return torch.tensor(math.e, dtype=dtype)


def machine_eps(dtype=torch.float64) -> float:
    """Machine epsilon of dtype (reference: math_utils.hpp:18-22)."""
    if dtype is quadmath.DD:
        return 2.0 ** -104  # double-double effective epsilon
    return float(torch.finfo(dtype).eps)


def significant_bits(dtype=torch.float64) -> int:
    """Mantissa bits of dtype, the implicit one included (reference:
    math_utils.hpp:24-26)."""
    if dtype is quadmath.DD:
        return 104
    return 1 - int(round(math.log2(torch.finfo(dtype).eps)))


def digits(dtype=torch.float64) -> int:
    """Significant decimal digits of dtype."""
    return int(math.floor(significant_bits(dtype) * math.log10(2.0)))


def atoreal(s: str, dtype=torch.float64):
    """Parse a decimal string into dtype (reference: math_utils.hpp:35).
    For DD the parse keeps about 32 significant digits: a float64
    leading part plus a float64 correction."""
    if dtype is quadmath.DD:
        return quadmath.dd_from_string(s)
    return torch.tensor(float(s), dtype=dtype)


def pow_int(x, n: int):
    """x**n by binary exponentiation for integer n (DD too)."""
    if isinstance(x, quadmath.DD):
        return quadmath.dd_powi(x, n)
    return x ** n
