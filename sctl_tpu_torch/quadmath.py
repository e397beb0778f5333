"""Extended-precision matrix products on the host (counterpart of the
part of sctl_tpu/quadmath.py that `ld_gemm` reaches: `DD` :34-137,
`_two_sum`, `_quick_two_sum`, `dd_add` :147-190, `_split_slices`
:330-368 and `ld_gemm` :369-414).

`ld_gemm` multiplies longdouble (80-bit) or float64 matrices at BLAS
speed: each factor splits exactly into float64 slices whose products
accumulate without rounding, and the partial products are summed in
double-double.  The hiprec KIFMM operator tables
(`fmm.kifmm.unit_tables(..., hiprec=True)`) build their pseudo-inverses
and M2L tables with it.  Pure numpy; nothing here runs on the card.
"""

from __future__ import annotations

import numpy as np


class DD:
    """Double-double array: value = hi + lo (elementwise), |lo| at most
    half an ulp of hi."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=None):
        self.hi = np.asarray(hi, np.float64)
        self.lo = (np.asarray(lo, np.float64) if lo is not None
                   else np.zeros_like(self.hi))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def dd_add(a: DD, b: DD) -> DD:
    s1, s2 = _two_sum(a.hi, b.hi)
    t1, t2 = _two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = _quick_two_sum(s1, s2)
    return DD(s1, s2)


def _split_slices(A: np.ndarray, axis: int, nslice: int = 3):
    """Exact slice decomposition of a float64 matrix for an error-free
    product (Ozaki, Ogita, Oishi and Rump, "Error-free transformations
    of matrix multiplication", Numer. Algorithms 2012): A = sum(slices),
    every entry of a slice but the last an integer multiple of a
    per-row (axis=1) or per-column (axis=0) power of two with at most
    21 significant bits, so that slice-pair products accumulate exactly
    in a float64 product of depth k <= 2048 (2^21 2^21 2^11 = 2^53 grid
    units).  The last slice is the remainder; its products are about
    2^-42 of the result and their rounding about 2^-94.  Row and column
    maxima of |A| must lie within [2^-1000, 2^990] (`ld_gemm` checks)."""
    A = np.asarray(A, np.float64)
    mx = np.max(np.abs(A), axis=axis, keepdims=True)
    mx = np.where(mx > 0, mx, 1.0)
    # sigma = 2^(e+32): fl((A + sigma) - sigma) keeps the bits down to
    # ulp(sigma) = 2^(e-20), entries of at most 21 bits below 2^e
    e2 = np.exp2(np.ceil(np.log2(mx)))
    out, rem = [], A
    for _ in range(nslice - 1):
        sigma = e2 * np.float64(2.0**32)
        hi = (rem + sigma) - sigma
        out.append(hi)
        rem = rem - hi               # exact: hi holds bits >= ulp(sigma)
        e2 = e2 * np.float64(2.0**-21)
    out.append(rem)
    return out


def ld_gemm(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(m, k) @ (k, n) of longdouble or float64 matrices in extended
    precision -> longdouble.  Each longdouble splits exactly into a
    float64 hi and lo part; hi @ hi runs as 9 error-free sliced float64
    products, the cross terms as 2 plain ones, and the 11 partials are
    summed elementwise in double-double.  Normwise within about 1e-27
    of numpy's (BLAS-less, about 100 times slower) longdouble product."""
    k = A.shape[1]
    assert k == B.shape[0] and k <= 2048
    for M, ax in ((A, 1), (B, 0)):
        mx = np.max(np.abs(np.asarray(M, np.float64)), axis=ax)
        nz = mx[mx > 0]
        assert nz.size == 0 or (2.0**-1000 <= nz.min()
                                and nz.max() <= 2.0**990), \
            "ld_gemm row/col scale outside the exact-split range"
    Ah = np.asarray(A, np.float64)
    Bh = np.asarray(B, np.float64)
    Al = (np.float64(A - Ah.astype(np.longdouble))
          if np.asarray(A).dtype == np.longdouble else None)
    Bl = (np.float64(B - Bh.astype(np.longdouble))
          if np.asarray(B).dtype == np.longdouble else None)
    As = _split_slices(Ah, axis=1)
    Bs = _split_slices(Bh, axis=0)
    parts = [a @ b for a in As for b in Bs]
    if Bl is not None:
        parts.append(Ah @ Bl)
    if Al is not None:
        parts.append(Al @ Bh)
    acc = DD(parts[0])
    for p in parts[1:]:
        acc = dd_add(acc, DD(p))
    return acc.hi.astype(np.longdouble) + acc.lo.astype(np.longdouble)
