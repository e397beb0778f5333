"""Lagrange interpolation on the host (counterpart of
sctl_tpu/linalg/lagrange.py; reference: include/sctl/lagrange-interp.hpp,
.txx — `Interpolate` builds the interpolation-weight matrix, `Derivative`
the spectral differentiation).

Offline precompute in float64 or double-double numpy (the reference
computes the SDC matrices in extended precision, ode-solver.txx:77-112);
callers move the float64 results to the device.
"""

from __future__ import annotations

import numpy as np

from .. import quadmath as qm


def interpolation_matrix(src_nds, trg_nds, dd: bool = False) -> np.ndarray:
    """Matrix M (Ns, Nt) with f(trg) = f(src) @ M.

    float64: first-form barycentric weights M[i] = l(t) w_i / (t - s_i),
    l(t) = prod_j (t - s_j), w_i = 1 / prod_{j != i} (s_i - s_j); an
    exact node hit takes the one-hot limit.  dd=True: the product form
    prod_{j != i} (t - s_j) / (s_i - s_j) in double-double (nodes may be
    DD), rounded to float64 ("precompute in QuadReal, store in Real")."""
    if dd:
        return _interp_dd(src_nds, trg_nds)
    s = np.asarray(src_nds, dtype=np.float64)
    t = np.asarray(trg_nds, dtype=np.float64)
    den = s[:, None] - s[None, :]
    np.fill_diagonal(den, 1.0)
    w = 1.0 / den.prod(axis=1)
    d = t[None, :] - s[:, None]
    hit = d == 0.0
    M = d.prod(axis=0)[None, :] * w[:, None] / np.where(hit, 1.0, d)
    if hit.any():
        col = hit.any(axis=0)
        M[:, col] = hit[:, col]
    return M


def _interp_dd(src_nds, trg_nds):
    s = src_nds if isinstance(src_nds, qm.DD) else qm.DD(
        np.asarray(src_nds, dtype=np.float64))
    t = trg_nds if isinstance(trg_nds, qm.DD) else qm.DD(
        np.asarray(trg_nds, dtype=np.float64))
    ns, nt = len(s.hi), len(t.hi)
    M = qm.DD(np.ones((ns, nt)))
    for i in range(ns):
        row = qm.DD(np.ones(nt))
        for j in range(ns):
            if j != i:
                num = t - qm.DD(s.hi[j], s.lo[j])
                den = qm.DD(s.hi[i], s.lo[i]) - qm.DD(s.hi[j], s.lo[j])
                row = qm.dd_mul(row, qm.dd_div(num, den))
        M.hi[i, :], M.lo[i, :] = row.hi, row.lo
    return M.to_float64()


def derivative_matrix(nds) -> np.ndarray:
    """Spectral differentiation matrix D (N, N): f'(nds) = f(nds) @ D
    (reference: LagrangeInterp::Derivative, lagrange-interp.txx:104)."""
    x = np.asarray(nds, dtype=np.float64)
    n = len(x)
    # barycentric weights
    w = np.ones(n)
    for i in range(n):
        for j in range(n):
            if j != i:
                w[i] /= (x[i] - x[j])
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                D[i, j] = (w[i] / w[j]) / (x[j] - x[i])
    for j in range(n):
        D[j, j] = -np.sum(D[:, j])
    return D
