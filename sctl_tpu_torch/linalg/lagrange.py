"""Lagrange interpolation weights (numpy copy of
sctl_tpu/linalg/lagrange.py `interpolation_matrix`, float64 path)."""

from __future__ import annotations

import numpy as np


def interpolation_matrix(src_nds, trg_nds) -> np.ndarray:
    """Matrix M (Ns, Nt) with f(trg) = f(src) @ M: first-form
    barycentric weights M[i] = l(t) w_i / (t - s_i), l(t) =
    prod_j (t - s_j), w_i = 1 / prod_{j != i} (s_i - s_j); an exact
    node hit takes the one-hot limit."""
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
