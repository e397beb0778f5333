"""Plain float64 formulas of the potential kernels the cells use.

Written from the kernels' definitions, r = x_target - x_source, a zero
contribution where r = 0:

    Laplace3D-FxU   u = f / (4 pi |r|)

This module imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

# name -> (values a source carries, values a target receives)
DIMS = {
    "Laplace3D-FxU": (1, 1),
}


def kernel_matrix(name: str, xt, xs):
    """(T, S, k1, k0) float64 blocks K(xt_t - xs_s) for targets xt (T,
    3) and sources xs (S, 3)."""
    if name not in DIMS:
        raise ValueError(f"no reference formula for {name}")
    d = xt[:, None, :] - xs[None, :, :]                     # (T, S, 3)
    r2 = (d * d).sum(-1)
    pos = r2 > 0
    rinv = torch.where(pos, torch.rsqrt(torch.where(pos, r2, 1.0)), 0.0)
    return (rinv / (4 * math.pi))[..., None, None]


def direct_sum(name: str, xt, xs, F, block_bytes: int = 1 << 30):
    """Direct sums of several density sets at once, in float64:
    xt (T, 3), xs (S, 3), F (S, k0, m) -> (T, k1, m).  Sources go in
    blocks whose float64 temporaries (about 8 + 2 k0 k1 values a pair)
    take about `block_bytes`, so memory stays bounded at any size."""
    xt, xs, F = xt.double(), xs.double(), F.double()
    k0, k1 = DIMS[name]
    T, S = xt.shape[0], xs.shape[0]
    out = torch.zeros((T, k1, F.shape[-1]), dtype=torch.float64,
                      device=xt.device)
    step = max(1, block_bytes // (8 * (8 + 2 * k0 * k1) * max(T, 1)))
    for s in range(0, S, step):
        sl = slice(s, min(S, s + step))
        out += torch.einsum("tsij,sjm->tim", kernel_matrix(name, xt, xs[sl]),
                            F[sl])
    return out
