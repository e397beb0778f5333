"""Potential-theory kernels in PyTorch (counterpart of
sctl_tpu/ops/kernels.py:84).

Conventions match the JAX package: r = x_target - x_source;
out[k1] += K[k0][k1] * density[k0]; `scale_factor` is applied once to
the accumulated sum; r == 0 gives a zero contribution (masked 1/r).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .uker import check_supported, uker_matrix


def rinv_masked(r2: torch.Tensor) -> torch.Tensor:
    """1/sqrt(r2), 0 where r2 == 0 (coincident and padding pairs)."""
    pos = r2 > 0
    return torch.where(pos, torch.rsqrt(torch.where(pos, r2, 1.0)), 0.0)


def pairwise_r2(xt: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(..., T, S) squared distances by explicit differences (never the
    |x|^2 + |y|^2 - 2 x.y form, which leaves r2 != 0 for coincident
    points and defeats the self-pair mask)."""
    r2 = None
    for d in range(xt.shape[-1]):
        dx = xt[..., :, d, None] - xs[..., None, :, d]
        r2 = dx * dx if r2 is None else r2 + dx * dx
    return r2


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Kernel descriptor: dimensions, flops per pair, scale factor and
    the per-component homogeneity exponents under x -> a x,
    K(a r)[i, j] = a^-(src_scal[i] + trg_scal[j]) K(r)[i, j]."""
    name: str
    kdim0: int
    kdim1: int
    scale_factor: float
    src_scal: tuple
    trg_scal: tuple

    def matrix(self, dx: torch.Tensor) -> torch.Tensor:
        """(..., k0, k1) blocks for displacements dx (..., 3), without
        the scale factor."""
        return uker_matrix(self.name, dx, rinv_masked((dx * dx).sum(-1)))

    def apply_pairwise(self, xt, xs, f):
        """Unscaled applied kernel: xt (..., T, 3), xs (..., S, 3),
        f (..., S, k0) -> (..., T, k1)."""
        check_supported(self.name)
        rinv = rinv_masked(pairwise_r2(xt, xs))
        return torch.matmul(rinv, f)

    def full_matrix(self, xt, xs):
        """Dense (S*k0, T*k1) matrix including the scale factor (the
        layout of sctl_tpu KernelSpec.full_matrix)."""
        dx = xt[None, :, :] - xs[:, None, :]
        m = self.matrix(dx) * self.scale_factor          # (S,T,k0,k1)
        S, T = xs.shape[0], xt.shape[0]
        return m.permute(0, 2, 1, 3).reshape(S * self.kdim0,
                                             T * self.kdim1)


Laplace3D_FxU = KernelSpec(
    "Laplace3D-FxU", 1, 1, 1 / (4 * math.pi),
    src_scal=(1.0,), trg_scal=(0.0,))

KERNELS = {Laplace3D_FxU.name: Laplace3D_FxU}
