"""Potential-theory kernels in PyTorch (counterpart of
sctl_tpu/ops/kernels.py:84-229).

Conventions match the JAX package: r = x_target - x_source;
out[k1] += K[k0][k1] * density[k0]; `scale_factor` is applied once to
the accumulated sum; r == 0 gives a zero contribution (masked 1/r).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .uker import rinv_masked, uker_apply, uker_matrix


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Kernel descriptor: dimensions, whether it reads source normals,
    scale factor and the per-component homogeneity exponents under
    x -> a x, K(a r)[i, j] = a^-(src_scal[i] + trg_scal[j]) K(r)[i, j].
    `flops` is the JAX package's per-pair operation count
    (sctl_tpu/ops/kernels.py:192-225), which the card's bounds read."""
    name: str
    kdim0: int
    kdim1: int
    needs_normal: bool
    scale_factor: float
    src_scal: tuple
    trg_scal: tuple
    flops: int = 0

    @property
    def src_floats(self) -> int:
        """Values a source carries: its point, its densities and, for
        the double layers, its normal (what a pair kernel stages)."""
        return 3 + self.kdim0 + (3 if self.needs_normal else 0)

    def matrix(self, dx: torch.Tensor, n=None) -> torch.Tensor:
        """(..., k0, k1) blocks for displacements dx (..., 3) and
        per-pair source normals n, without the scale factor."""
        return uker_matrix(self.name, dx, rinv_masked((dx * dx).sum(-1)),
                           n)

    def apply_pairwise(self, xt, xs, ns, f):
        """Unscaled applied kernel: xt (..., T, 3), xs (..., S, 3),
        ns (..., S, 3) source normals (None unless needs_normal),
        f (..., S, k0) -> (..., T, k1)."""
        return uker_apply(self.name, xt, xs, ns, f)

    def full_matrix(self, xt, xs, ns=None):
        """Dense (S*k0, T*k1) matrix including the scale factor (the
        layout of sctl_tpu KernelSpec.full_matrix)."""
        dx = xt[None, :, :] - xs[:, None, :]
        n = None if ns is None else ns[:, None, :].expand_as(dx)
        m = self.matrix(dx, n) * self.scale_factor       # (S,T,k0,k1)
        S, T = xs.shape[0], xt.shape[0]
        return m.permute(0, 2, 1, 3).reshape(S * self.kdim0,
                                             T * self.kdim1)


_PI = math.pi
Laplace3D_FxU = KernelSpec(
    "Laplace3D-FxU", 1, 1, False, 1 / (4 * _PI),
    src_scal=(1.0,), trg_scal=(0.0,), flops=6)
Laplace3D_DxU = KernelSpec(
    "Laplace3D-DxU", 1, 1, True, 1 / (4 * _PI),
    src_scal=(2.0,), trg_scal=(0.0,), flops=14)
Laplace3D_FxdU = KernelSpec(
    "Laplace3D-FxdU", 1, 3, False, -1 / (4 * _PI),
    src_scal=(1.0,), trg_scal=(1.0, 1.0, 1.0), flops=11)
Stokes3D_FxU = KernelSpec(
    "Stokes3D-FxU", 3, 3, False, 1 / (8 * _PI),
    src_scal=(1.0, 1.0, 1.0), trg_scal=(0.0, 0.0, 0.0), flops=23)
Stokes3D_DxU = KernelSpec(
    "Stokes3D-DxU", 3, 3, True, 3 / (4 * _PI),
    src_scal=(2.0, 2.0, 2.0), trg_scal=(0.0, 0.0, 0.0), flops=26)
Stokes3D_FxT = KernelSpec(
    "Stokes3D-FxT", 3, 9, False, -3 / (4 * _PI),
    src_scal=(1.0, 1.0, 1.0), trg_scal=(1.0,) * 9, flops=39)
Stokes3D_FSxU = KernelSpec(
    "Stokes3D-FSxU", 4, 3, False, 1 / (8 * _PI),
    src_scal=(1.0, 1.0, 1.0, 2.0), trg_scal=(0.0, 0.0, 0.0), flops=26)
Stokes3D_FxUP = KernelSpec(
    "Stokes3D-FxUP", 3, 4, False, 1 / (8 * _PI),
    src_scal=(1.0, 1.0, 1.0), trg_scal=(0.0, 0.0, 0.0, 1.0), flops=26)

KERNELS = {k.name: k for k in (
    Laplace3D_FxU, Laplace3D_DxU, Laplace3D_FxdU, Stokes3D_FxU,
    Stokes3D_DxU, Stokes3D_FxT, Stokes3D_FSxU, Stokes3D_FxUP)}
