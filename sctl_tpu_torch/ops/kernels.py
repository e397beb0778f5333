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
    x -> a x, K(a r)[i, j] = a^-(src_scal[i] + trg_scal[j]) K(r)[i, j]."""
    name: str
    kdim0: int
    kdim1: int
    needs_normal: bool
    scale_factor: float
    src_scal: tuple
    trg_scal: tuple

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


Laplace3D_FxU = KernelSpec(
    "Laplace3D-FxU", 1, 1, False, 1 / (4 * math.pi),
    src_scal=(1.0,), trg_scal=(0.0,))
Stokes3D_FxU = KernelSpec(
    "Stokes3D-FxU", 3, 3, False, 1 / (8 * math.pi),
    src_scal=(1.0, 1.0, 1.0), trg_scal=(0.0, 0.0, 0.0))
Stokes3D_DxU = KernelSpec(
    "Stokes3D-DxU", 3, 3, True, 3 / (4 * math.pi),
    src_scal=(2.0, 2.0, 2.0), trg_scal=(0.0, 0.0, 0.0))
Stokes3D_FSxU = KernelSpec(
    "Stokes3D-FSxU", 4, 3, False, 1 / (8 * math.pi),
    src_scal=(1.0, 1.0, 1.0, 2.0), trg_scal=(0.0, 0.0, 0.0))

KERNELS = {k.name: k for k in (Laplace3D_FxU, Stokes3D_FxU, Stokes3D_DxU,
                               Stokes3D_FSxU)}
