"""Single-source kernel micro-spec (counterpart of sctl_tpu/ops/uker.py).

`uker_matrix` writes each kernel's (..., k0, k1) matrix blocks once,
over numpy or torch arrays alike; `kernels.py` (torch) and
`kernels_np.py` (numpy f64 host precompute) both call it.
`uker_apply` is the applied form, out[..., t, :] = sum_s K(xt_t - xs_s)
f_s, written with explicit per-pair differences (never the moment
expansion xt * sum(w) - sum(xs w), which cancels in float32 when the
points lie far from the origin).

This slice carries Laplace3D-FxU and the three Stokes kernels of the
BIE path; every other kernel name raises.
"""

from __future__ import annotations

import numpy as np
import torch

SUPPORTED = ("Laplace3D-FxU", "Stokes3D-FxU", "Stokes3D-DxU",
             "Stokes3D-FSxU")
# the uniform KIFMM's shared-surface and slab kernels
LAPLACE_ONLY = ("Laplace3D-FxU",)


def check_supported(name: str, supported=SUPPORTED) -> None:
    """Raise NotImplementedError unless `name` is in `supported` (by
    default every kernel of the port; a stage passes its own list)."""
    if name not in supported:
        raise NotImplementedError(
            f"kernel {name} is not ported here; this path runs "
            f"{', '.join(supported)}")


def _eye3(d):
    if isinstance(d, torch.Tensor):
        return torch.eye(3, dtype=d.dtype, device=d.device)
    return np.eye(3, dtype=d.dtype)


def _cat(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def uker_matrix(name: str, d, rinv, ns=None):
    """(..., k0, k1) kernel blocks from displacements d = xt - xs
    (..., 3), the masked 1/r (0 where r = 0) and, for the double layer,
    per-pair source normals ns (..., 3).  No scale factor: callers
    apply it, as sctl_tpu/ops/uker.py:46 does."""
    check_supported(name)
    if name == "Laplace3D-FxU":
        return rinv[..., None, None]
    rinv3 = rinv * rinv * rinv
    dd = d[..., :, None] * d[..., None, :]
    if name == "Stokes3D-DxU":
        rdotn = (d * ns).sum(-1)
        return dd * (rdotn * rinv3 * rinv * rinv)[..., None, None]
    stk = _eye3(d) * rinv[..., None, None] + dd * rinv3[..., None, None]
    if name == "Stokes3D-FxU":
        return stk
    src = (d * rinv3[..., None])[..., None, :]             # (..., 1, 3)
    return _cat([stk, src], -2)                            # FSxU (.., 4, 3)


def rinv_masked(r2: torch.Tensor) -> torch.Tensor:
    """1/sqrt(r2), 0 where r2 == 0 (coincident and padding pairs)."""
    pos = r2 > 0
    return torch.where(pos, torch.rsqrt(torch.where(pos, r2, 1.0)), 0.0)


def pairwise_r2(xt: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(..., T, S) squared distances by explicit differences (never the
    |x|^2 + |y|^2 - 2 x.y form, which leaves r2 != 0 for coincident
    points and defeats the self-pair mask)."""
    r2 = None
    for k in range(xt.shape[-1]):
        dx = xt[..., :, k, None] - xs[..., None, :, k]
        r2 = dx * dx if r2 is None else r2 + dx * dx
    return r2


def uker_apply(name: str, xt, xs, ns, f):
    """Unscaled applied kernel: xt (..., T, 3), xs (..., S, 3),
    ns (..., S, 3) or None, f (..., S, k0) -> (..., T, k1)."""
    check_supported(name)
    if name == "Laplace3D-FxU":
        return torch.matmul(rinv_masked(pairwise_r2(xt, xs)), f)
    d = xt[..., :, None, :] - xs[..., None, :, :]          # (..., T, S, 3)
    rinv = rinv_masked((d * d).sum(-1))
    rinv3 = rinv * rinv * rinv
    rdotf = (d * f[..., None, :, :3]).sum(-1)
    if name == "Stokes3D-DxU":
        rdotn = (d * ns[..., None, :, :]).sum(-1)
        w = rdotf * rdotn * rinv3 * rinv * rinv
        return torch.einsum("...tsj,...ts->...tj", d, w)
    w = rdotf * rinv3
    if name == "Stokes3D-FSxU":
        w = w + f[..., None, :, 3] * rinv3
    return (torch.matmul(rinv, f[..., :3])
            + torch.einsum("...tsj,...ts->...tj", d, w))
