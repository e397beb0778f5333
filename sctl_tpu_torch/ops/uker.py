"""Single-source kernel micro-spec (counterpart of sctl_tpu/ops/uker.py).

`uker_matrix` writes each kernel's (..., k0, k1) matrix blocks once,
over numpy or torch arrays alike; `kernels.py` (torch) and
`kernels_np.py` (numpy f64 host precompute) both call it.
`uker_apply` is the applied form, out[..., t, :] = sum_s K(xt_t - xs_s)
f_s, written with explicit per-pair differences (never the moment
expansion xt * sum(w) - sum(xs w), which cancels in float32 when the
points lie far from the origin).

All eight kernels of the JAX package are here.  `FORMULA` numbers
them as csrc/ukernels.cuh does, where each CUDA kernel reads its
formula from.
"""

from __future__ import annotations

import numpy as np
import torch

SUPPORTED = ("Laplace3D-FxU", "Laplace3D-DxU", "Laplace3D-FxdU",
             "Stokes3D-FxU", "Stokes3D-DxU", "Stokes3D-FxT",
             "Stokes3D-FSxU", "Stokes3D-FxUP")
# kernel name -> formula index of csrc/ukernels.cuh
FORMULA = {name: i for i, name in enumerate(SUPPORTED)}
# the kernels with a uniform-tree path (sctl_tpu/fmm/fmm.py:35-42)
TREE_KERNELS = SUPPORTED[:5] + ("Stokes3D-FSxU",)
# the S2M check kernels and the L2T kernels of those tree paths
S2M_KERNELS = ("Laplace3D-FxU", "Laplace3D-DxU", "Stokes3D-FxU",
               "Stokes3D-DxU", "Stokes3D-FSxU")
L2T_KERNELS = ("Laplace3D-FxU", "Laplace3D-FxdU", "Stokes3D-FSxU")


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
    if name == "Laplace3D-DxU":
        return ((d * ns).sum(-1) * rinv3)[..., None, None]
    if name == "Laplace3D-FxdU":
        return (d * rinv3[..., None])[..., None, :]        # (..., 1, 3)
    dd = d[..., :, None] * d[..., None, :]
    if name in ("Stokes3D-DxU", "Stokes3D-FxT"):
        rinv5 = rinv3 * rinv * rinv
        if name == "Stokes3D-DxU":
            return dd * ((d * ns).sum(-1) * rinv5)[..., None, None]
        rr = d[..., :, None, None] * (dd * rinv5[..., None, None])[
            ..., None, :, :]                               # (..., 3, 3, 3)
        return rr.reshape(rr.shape[:-3] + (3, 9))
    stk = _eye3(d) * rinv[..., None, None] + dd * rinv3[..., None, None]
    if name == "Stokes3D-FxU":
        return stk
    src = d * rinv3[..., None]
    if name == "Stokes3D-FSxU":
        return _cat([stk, src[..., None, :]], -2)          # (..., 4, 3)
    return _cat([stk, src[..., :, None]], -1)              # FxUP (.., 3, 4)


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
    dsum = lambda w: torch.einsum("...tsj,...ts->...tj", d, w)
    if name.startswith("Laplace"):
        if name == "Laplace3D-DxU":
            rdotn = (d * ns[..., None, :, :]).sum(-1)
            return torch.matmul(rdotn * rinv3, f)
        return dsum(rinv3 * f[..., None, :, 0])            # FxdU
    rdotf = (d * f[..., None, :, :3]).sum(-1)
    if name in ("Stokes3D-DxU", "Stokes3D-FxT"):
        rinv5 = rinv3 * rinv * rinv
        if name == "Stokes3D-DxU":
            rdotn = (d * ns[..., None, :, :]).sum(-1)
            return dsum(rdotf * rdotn * rinv5)
        w = (rdotf * rinv5)[..., None]
        return torch.einsum("...tsj,...tsk->...tjk", d * w, d).flatten(-2)
    w = rdotf * rinv3
    if name == "Stokes3D-FSxU":
        w = w + f[..., None, :, 3] * rinv3
    u = torch.matmul(rinv, f[..., :3]) + dsum(w)
    if name == "Stokes3D-FxUP":                            # the pressure
        u = torch.cat([u, (rdotf * rinv3).sum(-1, keepdim=True)], -1)
    return u
